"""Module teardown shared by the PyTorch port's CPU test files.

The tier-1 suite runs six pytest-xdist workers on one host, and its largest
JAX test (`test_cli_train.py::test_train_cli_grad_accum_on_mesh`, about 36 GB)
runs beside them. A worker keeps what earlier files left: JAX's compiled
programs and freed heap that glibc has not given back. A port test file that
imports `teardown_module` from here drops both when it ends, which keeps such a
worker near its import footprint (about 1 GB) instead of several GB.
"""

import ctypes
import gc

import jax


def teardown_module(module=None):
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass
