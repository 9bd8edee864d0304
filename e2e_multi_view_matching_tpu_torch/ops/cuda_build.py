"""Build and load the hand-written CUDA kernels of `ops/csrc/`.

Each `*.cu` source is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface and loaded with `ctypes`. The library is built at
first use into `build/cuda/` at the repository root (listed in `.gitignore`),
named by a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. `build_all()` starts one `nvcc` per source in
parallel. No `--use_fast_math`: the kernels rely on IEEE `expf`, division and
subnormals (the Sinkhorn guard 1e-30).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = ("attention_cuda", "attention_bf16_cuda", "sinkhorn_cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name, extra_flags=()):
    src, out = _lib_path(name)
    if out.exists() and not extra_flags:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name, started):
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(verbose=False):
    """Compile every kernel source, one `nvcc` each, all started together.

    Returns {name: nvcc output}; with `verbose`, sources are rebuilt with
    `-Xptxas -v` so the output lists each kernel's registers and spills."""
    extra = ("-Xptxas", "-v") if verbose else ()
    started = {n: _start(n, extra) for n in SOURCES}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name, signatures):
    """ctypes handle of the named kernel library, building it if needed.

    Args:
        name: source stem under `csrc/`.
        signatures: {function: (restype, [argtypes])} of its C interface.
    """
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)[1]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return lib
