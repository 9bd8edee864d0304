"""The training Sinkhorn kernels' share of their roofline in the traced
stretch: `sinkhorn_log` with its stash and `sinkhorn_bwd`, each launch's
least time at the training shapes (`harness/work.py`), over the two
kernels' device time. Found by the names of their CUDA symbols."""

import re

from benchmark.harness import work

KERNELS = ((re.compile(r"\blog_cluster_kernel<"), work.sinkhorn_log_stash),
           (re.compile(r"\bbwd_cluster_kernel<"), work.sinkhorn_bwd))


def read(run):
    t = run.trace
    if t is None or not t.done:
        return None
    shape = work.sinkhorn_shape(run.shapes)
    bound = seconds = 0.0
    for pattern, arithmetic in KERNELS:
        n, s = t.seconds_by(pattern)
        bound += n * work.bound_s(*arithmetic(*shape))
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
