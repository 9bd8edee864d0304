"""`sinkhorn_scaling`'s share of its roofline in the traced stretch (at
K = 2048 its wide instantiation): the least time of each launch's
scaling-domain solve at the eval shapes (`harness/work.py`), over the
kernel's device time. Found by the name of its CUDA symbol."""

import re

from benchmark.harness import work

KERNEL = re.compile(r"\bscaling_cluster_kernel<")


def read(run):
    t = run.trace
    if t is None or not t.done:
        return None
    n, s = t.seconds_by(KERNEL)
    if s <= 0:
        return None
    return 100.0 * n * work.bound_s(*work.sinkhorn_scaling(*work.sinkhorn_shape(run.shapes))) / s
