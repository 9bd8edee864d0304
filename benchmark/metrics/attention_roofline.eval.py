"""The attention kernels' share of their roofline in the traced stretch: the
least time the eval shapes allow for every launch of `attn_fwd` (self
layers) and `cross_attn_fwd` (cross layers) found in the device trace
(`harness/work.py`: operations at the FP32 peak, exponentials, bytes read
and written once), over those kernels' device time. The kernels are found
by the names of their CUDA symbols."""

import re

from benchmark.harness import work

KERNELS = (("self", re.compile(r"\battn_fwd_kernel<"), work.attn_fwd),
           ("cross", re.compile(r"\bcross_attn_fwd_kernel<\d+, false>"), work.attn_fwd))


def read(run):
    t = run.trace
    if t is None or not t.done:
        return None
    shapes = work.attention_shapes(run.shapes)
    bound = seconds = 0.0
    for kind, pattern, arithmetic in KERNELS:
        n, s = t.seconds_by(pattern)
        bound += n * work.bound_s(*arithmetic(*shapes[kind]))
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
