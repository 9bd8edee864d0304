"""The cross-attention training kernels' share of their roofline in the
traced stretch: the least time the training shapes allow for every launch
of `cross_attn_fwd_lse`, `cross_attn_bwd_dq` and `cross_attn_bwd_dkv` found
in the device trace (`harness/work.py`), over those kernels' device time.
The kernels are found by the names of their CUDA symbols."""

import re

from benchmark.harness import work

KERNELS = ((re.compile(r"\bcross_attn_fwd_kernel<\d+, true>"), work.attn_fwd_lse),
           (re.compile(r"\bcross_attn_bwd_dq_kernel<"), work.attn_bwd_dq),
           (re.compile(r"\bcross_attn_bwd_dkv_kernel<"), work.attn_bwd_dkv))


def read(run):
    t = run.trace
    if t is None or not t.done:
        return None
    shape = work.attention_shapes(run.shapes)["cross"]
    bound = seconds = 0.0
    for pattern, arithmetic in KERNELS:
        n, s = t.seconds_by(pattern)
        bound += n * work.bound_s(*arithmetic(*shape))
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
