"""Multi-head attention over keypoint tokens (plain PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/ops/attention.py`. Heads split
contiguously, `reshape(B, S, h, dh)`, as the JAX package does (not the
upstream SuperGlue interleave). Masked-out logits are filled with -1e9 and the
softmax denominator carries +1e-9, the JAX constants. The dtypes are the JAX
package's too: float32 logits and softmax whatever the inputs' type, the
probabilities rounded to v's type before the float32-accumulated product with
v, the output in q's type (for bfloat16 inputs: logits from exact products,
`attn` rounded to bfloat16, the output rounded once).
"""

import math

import torch

_NEG_INF = -1e9


def at_least_f32(x):
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def multi_head_attention(q, k, v, num_heads, mask=None):
    """Scaled dot-product MHA on already-projected tensors.

    Args:
        q: (B, Q, D); k, v: (B, S, D); num_heads: head count.
        mask: optional (B, Q, S) or (Q, S) bool, True = attend.
    Returns:
        (B, Q, D) attention output (no output projection).
    """
    B, Q, D = q.shape
    S = k.shape[1]
    h = num_heads
    dh = D // h
    # bfloat16 operands go in as float32: the products of bfloat16 values are
    # exact in float32, and a bfloat16 einsum would round its result
    qh = at_least_f32(q.reshape(B, Q, h, dh))
    kh = at_least_f32(k.reshape(B, S, h, dh))
    vh = at_least_f32(v.reshape(B, S, h, dh))
    logits = torch.einsum("bqhd,bshd->bhqs", qh, kh) / math.sqrt(dh)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None], _NEG_INF)
    attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-9)
    attn = at_least_f32(attn.to(v.dtype))
    out = torch.einsum("bhqs,bshd->bqhd", attn, vh)
    return out.reshape(B, Q, D).to(q.dtype)


def _view_ids(n_views, n_kpts, device):
    return torch.arange(n_views, device=device).repeat_interleave(n_kpts)


def cross_view_mask(n_views, n_kpts, device=None):
    """(V*K, V*K) bool mask: token q may attend key s iff in different views."""
    vid = _view_ids(n_views, n_kpts, device)
    return vid[:, None] != vid[None, :]


def self_view_mask(n_views, n_kpts, device=None):
    """(V*K, V*K) bool mask allowing attention only within the same view."""
    vid = _view_ids(n_views, n_kpts, device)
    return vid[:, None] == vid[None, :]
