"""Fused view-structured attention: the CUDA counterpart of `ops/attention_pallas.py`.

`fused_view_attention` keeps the JAX dispatch: the cross-view kernel (own-view
keys never read) when the query tile divides `n_kpts`, otherwise the masked
kernel, which builds the `full`/`self`/`cross` mask from token indices. A CUDA
tensor launches a kernel or raises; a CPU tensor takes the plain version,
`multi_head_attention` with the same mask. Forward only.

Kernels (`ops/csrc/attention_cuda.cu`): `attn_fwd` replaces `_attn_kernel`,
`cross_attn_fwd` replaces `_cross_attn_kernel`.
"""

import ctypes

import torch

from e2e_multi_view_matching_tpu_torch.ops import cuda_build
from e2e_multi_view_matching_tpu_torch.ops.attention import (
    cross_view_mask,
    multi_head_attention,
    self_view_mask,
)

QUERY_TILE = 64  # query rows per block of both kernels (BQ in the source)
_MODES = {"full": 0, "self": 1, "cross": 2}
_HEAD_DIMS = (16, 32, 64)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "attn_query_tile": (_I, []),
}

# kernel launches since the last reset, one per wrapper call that launched
launches = {"attn_fwd": 0, "cross_attn_fwd": 0}


def _lib():
    lib = cuda_build.load("attention_cuda", _SIGNATURES)
    if lib.attn_query_tile() != QUERY_TILE:
        raise RuntimeError("attention kernel query tile disagrees with QUERY_TILE")
    return lib


def _check(q, k, v):
    for x in (q, k, v):
        if not x.is_cuda:
            raise ValueError("the attention kernels take CUDA tensors")
        if x.dtype != torch.float32:
            raise ValueError(f"the attention kernels take float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the attention kernels take contiguous tensors")
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError("q, k, v must share one shape (BH, S, dh)")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"the attention kernels take head widths {_HEAD_DIMS}")


def attn_fwd(q, k, v, n_kpts, mode, scale):
    """Masked attention kernel on split heads (BH, S, dh), mode full/self/cross."""
    _check(q, k, v)
    if mode not in _MODES:
        raise ValueError(f"attn_fwd takes a mode in {tuple(_MODES)}")
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    rc = _lib().attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         BH, S, dh, n_kpts, _MODES[mode], scale,
                         torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attn_fwd launch failed (code {rc})")
    launches["attn_fwd"] += 1
    return out


def cross_attn_fwd(q, k, v, n_views, n_kpts, scale):
    """Cross-view online-softmax kernel on split heads (BH, S = V*K, dh)."""
    _check(q, k, v)
    BH, S, dh = q.shape
    if n_kpts % QUERY_TILE or S != n_views * n_kpts or n_views < 2:
        raise ValueError("cross_attn_fwd takes n_views >= 2, S = n_views * n_kpts "
                         f"and n_kpts a multiple of {QUERY_TILE}")
    out = torch.empty_like(q)
    rc = _lib().cross_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), BH, S, dh, n_views, n_kpts, scale,
                               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cross_attn_fwd launch failed (code {rc})")
    launches["cross_attn_fwd"] += 1
    return out


def plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode):
    """The plain PyTorch version of both kernels (masked `multi_head_attention`)."""
    if mode == "full":
        mask = None
    else:
        fn = cross_view_mask if mode == "cross" else self_view_mask
        mask = fn(n_views, n_kpts, device=q.device)
    return multi_head_attention(q, k, v, num_heads, mask=mask)


def _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode):
    """Forward of `fused_view_attention` on the kernels (CUDA tensors)."""
    B, S, D = q.shape
    h = num_heads
    dh = D // h

    def split(x):
        return x.reshape(B, S, h, dh).transpose(1, 2).reshape(B * h, S, dh).contiguous()

    scale = 1.0 / (dh ** 0.5)
    if mode == "cross" and n_views > 1 and n_kpts % QUERY_TILE == 0:
        out = cross_attn_fwd(split(q), split(k), split(v), n_views, n_kpts, scale)
    else:
        out = attn_fwd(split(q), split(k), split(v), n_kpts, mode, scale)
    return out.reshape(B, h, S, dh).transpose(1, 2).reshape(B, S, D)


class _FusedViewAttention(torch.autograd.Function):
    """Kernel forward; backward = VJP of the plain version, recomputed from
    the saved q, k, v (the probabilities are never kept)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, n_views, n_kpts, mode):
        ctx.save_for_backward(q, k, v)
        ctx.structure = (num_heads, n_views, n_kpts, mode)
        return _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = plain_view_attention(q, k, v, *ctx.structure)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def fused_view_attention(q, k, v, num_heads, n_views, n_kpts, mode="cross"):
    """Masked MHA over view/keypoint tokens.

    Args:
        q, k, v: (B, S, D) projected tensors with S = n_views * n_kpts.
        num_heads: head count; n_views, n_kpts: token structure.
        mode: "cross" (attend other views), "self" (own view) or "full".
    Returns:
        (B, S, D) attention output (no output projection).
    """
    if not q.is_cuda:
        return plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedViewAttention.apply(q, k, v, num_heads, n_views, n_kpts, mode)
    return _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
