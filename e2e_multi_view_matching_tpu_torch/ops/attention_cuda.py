"""Fused view-structured attention: the CUDA counterpart of `ops/attention_pallas.py`.

`fused_view_attention` keeps the JAX dispatch: the cross-view kernels (own-view
keys never read) for every cross layer with more than one view, otherwise the
masked kernel, which builds the `full`/`self`/`cross` mask from token indices.
Under grad the cross layers carry the flash backward of the JAX custom VJP: the
forward also stores the per-row LSE, and two kernels rebuild the probabilities
from it for dq and for dk/dv; self and full layers keep the recompute VJP
through the plain version, as in JAX. A CUDA tensor launches a kernel or
raises; a CPU tensor takes the plain versions (the same autograd wiring under
grad).

Kernels (`ops/csrc/attention_cuda.cu`): `attn_fwd` replaces `_attn_kernel`,
`cross_attn_fwd` `_cross_attn_kernel`, `cross_attn_fwd_lse`
`_cross_attn_lse_kernel`, `cross_attn_bwd_dq` `_cross_attn_bwd_dq_kernel`,
`cross_attn_bwd_dkv` `_cross_attn_bwd_dkv_kernel`.
"""

import ctypes

import torch

from e2e_multi_view_matching_tpu_torch.ops import cuda_build
from e2e_multi_view_matching_tpu_torch.ops.attention import (
    _NEG_INF,
    cross_view_mask,
    multi_head_attention,
    self_view_mask,
)

_MODES = {"full": 0, "self": 1, "cross": 2}
_HEAD_DIMS = (16, 32, 64)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd_lse": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_bwd_dq": (_I, [_P] * 7 + [_I] * 5 + [_F, _P]),
    "cross_attn_bwd_dkv": (_I, [_P] * 8 + [_I] * 5 + [_F, _P]),
}

# kernel launches since the last reset, one per wrapper call that launched
launches = {"attn_fwd": 0, "cross_attn_fwd": 0, "cross_attn_fwd_lse": 0,
            "cross_attn_bwd_dq": 0, "cross_attn_bwd_dkv": 0}


def _lib():
    return cuda_build.load("attention_cuda", _SIGNATURES)


def _check(*xs, shape=None):
    shape = xs[0].shape if shape is None else shape
    for x in xs:
        if not x.is_cuda:
            raise ValueError("the attention kernels take CUDA tensors")
        if x.dtype != torch.float32:
            raise ValueError(f"the attention kernels take float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the attention kernels take contiguous tensors")
        if x.shape != shape:
            raise ValueError(f"attention kernel operands must share the shape {tuple(shape)}")
    if len(shape) != 3:
        raise ValueError("the attention kernels take split heads (BH, S, dh)")
    if shape[2] not in _HEAD_DIMS:
        raise ValueError(f"the attention kernels take head widths {_HEAD_DIMS}")


def _check_cross(q, n_views, n_kpts):
    if n_views < 2 or q.shape[1] != n_views * n_kpts:
        raise ValueError("the cross-view kernels take n_views >= 2 and S = n_views * n_kpts")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")
    launches[name] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def attn_fwd(q, k, v, n_kpts, mode, scale):
    """Masked attention kernel on split heads (BH, S, dh), mode full/self/cross."""
    _check(q, k, v)
    if mode not in _MODES:
        raise ValueError(f"attn_fwd takes a mode in {tuple(_MODES)}")
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    _launched("attn_fwd", _lib().attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, dh, n_kpts,
        _MODES[mode], scale, _stream(q)))
    return out


def cross_attn_fwd(q, k, v, n_views, n_kpts, scale):
    """Cross-view online-softmax kernel on split heads (BH, S = V*K, dh)."""
    _check(q, k, v)
    _check_cross(q, n_views, n_kpts)
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    _launched("cross_attn_fwd", _lib().cross_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, dh, n_views,
        n_kpts, scale, _stream(q)))
    return out


def cross_attn_fwd_lse(q, k, v, n_views, n_kpts, scale):
    """`cross_attn_fwd` that also returns the per-row LSE (BH, S) of its softmax."""
    _check(q, k, v)
    _check_cross(q, n_views, n_kpts)
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=q.dtype, device=q.device)
    _launched("cross_attn_fwd_lse", _lib().cross_attn_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, S,
        dh, n_views, n_kpts, scale, _stream(q)))
    return out, lse


def _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts):
    _check(q, k, v, do)
    for x in (lse, dvec):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("lse and dvec must be contiguous float32 CUDA tensors")
        if x.shape != q.shape[:2]:
            raise ValueError("lse and dvec must have the shape (BH, S)")
    _check_cross(q, n_views, n_kpts)


def cross_attn_bwd_dq(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """dq of the cross-view attention from the stashed LSE and dvec = rowsum(dO * O)."""
    _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts)
    BH, S, dh = q.shape
    dq = torch.empty_like(q)
    _launched("cross_attn_bwd_dq", _lib().cross_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dq.data_ptr(), BH, S, dh, n_views, n_kpts, scale, _stream(q)))
    return dq


def cross_attn_bwd_dkv(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """(dk, dv) of the cross-view attention from the stashed LSE and dvec."""
    _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts)
    BH, S, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launched("cross_attn_bwd_dkv", _lib().cross_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, S, dh, n_views, n_kpts, scale,
        _stream(q)))
    return dk, dv


def plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode):
    """The plain PyTorch version of the forward kernels (masked `multi_head_attention`)."""
    if mode == "full":
        mask = None
    else:
        fn = cross_view_mask if mode == "cross" else self_view_mask
        mask = fn(n_views, n_kpts, device=q.device)
    return multi_head_attention(q, k, v, num_heads, mask=mask)


def cross_attn_fwd_lse_plain(q, k, v, n_views, n_kpts, scale):
    """Plain version of `cross_attn_fwd_lse` on split heads: one-shot softmax
    under the cross mask (-1e9 fill, +1e-9 denominator) -> (o, lse (BH, S))."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    s = s.masked_fill(~cross_view_mask(n_views, n_kpts, device=q.device), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True) + 1e-9
    return (p @ v) / l, (m + torch.log(l))[..., 0]


def cross_attn_bwd_plain(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """Plain version of `cross_attn_bwd_dq` and `cross_attn_bwd_dkv`: p rebuilt
    from the LSE under the cross mask -> (dq, dk, dv)."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    p = p.masked_fill(~cross_view_mask(n_views, n_kpts, device=q.device), 0.0)
    ds = p * (do @ v.transpose(1, 2) - dvec[..., None])
    return (ds @ k) * scale, (ds.transpose(1, 2) @ q) * scale, p.transpose(1, 2) @ do


def _split_merge(B, S, h, dh):
    def split(x):
        return x.reshape(B, S, h, dh).transpose(1, 2).reshape(B * h, S, dh).contiguous()

    def merge(x):
        return x.reshape(B, h, S, dh).transpose(1, 2).reshape(B, S, h * dh)

    return split, merge


def _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode):
    """Forward of `fused_view_attention` on the kernels (CUDA tensors)."""
    B, S, D = q.shape
    dh = D // num_heads
    split, merge = _split_merge(B, S, num_heads, dh)
    scale = 1.0 / (dh ** 0.5)
    if mode == "cross" and n_views > 1:
        out = cross_attn_fwd(split(q), split(k), split(v), n_views, n_kpts, scale)
    else:
        out = attn_fwd(split(q), split(k), split(v), n_kpts, mode, scale)
    return merge(out)


class _FusedViewAttention(torch.autograd.Function):
    """Cross layers (n_views > 1): forward with the LSE stash, backward from it
    (JAX `_fwd`/`_bwd` of `fused_view_attention`), on the kernels for CUDA
    tensors and on their plain versions for CPU tensors. Other layers: forward
    on the kernel (CPU: the plain version), backward = VJP of the plain version
    recomputed from the saved q, k, v (the probabilities are never kept)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, n_views, n_kpts, mode):
        ctx.structure = (num_heads, n_views, n_kpts, mode)
        ctx.flash = mode == "cross" and n_views > 1
        if not ctx.flash:
            ctx.save_for_backward(q, k, v)
            if q.is_cuda:
                return _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
            return plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
        B, S, D = q.shape
        dh = D // num_heads
        split, merge = _split_merge(B, S, num_heads, dh)
        fwd = cross_attn_fwd_lse if q.is_cuda else cross_attn_fwd_lse_plain
        qs, ks, vs = split(q), split(k), split(v)
        o_s, lse = fwd(qs, ks, vs, n_views, n_kpts, 1.0 / (dh ** 0.5))
        ctx.save_for_backward(qs, ks, vs, o_s, lse)
        return merge(o_s)

    @staticmethod
    def backward(ctx, g):
        num_heads, n_views, n_kpts, mode = ctx.structure
        if not ctx.flash:
            with torch.enable_grad():
                q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
                out = plain_view_attention(q, k, v, *ctx.structure)
                dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
            return dq, dk, dv, None, None, None, None
        qs, ks, vs, o_s, lse = ctx.saved_tensors
        B, S, D = g.shape
        dh = D // num_heads
        split, merge = _split_merge(B, S, num_heads, dh)
        do_s = split(g)
        dvec = (do_s * o_s).sum(dim=-1)
        scale = 1.0 / (dh ** 0.5)
        args = (qs, ks, vs, do_s, lse, dvec, n_views, n_kpts, scale)
        if g.is_cuda:
            dq = cross_attn_bwd_dq(*args)
            dk, dv = cross_attn_bwd_dkv(*args)
        else:
            dq, dk, dv = cross_attn_bwd_plain(*args)
        return merge(dq), merge(dk), merge(dv), None, None, None, None


def fused_view_attention(q, k, v, num_heads, n_views, n_kpts, mode="cross"):
    """Masked MHA over view/keypoint tokens.

    Args:
        q, k, v: (B, S, D) projected tensors with S = n_views * n_kpts.
        num_heads: head count; n_views, n_kpts: token structure.
        mode: "cross" (attend other views), "self" (own view) or "full".
    Returns:
        (B, S, D) attention output (no output projection).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedViewAttention.apply(q, k, v, num_heads, n_views, n_kpts, mode)
    if not q.is_cuda:
        return plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
    return _kernel_view_attention(q, k, v, num_heads, n_views, n_kpts, mode)
