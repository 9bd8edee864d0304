"""Fused view-structured attention: the CUDA counterpart of `ops/attention_pallas.py`.

`fused_view_attention` keeps the JAX dispatch: the cross-view kernels (own-view
keys never read) for every cross layer with more than one view, otherwise the
masked kernel, which builds the `full`/`self`/`cross` mask from token indices.
Under grad the cross layers carry the flash backward of the JAX custom VJP: the
forward also stores the per-row LSE, and two kernels rebuild the probabilities
from it for dq and for dk/dv; self and full layers keep the recompute VJP
through `multi_head_attention` with the layer's mask, as in JAX (`_bwd`
takes the VJP of `_ref_attention`). A CUDA tensor launches a kernel or raises;
a CPU tensor takes the plain versions (the same autograd wiring under grad).

Kernels (`ops/csrc/attention_cuda.cu`, float32): `attn_fwd` replaces
`_attn_kernel`, `cross_attn_fwd` `_cross_attn_kernel`, `cross_attn_fwd_lse`
`_cross_attn_lse_kernel`, `cross_attn_bwd_dq` `_cross_attn_bwd_dq_kernel`,
`cross_attn_bwd_dkv` `_cross_attn_bwd_dkv_kernel`. Given bfloat16 q, k, v (and
dO), each wrapper launches its tensor-core kernel of
`ops/csrc/attention_bf16_cuda.cu` instead, counted under the kernel's name
with `_bf16` appended: the Pallas kernels' bfloat16 instantiations. Forward:
scores, softmax and P V in float32, the output rounded to bfloat16 once, the
LSE in float32 (`plain_view_attention` and `cross_attn_fwd_lse_plain` on
bfloat16 inputs are their plain versions). Backward: float32 scores, p, dp and
ds from the float32 LSE and dvec, p and ds rounded to bfloat16 where the
Pallas bodies round them, each gradient rounded to bfloat16 once
(`cross_attn_bwd_plain` on bfloat16 inputs). The LSE and dvec are float32 in
every mode.

In bfloat16 the self and full layers' VJP is that of bfloat16
`multi_head_attention` (the probabilities rounded to bfloat16 before P V),
not of the forward kernel's arithmetic (P kept in float32): the JAX package
pairs the two the same way. In float32 the two are one function.
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
_FWD_DTYPES = (torch.float32, torch.bfloat16)  # the two forward kernels' types
_HEAD_DIMS = (16, 32, 64)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd_lse": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_bwd_dq": (_I, [_P] * 7 + [_I] * 5 + [_F, _P]),
    "cross_attn_bwd_dkv": (_I, [_P] * 8 + [_I] * 5 + [_F, _P]),
    "attn_kernel_info": (_I, [_I, _I, _P]),
}
_BF16_SIGNATURES = {
    "attn_fwd_bf16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd_bf16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_fwd_lse_bf16": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "cross_attn_bwd_dq_bf16": (_I, [_P] * 7 + [_I] * 5 + [_F, _P]),
    "cross_attn_bwd_dkv_bf16": (_I, [_P] * 8 + [_I] * 5 + [_F, _P]),
    "attn_bf16_kernel_info": (_I, [_I, _I, _P]),
}
_KERNELS = {("attn_fwd", "full"): 0, ("attn_fwd", "self"): 1, ("attn_fwd", "cross"): 2,
            ("cross_attn_fwd", "cross"): 3, ("cross_attn_fwd_lse", "cross"): 4,
            ("cross_attn_bwd_dq", "cross"): 5, ("cross_attn_bwd_dkv", "cross"): 6,
            ("attn_fwd_bf16", "full"): 0, ("attn_fwd_bf16", "self"): 1,
            ("attn_fwd_bf16", "cross"): 2, ("cross_attn_fwd_bf16", "cross"): 3,
            ("cross_attn_fwd_lse_bf16", "cross"): 4, ("cross_attn_bwd_dq_bf16", "cross"): 5,
            ("cross_attn_bwd_dkv_bf16", "cross"): 6}

# kernel launches since the last reset, one per wrapper call that launched
launches = {"attn_fwd": 0, "cross_attn_fwd": 0, "cross_attn_fwd_lse": 0,
            "cross_attn_bwd_dq": 0, "cross_attn_bwd_dkv": 0, "attn_fwd_bf16": 0,
            "cross_attn_fwd_bf16": 0, "cross_attn_fwd_lse_bf16": 0,
            "cross_attn_bwd_dq_bf16": 0, "cross_attn_bwd_dkv_bf16": 0}


def _lib():
    return cuda_build.load("attention_cuda", _SIGNATURES)


def _lib_bf16():
    return cuda_build.load("attention_bf16_cuda", _BF16_SIGNATURES)


def _check(*xs, shape=None, dtypes=(torch.float32,)):
    """CUDA, contiguous, 16-byte aligned, one shape and one dtype of `dtypes`."""
    shape = xs[0].shape if shape is None else shape
    for x in xs:
        if not x.is_cuda:
            raise ValueError("the attention kernels take CUDA tensors")
        if x.dtype not in dtypes or x.dtype != xs[0].dtype:
            raise ValueError(f"this attention kernel takes one dtype of {dtypes}, got "
                             f"{[y.dtype for y in xs]}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("the attention kernels take contiguous 16-byte aligned tensors")
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
    """Masked attention kernel on split heads (BH, S, dh), mode full/self/cross;
    float32 or bfloat16 (the tensor-core kernel, counted as `attn_fwd_bf16`)."""
    _check(q, k, v, dtypes=_FWD_DTYPES)
    if mode not in _MODES:
        raise ValueError(f"attn_fwd takes a mode in {tuple(_MODES)}")
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, dh, n_kpts,
            _MODES[mode], scale, _stream(q))
    if q.dtype == torch.bfloat16:
        _launched("attn_fwd_bf16", _lib_bf16().attn_fwd_bf16(*args))
    else:
        _launched("attn_fwd", _lib().attn_fwd(*args))
    return out


def cross_attn_fwd(q, k, v, n_views, n_kpts, scale):
    """Cross-view online-softmax kernel on split heads (BH, S = V*K, dh);
    float32 or bfloat16 (the tensor-core kernel, counted as `cross_attn_fwd_bf16`)."""
    _check(q, k, v, dtypes=_FWD_DTYPES)
    _check_cross(q, n_views, n_kpts)
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, dh, n_views,
            n_kpts, scale, _stream(q))
    if q.dtype == torch.bfloat16:
        _launched("cross_attn_fwd_bf16", _lib_bf16().cross_attn_fwd_bf16(*args))
    else:
        _launched("cross_attn_fwd", _lib().cross_attn_fwd(*args))
    return out


def cross_attn_fwd_lse(q, k, v, n_views, n_kpts, scale):
    """`cross_attn_fwd` that also returns the per-row LSE (BH, S) of its softmax,
    float32 in both modes (bfloat16 q, k, v: `cross_attn_fwd_lse_bf16`)."""
    _check(q, k, v, dtypes=_FWD_DTYPES)
    _check_cross(q, n_views, n_kpts)
    BH, S, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, S,
            dh, n_views, n_kpts, scale, _stream(q))
    if q.dtype == torch.bfloat16:
        _launched("cross_attn_fwd_lse_bf16", _lib_bf16().cross_attn_fwd_lse_bf16(*args))
    else:
        _launched("cross_attn_fwd_lse", _lib().cross_attn_fwd_lse(*args))
    return out, lse


def kernel_info(name, dh, mode="cross"):
    """Occupancy of an attention kernel on the current card, as the CUDA
    runtime reports it: {blocks_per_sm, registers, local_bytes, shared_bytes,
    tile_rows (rows a block owns: query rows, key rows for dk/dv)}; the
    bfloat16 kernels also {threads (a block, the size the occupancy is asked
    at), persistent (a grid of resident blocks walking the work items)}."""
    bf16 = name.endswith("_bf16")
    info = (ctypes.c_int * (7 if bf16 else 5))()
    if bf16:
        rc = _lib_bf16().attn_bf16_kernel_info(dh, _KERNELS[(name, mode)],
                                               ctypes.addressof(info))
    else:
        rc = _lib().attn_kernel_info(dh, _KERNELS[(name, mode)], ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"attn_kernel_info failed for {name} (code {rc})")
    out = dict(zip(("blocks_per_sm", "registers", "local_bytes", "shared_bytes", "tile_rows",
                    "threads"), info))
    if bf16:
        out["persistent"] = bool(info[6])
    return out


# The launch of the Hopper forward kernels (`attn_fwd_bf16`, `cross_attn_fwd_bf16`,
# `cross_attn_fwd_lse_bf16`, ops/csrc/attention_bf16_cuda.cu: HW_THREADS, HW_ROWS,
# BK, HW_STAGES, HSmem): one block of a producer and two consumer warpgroups a
# work item of 128 query rows at a time, persistent, one block an SM (the
# consumers take 232 registers).
HOPPER_FWD = ("attn_fwd_bf16", "cross_attn_fwd_bf16", "cross_attn_fwd_lse_bf16")
HOPPER_THREADS = 384
HOPPER_ROWS = 128  # query rows of a work item, 64 a consumer warpgroup
HOPPER_KEYS = 64  # keys a K/V tile
HOPPER_STAGES = 4  # K/V tiles in flight
SMEM_BYTES = 227 * 1024  # a block's shared memory on an H100
# The Hopper backward kernels (BwdWalk): the same block shape. dk/dv
# (`cross_attn_bwd_dkv_bf16`: HB_STAGES, BSmem): a work item of 128 key rows, 4
# stages of 64 query rows (Q, dO, their LSE and dvec). dq
# (`cross_attn_bwd_dq_bf16`: HQ_STAGES, DqSmem): a work item of 128 query rows,
# 4 stages of 64 keys (K, V).
HOPPER_DKV = "cross_attn_bwd_dkv_bf16"
HOPPER_DKV_STAGES = 4
HOPPER_DQ = "cross_attn_bwd_dq_bf16"
HOPPER_DQ_STAGES = 4


def _cdiv(a, b):
    return -(-a // b)


def hopper_fwd_plan(name, BH, S, dh, n_views=1, n_kpts=None, sms=132):
    """Launch plan of a Hopper forward kernel (`name` in HOPPER_FWD) on
    (BH, S, dh), as its C entry point makes it: {threads, tile_rows, key_rows,
    stages, swizzle_bytes (the TMA and wgmma swizzle: a row's 2 dh bytes),
    shared_bytes, items (work items of 128 query rows), key_tiles (a work
    item's), grid (persistent: min(items, sms)), waves (items a block)}.
    `n_kpts` is the view length (the cross kernel's, and the masked modes')."""
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the attention kernels take head widths {_HEAD_DIMS}")
    if name == "attn_fwd_bf16":
        items, key_tiles = BH * _cdiv(S, HOPPER_ROWS), _cdiv(S, HOPPER_KEYS)
    elif name in ("cross_attn_fwd_bf16", "cross_attn_fwd_lse_bf16"):
        if n_views < 2 or S != n_views * n_kpts:
            raise ValueError("the cross-view kernels take n_views >= 2 and S = n_views * "
                             "n_kpts")
        items = BH * n_views * _cdiv(n_kpts, HOPPER_ROWS)
        key_tiles = (n_views - 1) * _cdiv(n_kpts, HOPPER_KEYS)
    else:
        raise ValueError(f"no Hopper plan for {name}")
    tile = HOPPER_KEYS * 2 * dh  # bytes of a K, a V tile or a 64-row half of Q
    # two Q buffers of two halves, the K and V stages, 12 mbarriers, 1024 B of alignment
    shared = 1024 + (4 + 2 * HOPPER_STAGES) * tile + 8 * (2 * HOPPER_STAGES + 4)
    grid = min(items, sms)
    return {"threads": HOPPER_THREADS, "tile_rows": HOPPER_ROWS, "key_rows": HOPPER_KEYS,
            "stages": HOPPER_STAGES, "swizzle_bytes": 2 * dh, "shared_bytes": shared,
            "items": items, "key_tiles": key_tiles, "grid": grid, "waves": items / grid}


def _bwd_walk(S, dh, n_views, n_kpts):
    """The Hopper backward kernels' walk of one slice (BwdWalk): [(row0, n_live,
    [(x0, n_valid), ...])] in the order the kernels take the work items; the
    item owns rows row0 .. row0 + n_live - 1 of one view (128 rows computed)
    and streams the other views' rows in tiles of 64 from x0, of which the
    first n_valid weigh (the rest are the own view's, the next view's or past
    S, and weigh 0), as the ranges before and after the own view. Also
    (streamed tiles of each view's items, rows computed per row stored: a
    consumer warpgroup whose 64 rows all lie past the view's end computes
    nothing)."""
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the attention kernels take head widths {_HEAD_DIMS}")
    if n_views < 2 or n_kpts < 1 or S != n_views * n_kpts:
        raise ValueError("the cross-view kernels take n_views >= 2 and S = n_views * n_kpts")
    K, T = n_kpts, HOPPER_KEYS

    def tiles(w):  # the ranges before and after the own view
        before = [(x0, min(T, w * K - x0)) for x0 in range(0, w * K, T)]
        after = [(x0, min(T, S - x0)) for x0 in range(w * K + K, S, T)]
        return before + after

    walk = [(w * K + r0, min(HOPPER_ROWS, K - r0), tiles(w))
            for w in range(n_views) for r0 in range(0, K, HOPPER_ROWS)]
    computed = sum(64 * _cdiv(n_live, 64) for _, n_live, _ in walk)
    return walk, [len(tiles(w)) for w in range(n_views)], computed / S


def hopper_dkv_plan(BH, S, dh, n_views, n_kpts, sms=132):
    """Launch plan and walk of the Hopper dk/dv kernel (`cross_attn_bwd_dkv_bf16`)
    on (BH, S, dh), as its C entry point makes them: {threads, tile_rows (key
    rows of a work item), query_rows (a streamed tile's), stages, swizzle_bytes,
    shared_bytes, items, grid (persistent: min(items, sms)), waves (items a
    block), query_tiles (of each view's items, by view), rows_per_stored (key
    rows computed per key row stored), walk}. `walk` (`_bwd_walk`) lists one
    slice's work items: each owns key rows and streams query tiles."""
    walk, query_tiles, rows_per_stored = _bwd_walk(S, dh, n_views, n_kpts)
    items = BH * len(walk)
    tile = HOPPER_KEYS * 2 * dh
    # two K/V buffers of four tiles, the Q and dO stages, a stage's 128 floats,
    # 12 mbarriers, 1024 B of alignment
    shared = (1024 + (8 + 2 * HOPPER_DKV_STAGES) * tile + HOPPER_DKV_STAGES * 2 * HOPPER_KEYS * 4
              + 8 * (2 * HOPPER_DKV_STAGES + 4))
    grid = min(items, sms)
    return {"threads": HOPPER_THREADS, "tile_rows": HOPPER_ROWS, "query_rows": HOPPER_KEYS,
            "stages": HOPPER_DKV_STAGES, "swizzle_bytes": 2 * dh, "shared_bytes": shared,
            "items": items, "grid": grid, "waves": items / grid, "query_tiles": query_tiles,
            "rows_per_stored": rows_per_stored, "walk": walk}


def hopper_dq_plan(BH, S, dh, n_views, n_kpts, sms=132):
    """Launch plan and walk of the Hopper dq kernel (`cross_attn_bwd_dq_bf16`)
    on (BH, S, dh), as its C entry point makes them: {threads, tile_rows (query
    rows of a work item), key_rows (a streamed tile's), stages, swizzle_bytes,
    shared_bytes, items, grid (persistent: min(items, sms)), waves (items a
    block), key_tiles (of each view's items, by view), rows_per_stored (query
    rows computed per query row stored), walk}. `walk` (`_bwd_walk`, dk/dv's
    with the roles swapped) lists one slice's work items: each owns query rows
    and streams the other views' keys."""
    walk, key_tiles, rows_per_stored = _bwd_walk(S, dh, n_views, n_kpts)
    items = BH * len(walk)
    tile = HOPPER_KEYS * 2 * dh
    # two Q/dO buffers of four tiles, the K and V stages, 12 mbarriers, 1024 B
    # of alignment
    shared = 1024 + (8 + 2 * HOPPER_DQ_STAGES) * tile + 8 * (2 * HOPPER_DQ_STAGES + 4)
    grid = min(items, sms)
    return {"threads": HOPPER_THREADS, "tile_rows": HOPPER_ROWS, "key_rows": HOPPER_KEYS,
            "stages": HOPPER_DQ_STAGES, "swizzle_bytes": 2 * dh, "shared_bytes": shared,
            "items": items, "grid": grid, "waves": items / grid, "key_tiles": key_tiles,
            "rows_per_stored": rows_per_stored, "walk": walk}


def hopper_fwd_walk(name, S, n_views=1, n_kpts=None):
    """The work items of one (batch*head) slice in the order the Hopper forward
    kernel walks them: [(row0, n_live, [(key0, n_valid), ...])]. Rows row0 ..
    row0 + 127 are computed and the first n_live stored; a key tile reads 64
    rows from key0, the first n_valid weigh, the rest weigh 0. The cross
    kernel's items lie inside one view and take the other views' keys one view
    at a time; the masked kernel's take all S keys."""
    if name == "attn_fwd_bf16":
        keys = [(k0, min(HOPPER_KEYS, S - k0)) for k0 in range(0, S, HOPPER_KEYS)]
        return [(r0, min(HOPPER_ROWS, S - r0), keys) for r0 in range(0, S, HOPPER_ROWS)]
    hopper_fwd_plan(name, 1, S, 16, n_views, n_kpts)  # checks name and shape
    items = []
    for qv in range(n_views):
        keys = [(w * n_kpts + j, min(HOPPER_KEYS, n_kpts - j))
                for w in range(n_views) if w != qv for j in range(0, n_kpts, HOPPER_KEYS)]
        items += [(qv * n_kpts + r0, min(HOPPER_ROWS, n_kpts - r0), keys)
                  for r0 in range(0, n_kpts, HOPPER_ROWS)]
    return items


def _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts):
    _check(q, k, v, do, dtypes=_FWD_DTYPES)
    for x in (lse, dvec):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("lse and dvec must be contiguous float32 CUDA tensors")
        if x.shape != q.shape[:2]:
            raise ValueError("lse and dvec must have the shape (BH, S)")
    _check_cross(q, n_views, n_kpts)


def cross_attn_bwd_dq(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """dq of the cross-view attention from the stashed LSE and dvec = rowsum(dO * O)
    (float32 both); q, k, v, dO float32 or bfloat16 (`cross_attn_bwd_dq_bf16`)."""
    _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts)
    BH, S, dh = q.shape
    dq = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dq.data_ptr(), BH, S, dh, n_views, n_kpts, scale, _stream(q))
    if q.dtype == torch.bfloat16:
        _launched("cross_attn_bwd_dq_bf16", _lib_bf16().cross_attn_bwd_dq_bf16(*args))
    else:
        _launched("cross_attn_bwd_dq", _lib().cross_attn_bwd_dq(*args))
    return dq


def cross_attn_bwd_dkv(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """(dk, dv) of the cross-view attention from the stashed LSE and dvec; q, k,
    v, dO float32 or bfloat16 (`cross_attn_bwd_dkv_bf16`)."""
    _check_bwd(q, k, v, do, lse, dvec, n_views, n_kpts)
    BH, S, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, S, dh, n_views, n_kpts, scale,
            _stream(q))
    if q.dtype == torch.bfloat16:
        _launched("cross_attn_bwd_dkv_bf16", _lib_bf16().cross_attn_bwd_dkv_bf16(*args))
    else:
        _launched("cross_attn_bwd_dkv", _lib().cross_attn_bwd_dkv(*args))
    return dk, dv


def _mode_mask(n_views, n_kpts, mode, device):
    """The (S, S) mask of `mode` (None for "full")."""
    if mode == "full":
        return None
    fn = cross_view_mask if mode == "cross" else self_view_mask
    return fn(n_views, n_kpts, device=device)


def plain_view_attention(q, k, v, num_heads, n_views, n_kpts, mode):
    """The plain PyTorch version of the forward kernels (masked `multi_head_attention`).

    bfloat16 inputs take the kernels' arithmetic, the Pallas bodies': q, k, v
    upcast to float32, the float32 attention (P V with P in float32), the
    output rounded to bfloat16 once (not `multi_head_attention`'s bfloat16
    semantics, which round the probabilities to bfloat16 before P V)."""
    mask = _mode_mask(n_views, n_kpts, mode, q.device)
    if q.dtype == torch.bfloat16:
        out = multi_head_attention(q.float(), k.float(), v.float(), num_heads, mask=mask)
        return out.to(torch.bfloat16)
    return multi_head_attention(q, k, v, num_heads, mask=mask)


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (the spacing of bfloat16 in x's binade), float32."""
    _, e = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# float32 sums on the tensor cores align each addend to the largest and drop
# the bits below (truncation, not rounding): an output of the bfloat16 kernels
# carries up to ~2^-20 of its absolute scale (sum p |v| / l) where IEEE float32
# sums carry ~2^-24 (measured on an H100 at 1600 keys, |v| ~ 2).
BF16_SUM_TOL = 2.0 ** -18
# The backward kernels round p and ds to bfloat16 before their products, as
# the Pallas bodies do, but form them from dp = dO v^T, s = q k^T and exp in
# another order and with other rounding than the plain version: their float32
# p and ds differ from the plain version's by a few float32 ulps, so where one
# lies near the midpoint of two bfloat16 values the two round it to
# neighbours one bfloat16 ulp apart. Each such flip moves the sum it feeds by
# ulp(ds_ij) |k_j| (dq), ulp(ds_ij) |q_i| (dk) or ulp(p_ij) |dO_i| (dv). A
# kernel is held to one bfloat16 ulp of the plain version's output + 1e-6 +
# BF16_SUM_TOL of the sum's absolute scale + the flips of every term at once:
#   dq_i: scale sum_j ulp(ds_ij) |k_j|,  dk_j: scale sum_i ulp(ds_ij) |q_i|,
#   dv_j: sum_i ulp(p_ij) |dO_i|
# (`cross_attn_bwd_bf16_slack`). Every term at once is the bound, not the
# expectation: a flip needs the two float32 values on either side of a
# midpoint, which a few ulps of difference make rare.


def bf16_ulp_error(out, ref, abs_scale=None, flips=None):
    """max |out - ref| / (one bfloat16 ulp of ref + 1e-6 [+ BF16_SUM_TOL *
    abs_scale] [+ flips]): the one-ulp gate holds at <= 1. The 1e-6 covers
    outputs that cancel to near 0, where the float32 sums' rounding exceeds
    their ulp; `abs_scale` (the attention of |v|, sum p |v| / l per output; in
    the backward, the sum of the absolute products) widens it to the kernels'
    tensor-core sums; `flips` (the backward: the sum of one bfloat16 ulp of
    every rounded p or ds times its partner) to the roundings that may land
    on a neighbour (`cross_attn_bwd_bf16_slack`)."""
    d = (out.float() - ref.float()).abs()
    slack = bf16_ulp(ref) + 1e-6
    if abs_scale is not None:
        slack = slack + BF16_SUM_TOL * abs_scale.float()
    if flips is not None:
        slack = slack + flips.float()
    return float((d / slack).max())


def cross_attn_fwd_lse_plain(q, k, v, n_views, n_kpts, scale):
    """Plain version of `cross_attn_fwd_lse` on split heads: one-shot softmax
    under the cross mask (-1e9 fill, +1e-9 denominator) -> (o, lse (BH, S)).
    bfloat16 q, k, v are upcast, o is rounded to bfloat16 once, the LSE stays
    float32."""
    if q.dtype == torch.bfloat16:
        o, lse = cross_attn_fwd_lse_plain(q.float(), k.float(), v.float(), n_views, n_kpts,
                                          scale)
        return o.to(torch.bfloat16), lse
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    s = s.masked_fill(~cross_view_mask(n_views, n_kpts, device=q.device), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True) + 1e-9
    return (p @ v) / l, (m + torch.log(l))[..., 0]


def _cross_p_ds(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """float32 p (zero under the mask) and ds = p (dO v^T - dvec) of the cross
    backward."""
    q, k, v, do = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    p = p.masked_fill(~cross_view_mask(n_views, n_kpts, device=q.device), 0.0)
    return p, p * (do @ v.transpose(1, 2) - dvec[..., None])


def cross_attn_bwd_plain(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """Plain version of `cross_attn_bwd_dq` and `cross_attn_bwd_dkv`: p rebuilt
    from the LSE under the cross mask -> (dq, dk, dv). bfloat16 q, k, v, dO
    take the Pallas bodies' roundings: float32 s, p, dp and ds, then dq =
    bf16(scale bf16(ds) k), dk = bf16(scale bf16(ds)^T q), dv = bf16(bf16(p)^T
    dO)."""
    p, ds = _cross_p_ds(q, k, v, do, lse, dvec, n_views, n_kpts, scale)
    if q.dtype != torch.bfloat16:
        return (ds @ k) * scale, (ds.transpose(1, 2) @ q) * scale, p.transpose(1, 2) @ do
    bf = torch.bfloat16
    q, k, do = q.float(), k.float(), do.float()
    ds, p = ds.to(bf).float(), p.to(bf).float()
    return (((ds @ k) * scale).to(bf), ((ds.transpose(1, 2) @ q) * scale).to(bf),
            (p.transpose(1, 2) @ do).to(bf))


def cross_attn_bwd_bf16_slack(q, k, v, do, lse, dvec, n_views, n_kpts, scale):
    """The widening terms of the bfloat16 backward's one-ulp gate (see
    BF16_SUM_TOL): ((abs_scale, flips) of dq, of dk, of dv), float32, each
    the shape of its gradient; `bf16_ulp_error(kernel, plain, *terms)`."""
    p, ds = _cross_p_ds(q, k, v, do, lse, dvec, n_views, n_kpts, scale)
    aq, ak, ado = q.float().abs(), k.float().abs(), do.float().abs()
    ads, uds, up = ds.abs(), bf16_ulp(ds), bf16_ulp(p) * (p > 0)
    uds = uds * (ds != 0)
    return ((scale * (ads @ ak), scale * (uds @ ak)),
            (scale * (ads.transpose(1, 2) @ aq), scale * (uds.transpose(1, 2) @ aq)),
            (p.transpose(1, 2) @ ado, up.transpose(1, 2) @ ado))


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
    tensors and on their plain versions for CPU tensors, float32 or bfloat16.
    Other layers: forward on the kernel (CPU: the plain version), backward =
    VJP of the masked `multi_head_attention` recomputed from the saved q, k, v
    (the probabilities are never kept)."""

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
        if not ctx.flash:  # JAX: the VJP of `_ref_attention`
            with torch.enable_grad():
                q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
                out = multi_head_attention(q, k, v, num_heads,
                                           mask=_mode_mask(n_views, n_kpts, mode, q.device))
                dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
            return dq, dk, dv, None, None, None, None
        qs, ks, vs, o_s, lse = ctx.saved_tensors
        B, S, D = g.shape
        dh = D // num_heads
        split, merge = _split_merge(B, S, num_heads, dh)
        do_s = split(g)
        dvec = (do_s.float() * o_s.float()).sum(dim=-1)  # float32 in every mode
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
