"""Dustbin Sinkhorn on the CUDA kernels: the counterpart of `ops/sinkhorn_pallas.py`.

`log_optimal_transport_cuda` augments the scores (`augment_couplings`) and
solves the transport with the kernels of `ops/csrc/sinkhorn_cuda.cu`:

- without grad, `algorithm="scaling"` (the default): `sinkhorn_scaling`, the
  stabilized scaling domain (replacing `_sinkhorn_scaling_kernel`); the
  iteration count rounds UP to a multiple of 10 (`_eff_iters`);
- without grad, `algorithm="log"`: `sinkhorn_log`, the exact log-domain
  iteration at the exact count (replacing `_sinkhorn_kernel`);
- under grad (grad mode on and `scores` or `alpha` requires grad): one
  `torch.autograd.Function` whose forward is `sinkhorn_log_stash` (replacing
  `_sinkhorn_log_stash_kernel`) at the effective count, keeping every
  iteration's duals, and whose backward is `sinkhorn_bwd` (replacing
  `_sinkhorn_bwd_kernel`), the reverse sweep over them. So the value under
  grad is the log domain's, as in the JAX package.

A CPU tensor takes the plain versions: `log_sinkhorn_mxu` / `log_sinkhorn`
without grad, autograd through `log_sinkhorn` at the effective count under
grad. A CUDA tensor launches a kernel or raises.

All three kernels run on thread-block clusters, one cluster per pair matrix
at a time, one launch per call (see the source's header): the cluster's
blocks split the rows into bands, warps own rows, and the column reductions
meet over distributed shared memory in a fixed order, so two runs give the
same bits. `cluster_plan` chooses their launch here, where the CPU tests
reach it: the cluster size, whether the band stays in shared memory
(resident) or streams from device memory, the number of persistent clusters,
the columns a lane holds (the kernel instantiation) and the shared bytes.
`sinkhorn_log` and `sinkhorn_bwd` take N <= 1056 (33 columns a lane), which
every training shape is; `sinkhorn_scaling` takes N <= 2080 (65 columns a
lane, streamed), the (2049, 2049) pair matrices of the MegaDepth and YFCC
evaluations at K = 2048. A wider matrix raises `ValueError`.
"""

import ctypes
import functools

import torch

from e2e_multi_view_matching_tpu_torch.ops import cuda_build
from e2e_multi_view_matching_tpu_torch.ops.sinkhorn import (
    augment_couplings,
    log_sinkhorn,
    log_sinkhorn_mxu,
)

ABSORB_EVERY = 10
ALGORITHMS = ("scaling", "log")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sinkhorn_scaling": (_I, [_P] * 5 + [_I] * 5 + [_F] + [_I] * 5 + [_P]),
    "sinkhorn_log": (_I, [_P] * 6 + [_I] * 5 + [_F] + [_I] * 5 + [_P]),
    "sinkhorn_bwd": (_I, [_P] * 7 + [_I] * 9 + [_P]),
    "sinkhorn_cluster_info": (_I, [_I] * 5 + [_P]),
}

# The cluster kernels' launch plan; the numbers mirror the source's constants
# (CT, CS_MAX, KC_STREAMED, the instantiations) and layouts.
CLUSTER_THREADS = 512  # a block
CLUSTER_WARPS = CLUSTER_THREADS // 32
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks (SMs) a cluster, up to the portable maximum
COLUMN_SLOTS = (4, 8, 13, 16, 33)  # columns a lane: N <= 32 x 33
WIDE_SLOTS = 65  # sinkhorn_scaling only, streamed: N <= 32 x 65 = 2080
SMEM_BYTES = 227 * 1024  # a block's shared memory on an H100
L2_BUDGET_BYTES = 40e6  # streamed matrices in flight, inside the 50 MB L2
# the cluster kernels, by their code in `sinkhorn_cluster_info`
CLUSTER_KINDS = ("scaling", "bwd", "log")

# kernel launches since the last reset, one per solve or sweep (one cluster
# launch each)
launches = {"sinkhorn_scaling": 0, "sinkhorn_log": 0, "sinkhorn_log_stash": 0,
            "sinkhorn_bwd": 0}


def _eff_iters(n_iters, algorithm="scaling"):
    # the scaling domain rounds the count UP to a multiple of absorb_every;
    # forward-under-grad and backward differentiate the same effective count
    if algorithm == "scaling":
        return -(-n_iters // ABSORB_EVERY) * ABSORB_EVERY
    return n_iters


def _check(couplings, log_mu, log_nu, *more):
    for x in (couplings, log_mu, log_nu) + more:
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("the Sinkhorn kernels take contiguous float32 CUDA tensors")
    B, M, N = couplings.shape
    if log_mu.shape != (B, M) or log_nu.shape != (B, N):
        raise ValueError("marginals must be (B, M) and (B, N)")
    return B, M, N


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed (code {rc}; -1: no kernel for the plan, -2: no "
                           "iterations, -3: the cluster cannot be scheduled, -4: more "
                           "clusters than fit at once, -5: plan and kernel layout "
                           "differ; positive: a CUDA error)")


def _smem_floats(kind, resident, band, N, kc):
    """Shared floats of one block (the source's scaling_layout, bwd_layout,
    log_layout; kc: columns a lane): the band (K; C and G; C) when resident,
    the warps' column vectors, the gathered partials, the partials and column
    vectors, and row vectors."""
    NP = _round4(N)
    fixed = CLUSTER_WARPS + CLUSTER_SIZES[-1]
    if kind == "scaling":  # the band as a span; 2 x (max, sum), column (max, sum),
        # b v log_nu; u a log_mu; the wide kernel gathers into the warps' sums
        fixed -= CLUSTER_SIZES[-1] if kc == WIDE_SLOTS else 0
        return (_round4(band * N + 3) if resident else 0) + (fixed + 9) * NP + 3 * _round4(band)
    if kind == "log":  # the band in rows of 32 kc; the warps' (max, sum) vectors;
        # 2 x (max, sum), v (32 kc), log_nu; u log_mu
        return ((band * 32 * kc if resident else 0) + (2 * CLUSTER_WARPS + 5) * NP + 32 * kc
                + 2 * _round4(band))
    # 2 parities, gv (v_t - log_nu) v_{t-1} log_nu; u_t (u_t - log_mu) gu_T log_mu
    return (2 * band * NP if resident else 0) + (fixed + 6) * NP + 4 * _round4(band)


def _round4(x):
    return -(-x // 4) * 4


def max_columns(kind):
    """The widest N the cluster kernel `kind` takes."""
    return 32 * (WIDE_SLOTS if kind == "scaling" else COLUMN_SLOTS[-1])


def cluster_plan(kind, B, M, N, capacity=None):
    """Launch plan of the cluster kernel `kind` ("scaling", "bwd" or "log")
    for B pair matrices of M x N.

    The cluster splits the rows into `cluster_size` bands. Resident where the
    band (K for scaling; C and G for the sweep; C for the log domain) fits the
    block's shared memory: with the smallest such cluster, so that the most
    pairs are in flight. Else streamed from device memory, with up to 8 blocks a cluster
    (two rows a warp at least). Streamed, the log domain and the sweep keep
    few enough persistent clusters that the matrices in flight stay inside
    the L2 budget; the scaling domain (the wide kernel, N > 1056, always
    streams) takes a cluster a pair, as many as fit, as resident plans do:
    all 15 that fit solved 80 x 1025 x 1025 in 15.03 ms against 15.71 at
    the budget's 9, and 8 and 80 x 2049 x 2049 in 7.66 and 58.7 ms against
    26.0 and 259.6 at its 2, with the same bits (NVIDIA H100 80GB HBM3 at
    700 W, `tools/torch_sinkhorn_times.py --kernel scaling
    --cluster_counts`). `capacity` is the number of such clusters the card
    holds at once (`sinkhorn_cluster_info`); None on the CPU, where there is
    no card to ask.

    Returns a dict: kind, cluster_size, band, resident, n_clusters,
    column_slots (the columns a lane holds), smem_bytes, workspace
    ({name: shape}).
    """
    if kind not in CLUSTER_KINDS:
        raise ValueError(f"unknown cluster kernel {kind!r}")
    if N > max_columns(kind):
        raise ValueError(f"sinkhorn_{kind} takes N <= {max_columns(kind)}, got {N}")
    # columns a lane: resident the smallest instantiation, streamed the largest
    # (N > 1056: the wide one)
    kc = next((k for k in COLUMN_SLOTS if 32 * k >= N), WIDE_SLOTS)

    def fits(cs):
        return 4 * _smem_floats(kind, True, -(-M // cs), N, kc) <= SMEM_BYTES

    cs = None if kc == WIDE_SLOTS else next((c for c in CLUSTER_SIZES if fits(c)), None)
    resident = cs is not None
    if not resident:  # two rows a warp at least
        cs = max(1, min(CLUSTER_SIZES[-1], M // (2 * CLUSTER_WARPS)))
        kc = max(kc, COLUMN_SLOTS[-1])
    band = -(-M // cs)
    smem = 4 * _smem_floats(kind, resident, band, N, kc)
    if smem > SMEM_BYTES:
        raise ValueError(f"sinkhorn_{kind}: N = {N} too wide for a block's shared memory")
    if resident or kind == "scaling":
        n = B
    else:  # C and G for the sweep; C for the log domain
        in_flight = (2 if kind == "bwd" else 1) * 4 * M * N
        n = max(1, min(B, int(L2_BUDGET_BYTES // in_flight)))
    if capacity is not None:
        n = min(n, capacity)
    return {"kind": kind, "cluster_size": cs, "band": band, "resident": resident,
            "n_clusters": n, "column_slots": kc, "smem_bytes": smem,
            "workspace": {"K": (B, M, N)} if kind == "scaling" and not resident else {}}


@functools.lru_cache(maxsize=None)
def kernel_plan(kind, B, M, N, device_index=0):
    """`cluster_plan` with the card's capacity, and what the CUDA runtime
    says of the chosen instantiation: `clusters_that_fit`, `registers`,
    `local_bytes` (spills)."""
    lib = cuda_build.load("sinkhorn_cuda", _SIGNATURES)
    plan = cluster_plan(kind, B, M, N)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        rc = lib.sinkhorn_cluster_info(CLUSTER_KINDS.index(kind), int(plan["resident"]),
                                       plan["column_slots"], plan["cluster_size"],
                                       plan["smem_bytes"], info)
    _raise_on(rc, f"sinkhorn_{kind} plan")
    return {**cluster_plan(kind, B, M, N, capacity=info[0]), "clusters_that_fit": info[0],
            "registers": info[1], "local_bytes": info[2]}


def _plan_args(plan):
    return (plan["cluster_size"], int(plan["resident"]), plan["n_clusters"],
            plan["column_slots"], plan["smem_bytes"])


def sinkhorn_scaling(couplings, log_mu, log_nu, n_iters, norm):
    """Kernel solve: (couplings + u + v) - norm for (B, M, N) f32 CUDA inputs.

    `n_iters` must be a multiple of 10 (see `_eff_iters`)."""
    B, M, N = _check(couplings, log_mu, log_nu)
    if n_iters <= 0 or n_iters % ABSORB_EVERY:
        raise ValueError(f"n_iters must be a positive multiple of {ABSORB_EVERY}")
    lib = cuda_build.load("sinkhorn_cuda", _SIGNATURES)
    plan = kernel_plan("scaling", B, M, N, couplings.device.index or 0)
    out = torch.empty_like(couplings)
    K = couplings.new_empty(plan["workspace"].get("K", (0,)))
    ptrs = [t.data_ptr() for t in (couplings, log_mu, log_nu, out, K)]
    rc = lib.sinkhorn_scaling(*ptrs, B, M, N, n_iters, ABSORB_EVERY, float(norm),
                              *_plan_args(plan),
                              torch.cuda.current_stream(couplings.device).cuda_stream)
    _raise_on(rc, "sinkhorn_scaling")
    launches["sinkhorn_scaling"] += 1
    return out


def _sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm, stash):
    B, M, N = _check(couplings, log_mu, log_nu)
    if n_iters <= 0:
        raise ValueError("n_iters must be positive")
    lib = cuda_build.load("sinkhorn_cuda", _SIGNATURES)
    plan = kernel_plan("log", B, M, N, couplings.device.index or 0)
    out = torch.empty_like(couplings)
    U = couplings.new_empty((B, n_iters, M) if stash else (B, M))
    V = couplings.new_empty((B, n_iters, N) if stash else (B, N))
    ptrs = [t.data_ptr() for t in (couplings, log_mu, log_nu, out, U, V)]
    rc = lib.sinkhorn_log(*ptrs, B, M, N, n_iters, int(stash), float(norm), *_plan_args(plan),
                          torch.cuda.current_stream(couplings.device).cuda_stream)
    name = "sinkhorn_log_stash" if stash else "sinkhorn_log"
    _raise_on(rc, name)
    launches[name] += 1
    return out, U, V


def sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm):
    """Kernel solve in the exact log domain: (couplings + u + v) - norm after
    `n_iters` iterations, for (B, M, N) f32 CUDA inputs."""
    return _sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm, False)[0]


def sinkhorn_log_stash(couplings, log_mu, log_nu, n_iters, norm):
    """`sinkhorn_log` that also returns every iteration's duals.

    Returns:
        (Z - norm (B, M, N), U (B, n_iters, M), V (B, n_iters, N)).
    """
    return _sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm, True)


def sinkhorn_bwd(couplings, U, V, g, log_mu, log_nu):
    """Kernel reverse sweep: the cotangent of `couplings` for the cotangent `g`
    of the log-domain solve whose duals are stashed in U (B, T, M), V (B, T, N)."""
    B, M, N = _check(couplings, log_mu, log_nu, U, V, g)
    T = U.shape[1]
    if U.shape != (B, T, M) or V.shape != (B, T, N) or g.shape != (B, M, N) or T < 1:
        raise ValueError("sinkhorn_bwd takes U (B, T, M), V (B, T, N), g (B, M, N), T >= 1")
    lib = cuda_build.load("sinkhorn_cuda", _SIGNATURES)
    plan = kernel_plan("bwd", B, M, N, couplings.device.index or 0)
    G = torch.empty_like(couplings)
    ptrs = [t.data_ptr() for t in (couplings, U, V, g, log_mu, log_nu, G)]
    rc = lib.sinkhorn_bwd(*ptrs, B, M, N, T, *_plan_args(plan),
                          torch.cuda.current_stream(couplings.device).cuda_stream)
    _raise_on(rc, "sinkhorn_bwd")
    launches["sinkhorn_bwd"] += 1
    return G


def dustbin_grads(dcoup, M, N):
    """Split the cotangent of the augmented couplings (B, M+1, N+1) into the
    scores' (B, M, N) and the dustbin score's: the sum over the dustbin
    column, the dustbin row and the corner."""
    dalpha = dcoup[:, :M, N].sum() + dcoup[:, M, :N].sum() + dcoup[:, M, N].sum()
    return dcoup[:, :M, :N], dalpha


class _SinkhornKernels(torch.autograd.Function):
    """Forward `sinkhorn_log_stash`, backward `sinkhorn_bwd` (CUDA tensors)."""

    @staticmethod
    def forward(ctx, scores, alpha, n_iters):
        couplings, log_mu, log_nu, norm = augment_couplings(scores, alpha)
        Z, U, V = sinkhorn_log_stash(couplings, log_mu, log_nu, n_iters, norm)
        ctx.save_for_backward(couplings, U, V, log_mu, log_nu)
        ctx.alpha_meta = ((alpha.shape, alpha.dtype) if isinstance(alpha, torch.Tensor)
                          else None)
        return Z

    @staticmethod
    def backward(ctx, g):
        couplings, U, V, log_mu, log_nu = ctx.saved_tensors
        dcoup = sinkhorn_bwd(couplings, U, V, g.contiguous(), log_mu, log_nu)
        M, N = couplings.shape[1] - 1, couplings.shape[2] - 1
        dscores, dalpha = dustbin_grads(dcoup, M, N)
        if ctx.alpha_meta is None:
            return dscores, None, None
        shape, dtype = ctx.alpha_meta
        return dscores, dalpha.to(dtype).reshape(shape), None


def log_optimal_transport_cuda(scores, alpha, n_iters, algorithm="scaling"):
    """Drop-in for `ops.sinkhorn.log_optimal_transport` on the CUDA kernels.

    Args:
        scores: (B, M, N) f32; alpha: scalar dustbin score (float or 0-dim
        tensor); n_iters: int; algorithm: "scaling" or "log" (see the module
        docstring).
    Returns:
        (B, M+1, N+1) log assignment.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}")
    eff = _eff_iters(n_iters, algorithm)
    alpha_grad = isinstance(alpha, torch.Tensor) and alpha.requires_grad
    under_grad = torch.is_grad_enabled() and (scores.requires_grad or alpha_grad)
    if under_grad and scores.is_cuda:
        return _SinkhornKernels.apply(scores, alpha, eff)
    couplings, log_mu, log_nu, norm = augment_couplings(scores, alpha)
    if under_grad:
        return log_sinkhorn(couplings, log_mu, log_nu, eff) - norm
    if not scores.is_cuda:
        if algorithm == "log":
            return log_sinkhorn(couplings, log_mu, log_nu, n_iters) - norm
        return log_sinkhorn_mxu(couplings, log_mu, log_nu, n_iters, ABSORB_EVERY) - norm
    if algorithm == "log":
        return sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm)
    return sinkhorn_scaling(couplings, log_mu, log_nu, eff, norm)
