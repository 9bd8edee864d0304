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
"""

import ctypes

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
    "sinkhorn_scaling": (_I, [_P] * 11 + [_I] * 5 + [_F, _P]),
    "sinkhorn_log": (_I, [_P] * 8 + [_I] * 5 + [_F, _P]),
    "sinkhorn_bwd": (_I, [_P] * 10 + [_I] * 4 + [_P]),
    "sinkhorn_rows_per_block": (_I, []),
}

# kernel launches since the last reset, one per solve or sweep (each a
# sequence of CUDA launches inside one C function of the source)
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


def _lib_and_partials(couplings):
    lib = cuda_build.load("sinkhorn_cuda", _SIGNATURES)
    B, M, N = couplings.shape
    nrb = -(-M // lib.sinkhorn_rows_per_block())
    return lib, couplings.new_empty((B, nrb, N))


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed (code {rc}; -1: N too wide for the "
                           "shared-memory tile, -2: no iterations)")


def sinkhorn_scaling(couplings, log_mu, log_nu, n_iters, norm):
    """Kernel solve: (couplings + u + v) - norm for (B, M, N) f32 CUDA inputs.

    `n_iters` must be a multiple of 10 (see `_eff_iters`)."""
    B, M, N = _check(couplings, log_mu, log_nu)
    if n_iters <= 0 or n_iters % ABSORB_EVERY:
        raise ValueError(f"n_iters must be a positive multiple of {ABSORB_EVERY}")
    lib, part0 = _lib_and_partials(couplings)
    out = torch.empty_like(couplings)
    K = torch.empty_like(couplings)
    u = torch.empty_like(log_mu)
    a = torch.empty_like(log_mu)
    v = torch.empty_like(log_nu)
    b = torch.empty_like(log_nu)
    part1 = torch.empty_like(part0)
    ptrs = [t.data_ptr() for t in (couplings, log_mu, log_nu, out, K, u, v, a, b,
                                   part0, part1)]
    rc = lib.sinkhorn_scaling(*ptrs, B, M, N, n_iters, ABSORB_EVERY, float(norm),
                              torch.cuda.current_stream(couplings.device).cuda_stream)
    _raise_on(rc, "sinkhorn_scaling")
    launches["sinkhorn_scaling"] += 1
    return out


def _sinkhorn_log(couplings, log_mu, log_nu, n_iters, norm, stash):
    B, M, N = _check(couplings, log_mu, log_nu)
    if n_iters <= 0:
        raise ValueError("n_iters must be positive")
    lib, part0 = _lib_and_partials(couplings)
    part1 = torch.empty_like(part0)
    out = torch.empty_like(couplings)
    U = couplings.new_empty((B, n_iters, M) if stash else (B, M))
    V = couplings.new_empty((B, n_iters, N) if stash else (B, N))
    ptrs = [t.data_ptr() for t in (couplings, log_mu, log_nu, out, U, V, part0, part1)]
    rc = lib.sinkhorn_log(*ptrs, B, M, N, n_iters, int(stash), float(norm),
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
    lib, cpart = _lib_and_partials(couplings)
    G = torch.empty_like(couplings)
    gu0 = torch.empty_like(log_mu)
    gv = torch.empty_like(log_nu)
    ptrs = [t.data_ptr() for t in (couplings, U, V, g, log_mu, log_nu, G, gu0, gv, cpart)]
    rc = lib.sinkhorn_bwd(*ptrs, B, M, N, T,
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
