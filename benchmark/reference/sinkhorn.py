"""Dustbin-augmented Sinkhorn in plain PyTorch: the benchmark's reference.

Frozen copies of the port's `ops/sinkhorn.py` iterations: `log_sinkhorn`,
the exact log-domain iteration (differentiable by autograd; what training's
`sinkhorn_log` and `sinkhorn_bwd` kernels compute), and `log_sinkhorn_scaling`,
the stabilised scaling-domain iteration that eval's `sinkhorn_scaling` kernel
computes (one exact log-domain step, then `absorb_every - 1` scaling steps
whose scalings are absorbed into the log potentials).
"""

import math

import torch


def log_sinkhorn(couplings, log_mu, log_nu, n_iters):
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(n_iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :]


def log_sinkhorn_scaling(couplings, log_mu, log_nu, n_iters, absorb_every=10):
    tiny = 1e-30
    mu = torch.exp(log_mu)
    nu = torch.exp(log_nu)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(-(-n_iters // absorb_every)):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
        K = torch.exp(couplings + u[:, :, None] + v[:, None, :])
        a = torch.ones_like(mu)
        b = torch.ones_like(nu)
        for _ in range(absorb_every - 1):
            a = mu / (torch.bmm(K, b[:, :, None])[..., 0] + tiny)
            b = nu / (torch.bmm(a[:, None, :], K)[:, 0] + tiny)
        u = u + torch.log(a + tiny)
        v = v + torch.log(b + tiny)
    return couplings + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores, alpha, n_iters, domain="log"):
    """(B, M, N) scores and the dustbin score `alpha` -> (B, M+1, N+1) log
    assignment (probabilities scaled by M + N); `domain` "log" or
    "scaling"."""
    B, M, N = scores.shape
    couplings = torch.cat([torch.cat([scores, alpha.expand(B, M, 1)], dim=2),
                           alpha.expand(B, 1, N + 1)], dim=1)
    norm = -math.log(M + N)
    log_mu = torch.cat([torch.full((B, M), norm, dtype=scores.dtype, device=scores.device),
                        torch.full((B, 1), math.log(N) + norm, dtype=scores.dtype,
                                   device=scores.device)], dim=1)
    log_nu = torch.cat([torch.full((B, N), norm, dtype=scores.dtype, device=scores.device),
                        torch.full((B, 1), math.log(M) + norm, dtype=scores.dtype,
                                   device=scores.device)], dim=1)
    solve = log_sinkhorn if domain == "log" else log_sinkhorn_scaling
    return solve(couplings, log_mu, log_nu, n_iters) - norm
