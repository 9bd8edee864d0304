"""Log-domain Sinkhorn optimal transport with dustbin augmentation (plain PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/ops/sinkhorn.py`.
`log_sinkhorn` is the exact log-domain iteration, differentiable by autograd:
it is the gradient reference of every Sinkhorn path. `log_sinkhorn_mxu` is the
stabilized scaling-domain iteration (forward only; the algorithm and the plain
version of the `sinkhorn_scaling` kernel in `ops/sinkhorn_cuda.py`). Its
iteration count rounds UP to a multiple of `absorb_every`.

`log_sinkhorn_stash` and `log_sinkhorn_bwd` repeat, step by step, the
arithmetic of the training kernels `sinkhorn_log_stash` and `sinkhorn_bwd`:
the forward that keeps every iteration's duals, and the manual reverse sweep
over them. They are those kernels' plain versions.
"""

import math

import torch


def log_sinkhorn(couplings, log_mu, log_nu, n_iters):
    """Alternating log-domain Sinkhorn normalization.

    Args:
        couplings: (B, M, N); log_mu: (B, M); log_nu: (B, N); n_iters: int.
    Returns:
        (B, M, N) log transport plan couplings + u (+) v.
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(n_iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :]


def log_sinkhorn_stash(couplings, log_mu, log_nu, n_iters):
    """`log_sinkhorn` with max-subtracted log-sum-exps written out, keeping
    every iteration's duals.

    Returns:
        (Z (B, M, N), U (B, n_iters, M), V (B, n_iters, N)): u_t and v_t after
        iteration t; Z = couplings + u_T (+) v_T.
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    U, V = [], []
    for _ in range(n_iters):
        a = couplings + v[:, None, :]
        m1 = a.amax(dim=2)
        u = log_mu - (torch.log(torch.exp(a - m1[:, :, None]).sum(dim=2)) + m1)
        b = couplings + u[:, :, None]
        m0 = b.amax(dim=1)
        v = log_nu - (torch.log(torch.exp(b - m0[:, None, :]).sum(dim=1)) + m0)
        U.append(u)
        V.append(v)
    Z = couplings + u[:, :, None] + v[:, None, :]
    return Z, torch.stack(U, dim=1), torch.stack(V, dim=1)


def log_sinkhorn_bwd(couplings, U, V, g, log_mu, log_nu):
    """Manual reverse sweep: the cotangent of `couplings` for the cotangent `g`
    of Z = `log_sinkhorn_stash(...)[0]`, from the stashed duals.

    Each reverse step rebuilds the column softmax Q_t and the row softmax P_t
    of iteration t (entries <= 1: the grouping of the exponents keeps them
    from overflowing), accumulates the cotangent and chains the duals':

        gu_t = [t == T] rowsum(g) - rowsum(Q_t * gv_t)
        dC  -= Q_t * gv_t + P_t * gu_t
        gv_{t-1} = -colsum(P_t * gu_t)

    Args:
        couplings, g: (B, M, N); U: (B, T, M); V: (B, T, N); log_mu (B, M);
        log_nu (B, N).
    Returns:
        (B, M, N) cotangent of the couplings.
    """
    T = U.shape[1]
    G = g
    gu0 = g.sum(dim=2)
    gv = g.sum(dim=1)
    for s in range(T):
        t = T - 1 - s
        u_t, v_t = U[:, t], V[:, t]
        v_prev = V[:, t - 1] if t > 0 else torch.zeros_like(v_t)
        Q = torch.exp((couplings + u_t[:, :, None]) + (v_t - log_nu)[:, None, :])
        tmp = Q * gv[:, None, :]
        gu = -tmp.sum(dim=2)
        if s == 0:
            gu = gu0 + gu
        P = torch.exp((couplings + v_prev[:, None, :]) + (u_t - log_mu)[:, :, None])
        tmp2 = P * gu[:, :, None]
        G = G - (tmp + tmp2)
        gv = -tmp2.sum(dim=1)
    return G


def log_sinkhorn_mxu(couplings, log_mu, log_nu, n_iters, absorb_every=10):
    """Stabilized scaling-domain Sinkhorn, same u-then-v order as `log_sinkhorn`.

    Each block runs one exact log-domain iteration, materializes
    K = exp(couplings + u + v), then `absorb_every - 1` scaling iterations
    a = mu / (K b + 1e-30), b = nu / (K^T a + 1e-30), and absorbs the scalings
    into the log potentials.
    """
    # 1e-30, not a subnormal: a fully underflowed row/column sum must not
    # divide by exactly 0 where subnormals flush to zero
    tiny = 1e-30
    mu = torch.exp(log_mu)
    nu = torch.exp(log_nu)
    n_absorb = -(-n_iters // absorb_every)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(n_absorb):
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


def augment_couplings(scores, alpha):
    """Dustbin row/column augmentation + SuperGlue marginals.

    Returns (couplings (B, M+1, N+1), log_mu (B, M+1), log_nu (B, N+1), norm).
    """
    B, M, N = scores.shape
    couplings = scores.new_empty((B, M + 1, N + 1))
    couplings[:, :M, :N] = scores
    couplings[:, :M, N] = alpha
    couplings[:, M, :] = alpha
    norm = -math.log(M + N)
    log_mu = torch.full((B, M + 1), norm, dtype=scores.dtype, device=scores.device)
    log_nu = torch.full((B, N + 1), norm, dtype=scores.dtype, device=scores.device)
    log_mu[:, M] = math.log(N) + norm
    log_nu[:, N] = math.log(M) + norm
    return couplings, log_mu, log_nu, norm


def log_optimal_transport(scores, alpha, n_iters, impl="xla"):
    """Dustbin-augmented entropic optimal transport in log space.

    Args:
        scores: (B, M, N); alpha: scalar dustbin score; n_iters: int.
        impl: "xla" (log-domain iteration) or "mxu" (scaling domain).
    Returns:
        (B, M+1, N+1) log assignment (probabilities scaled by M+N).
    """
    couplings, log_mu, log_nu, norm = augment_couplings(scores, alpha)
    if impl == "mxu":
        Z = log_sinkhorn_mxu(couplings, log_mu, log_nu, n_iters, 10)
    elif impl == "xla":
        Z = log_sinkhorn(couplings, log_mu, log_nu, n_iters)
    else:
        raise ValueError(f"unknown sinkhorn impl {impl!r}")
    return Z - norm


def extract_matches(log_p, match_threshold=0.2):
    """Mutual-max match extraction from a dustbin-augmented log assignment.

    Returns (matches0 (B, M) int32 or -1, matches1 (B, N) int32 or -1,
    mscores0 (B, M)).
    """
    core = log_p[:, :-1, :-1]
    M, N = core.shape[1], core.shape[2]
    # argmax returns the first maximum, like jnp.argmax
    idx0, max0 = core.argmax(dim=2), core.amax(dim=2)
    idx1, max1 = core.argmax(dim=1), core.amax(dim=1)
    ar_m = torch.arange(M, device=core.device)
    ar_n = torch.arange(N, device=core.device)
    mutual0 = torch.gather(idx1, 1, idx0) == ar_m[None]
    mutual1 = torch.gather(idx0, 1, idx1) == ar_n[None]
    scores0 = torch.exp(max0)
    scores1 = torch.exp(max1)
    valid0 = mutual0 & (scores0 > match_threshold)
    valid1 = mutual1 & (scores1 > match_threshold)
    matches0 = torch.where(valid0, idx0, -1).to(torch.int32)
    matches1 = torch.where(valid1, idx1, -1).to(torch.int32)
    return matches0, matches1, torch.where(valid0, scores0, 0.0)
