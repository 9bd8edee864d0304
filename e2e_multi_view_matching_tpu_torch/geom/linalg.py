"""Symmetric eigendecomposition, null vectors and small closed-form solvers (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/geom/linalg.py`.

No function here synchronises the host with the device. `torch.linalg.eigh`,
`cholesky` and `solve` check their error flags with a host sync on CUDA, so:
`safe_eigh` is the cyclic Jacobi of `jacobi_eigh` sorted ascending, and the
Cholesky and LU solves use the `_ex` variants with `check_errors=False`, with
a failed factorization turned into NaN as `jax.scipy.linalg.cho_factor` and
`jnp.linalg.solve` return it, so the callers' `isfinite` fallbacks hold.

`safe_eigh` differentiates as the JAX package's gap-clamped custom JVP does,
transposed into a VJP; autograd through the unrolled Jacobi would give
another gradient (and an unbounded one at close eigenvalues). The other
functions are compositions of smooth guarded ops, differentiated by autograd.
"""

import functools

import numpy as np
import torch

_NAN = float("nan")


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


_GAP_EPS = 1e-6  # 1/(w_j - w_i) is clipped to magnitude <= 1/_GAP_EPS


class _SafeEigh(torch.autograd.Function):
    """Sorted Jacobi forward; backward = the transpose of JAX's
    `_safe_eigh_jvp`: for dA_s = sym(dA), dw = diag(V^T dA_s V) and
    dV = V (F o V^T dA_s V), so
        gA = sym(V (diag(gw) + F o (V^T gV)) V^T)
    with F_ij = 1 / (w_j - w_i), magnitude clamped at 1/_GAP_EPS, F_ii = 0."""

    @staticmethod
    def forward(ctx, A, n_sweeps):
        w, V = jacobi_eigh(A, n_sweeps=n_sweeps)
        w, order = torch.sort(w, dim=-1)
        V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        gap = w[..., None, :] - w[..., :, None]
        sign = torch.where(gap >= 0, 1.0, -1.0)
        F = 1.0 / (sign * torch.clamp(gap.abs(), min=_GAP_EPS))
        F = F * (1.0 - _eye(w.shape[-1], w))
        inner = F * (V.transpose(-1, -2) @ gV) if gV is not None else torch.zeros_like(V)
        if gw is not None:
            inner = inner + torch.diag_embed(gw)
        return _sym(V @ inner @ V.transpose(-1, -2)), None


def safe_eigh(A, n_sweeps=8):
    """Eigendecomposition of a symmetric matrix with gap-clamped gradients.

    Args:
        A: (..., n, n) symmetric.
    Returns:
        (eigenvalues (..., n) ascending, eigenvectors (..., n, n) columns).
    """
    return _SafeEigh.apply(A, n_sweeps)


def smallest_eigvec(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric A (..., n, n)."""
    return safe_eigh(A)[1][..., :, 0]


def weighted_nullvec(X, w):
    """Null vector of diag(sqrt(w)) X via the Gram matrix X^T diag(w) X.

    Args:
        X: (..., N, D) stacked constraint rows; w: (..., N) non-negative weights.
    Returns:
        (..., D) unit null vector.
    """
    G = torch.einsum("...nd,...n,...ne->...de", X, w, X)
    return smallest_eigvec(G)


def adj3x3(M):
    """Batched closed-form 3x3 adjugate and determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj, det


def det3x3(M):
    """Batched closed-form 3x3 determinant."""
    return adj3x3(M)[1]


def _floored_inverse(adj, det, det_eps):
    sign = torch.where(det >= 0, 1.0, -1.0)
    det_safe = sign * torch.clamp(det.abs(), min=det_eps)
    return adj / det_safe[..., None, None]


def inv3x3(M, det_eps=1e-30):
    """Batched closed-form 3x3 inverse via the adjugate (|det| floored)."""
    return _floored_inverse(*adj3x3(M), det_eps)


def adj4x4(M):
    """Batched closed-form 4x4 adjugate and determinant (2x2-minor cofactors)."""
    m = M
    s0 = m[..., 0, 0] * m[..., 1, 1] - m[..., 1, 0] * m[..., 0, 1]
    s1 = m[..., 0, 0] * m[..., 1, 2] - m[..., 1, 0] * m[..., 0, 2]
    s2 = m[..., 0, 0] * m[..., 1, 3] - m[..., 1, 0] * m[..., 0, 3]
    s3 = m[..., 0, 1] * m[..., 1, 2] - m[..., 1, 1] * m[..., 0, 2]
    s4 = m[..., 0, 1] * m[..., 1, 3] - m[..., 1, 1] * m[..., 0, 3]
    s5 = m[..., 0, 2] * m[..., 1, 3] - m[..., 1, 2] * m[..., 0, 3]
    c5 = m[..., 2, 2] * m[..., 3, 3] - m[..., 3, 2] * m[..., 2, 3]
    c4 = m[..., 2, 1] * m[..., 3, 3] - m[..., 3, 1] * m[..., 2, 3]
    c3 = m[..., 2, 1] * m[..., 3, 2] - m[..., 3, 1] * m[..., 2, 2]
    c2 = m[..., 2, 0] * m[..., 3, 3] - m[..., 3, 0] * m[..., 2, 3]
    c1 = m[..., 2, 0] * m[..., 3, 2] - m[..., 3, 0] * m[..., 2, 2]
    c0 = m[..., 2, 0] * m[..., 3, 1] - m[..., 3, 0] * m[..., 2, 1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    b = [
        [
            m[..., 1, 1] * c5 - m[..., 1, 2] * c4 + m[..., 1, 3] * c3,
            -m[..., 0, 1] * c5 + m[..., 0, 2] * c4 - m[..., 0, 3] * c3,
            m[..., 3, 1] * s5 - m[..., 3, 2] * s4 + m[..., 3, 3] * s3,
            -m[..., 2, 1] * s5 + m[..., 2, 2] * s4 - m[..., 2, 3] * s3,
        ],
        [
            -m[..., 1, 0] * c5 + m[..., 1, 2] * c2 - m[..., 1, 3] * c1,
            m[..., 0, 0] * c5 - m[..., 0, 2] * c2 + m[..., 0, 3] * c1,
            -m[..., 3, 0] * s5 + m[..., 3, 2] * s2 - m[..., 3, 3] * s1,
            m[..., 2, 0] * s5 - m[..., 2, 2] * s2 + m[..., 2, 3] * s1,
        ],
        [
            m[..., 1, 0] * c4 - m[..., 1, 1] * c2 + m[..., 1, 3] * c0,
            -m[..., 0, 0] * c4 + m[..., 0, 1] * c2 - m[..., 0, 3] * c0,
            m[..., 3, 0] * s4 - m[..., 3, 1] * s2 + m[..., 3, 3] * s0,
            -m[..., 2, 0] * s4 + m[..., 2, 1] * s2 - m[..., 2, 3] * s0,
        ],
        [
            -m[..., 1, 0] * c3 + m[..., 1, 1] * c1 - m[..., 1, 2] * c0,
            m[..., 0, 0] * c3 - m[..., 0, 1] * c1 + m[..., 0, 2] * c0,
            -m[..., 3, 0] * s3 + m[..., 3, 1] * s1 - m[..., 3, 2] * s0,
            m[..., 2, 0] * s3 - m[..., 2, 1] * s1 + m[..., 2, 2] * s0,
        ],
    ]
    adj = torch.stack([torch.stack(row, dim=-1) for row in b], dim=-2)
    return adj, det


def inv4x4(M, det_eps=1e-30):
    """Batched closed-form 4x4 inverse via the adjugate (|det| floored)."""
    return _floored_inverse(*adj4x4(M), det_eps)


def cholesky_nan(A):
    """Lower Cholesky factor without a host sync; NaN where A is not PD."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, _NAN)


def cho_solve(L, b):
    """Solve (L L^T) x = b for (..., n) or (..., n, k) right-hand sides."""
    vec = b.dim() == L.dim() - 1
    B = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def solve_nan(A, b):
    """A x = b by LU without a host sync; NaN where A is singular."""
    x, info = torch.linalg.solve_ex(A, b, check_errors=False)
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, _NAN, x)


# deterministic inverse-iteration seeds (fixed "generic" unit directions)
_II_SEED = {
    3: (0.5377, -0.6312, 0.5594),
    4: (0.4287, -0.5811, 0.3713, 0.5810),
    9: (0.2887, -0.3451, 0.3313, -0.2918, 0.3562, 0.3117, -0.3265, 0.3410, 0.3710),
}


@functools.lru_cache(maxsize=None)
def _ii_seed(n, dtype, device):
    seed = _II_SEED.get(n)
    if seed is None:
        seed = np.sin(1.0 + 2.7 * np.arange(n)) / np.sqrt(n)
    # a cached tensor made under torch.inference_mode (the eval loops) could
    # not be saved for a later backward (training): make it a normal tensor
    with torch.inference_mode(False):
        return torch.as_tensor(np.asarray(seed), dtype=dtype, device=device)


def _ii_step(v_prev, w):
    """Normalize w; keep v_prev where w degenerated or went non-finite."""
    nsq = torch.sum(w * w, dim=-1, keepdim=True)
    good = torch.isfinite(nsq) & (nsq > 1e-30)
    w = torch.where(good, w, v_prev)
    return w / torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1, keepdim=True), min=1e-38))


def smallest_eigvec_ii(G, n_iters=4, damp_rel=1e-7):
    """Smallest eigenvector of a symmetric PSD matrix by damped inverse iteration.

    3x3/4x4 use the adjugate (elementwise, no factorization); larger sizes
    factor once with Cholesky and finish with two Rayleigh-shifted LU solves.

    Args:
        G: (..., n, n) symmetric PSD; n_iters: inverse-iteration steps;
        damp_rel: shift as a fraction of trace/n.
    Returns:
        (..., n) unit eigenvector estimate.
    """
    n = G.shape[-1]
    tr = G.diagonal(dim1=-2, dim2=-1).sum(-1)
    if n > 4:
        # f32 Gram assembly noise can make G indefinite by ~1e-7 * scale
        damp_rel = max(damp_rel, 2e-6)
    eps = damp_rel * torch.clamp(tr / n, min=1e-30)
    eye = _eye(n, G)
    Gd = G + eps[..., None, None] * eye
    v = _ii_seed(n, G.dtype, G.device).expand(G.shape[:-1])
    adj_fn = adj3x3 if n == 3 else adj4x4 if n == 4 else None
    if adj_fn is not None:
        # adj(Gd) v is parallel to Gd^{-1} v and cannot overflow
        Madj, _ = adj_fn(Gd)
        for _ in range(n_iters):
            v = _ii_step(v, (Madj @ v[..., None])[..., 0])
        # one Rayleigh-shifted step
        mu = torch.einsum("...i,...ij,...j->...", v, G, v)
        Sadj, _ = adj_fn(G - (mu - eps)[..., None, None] * eye)
        return _ii_step(v, (Sadj @ v[..., None])[..., 0])
    L = cholesky_nan(Gd)
    for _ in range(n_iters):
        v = _ii_step(v, cho_solve(L, v))
    # Rayleigh-quotient refinement: two shifted LU solves
    for _ in range(2):
        mu = torch.einsum("...i,...ij,...j->...", v, G, v)
        v = _ii_step(v, solve_nan(G - (mu - eps)[..., None, None] * eye, v[..., None])[..., 0])
    return v


def _round_robin_rounds(n):
    """Static parallel-Jacobi schedule: rounds of disjoint (p, q) pairs covering
    every pair once per sweep (circle method)."""
    m = n if n % 2 == 0 else n + 1
    idx = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = idx[k], idx[m - 1 - k]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _jacobi_indices(n, device):
    """Per round: (p, q) index tensors and the flat (n*n) positions of the
    rotation entries [p,p], [q,q], [p,q], [q,p], on `device`."""
    out = []
    for pairs in _round_robin_rounds(n):
        p = np.asarray([a for a, _ in pairs])
        q = np.asarray([b for _, b in pairs])
        flat = np.concatenate([p * n + p, q * n + q, p * n + q, q * n + p])
        with torch.inference_mode(False):  # cached: see _ii_seed
            out.append(tuple(torch.as_tensor(x, device=device) for x in (p, q, flat)))
    return tuple(out)


def jacobi_eigh(A, n_sweeps=8):
    """Batched symmetric eigendecomposition by unrolled parallel-cyclic Jacobi.

    Args:
        A: (..., n, n) symmetric; n_sweeps: full sweeps.
    Returns:
        (eigenvalues (..., n) UNSORTED, eigenvectors (..., n, n) columns).
    """
    n = A.shape[-1]
    A = _sym(A)
    batch = A.shape[:-2]
    eye_flat = _eye(n, A).reshape(n * n).expand(batch + (n * n,))
    V = _eye(n, A).expand(batch + (n, n))
    rounds = _jacobi_indices(n, A.device)
    for _ in range(n_sweeps):
        for p, q, flat in rounds:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            x = aqq - app
            y = 2.0 * apq
            # guard the (0, 0) atan2 singularity (exactly degenerate pair)
            x = torch.where(x.abs() + y.abs() < 1e-30, 1e-30, x)
            theta = 0.5 * torch.atan2(y, x)
            c = torch.cos(theta)
            s = torch.sin(theta)
            # J = I with [p,p]=[q,q]=c, [p,q]=s, [q,p]=-s
            J = eye_flat.index_add(-1, flat, torch.cat([c - 1.0, c - 1.0, s, -s], -1))
            J = J.reshape(batch + (n, n))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return A.diagonal(dim1=-2, dim2=-1), V


def eig_thresholded_solve(S, rhs, rel_thresh=1e-5, n_sweeps=8):
    """Solve S x = rhs for symmetric S, zeroing directions whose eigenvalue is
    below `rel_thresh * lam_max` (gauge freedoms, noise)."""
    lam, V = jacobi_eigh(S, n_sweeps=n_sweeps)
    lam_max = torch.clamp(lam.amax(dim=-1, keepdim=True), min=1e-12)
    good = lam > rel_thresh * lam_max
    inv_lam = torch.where(good, 1.0 / torch.where(good, lam, 1.0), 0.0)
    return torch.einsum("...ij,...j,...kj,...k->...i", V, inv_lam, V, rhs)


def solve_psd(A, b, damping=0.0):
    """Solve A x = b for symmetric PSD A with optional Tikhonov damping (Cholesky)."""
    if isinstance(damping, torch.Tensor):
        damping = damping[..., None, None]
    A = A + damping * _eye(A.shape[-1], A)
    return cho_solve(cholesky_nan(A), b)
