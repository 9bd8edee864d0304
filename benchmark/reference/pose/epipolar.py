"""Epipolar geometry primitives (PyTorch): normalization, triangulation,

Frozen copy of the port's `geom/epipolar.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.
essential-matrix decomposition, epipolar distances.

Counterpart of `e2e_multi_view_matching_tpu/geom/epipolar.py`. Decompositions
go through the closed-form small-matrix code of `geom/linalg.py`; validity is
carried by weights and masks, never ragged shapes.
"""

import math

import torch
import torch.nn.functional as F

from .linalg import det3x3, smallest_eigvec_ii

_EPS = 1e-8


def safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    """sqrt(max(sum(x^2), eps)): an L2 norm that stays finite at the origin."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim), min=eps))


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def normalize_keypoints(kpts, intr):
    """Pixel coordinates (..., N, 2) -> normalized camera coordinates, with
    intrinsics (..., 3|4, 3|4)."""
    fx = intr[..., 0, 0][..., None]
    fy = intr[..., 1, 1][..., None]
    cx = intr[..., 0, 2][..., None]
    cy = intr[..., 1, 2][..., None]
    return torch.stack([(kpts[..., 0] - cx) / fx, (kpts[..., 1] - cy) / fy], dim=-1)


def hartley_normalize(pts, w=None):
    """Weighted Hartley normalization: zero (weighted) mean, mean distance sqrt(2).

    Returns (pts_norm (..., N, 2), T (..., 3, 3)) with pts_norm_h = T @ pts_h.
    """
    if w is None:
        w = torch.ones_like(pts[..., 0])
    w_sum = torch.sum(w, dim=-1, keepdim=True) + _EPS
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / w_sum[..., None]
    centered = pts - mean
    mean_dist = torch.sum(safe_norm(centered, dim=-1) * w, dim=-1, keepdim=True) / w_sum
    scale = math.sqrt(2.0) / (mean_dist + _EPS)
    pts_norm = centered * scale[..., None]
    s = scale[..., 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zeros, -s * mx], dim=-1),
        torch.stack([zeros, s, -s * my], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return pts_norm, T


def triangulate_points(P0, P1, x0, x1):
    """Batched DLT triangulation: P0, P1 (..., 3, 4); x0, x1 (..., N, 2) ->
    (..., N, 3)."""
    def rows(P, x):
        P0r = P[..., None, 0, :]
        P1r = P[..., None, 1, :]
        P2r = P[..., None, 2, :]
        return torch.stack([x[..., 0:1] * P2r - P0r, x[..., 1:2] * P2r - P1r], dim=-2)

    A = torch.cat([rows(P0, x0), rows(P1, x1)], dim=-2)  # (..., N, 4, 4)
    G = torch.einsum("...ij,...ik->...jk", A, A)
    h = smallest_eigvec_ii(G, n_iters=4)
    wcomp = h[..., 3]
    sign = torch.where(wcomp >= 0, 1.0, -1.0)
    return h[..., :3] / (sign * torch.clamp(wcomp.abs(), min=_EPS))[..., None]


def two_ray_depths(R, t, x0, x1):
    """Closed-form depths (z0, z1) of normalized correspondences x0, x1 (..., N, 2)
    for cam1 = (R (..., 3, 3), t (..., 3)); sign-equivalent to triangulation."""
    x0h = _homogeneous(x0)
    x1h = _homogeneous(x1)
    Rx0 = torch.einsum("...ij,...nj->...ni", R, x0h)
    c = torch.linalg.cross(x1h, Rx0, dim=-1)
    x1t = torch.linalg.cross(x1h, t[..., None, :].expand(x1h.shape), dim=-1)
    denom = torch.sum(c * c, dim=-1)
    z0 = -torch.sum(x1t * c, dim=-1) / torch.clamp(denom, min=_EPS)
    z1 = z0 * Rx0[..., 2] + t[..., None, 2]
    return z0, z1


def midpoint_triangulate_rel(R, t, x0, x1):
    """Midpoint triangulation for a relative pair (cam0 = identity) ->
    (..., N, 3) points in the cam0 frame."""
    z0, z1 = two_ray_depths(R, t, x0, x1)
    x0h = _homogeneous(x0)
    x1h = _homogeneous(x1)
    X0 = z0[..., None] * x0h
    X1 = torch.einsum("...ji,...nj->...ni", R, z1[..., None] * x1h - t[..., None, :])
    return 0.5 * (X0 + X1)


def depth_from_point(R, t, X):
    """Depth of 3D points X (..., N, 3) in the camera (R (..., 3, 3), t (..., 3))."""
    return torch.einsum("...ij,...nj->...ni", R, X)[..., 2] + t[..., None, 2]


def sym_epipolar_distance(x0, x1, Fm, squared=True):
    """Symmetric epipolar distance (..., N) of correspondences under F (..., 3, 3)."""
    x0h = _homogeneous(x0)
    x1h = _homogeneous(x1)
    Fx0 = torch.einsum("...ij,...nj->...ni", Fm, x0h)
    FTx1 = torch.einsum("...ji,...nj->...ni", Fm, x1h)
    num = torch.sum(x1h * Fx0, dim=-1) ** 2
    denom = (1.0 / (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + _EPS)
             + 1.0 / (FTx1[..., 0] ** 2 + FTx1[..., 1] ** 2 + _EPS))
    d = num * denom
    return d if squared else torch.sqrt(d + _EPS)


def _essential_uv(E):
    """Consistent (U, s, V) with E ~ U diag(s) V^T, without eigh or SVD: null
    direction by inverse iteration, any orthonormal completion, and U's top-2
    frame from the polar decomposition of [E v1, E v2]."""
    G = E.transpose(-1, -2) @ E
    v3 = smallest_eigvec_ii(G, n_iters=4)
    k = torch.argmin(v3.abs(), dim=-1)
    e_k = F.one_hot(k, 3).to(E.dtype)
    v1 = e_k - torch.sum(e_k * v3, dim=-1, keepdim=True) * v3
    v1 = v1 / safe_norm(v1, dim=-1, keepdim=True)
    v2 = torch.linalg.cross(v3, v1, dim=-1)
    V = torch.stack([v1, v2, v3], dim=-1)

    m1 = (E @ v1[..., None])[..., 0]
    m2 = (E @ v2[..., None])[..., 0]
    a11 = torch.sum(m1 * m1, dim=-1)
    a12 = torch.sum(m1 * m2, dim=-1)
    a22 = torch.sum(m2 * m2, dim=-1)
    # A^{1/2} = (A + sqrt(det) I) / sqrt(tr + 2 sqrt(det)) for the 2x2 Gram A
    d = torch.sqrt(torch.clamp(a11 * a22 - a12 * a12, min=0.0))
    t = torch.sqrt(torch.clamp(a11 + a22 + 2.0 * d, min=_EPS))
    den = torch.clamp((a11 + d) * (a22 + d) - a12 * a12, min=_EPS)
    f = t / den
    b11 = f * (a22 + d)
    b12 = -f * a12
    b22 = f * (a11 + d)
    u1 = m1 * b11[..., None] + m2 * b12[..., None]
    u2 = m1 * b12[..., None] + m2 * b22[..., None]
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    s = torch.stack([torch.sqrt(torch.clamp(a11, min=0.0)),
                     torch.sqrt(torch.clamp(a22, min=0.0)),
                     torch.zeros_like(a11)], dim=-1)
    return U, s, V


def motion_from_essential(E):
    """Four (R, t) candidates from an essential matrix (..., 3, 3) ->
    Rs (..., 4, 3, 3), ts (..., 4, 3) with unit translations."""
    U, _, V = _essential_uv(E)
    detU = det3x3(U)
    detV = det3x3(V)
    ones = torch.ones_like(detU)
    U = U * torch.stack([ones, ones, detU], dim=-1)[..., None, :]
    V = V * torch.stack([ones, ones, detV], dim=-1)[..., None, :]
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], from the identity's rows: a
    # scalar written into a 0-dim CUDA view is a synchronising host copy
    e = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-e[1], e[0], e[2]])
    VT = V.transpose(-1, -2)
    R1 = U @ W @ VT
    R2 = U @ W.T @ VT
    t = U[..., :, 2]
    t = t / safe_norm(t, dim=-1, keepdim=True)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def cheirality_scores(Rs, ts, x0, x1, w=None):
    """Weighted count of points in front of both cameras, per candidate:
    Rs (..., C, 3, 3), ts (..., C, 3); x0, x1 (..., N, 2) -> (..., C)."""
    if w is None:
        w = torch.ones_like(x0[..., 0])
    x0c = x0[..., None, :, :].expand(Rs.shape[:-2] + x0.shape[-2:])
    x1c = x1[..., None, :, :].expand(Rs.shape[:-2] + x1.shape[-2:])
    d0, d1 = two_ray_depths(Rs, ts, x0c, x1c)
    pos = ((d0 > 0.0) & (d1 > 0.0)).to(x0.dtype)
    return torch.sum(pos * w[..., None, :], dim=-1)
