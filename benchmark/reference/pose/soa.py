"""Structure-of-arrays small-matrix helpers for the batched BA solvers (PyTorch).

Frozen copy of the port's `geom/soa.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/geom/soa.py`. Operands are
(m, k, *batch): the small matrix dimensions lead and the large batch axes
trail, and every product unrolls statically (m, k, n <= 6) into elementwise
multiplies over the batch.
"""

import torch


def mm_soa(A, B):
    """(m, k, *b) @ (k, n, *b) -> (m, n, *b), elementwise over the batch."""
    m, k, n = A.shape[0], A.shape[1], B.shape[1]
    return torch.stack([
        torch.stack([sum(A[i, q] * B[q, j] for q in range(k)) for j in range(n)])
        for i in range(m)
    ])


def mtm_soa(A, B):
    """sum_r A[r, i] B[r, j]: (r, m, *b), (r, n, *b) -> (m, n, *b)."""
    r, m, n = A.shape[0], A.shape[1], B.shape[1]
    return torch.stack([
        torch.stack([sum(A[q, i] * B[q, j] for q in range(r)) for j in range(n)])
        for i in range(m)
    ])


def abT_soa(A, B):
    """sum_k A[i, k] B[j, k]: (m, k, *b), (n, k, *b) -> (m, n, *b)."""
    m, k, n = A.shape[0], A.shape[1], B.shape[0]
    return torch.stack([
        torch.stack([sum(A[i, q] * B[j, q] for q in range(k)) for j in range(n)])
        for i in range(m)
    ])


def mv_soa(A, v):
    """(m, k, *b) @ (k, *b) -> (m, *b)."""
    m, k = A.shape[0], A.shape[1]
    return torch.stack([sum(A[i, q] * v[q] for q in range(k)) for i in range(m)])


def mtv_soa(A, v):
    """sum_r A[r, m] v[r]: (r, m, *b), (r, *b) -> (m, *b)."""
    r, m = A.shape[0], A.shape[1]
    return torch.stack([sum(A[q, i] * v[q] for q in range(r)) for i in range(m)])


def hat_soa(a):
    """(3, *b) -> (3, 3, *b) skew-symmetric."""
    z = torch.zeros_like(a[0])
    return torch.stack([
        torch.stack([z, -a[2], a[1]]),
        torch.stack([a[2], z, -a[0]]),
        torch.stack([-a[1], a[0], z]),
    ])


def inv3x3_soa(H, det_eps=1e-30):
    """Closed-form adjugate inverse of (3, 3, *b) matrices; |det| floored at
    `det_eps` with its sign kept."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 0], H[1, 1], H[1, 2]
    g, h, i = H[2, 0], H[2, 1], H[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    sign = torch.where(det >= 0, 1.0, -1.0)
    inv_det = sign / torch.clamp(det.abs(), min=det_eps)
    return inv_det[None, None] * torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e]),
        torch.stack([B, a * i - c * g, -(a * f - c * d)]),
        torch.stack([C, -(a * h - b * g), a * e - b * d]),
    ])
