"""Robust translation (position) averaging (PyTorch), batched over tuples.

Frozen copy of the port's `mvba/translation_averaging.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/mvba/translation_averaging.py`:
the edge scales are eliminated, leaving the weighted projection Laplacian
sum_e w_e ||(I - g_e g_e^T)(c_j - c_i)||^2 with c_0 fixed, whose null vector
(the scale gauge) comes from damped inverse iteration; IRLS reweights edges by
1/max(residual, delta), and sign and scale align to the tree init.
"""

import torch
import torch.nn.functional as F

from .linalg import smallest_eigvec_ii


def translation_averaging(c_init, edges_i, edges_j, gamma, edge_valid, n_irls=8,
                          delta=1e-3):
    """Robust camera position averaging.

    Args:
        c_init: (B, N, 3) initial camera centers; c_0 is the gauge.
        edges_i, edges_j: (E,) int64 endpoints.
        gamma: (B, E, 3) unit directions from camera i to camera j (world).
        edge_valid: (B, E) mask.
    Returns:
        (B, N, 3) camera centers, c_0 = c_init_0, scale/sign aligned to c_init.
    """
    B, N = c_init.shape[:2]
    dtype = c_init.dtype
    ev = edge_valid.to(dtype)
    Ae = (F.one_hot(edges_j, N) - F.one_hot(edges_i, N)).to(dtype)[:, 1:]
    eye3 = torch.eye(3, dtype=dtype, device=c_init.device)
    Proj = eye3 - gamma[..., :, None] * gamma[..., None, :]  # (B, E, 3, 3)
    c0_off = c_init[:, :1]
    c_rel_init = (c_init - c0_off)[:, 1:]  # (B, N-1, 3)
    n = (N - 1) * 3

    def solve(w):
        M = torch.einsum("be,ea,ec,beij->baicj", w * ev, Ae, Ae, Proj).reshape(B, n, n)
        c_rest = smallest_eigvec_ii(M, n_iters=4).reshape(B, N - 1, 3)
        num = torch.sum(c_rest * c_rel_init, dim=(1, 2))
        den = torch.clamp(torch.sum(c_rest * c_rest, dim=(1, 2)), min=1e-12)
        return c_rest * (num / den)[:, None, None]

    c_rest = solve(torch.ones_like(ev))
    for _ in range(n_irls):
        c_full = torch.cat([torch.zeros_like(c0_off), c_rest], dim=1)
        diff = c_full[:, edges_j] - c_full[:, edges_i]
        resid = torch.einsum("beij,bej->bei", Proj, diff)
        c_rest = solve(1.0 / torch.clamp(torch.linalg.vector_norm(resid, dim=-1), min=delta))
    return torch.cat([c0_off, c_rest + c0_off], dim=1)


def edge_directions(R_glob, R_rel, t_rel):
    """Unit world-frame direction from camera i's center to camera j's:
    -R_i^T R_ij^T t_ij, normalized. R_glob (..., E, 3, 3) are the i endpoints'
    extrinsic rotations; R_rel (..., E, 3, 3), t_rel (..., E, 3)."""
    d = -torch.einsum("...eji,...ekj,...ek->...ei", R_glob, R_rel, t_rel)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
