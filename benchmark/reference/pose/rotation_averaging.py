"""Robust IRLS rotation averaging (PyTorch), batched over tuples.

Frozen copy of the port's `mvba/rotation_averaging.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/mvba/rotation_averaging.py`:
right-perturbation linearization log(R_j^T R_ij R_i) solved on the weighted
graph Laplacian (camera 0 is the gauge), one L2 round and then IRLS rounds
with Geman-McClure weights.
"""

import torch
import torch.nn.functional as F

from .lie import so3_exp, so3_log
from .linalg import cho_solve, cholesky_nan


def rotation_averaging(R_init, edges_i, edges_j, R_rel, edge_valid, n_irls=10,
                       n_inner=1, sigma=0.1):
    """Robust rotation averaging.

    Args:
        R_init: (B, N, 3, 3) initial extrinsic rotations (world->cam); camera 0
            is the gauge and is returned unchanged.
        edges_i, edges_j: (E,) int64 camera indices per measured relative.
        R_rel: (B, E, 3, 3) measured R_ij (cam_i -> cam_j).
        edge_valid: (B, E) bool mask.
        n_irls: IRLS reweighting rounds; n_inner: steps per round;
        sigma: Geman-McClure scale (radians).
    Returns:
        (B, N, 3, 3) refined rotations.
    """
    N = R_init.shape[1]
    dtype = R_init.dtype
    ev = edge_valid.to(dtype)
    # signed incidence over cameras 1..N-1: +1 at i, -1 at j
    Ae = (F.one_hot(edges_i, N) - F.one_hot(edges_j, N)).to(dtype)[:, 1:]
    eye = torch.eye(N - 1, dtype=dtype, device=R_init.device)

    def residuals(R):
        Eerr = R[:, edges_j].transpose(-1, -2) @ R_rel @ R[:, edges_i]
        return so3_log(Eerr)  # (B, E, 3)

    def solve_step(R, w):
        r = residuals(R)
        wgt = w * ev
        L = torch.einsum("be,ei,ej->bij", wgt, Ae, Ae)
        b = -torch.einsum("be,ei,bed->bid", wgt, Ae, r)
        # scale-relative damping keeps an underconstrained graph invertible
        diag_max = torch.clamp(L.diagonal(dim1=-2, dim2=-1).amax(dim=-1), min=1.0)
        L = L + (1e-5 * diag_max)[:, None, None] * eye
        delta = cho_solve(cholesky_nan(L), b)  # (B, N-1, 3)
        delta = torch.cat([torch.zeros_like(delta[:, :1]), delta], dim=1)
        # keep the previous iterate where the solve degenerated anyway
        ok = torch.isfinite(delta).all(dim=2).all(dim=1)
        delta = torch.where(ok[:, None, None], delta, 0.0)
        return R @ so3_exp(delta)

    R = solve_step(R_init, torch.ones_like(ev))
    for _ in range(n_irls):
        r = residuals(R)
        nrm2 = torch.sum(r * r, dim=-1)
        w = (sigma ** 2 / (nrm2 + sigma ** 2)) ** 2
        for _ in range(n_inner):
            R = solve_step(R, w)
    return R
