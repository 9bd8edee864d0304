"""Two-view Levenberg-Marquardt bundle adjustment with Schur complement (PyTorch).

Frozen copy of the port's `pose/two_view_ba.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/pose/two_view_ba.py`: a free
6-DoF second camera and one 3D point per match, confidence-weighted
reprojection residuals, per-sample LM damping (x1.5 on regression, /3.5 on
improvement, init 0.1), best-iterate tracking and an `n_matches > 6` gate.
The point blocks are eliminated analytically, leaving one 6x6 system per
sample, solved with eigenvalue thresholding (the scale gauge). With
`retriangulate=True` (variable projection) the points are triangulated again
from the current camera at every iteration. Per-point quantities use the
structure-of-arrays layout (small..., B, K).
"""

import torch

from .epipolar import midpoint_triangulate_rel
from .lie import se3_exp
from .linalg import eig_thresholded_solve
from .soa import (
    hat_soa,
    inv3x3_soa,
    mm_soa,
    mtm_soa,
    mtv_soa,
    mv_soa,
)

_Z_EPS = 1e-6


def _proj_jac(Ap):
    """Projection pi (2, B, K) and its Jacobian (2, 3, B, K) of points Ap (3, B, K)."""
    z = Ap[2]
    sign = torch.where(z >= 0, 1.0, -1.0)
    inv_z = 1.0 / (sign * torch.clamp(z.abs(), min=_Z_EPS))
    zeros = torch.zeros_like(inv_z)
    J = torch.stack([
        torch.stack([inv_z, zeros, -Ap[0] * inv_z * inv_z]),
        torch.stack([zeros, inv_z, -Ap[1] * inv_z * inv_z]),
    ])
    return Ap[:2] * inv_z[None], J


def bundle_adjust_two_view(x0, x1, conf, init_T021, n_iterations=10, lm_init=0.1,
                           lm_increase=1.5, lm_decrease=3.5, retriangulate=False):
    """Refine relative poses by confidence-weighted two-view LM bundle adjustment.

    Args:
        x0, x1: (B, K, 2) camera-normalized matched keypoints.
        conf: (B, K) confidences; <= 0 marks an invalid match.
        init_T021: (B, 4, 4) initial relative transforms.
        n_iterations: LM iterations.
        retriangulate: variable projection -- midpoint-triangulate the points
            from the current camera before every LM step and after the last
            one, instead of carrying them as free LM state (the camera step
            still uses the Schur-reduced curvature).
    Returns:
        (T021 (B, 4, 4) best-residual extrinsics -- the init where the sample is
         gated invalid --, valid (B,) bool = `n_matches > 6`).
    """
    w_match = torch.where(conf > 0.0, conf, 0.0)
    valid = torch.sum(w_match > 0.0, dim=-1) > 6
    # per-observation normalization: the 2K observation weights sum to 2
    w = w_match / torch.clamp(0.5 * torch.sum(w_match, dim=-1, keepdim=True), min=1e-6)

    def triangulate(T1):
        """Midpoint points (3, B, K) in the cam0 frame of the relative poses T1."""
        return midpoint_triangulate_rel(T1[:, :3, :3], T1[:, :3, 3], x0, x1).movedim(-1, 0)

    x0t = x0.movedim(-1, 0)  # (2, B, K)
    x1t = x1.movedim(-1, 0)
    eye3 = torch.eye(3, dtype=x0.dtype, device=x0.device)
    eye6 = torch.eye(6, dtype=x0.dtype, device=x0.device)

    def residual_system(T1, Xt):
        # cam0 = identity; Xt: (3, B, K)
        pi0, J0 = _proj_jac(Xt)
        R1 = T1[:, :3, :3].permute(1, 2, 0)[..., None]  # (3, 3, B, 1)
        t1 = T1[:, :3, 3].T[..., None]  # (3, B, 1)
        Ap1 = mv_soa(R1, Xt) + t1
        pi1, J1 = _proj_jac(Ap1)
        r0 = w[None] * (pi0 - x0t)
        r1 = w[None] * (pi1 - x1t)
        Jp0 = w[None, None] * J0
        Jp1 = w[None, None] * mm_soa(J1, R1)
        # camera Jacobian for cam1: J1 @ [-hat(Ap1) | I]  (rotation first)
        lhs = torch.cat([-hat_soa(Ap1),
                         eye3[..., None, None].expand((3, 3) + Ap1.shape[1:])], dim=1)
        Jc = w[None, None] * mm_soa(J1, lhs)  # (2, 6, B, K)
        r_norm = torch.sum(r0 * r0, dim=(0, 2)) + torch.sum(r1 * r1, dim=(0, 2))
        return r0, r1, Jp0, Jp1, Jc, r_norm

    def lm_step(T1, Xt, damp):
        r0, r1, Jp0, Jp1, Jc, r_norm = residual_system(T1, Xt)
        Hcc = torch.einsum("ribk,rjbk->bij", Jc, Jc)  # (B, 6, 6)
        bc = -torch.einsum("ribk,rbk->bi", Jc, r1)  # (B, 6)
        Hcp = mtm_soa(Jc, Jp1)  # (6, 3, B, K)
        Hpp = mtm_soa(Jp0, Jp0) + mtm_soa(Jp1, Jp1)  # (3, 3, B, K)
        bp = -(mtv_soa(Jp0, r0) + mtv_soa(Jp1, r1))  # (3, B, K)

        # Marquardt damping (multiplicative on diagonals + absolute floor)
        dpp = torch.clamp(torch.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]]), min=1e-8)
        Hpp_d = Hpp + damp[None, None, :, None] * eye3[..., None, None] * dpp[None]
        Hcc_d = Hcc + damp[:, None, None] * (
            eye6 * torch.clamp(Hcc.diagonal(dim1=-2, dim2=-1), min=1e-8)[..., None, :])
        # det floor 1e-12 keeps a ~singular point block from an Inf step
        Hpp_inv = inv3x3_soa(Hpp_d, det_eps=1e-12)
        Y = mm_soa(Hcp, Hpp_inv)  # (6, 3, B, K)
        S = Hcc_d - torch.einsum("ilbk,jlbk->bij", Y, Hcp)
        rhs = bc - torch.einsum("ijbk,jbk->bi", Y, bp)
        # eigen-thresholded 6x6 solve: zero the scale-gauge direction
        delta_c = eig_thresholded_solve(S, rhs, n_sweeps=6)
        HcpTdc = torch.einsum("ijbk,bi->jbk", Hcp, delta_c)  # (3, B, K)
        delta_p = mv_soa(Hpp_inv, bp - HcpTdc)
        step_ok = (torch.isfinite(delta_c).all(dim=-1)
                   & torch.isfinite(delta_p).all(dim=0).all(dim=-1))
        return delta_c, delta_p, r_norm, step_ok

    t0_norm = torch.linalg.vector_norm(init_T021[:, :3, 3], dim=-1)
    T1 = init_T021
    Xt = triangulate(init_T021)
    damp = torch.full_like(T1[:, 0, 0], lm_init)
    best_T1 = init_T021
    best_r = torch.full_like(damp, float("inf"))
    for _ in range(n_iterations):
        if retriangulate:
            Xt = triangulate(T1)
        delta_c, delta_p, r_norm, step_ok = lm_step(T1, Xt, damp)
        improved = r_norm < best_r
        best_T1 = torch.where(improved[:, None, None], T1, best_T1)
        best_r = torch.minimum(r_norm, best_r)
        damp = torch.where(improved, damp / lm_decrease, damp * lm_increase)
        T1_new = torch.where(step_ok[:, None, None], se3_exp(delta_c) @ T1, T1)
        X_new = torch.where(step_ok[None, :, None], Xt + delta_p, Xt)
        # gauge: pin ||t|| to the init's scale
        t_norm = torch.linalg.vector_norm(T1_new[:, :3, 3], dim=-1)
        s = torch.where(t_norm > 1e-9, t0_norm / torch.clamp(t_norm, min=1e-9), 1.0)
        T1_new = T1_new.clone()
        T1_new[:, :3, 3] = T1_new[:, :3, 3] * s[:, None]
        T1, Xt = T1_new, X_new * s[None, :, None]
    if retriangulate:
        Xt = triangulate(T1)
    improved = residual_system(T1, Xt)[5] < best_r
    best_T1 = torch.where(improved[:, None, None], T1, best_T1)
    return torch.where(valid[:, None, None], best_T1, init_T021), valid
