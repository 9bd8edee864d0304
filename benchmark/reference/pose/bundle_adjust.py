"""Multi-camera confidence-weighted Schur-complement LM bundle adjustment (PyTorch).

Frozen copy of the port's `mvba/bundle_adjust.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/mvba/bundle_adjust.py`, with the
tuple axis written out (the JAX package vmaps the single-tuple solver).
Residual w * (pi(R_c X + t_c) - obs), camera 0 pinned, one 3D point per
pairwise match seen by exactly two cameras, so the point block is 3x3
block-diagonal and the Schur complement leaves 6(N-1) unknowns per tuple,
solved with eigenvalue thresholding (the scale gauge survives fixing camera
0). With `retriangulate=True` (variable projection) the structure is solved
again by DLT triangulation from the current cameras at every iteration instead
of riding along as free LM state. Per-point quantities use the structure-of-arrays layout (small..., B, P);
per-camera sums are products with one-hot (P, N) matrices, as in the JAX
package.
"""

import torch
import torch.nn.functional as F

from .lie import se3_exp
from .linalg import (
    eig_thresholded_solve,
    smallest_eigvec_ii,
)
from .soa import (
    abT_soa,
    hat_soa,
    inv3x3_soa,
    mm_soa,
    mtm_soa,
    mtv_soa,
    mv_soa,
)

_Z_EPS = 1e-6


def _proj_jac_soa(Rsel, tsel, Xt):
    """Projection of Xt (3, B, P) by per-point cameras Rsel (3, 3, B, P),
    tsel (3, B, P) -> (pi (2, B, P), Ap (3, B, P), J (2, 3, B, P))."""
    Ap = mv_soa(Rsel, Xt) + tsel
    z = Ap[2]
    sign = torch.where(z >= 0, 1.0, -1.0)
    inv_z = 1.0 / (sign * torch.clamp(z.abs(), min=_Z_EPS))
    zeros = torch.zeros_like(inv_z)
    J = torch.stack([
        torch.stack([inv_z, zeros, -Ap[0] * inv_z * inv_z]),
        torch.stack([zeros, inv_z, -Ap[1] * inv_z * inv_z]),
    ])
    return Ap[:2] * inv_z[None], Ap, J


def _triangulate_pairwise_dlt(extr, cam_a, cam_b, xa, xb):
    """DLT-triangulate each point from its two observing cameras (world frame):
    extr (..., N, 4, 4), cam_a, cam_b (P,), xa, xb (..., P, 2) -> (..., P, 3).

    The structure solve of the variable-projection mode (`retriangulate=True`),
    where the DLT's algebraic image-space objective converges tighter than the
    3-D midpoint; the default init uses the midpoint below.
    """
    Pa = extr[..., cam_a, :3, :]  # (..., P, 3, 4)
    Pb = extr[..., cam_b, :3, :]

    def rows(Pm, x):
        r0 = x[..., 0:1, None] * Pm[..., 2:3, :] - Pm[..., 0:1, :]
        r1 = x[..., 1:2, None] * Pm[..., 2:3, :] - Pm[..., 1:2, :]
        return torch.cat([r0, r1], dim=-2)  # (..., P, 2, 4)

    A = torch.cat([rows(Pa, xa), rows(Pb, xb)], dim=-2)  # (..., P, 4, 4)
    G = torch.einsum("...ij,...ik->...jk", A, A)
    h = smallest_eigvec_ii(G, n_iters=3)
    wc = h[..., 3]
    sign = torch.where(wc >= 0, 1.0, -1.0)
    return h[..., :3] / (sign * torch.clamp(wc.abs(), min=1e-9))[..., None]


def _triangulate_pairwise(extr, cam_a, cam_b, xa, xb):
    """Midpoint of the shortest segment between each point's two viewing rays:
    extr (..., N, 4, 4), cam_a, cam_b (P,), xa, xb (..., P, 2) -> (..., P, 3)."""
    Ta = extr[..., cam_a, :, :]
    Tb = extr[..., cam_b, :, :]
    Ra, tra = Ta[..., :3, :3], Ta[..., :3, 3]
    Rb, trb = Tb[..., :3, :3], Tb[..., :3, 3]
    oa = -torch.einsum("...ji,...j->...i", Ra, tra)  # camera centers (world)
    ob = -torch.einsum("...ji,...j->...i", Rb, trb)
    ones = torch.ones_like(xa[..., :1])
    da = torch.einsum("...ji,...j->...i", Ra, torch.cat([xa, ones], -1))
    db = torch.einsum("...ji,...j->...i", Rb, torch.cat([xb, ones], -1))
    b = ob - oa
    a11 = torch.sum(da * da, dim=-1)
    a22 = torch.sum(db * db, dim=-1)
    a12 = torch.sum(da * db, dim=-1)
    r0 = torch.sum(da * b, dim=-1)
    r1 = -torch.sum(db * b, dim=-1)
    det = a11 * a22 - a12 * a12
    # near-parallel rays: floor the determinant
    det = torch.maximum(det, 1e-9 * torch.clamp(a11 * a22, min=1e-12))
    za = (r0 * a22 + a12 * r1) / det
    zb = (a11 * r1 + a12 * r0) / det
    return 0.5 * (oa + za[..., None] * da + ob + zb[..., None] * db)


def bundle_adjust_multi_view(extr_init, X_init, cam_a, cam_b, xa, xb, w,
                             n_iterations=20, lm_init=0.1, lm_increase=1.5,
                             lm_decrease=3.5, retriangulate=False):
    """Refine N camera extrinsics + P pairwise-match points, per tuple.

    Args:
        extr_init: (B, N, 4, 4) world->cam extrinsics; camera 0 is held fixed.
        X_init: (B, P, 3) world points (any values when `retriangulate`).
        cam_a, cam_b: (P,) int64 observing camera indices per point.
        xa, xb: (B, P, 2) normalized observations in those cameras.
        w: (B, P) confidence weights; <= 0 disables the point.
        retriangulate: variable projection -- DLT-triangulate the points from
            the current cameras before every LM step and after the last one.
    Returns:
        (extr (B, N, 4, 4) best iterate, X (B, P, 3) final points).
    """
    B, N = extr_init.shape[:2]
    dtype = extr_init.dtype
    dev = extr_init.device
    wm = torch.where(w > 0.0, w, 0.0)  # (B, P)
    free = N - 1
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    ar = torch.arange(N, device=dev)

    xa_t = xa.permute(2, 0, 1)  # (2, B, P)
    xb_t = xb.permute(2, 0, 1)
    mask_a = (cam_a > 0).to(dtype)  # camera 0 fixed
    mask_b = (cam_b > 0).to(dtype)
    oh_a = F.one_hot(cam_a, N).to(dtype)  # (P, N)
    oh_b = F.one_hot(cam_b, N).to(dtype)

    def pair_oh(o1, o2):
        return (o1[:, :, None] * o2[:, None, :]).reshape(-1, N * N)  # (P, N^2)

    oh_aa, oh_ab = pair_oh(oh_a, oh_a), pair_oh(oh_a, oh_b)
    oh_ba, oh_bb = pair_oh(oh_b, oh_a), pair_oh(oh_b, oh_b)

    def reduce_cams(flatP, oh):
        """(u, B, P) @ (P, n) -> (B, n, u): per-camera sums of per-point blocks."""
        return (flatP @ oh).permute(1, 2, 0)

    def side_system(extr, Xt, cam, x_t, mask):
        """One observation side: residual (2, B, P), Jp (2, 3, B, P), Jc (2, 6, B, P)."""
        Tsel = extr[:, cam]  # (B, P, 4, 4)
        Rsel = Tsel[..., :3, :3].permute(2, 3, 0, 1)
        tsel = Tsel[..., :3, 3].permute(2, 0, 1)
        pi, Ap, J = _proj_jac_soa(Rsel, tsel, Xt)
        r = wm[None] * (pi - x_t)
        Jp = wm[None, None] * mm_soa(J, Rsel)
        M = torch.cat([-hat_soa(Ap), eye3[..., None, None].expand((3, 3) + Ap.shape[1:])],
                      dim=1)  # (3, 6, B, P)
        Jc = (wm * mask)[None, None] * mm_soa(J, M)
        return r, Jp, Jc

    def residual_system(extr, Xt):
        ra, Jpa, Jca = side_system(extr, Xt, cam_a, xa_t, mask_a)
        rb, Jpb, Jcb = side_system(extr, Xt, cam_b, xb_t, mask_b)
        r_norm = torch.sum(ra * ra, dim=(0, 2)) + torch.sum(rb * rb, dim=(0, 2))
        return ra, rb, Jpa, Jpb, Jca, Jcb, r_norm

    def lm_step(extr, Xt, damp):
        ra, rb, Jpa, Jpb, Jca, Jcb, r_norm = residual_system(extr, Xt)
        Pn = ra.shape[-1]
        Hcc = (reduce_cams(mtm_soa(Jca, Jca).reshape(36, B, Pn), oh_a)
               + reduce_cams(mtm_soa(Jcb, Jcb).reshape(36, B, Pn), oh_b)
               ).reshape(B, N, 6, 6)
        bc = -(reduce_cams(mtv_soa(Jca, ra), oh_a) + reduce_cams(mtv_soa(Jcb, rb), oh_b))
        Hpp = mtm_soa(Jpa, Jpa) + mtm_soa(Jpb, Jpb)  # (3, 3, B, P)
        bp = -(mtv_soa(Jpa, ra) + mtv_soa(Jpb, rb))  # (3, B, P)
        Hcpa = mtm_soa(Jca, Jpa)  # (6, 3, B, P)
        Hcpb = mtm_soa(Jcb, Jpb)
        dpp = torch.clamp(torch.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]]), min=1e-8)
        Hpp_d = Hpp + damp[None, None, :, None] * eye3[..., None, None] * dpp[None]
        Hpp_inv = inv3x3_soa(Hpp_d)
        Ya = mm_soa(Hcpa, Hpp_inv)  # (6, 3, B, P)
        Yb = mm_soa(Hcpb, Hpp_inv)
        # Schur blocks S[c1, c2] -= Y_c1 Hcp_c2^T, scattered to camera pairs
        corr = -(reduce_cams(abT_soa(Ya, Hcpa).reshape(36, B, Pn), oh_aa)
                 + reduce_cams(abT_soa(Ya, Hcpb).reshape(36, B, Pn), oh_ab)
                 + reduce_cams(abT_soa(Yb, Hcpa).reshape(36, B, Pn), oh_ba)
                 + reduce_cams(abT_soa(Yb, Hcpb).reshape(36, B, Pn), oh_bb)
                 ).reshape(B, N, N, 6, 6)
        rhs_corr = -(reduce_cams(mv_soa(Ya, bp), oh_a) + reduce_cams(mv_soa(Yb, bp), oh_b))
        Hcc_d = Hcc + damp[:, None, None, None] * (
            eye6 * torch.clamp(Hcc.diagonal(dim1=-2, dim2=-1), min=1e-8)[..., None, :])
        corr[:, ar, ar] = corr[:, ar, ar] + Hcc_d
        rhs_c = bc + rhs_corr
        S = corr[:, 1:, 1:].permute(0, 1, 3, 2, 4).reshape(B, free * 6, free * 6)
        delta_c = eig_thresholded_solve(S, rhs_c[:, 1:].reshape(B, free * 6), n_sweeps=8)
        delta_c = torch.cat([torch.zeros_like(delta_c[:, :6]), delta_c],
                            dim=1).reshape(B, N, 6)
        # back-substitute points: Hcp^T delta_c summed over the two cameras
        d_sel_a = delta_c[:, cam_a].permute(2, 0, 1)  # (6, B, P)
        d_sel_b = delta_c[:, cam_b].permute(2, 0, 1)
        HcpTdc = mtv_soa(Hcpa, d_sel_a) + mtv_soa(Hcpb, d_sel_b)
        delta_p = mv_soa(Hpp_inv, bp - HcpTdc)
        ok = (torch.isfinite(delta_c).all(dim=2).all(dim=1)
              & torch.isfinite(delta_p).all(dim=0).all(dim=-1))
        return delta_c, delta_p, r_norm, ok

    def normalize_gauge(extr, Xt, scale_ref):
        t_norm = torch.linalg.vector_norm(extr[:, 1:, :3, 3], dim=-1).mean(dim=1)
        s = torch.where(t_norm > 1e-9, scale_ref / torch.clamp(t_norm, min=1e-9), 1.0)
        extr = extr.clone()
        extr[:, :, :3, 3] = extr[:, :, :3, 3] * s[:, None, None]
        return extr, Xt * s[None, :, None]

    scale_ref = torch.linalg.vector_norm(extr_init[:, 1:, :3, 3], dim=-1).mean(dim=1)
    extr = best_extr = extr_init
    Xt = best_Xt = X_init.permute(2, 0, 1)  # (3, B, P)
    damp = torch.full_like(scale_ref, lm_init)
    best_r = torch.full_like(scale_ref, float("inf"))
    for _ in range(n_iterations):
        if retriangulate:
            Xt = _triangulate_pairwise_dlt(extr, cam_a, cam_b, xa, xb).permute(2, 0, 1)
        delta_c, delta_p, r_norm, ok = lm_step(extr, Xt, damp)
        improved = r_norm < best_r
        best_extr = torch.where(improved[:, None, None, None], extr, best_extr)
        best_Xt = torch.where(improved[None, :, None], Xt, best_Xt)
        best_r = torch.minimum(r_norm, best_r)
        damp = torch.where(improved, damp / lm_decrease, damp * lm_increase)
        extr_new = torch.where(ok[:, None, None, None], se3_exp(delta_c) @ extr, extr)
        Xt_new = torch.where(ok[None, :, None], Xt + delta_p, Xt)
        extr, Xt = normalize_gauge(extr_new, Xt_new, scale_ref)
    if retriangulate:
        Xt = _triangulate_pairwise_dlt(extr, cam_a, cam_b, xa, xb).permute(2, 0, 1)
    r_final = residual_system(extr, Xt)[6]
    improved = r_final < best_r
    best_extr = torch.where(improved[:, None, None, None], extr, best_extr)
    best_Xt = torch.where(improved[None, :, None], Xt, best_Xt)
    return best_extr, best_Xt.permute(1, 2, 0)
