"""Confidence-weighted eight-point relative pose estimation (PyTorch).

Frozen copy of the port's `geom/eightpoint.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/geom/eightpoint.py`: the weighted
DLT null vector from the 9x9 Gram matrix, the rank-2 projection from 3x3 Gram
inverse iteration, and a branchless cheirality (or closest-to-target) choice
among the four decompositions. Invalid matches carry zero confidence.
"""

from typing import NamedTuple, Optional

import torch

from .epipolar import (
    cheirality_scores,
    hartley_normalize,
    motion_from_essential,
    normalize_keypoints,
    sym_epipolar_distance,
    two_ray_depths,
)
from .lie import make_transform
from .linalg import smallest_eigvec_ii, weighted_nullvec
from .metrics import (
    rotation_angle_error,
    translation_angle_error,
)

_EPS = 1e-8


class W8ptInfo(NamedTuple):
    """Side outputs of `estimate_relative_pose_w8pt`."""

    kpts0_norm: torch.Tensor  # (B, N, 2)
    kpts1_norm: torch.Tensor  # (B, N, 2)
    confidence: torch.Tensor  # (B, N) normalized weights
    inliers: Optional[torch.Tensor]  # (B, N) bool or None
    pos_depth_mask: torch.Tensor  # (B, N) bool
    F: torch.Tensor  # (B, 3, 3) fundamental (in normalized coords = essential)
    valid: torch.Tensor  # (B,) bool: enough effective matches


def _rank2_project(Fm):
    """Project (..., 3, 3) onto the rank-2 manifold: F - sigma3 u3 v3^T."""
    v3 = smallest_eigvec_ii(Fm.transpose(-1, -2) @ Fm, n_iters=4)
    u3 = smallest_eigvec_ii(Fm @ Fm.transpose(-1, -2), n_iters=4)
    sigma3 = torch.einsum("...i,...ij,...j->...", u3, Fm, v3)
    return Fm - sigma3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def find_fundamental_weighted(x0, x1, w):
    """Weighted 8-point DLT on camera-normalized correspondences x0, x1 (B, N, 2)
    with weights w (B, N) -> (B, 3, 3) rank-2, Frobenius-normalized."""
    x0n, T0 = hartley_normalize(x0, w)
    x1n, T1 = hartley_normalize(x1, w)
    xa, ya = x0n[..., 0], x0n[..., 1]
    xb, yb = x1n[..., 0], x1n[..., 1]
    X = torch.stack([xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya,
                     torch.ones_like(xa)], dim=-1)
    # rows are multiplied by w before the solve, so the Gram weights are w^2
    f = weighted_nullvec(X, w * w)
    Fm = _rank2_project(f.reshape(f.shape[:-1] + (3, 3)))
    Fm = T1.transpose(-1, -2) @ Fm @ T0
    return Fm / (torch.linalg.matrix_norm(Fm, keepdim=True) + _EPS)


def estimate_relative_pose_w8pt(kpts0, kpts1, intr0, intr1, confidence,
                                choose_closest=False, target_T021=None,
                                determine_inliers=False):
    """Confidence-weighted eight-point relative pose.

    Args:
        kpts0, kpts1: (B, N, 2) pixel coordinates; intr0, intr1: (B, 3|4, 3|4).
        confidence: (B, N) or (B, N, 1) non-negative match confidences.
        choose_closest: pick the candidate closest to `target_T021` (B, 4, 4)
            instead of by cheirality.
        determine_inliers: also compute the symmetric-epipolar inlier mask.
    Returns:
        (T021 (B, 4, 4), W8ptInfo).
    """
    if confidence.dim() == kpts0.dim():
        confidence = confidence[..., 0]
    conf = confidence / (torch.sum(confidence, dim=-1, keepdim=True) + 1e-6)
    x0 = normalize_keypoints(kpts0, intr0)
    x1 = normalize_keypoints(kpts1, intr1)
    Fm = find_fundamental_weighted(x0, x1, conf)

    Rs, ts = motion_from_essential(Fm)  # (B, 4, 3, 3), (B, 4, 3)
    if choose_closest:
        if target_T021 is None:
            raise ValueError("choose_closest requires target_T021")
        cand_T = make_transform(Rs, ts)
        tgt = target_T021[..., None, :, :]
        err = (rotation_angle_error(cand_T, tgt, reduce=False)
               + translation_angle_error(cand_T, tgt, reduce=False))
        best = torch.argmin(err, dim=-1)
    else:
        best = torch.argmax(cheirality_scores(Rs, ts, x0, x1, conf), dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    T021 = make_transform(R, t)

    depth0, depth1 = two_ray_depths(R, t, x0, x1)
    pos_depth = (depth0 > 0.0) & (depth1 > 0.0)

    inliers = None
    if determine_inliers:
        epi = sym_epipolar_distance(x0, x1, Fm, squared=True)
        fbar = (intr0[..., 0, 0] + intr0[..., 1, 1]
                + intr1[..., 0, 0] + intr1[..., 1, 1]) / 4.0
        inliers = pos_depth & (torch.sqrt(epi + _EPS) <= (3.0 / fbar)[..., None])

    valid = torch.sum((confidence > 0).to(torch.int32), dim=-1) >= 8
    info = W8ptInfo(kpts0_norm=x0, kpts1_norm=x1, confidence=conf, inliers=inliers,
                    pos_depth_mask=pos_depth, F=Fm, valid=valid)
    return T021, info
