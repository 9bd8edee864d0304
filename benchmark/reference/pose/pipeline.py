"""The `w8pt_ba` pose stage on the device: matcher outputs -> absolute extrinsics.

Frozen copy of the device path of the port's `mvba/pipeline.py`
(`multi_view_pose_device` and what it calls), kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.
"""

from dataclasses import dataclass

import torch

from .bundle_adjust import _triangulate_pairwise, bundle_adjust_multi_view
from .eightpoint import estimate_relative_pose_w8pt
from .epipolar import normalize_keypoints
from .rotation_averaging import rotation_averaging
from .spanning_tree import spanning_tree_poses_device
from .translation_averaging import edge_directions, translation_averaging
from .two_view_ba import bundle_adjust_two_view


@dataclass(frozen=True)
class MultiViewPipelineConfig:
    """The port's defaults of the `w8pt_ba` mode."""
    conf_thresh: float = 0.0
    min_inliers: int = 20
    two_view_ba_iterations: int = 10
    ba_iterations: int = 20
    ba_retriangulate: bool = False

def pair_indices(V, device):
    """(idx_i, idx_j) int64 tensors of the pairs [(i, j) for j < V for i < j],
    built on `device` (the lower triangle of (j, i), row-major)."""
    idx_j, idx_i = torch.tril_indices(V, V, -1, device=device)
    return idx_i, idx_j

def robust_relative_poses(kpts_i, kpts_j_matched, intr_i, intr_j, conf, n_iterations,
                          n_irls=2):
    """Robust w8pt + two-view BA for a batch of pairs.

    Args:
        kpts_i: (P, K, 2) keypoints of view i; kpts_j_matched: (P, K, 2) matched
        coordinates in view j; intr_i, intr_j: (P, 3, 3); conf: (P, K), 0 marks
        invalid matches.
    Returns:
        (T_rel (P, 4, 4), inlier_count (P,) int32, valid (P,), conf_gated (P, K)).
    """
    conf_cur = conf
    T_w8, info = estimate_relative_pose_w8pt(
        kpts_i, kpts_j_matched, intr_i, intr_j, conf_cur, determine_inliers=True)
    for _ in range(n_irls):
        gated = torch.where(info.inliers, conf, 0.0)
        # keep the previous weighting when gating would leave < 8 matches
        enough = torch.sum(gated > 0, dim=-1) >= 8
        conf_cur = torch.where(enough[:, None], gated, conf_cur)
        T_w8, info = estimate_relative_pose_w8pt(
            kpts_i, kpts_j_matched, intr_i, intr_j, conf_cur, determine_inliers=True)
    inlier_count = torch.sum(info.inliers, dim=-1, dtype=torch.int32)
    keep = info.pos_depth_mask & info.inliers
    conf_gated = torch.where(keep, conf, 0.0)
    conf_ba = torch.where(keep, info.confidence, 0.0)
    T_ba, valid_ba = bundle_adjust_two_view(
        info.kpts0_norm, info.kpts1_norm, conf_ba, T_w8, n_iterations=n_iterations)
    T_rel = torch.where(valid_ba[:, None, None], T_ba, T_w8)
    return T_rel, inlier_count, info.valid, conf_gated

def multi_view_pose_stage_a(kpts, intr, matches0, conf, cfg=MultiViewPipelineConfig()):
    """Matcher outputs -> per-pair relative poses.

    Args:
        kpts (B, V, K, 2), intr (B, V, 3|4, 3|4), matches0 (B, P, K) index into
        view j or -1, conf (B, P, K); pairs ordered as `pair_indices`.
    Returns:
        dict: T_rel (B, P, 4, 4); counts (B, P) int32; valid (B, P) bool;
        conf_gated (B, P, K); x_i_n, x_j_n (B, P, K, 2) normalized observations.
    """
    intr = intr[..., :3, :3]
    B, V, K, _ = kpts.shape
    idx_i, idx_j = pair_indices(V, kpts.device)
    P = idx_i.shape[0]
    kpts_i = kpts[:, idx_i]  # (B, P, K, 2)
    gather = torch.clamp(matches0, 0, K - 1).to(torch.int64)
    kpts_j = torch.gather(kpts[:, idx_j], 2, gather[..., None].expand(B, P, K, 2))
    valid = (matches0 >= 0) & (conf > cfg.conf_thresh)
    conf_m = torch.where(valid, conf, 0.0)
    intr_i = intr[:, idx_i]
    intr_j = intr[:, idx_j]
    T_rel, inlier_count, pose_valid, conf_gated = robust_relative_poses(
        kpts_i.reshape(B * P, K, 2), kpts_j.reshape(B * P, K, 2),
        intr_i.reshape(B * P, 3, 3), intr_j.reshape(B * P, 3, 3),
        conf_m.reshape(B * P, K), cfg.two_view_ba_iterations)
    return {
        "T_rel": T_rel.reshape(B, P, 4, 4),
        "counts": inlier_count.reshape(B, P),
        "valid": pose_valid.reshape(B, P),
        "conf_gated": conf_gated.reshape(B, P, K),
        "x_i_n": normalize_keypoints(kpts_i, intr_i),
        "x_j_n": normalize_keypoints(kpts_j, intr_j),
    }

def _global_stage_impl(extr_tree, edges_i, edges_j, T_rel, edge_valid, x_i, x_j, w,
                       cam_a, cam_b, cfg):
    """Averaging + BA from tree-initialized extrinsics, per tuple.

    The tuple axis is written out, so this is also the counterpart of the JAX
    package's `_global_stage_batch` (its vmap over tuples).

    Args:
        extr_tree: (B, V, 4, 4); edges_*: (E,); T_rel: (B, E, 4, 4);
        edge_valid: (B, E); x_i, x_j: (B, P, 2) normalized observations;
        w: (B, P); cam_a, cam_b: (P,).
    """
    R_avg = rotation_averaging(extr_tree[..., :3, :3], edges_i, edges_j,
                               T_rel[..., :3, :3], edge_valid)
    c_tree = -torch.einsum("bvji,bvj->bvi", extr_tree[..., :3, :3], extr_tree[..., :3, 3])
    gamma = edge_directions(R_avg[:, edges_i], T_rel[..., :3, :3], T_rel[..., :3, 3])
    c_avg = translation_averaging(c_tree, edges_i, edges_j, gamma, edge_valid)
    t_avg = -torch.einsum("bvij,bvj->bvi", R_avg, c_avg)
    extr = torch.zeros_like(extr_tree)
    extr[..., :3, :3] = R_avg
    extr[..., :3, 3] = t_avg
    extr[..., 3, 3] = 1.0

    # observation confidences normalized to a total of 2 per tuple
    w_sum = torch.clamp(torch.sum(w, dim=-1, keepdim=True) * 2.0, min=1e-6)
    w_n = w / (0.5 * w_sum) * 2.0
    # averaging failure (underconstrained pose graph): keep the tree init
    avg_ok = torch.isfinite(extr).flatten(1).all(dim=1)[:, None, None, None]
    extr = torch.where(avg_ok, extr, extr_tree)
    X0 = _triangulate_pairwise(extr, cam_a, cam_b, x_i, x_j)
    extr_ba, _ = bundle_adjust_multi_view(extr, X0, cam_a, cam_b, x_i, x_j, w_n,
                                          n_iterations=cfg.ba_iterations,
                                          retriangulate=cfg.ba_retriangulate)
    ba_ok = torch.isfinite(extr_ba).flatten(1).all(dim=1)[:, None, None, None]
    return torch.where(ba_ok, extr_ba, extr)

def multi_view_pose_device(kpts, intr, matches0, conf, cfg=MultiViewPipelineConfig()):
    """The complete `w8pt_ba` pipeline on the device, with no host sync.

    Args:
        kpts: (B, V, K, 2) pixel keypoints per view.
        intr: (B, V, 3|4, 3|4) intrinsics.
        matches0: (B, P, K) int match index into view j per pair, -1 = unmatched.
        conf: (B, P, K) per-match confidences.
    Returns:
        (B, V, 4, 4) extrinsics (world->cam, camera 0 = identity frame), on the
        device of the inputs.
    """
    stage_a = multi_view_pose_stage_a(kpts, intr, matches0, conf, cfg)
    B, P, K = stage_a["conf_gated"].shape
    V = kpts.shape[1]
    idx_i, idx_j = pair_indices(V, kpts.device)
    T_rel, counts, valid = stage_a["T_rel"], stage_a["counts"], stage_a["valid"]
    extr_tree, on_tree = spanning_tree_poses_device(T_rel, counts, valid, idx_i, idx_j, V)
    # edges entering the averaging: valid pairs with enough inliers or on the tree
    edge_valid = valid & ((counts >= cfg.min_inliers) | on_tree)
    return _global_stage_impl(
        extr_tree, idx_i, idx_j, T_rel, edge_valid,
        stage_a["x_i_n"].reshape(B, P * K, 2), stage_a["x_j_n"].reshape(B, P * K, 2),
        stage_a["conf_gated"].reshape(B, P * K),
        idx_i.repeat_interleave(K), idx_j.repeat_interleave(K), cfg)
