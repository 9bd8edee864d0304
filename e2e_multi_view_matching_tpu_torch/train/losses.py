"""Loss assembly: the Sinkhorn match NLL, the pose loss through the weighted
eight-point solve, and the two-stage blend (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/train/losses.py`. The pose loss
(stage 2) differentiates `estimate_relative_pose_w8pt` with `choose_closest`,
through the gap-clamped gradient of `geom/linalg.py::safe_eigh`.
"""

import torch

from e2e_multi_view_matching_tpu_torch.geom.eightpoint import estimate_relative_pose_w8pt
from e2e_multi_view_matching_tpu_torch.geom.metrics import (
    rotation_angle_error,
    translation_angle_error,
)


def match_loss_of_pair(log_p, gt_indices, gt_weights):
    """Weighted NLL of one pair's log assignment.

    Args:
        log_p: (B, K+1, K+1); gt_indices: (B, 2, K+1) with -1 = dustbin;
        gt_weights: (B, 2, K+1).
    Returns:
        scalar loss, summed over the batch / B.
    """
    B, F, _ = log_p.shape
    # -1 means dustbin = last column/row, mapped explicitly
    idx0 = gt_indices[:, 0].to(torch.int64)
    idx1 = gt_indices[:, 1].to(torch.int64)
    idx0 = torch.where(idx0 < 0, F - 1, idx0)
    idx1 = torch.where(idx1 < 0, F - 1, idx1)
    l0 = -torch.gather(log_p, 2, idx0[..., None])[..., 0]
    l1 = -torch.gather(log_p.transpose(1, 2), 2, idx1[..., None])[..., 0]
    loss = (l0 * gt_weights[:, 0]).sum() + (l1 * gt_weights[:, 1]).sum()
    return loss / B


def matcher_losses(result, gt_indices, gt_weights, kpts, intr, poses, pose_loss):
    """Total match / rot / transl losses over all pairs of the tuple.

    Args:
        result: matcher output dict (stacked pair tensors).
        gt_indices, gt_weights: (B, P, 2, K+1) from `gt_matches_all_pairs`.
        kpts: (B, V, K, 2); intr: (B, V, 3|4, 3|4); poses: (B, V, 4, 4) cam->world
            (read by the pose loss only).
        pose_loss: include the differentiable pose loss (stage 2).
    Returns:
        dict(match_loss, rot_loss, transl_loss) of scalars.
    """
    log_p = result["log_assignment"]  # (B, P, K+1, K+1)
    B, P = log_p.shape[:2]
    match_loss = sum(match_loss_of_pair(log_p[:, p], gt_indices[:, p], gt_weights[:, p])
                     for p in range(P))
    zero = torch.zeros((), dtype=log_p.dtype, device=log_p.device)
    if not pose_loss:
        return {"match_loss": match_loss, "rot_loss": zero, "transl_loss": zero}
    # all P pairs as one (B*P)-batched w8pt; the reductions reproduce the
    # per-pair loop: rot = sum_p mean_B, transl = sum_p [sum_B(err * valid) /
    # max(sum_B valid, 1)]
    K = kpts.shape[2]
    pairs = result["pairs"].to(torch.int64)  # (P, 2), i < j, the matcher's order
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    # LU inverse like jnp.linalg.inv; the _ex variant checks no flag on the host
    target = torch.linalg.inv_ex(poses[:, j_idx])[0] @ poses[:, i_idx]  # (B, P, 4, 4)
    matches0 = result["matches0"]  # (B, P, K)
    conf = torch.where(matches0 >= 0, result["conf_scores"], 0.0)
    gather = torch.clamp(matches0, 0, K - 1).to(torch.int64)
    kpts_j = torch.gather(kpts[:, j_idx], 2, gather[..., None].expand(B, P, K, 2))
    BP = B * P
    isz = intr.shape[2:]
    target = target.reshape(BP, 4, 4)
    T_pred, _ = estimate_relative_pose_w8pt(
        kpts[:, i_idx].reshape(BP, K, 2), kpts_j.reshape(BP, K, 2),
        intr[:, i_idx].reshape((BP,) + isz), intr[:, j_idx].reshape((BP,) + isz),
        conf.reshape(BP, K), choose_closest=True, target_T021=target)
    rot_err = rotation_angle_error(T_pred, target, reduce=False)
    rot_loss = rot_err.reshape(B, P).mean(dim=0).sum()
    tr_err = translation_angle_error(T_pred, target, reduce=False)
    n = (torch.linalg.vector_norm(T_pred[..., :3, 3], dim=-1)
         * torch.linalg.vector_norm(target[..., :3, 3], dim=-1))
    valid = (n > 1e-6).reshape(B, P).to(tr_err.dtype)
    denom = torch.clamp(valid.sum(dim=0), min=1.0)  # per pair
    transl_loss = (tr_err.reshape(B, P).sum(dim=0) / denom).sum()
    return {"match_loss": match_loss, "rot_loss": rot_loss, "transl_loss": transl_loss}


def combine_losses(losses, n_pairs, pose_match_ratio, rot_weight, trans_weight):
    """Two-stage blend: (1 - ratio) * match + ratio * pose, per pair."""
    scaled = {k: v / float(n_pairs) for k, v in losses.items()}
    pose_loss = rot_weight * scaled["rot_loss"] + trans_weight * scaled["transl_loss"]
    total = (1.0 - pose_match_ratio) * scaled["match_loss"] + pose_match_ratio * pose_loss
    return total, scaled
