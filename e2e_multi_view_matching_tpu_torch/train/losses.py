"""Loss assembly: the Sinkhorn match NLL and the two-stage blend (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/train/losses.py` for stage 1 (match
loss only). The pose loss of stage 2 differentiates the weighted eight-point
solve, which needs the eigen-solver's gradient; it comes with that slice, and
`matcher_losses(pose_loss=True)` raises until then instead of returning a
value that could not be trained through.
"""

import torch


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
        pose_loss: stage 2; not ported yet.
    Returns:
        dict(match_loss, rot_loss, transl_loss) of scalars.
    """
    if pose_loss:
        raise NotImplementedError(
            "the pose loss (stage 2, --pose_loss) is not ported yet: it needs the "
            "gradient of the eight-point solve's eigen-decomposition (the safe_eigh "
            "JVP), which comes with the stage-2 slice")
    log_p = result["log_assignment"]  # (B, P, K+1, K+1)
    match_loss = sum(match_loss_of_pair(log_p[:, p], gt_indices[:, p], gt_weights[:, p])
                     for p in range(log_p.shape[1]))
    zero = torch.zeros((), dtype=log_p.dtype, device=log_p.device)
    return {"match_loss": match_loss, "rot_loss": zero, "transl_loss": zero}


def combine_losses(losses, n_pairs, pose_match_ratio, rot_weight, trans_weight):
    """Two-stage blend: (1 - ratio) * match + ratio * pose, per pair."""
    scaled = {k: v / float(n_pairs) for k, v in losses.items()}
    pose_loss = rot_weight * scaled["rot_loss"] + trans_weight * scaled["transl_loss"]
    total = (1.0 - pose_match_ratio) * scaled["match_loss"] + pose_match_ratio * pose_loss
    return total, scaled
