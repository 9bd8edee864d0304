"""The numbers that decide `correct`: each layer of the timed path against
the plain reference, on the same inputs.

The reference follows the program stage by stage: the matcher's GNN runs on
the keypoints, scores and descriptors that the program's SuperPoint
returned, the pair scores and the Sinkhorn on the program's projected
descriptors, the confidence head on those and the program's matches, and
the pose stage on the program's keypoints, matches and confidences, once
each of those has been judged against its own reference (discrete steps
such as the top-K or mutual-best matches make any other order compare
different problems). Each reading is a largest gap over the
judged outputs:

- `kp_gap`: how far below the reference's K-th best detection score (or the
  threshold, where fewer than K clear it) the reference scores a keypoint
  that the program kept, or, where the reference's NMS suppresses it, below
  its window's best; and how far above the threshold the reference scores
  the best detection the program left out; 1 where the program keeps a
  pixel twice. Probabilities.
- `score_err`, `desc_err`: the program's scores and unit descriptors against
  the reference's (before NMS) at the program's keypoints.
- `gnn_err`: the projected descriptors that the pair scores are taken
  from, the largest gap over the reference's largest magnitude.
- `sinkhorn_err`: the log assignment (the pair scores and the dustbin
  Sinkhorn), the largest gap in log units.
- `matches_off`: the program's matches that the mutual-best rule does not
  take from the program's own log assignment (an exact count).
- `conf_err`: the confidences of every row.
- `pose_gap`: the pair pose errors (degrees) that the program's eval loop
  returned against the reference pose stage's.
- training: `loss_gap` (relative, worst of the steps), `grad_gap` and
  `change_gap` (worst leaf; see `leaf_gap`).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .matcher import extract_matches
from .superpoint import sample_descriptors


def merge(readings, new):
    """Fold the readings `new` of one unit into `readings`, the worst of the
    units so far; a reading that is not a number reads infinite."""
    for k, v in new.items():
        v = float(v) if np.isfinite(v) else np.inf
        readings[k] = max(readings.get(k, 0.0), v)
    return readings


def keypoint_readings(raw, nms, desc_map, kpts, scores, descs, threshold, radius):
    """Readings of one batch of frames. raw and nms (N, H8, W8), the score
    maps before and after NMS, and desc_map (N, Hc, Wc, D) are the
    reference's; kpts (N, K, 2), scores (N, K) and descs (N, K, D) the
    program's, whose valid slots have a score above 0.

    A kept keypoint reads how far its reference score lies below the
    reference's K-th best detection (or the threshold), and, where the
    reference's NMS suppresses it, how far below the largest score of its
    (2 radius + 1)^2 window: a suppression that rounding decides reads at
    rounding's size, not the score's."""
    N, H8, W8 = raw.shape
    K = kpts.shape[1]
    flat_raw = raw.reshape(N, -1)
    ranked = torch.topk(nms.reshape(N, -1), K).values  # (N, K) descending
    x = kpts[..., 0].round().to(torch.int64).clamp(0, W8 - 1)
    y = kpts[..., 1].round().to(torch.int64).clamp(0, H8 - 1)
    idx = y * W8 + x
    at = torch.gather(flat_raw, 1, idx)
    kept = torch.gather(nms.reshape(N, -1), 1, idx) > 0
    size = 2 * radius + 1
    window = F.max_pool2d(raw[:, None], size, stride=1, padding=radius)[:, 0].reshape(N, -1)
    nms_gap = torch.where(kept, 0.0, torch.gather(window, 1, idx) - at)
    valid = scores > 0
    floor = torch.maximum(ranked[:, -1], torch.tensor(threshold, device=raw.device))
    gap = torch.where(valid, torch.maximum((floor[:, None] - at).clamp_min(0), nms_gap),
                      0.0).amax()
    # the best detection the program left out: the reference's
    # (n_valid + 1)-th score above the threshold
    n_valid = valid.sum(dim=1)
    nxt = torch.gather(ranked, 1, n_valid.clamp(max=K - 1)[:, None])[:, 0]
    missed = torch.where(n_valid < K, (nxt - threshold).clamp_min(0), 0.0).amax()
    gap = torch.maximum(gap, missed)
    slots = torch.where(valid, idx, -1 - torch.arange(K, device=raw.device))
    dupes = sum(int(torch.unique(row).numel() != K) for row in slots)
    score_err = torch.where(valid, (scores - at).abs(), 0.0).amax()
    desc_err = (descs - sample_descriptors(kpts, desc_map)).abs().amax()
    return {"kp_gap": 1.0 if dupes else float(gap), "score_err": float(score_err),
            "desc_err": float(desc_err)}


def matcher_readings(ref_mdesc, ref_log_p, ref_conf, prog, threshold):
    """Readings of one sub-chunk's matcher, each stage on the program's
    outputs of the stage before: `ref_mdesc` (B, V, K, D), the reference's
    projected descriptors from the program's keypoints; `ref_log_p` (B, P,
    K+1, K+1), the reference's pair scores and Sinkhorn from the program's
    projected descriptors; `ref_conf` (B, P, K), the reference's confidence
    head on the program's descriptors and matches. `prog` holds the
    program's "mdesc", "log_assignment", "matches0" and "conf_scores"."""
    mdesc = prog["mdesc"].reshape(ref_mdesc.shape)
    gnn_err = (mdesc - ref_mdesc).abs().amax() / ref_mdesc.abs().amax()
    L = prog["log_assignment"]
    B, P, F = L.shape[:3]
    m0, _, _ = extract_matches(L.reshape(B * P, F, F), threshold)
    off = int((m0.reshape(prog["matches0"].shape) != prog["matches0"]).sum())
    return {"gnn_err": float(gnn_err),
            "sinkhorn_err": float((L - ref_log_p).abs().amax()),
            "matches_off": float(off),
            "conf_err": float((prog["conf_scores"] - ref_conf).abs().amax())}


def pair_errors(poses, extr):
    """(n, P, 3) (pose, translation, rotation) errors in degrees of every
    pair (i < j, ordered by j) of n tuples: cam->world ground truth `poses`
    (n, V, 4, 4) against estimated world->cam extrinsics `extr`; the eval
    loop's formula."""
    n, V = poses.shape[:2]
    out = np.zeros((n, V * (V - 1) // 2, 3))
    for b in range(n):
        p = 0
        for jv in range(V):
            for iv in range(jv):
                T_gt = np.linalg.inv(poses[b, jv]) @ poses[b, iv]
                T = extr[b, jv] @ np.linalg.inv(extr[b, iv])
                cos_r = np.clip((np.trace(T_gt[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
                err_r = np.degrees(np.arccos(cos_r))
                nrm = np.linalg.norm(T_gt[:3, 3]) * np.linalg.norm(T[:3, 3])
                err_t = (np.degrees(np.arccos(np.clip(T_gt[:3, 3] @ T[:3, 3] / nrm, -1, 1)))
                         if nrm > 1e-9 else 0.0)
                out[b, p] = (max(err_t, err_r), err_t, err_r)
                p += 1
    return out


def pose_readings(ref_errors, prog_errors):
    """`pose_gap` of one sub-chunk: the widest gap between the two sides'
    pair errors; a non-finite error on either side reads infinite."""
    diff = np.abs(np.asarray(prog_errors, np.float64) - np.asarray(ref_errors, np.float64))
    return {"pose_gap": float(np.max(np.where(np.isfinite(diff), diff, np.inf)))}


def leaf_gap(prog_norms, ref_norms, keep=None):
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref‖ of the leaf, the median
    leaf's ‖ref‖), over the leaves `keep` selects (all by default)."""
    prog = np.asarray(prog_norms, np.float64)
    ref = np.asarray(ref_norms, np.float64)
    keep = np.ones(len(ref), bool) if keep is None else np.asarray(keep)
    scale = np.maximum(ref, np.median(ref[keep]))
    gap = np.abs(prog - ref) / scale
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)[keep]))


def training_readings(prog, ref, dead_share=1e-3):
    """Readings of three training steps. `prog` and `ref` hold "losses"
    (3,), "grad_norms" and "change_norms" (one per parameter, in one order).
    Leaves whose reference gradient is under `dead_share` of the median
    leaf's (nought to rounding, as a key's bias under softmax) move under
    Adam by round-off alone and are left out of the change."""
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    loss_gap = np.abs(lp - lr) / np.abs(lr)
    g = np.asarray(ref["grad_norms"], np.float64)
    live = g >= dead_share * np.median(g)
    return {"loss_gap": float(np.max(np.where(np.isfinite(loss_gap), loss_gap, np.inf))),
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], live)}
