"""Multi-view pose pipeline: matcher outputs -> absolute extrinsics.

Counterpart of `e2e_multi_view_matching_tpu/mvba/pipeline.py`:

1. per-pair relative poses (stage A), by the init mode:
   - `w8pt_ba`: confidence-weighted eight-point with two
     epipolar-inlier-gated re-estimates, then two-view LM BA, over all B*P
     pairs on the device;
   - `ransac`: OpenCV's essential-matrix RANSAC of each pair on the host;
   - `ransac_ba`: the same, then one batched two-view LM BA on the device;
2. maximum-spanning-tree chaining into initial absolute poses;
3. robust rotation + translation averaging;
4. confidence-weighted multi-camera Schur LM BA, camera 0 fixed.

`multi_view_pose_device` is the `w8pt_ba` pipeline with the tuple axis written
out and no host sync, so an eval chunk is queued on the device in one pass of
the host. `multi_view_pose_pipeline_batch` is the host-tree pipeline of every
init mode: stage A, one packed copy of the relative poses, inlier counts and
validity to the host, the trees there, then steps 3-4 on the device.
"""

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from e2e_multi_view_matching_tpu_torch.geom.eightpoint import estimate_relative_pose_w8pt
from e2e_multi_view_matching_tpu_torch.geom.epipolar import normalize_keypoints
from e2e_multi_view_matching_tpu_torch.geom.ransac import estimate_pose_ransac
from e2e_multi_view_matching_tpu_torch.mvba.bundle_adjust import (
    _triangulate_pairwise,
    bundle_adjust_multi_view,
)
from e2e_multi_view_matching_tpu_torch.mvba.rotation_averaging import rotation_averaging
from e2e_multi_view_matching_tpu_torch.mvba.spanning_tree import (
    spanning_tree_poses,
    spanning_tree_poses_device,
)
from e2e_multi_view_matching_tpu_torch.mvba.translation_averaging import (
    edge_directions,
    translation_averaging,
)
from e2e_multi_view_matching_tpu_torch.pose.two_view_ba import bundle_adjust_two_view
from e2e_multi_view_matching_tpu_torch.utils.config import (
    fetch_packed,
    resolve_device,
    to_device,
)

INIT_MODES = ("w8pt_ba", "ransac", "ransac_ba")


@dataclass(frozen=True)
class MultiViewPipelineConfig:
    conf_thresh: float = 0.0
    min_inliers: int = 20
    two_view_ba_iterations: int = 10
    ba_iterations: int = 20
    ba_retriangulate: bool = False
    # per-pair relative-pose init: "w8pt_ba" (IRLS w8pt + LM BA on the
    # device), "ransac" (OpenCV essential RANSAC on the host), "ransac_ba"
    # (RANSAC, then one batched two-view BA on the device)
    init_mode: str = "w8pt_ba"
    ransac_thresh: float = 1.0  # pixels


def _pair_list(V):
    """The pairs [(i, j) for j < V for i < j], the order of `pair_indices`."""
    return [(i, j) for j in range(V) for i in range(j)]


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


def _ransac_relative_poses(kpts_i, kpts_j, intr_i, intr_j, conf, cfg, device):
    """Host RANSAC of each pair, then (`ransac_ba`) one batched two-view BA.

    OpenCV's essential RANSAC (`geom/ransac.py`) on the matches with conf > 0
    (at least 5 a pair), and the confidences of its inliers for the BA
    observations; `ransac_ba` then refines every pose with the two-view LM BA
    (`cfg.two_view_ba_iterations`) in one batch over all pairs on `device`,
    and keeps the refined pose where the BA's gate and the RANSAC pose are
    both valid. The refined poses come back in one packed copy.

    The pairs' RANSAC calls run on a thread pool: OpenCV releases the GIL in
    them, and each call seeds its own random generator, so every pair gets
    the pose of a call on its own (the tests hold it bit for bit against the
    JAX package's sequential loop). A pair whose matches are all wrong runs
    RANSAC to its iteration cap, tenths of a second of host time.

    Args:
        kpts_i, kpts_j: (BP, K, 2) float32 numpy pixel coordinates of view i's
            keypoints and of their matches in view j; intr_i, intr_j:
            (BP, 3, 3) float32; conf: (BP, K) float32, 0 marks no match.
    Returns:
        numpy (T_rel (BP, 4, 4) float32, inlier_count (BP,) int32,
        valid (BP,) bool, conf_gated (BP, K) float32).
    """
    BP, K = conf.shape
    T_rel = np.broadcast_to(np.eye(4, dtype=np.float32), (BP, 4, 4)).copy()
    pose_valid = np.zeros(BP, bool)
    inlier_count = np.zeros(BP, np.int32)
    conf_gated = np.zeros_like(conf)
    sel = conf > 0.0

    def ransac(p):
        if sel[p].sum() < 5:
            return None
        return estimate_pose_ransac(kpts_i[p][sel[p]], kpts_j[p][sel[p]], intr_i[p],
                                    intr_j[p], thresh=cfg.ransac_thresh)

    with ThreadPoolExecutor() as pool:
        rets = list(pool.map(ransac, range(BP)))
    for p, ret in enumerate(rets):
        if ret is None:
            continue
        R, t, inl = ret
        T_rel[p, :3, :3] = R
        T_rel[p, :3, 3] = t
        pose_valid[p] = True
        inlier_count[p] = int(inl.sum())
        gate = np.zeros(K, bool)
        gate[np.flatnonzero(sel[p])[inl]] = True
        conf_gated[p] = np.where(gate, conf[p], 0.0)

    if cfg.init_mode == "ransac_ba":
        x_i = normalize_keypoints(to_device(kpts_i, device), to_device(intr_i, device))
        x_j = normalize_keypoints(to_device(kpts_j, device), to_device(intr_j, device))
        T_ba, ok = bundle_adjust_two_view(x_i, x_j, to_device(conf_gated, device),
                                          to_device(T_rel, device),
                                          n_iterations=cfg.two_view_ba_iterations)
        T_ba, ok = fetch_packed([T_ba, ok])
        ok = (ok > 0.5) & pose_valid
        T_rel = np.where(ok[:, None, None], T_ba, T_rel)
    return T_rel, inlier_count, pose_valid, conf_gated


def _ransac_stage_a(kpts, intr, matches0, conf, cfg, device):
    """Stage A of the RANSAC init modes from host arrays: the matched
    coordinates gathered on the host by indexing alone (no arithmetic, so
    OpenCV sees the matcher's float32 values bit for bit), `conf_m` as the
    device stage A builds it, then `_ransac_relative_poses`. T_rel, counts
    and validity stay on the host (CPU tensors); the rest goes to `device`."""
    kpts = np.asarray(kpts, np.float32)
    intr = np.asarray(intr, np.float32)[..., :3, :3]
    matches0 = np.asarray(matches0).astype(np.int64)  # exact: K < 2**24 in float32
    conf = np.asarray(conf, np.float32)
    B, V, K, _ = kpts.shape
    pairs = _pair_list(V)
    P = len(pairs)
    idx_i = np.asarray([p[0] for p in pairs])
    idx_j = np.asarray([p[1] for p in pairs])
    kpts_i = kpts[:, idx_i]  # (B, P, K, 2)
    gather = np.clip(matches0, 0, K - 1)
    kpts_j = np.take_along_axis(kpts[:, idx_j], gather[..., None], axis=2)
    valid = (matches0 >= 0) & (conf > cfg.conf_thresh)
    conf_m = np.where(valid, conf, np.float32(0.0))
    intr_i = intr[:, idx_i]  # (B, P, 3, 3)
    intr_j = intr[:, idx_j]
    T_rel, inlier_count, pose_valid, conf_gated = _ransac_relative_poses(
        kpts_i.reshape(B * P, K, 2), kpts_j.reshape(B * P, K, 2),
        intr_i.reshape(B * P, 3, 3), intr_j.reshape(B * P, 3, 3),
        conf_m.reshape(B * P, K), cfg, device)
    return {
        "T_rel": torch.from_numpy(T_rel).reshape(B, P, 4, 4),
        "counts": torch.from_numpy(inlier_count).reshape(B, P),
        "valid": torch.from_numpy(pose_valid).reshape(B, P),
        "conf_gated": to_device(conf_gated.reshape(B, P, K), device),
        "x_i_n": normalize_keypoints(to_device(kpts_i, device), to_device(intr_i, device)),
        "x_j_n": normalize_keypoints(to_device(kpts_j, device), to_device(intr_j, device)),
    }


def multi_view_pose_from_stage_a(stage_a, cfg=MultiViewPipelineConfig(), profile=None):
    """Host spanning trees + averaging/BA from the output of a stage A.

    One packed copy of T_rel, the inlier counts and the validity to the host
    (`fetch_packed`; no copy where stage A left them on the host, as the
    RANSAC modes do), the maximum spanning tree of each tuple there, then
    the batched averaging + BA (`_global_stage_impl`) on the device of the
    observations, whose extrinsics come back in one more copy.

    Args:
        stage_a: dict as `multi_view_pose_stage_a` returns it.
        profile: optional dict; gets `stage_a_fetch_s`, `tree_host_s` and
            `stage_b_s` (wall seconds, the device synchronised at each border).
    Returns:
        (B, V, 4, 4) float32 numpy extrinsics.
    """
    t0 = time.perf_counter()
    B, P, K = stage_a["conf_gated"].shape
    V = int(round((1 + np.sqrt(1 + 8 * P)) / 2))
    pairs = _pair_list(V)
    dev = stage_a["conf_gated"].device
    T_rel_np, counts_np, valid_np = fetch_packed(
        [stage_a["T_rel"], stage_a["counts"], stage_a["valid"]])
    counts_np = counts_np.astype(np.int32)
    valid_np = valid_np > 0.5
    if profile is not None:
        if dev.type == "cuda":  # stage A's queued uploads and normalization
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        profile["stage_a_fetch_s"] = t1 - t0
        t0 = t1

    extr_tree = np.zeros((B, V, 4, 4), np.float32)
    edge_valid = np.zeros((B, P), bool)
    for b in range(B):
        rel = {pairs[p]: T_rel_np[b, p] for p in range(P) if valid_np[b, p]}
        cnt = {pairs[p]: int(counts_np[b, p]) for p in range(P) if valid_np[b, p]}
        extr_tree[b], tree = spanning_tree_poses(V, rel, cnt)
        tree_set = set(tree)
        # edges entering the averaging: valid pairs with enough inliers or on the tree
        edge_valid[b] = [valid_np[b, p]
                         and (counts_np[b, p] >= cfg.min_inliers or pairs[p] in tree_set)
                         for p in range(P)]
    if profile is not None:
        t1 = time.perf_counter()
        profile["tree_host_s"] = t1 - t0
        t0 = t1

    idx_i, idx_j = pair_indices(V, dev)
    extr = _global_stage_impl(
        to_device(extr_tree, dev), idx_i, idx_j, stage_a["T_rel"].to(dev, non_blocking=True),
        to_device(edge_valid, dev) > 0.5,
        stage_a["x_i_n"].reshape(B, P * K, 2), stage_a["x_j_n"].reshape(B, P * K, 2),
        stage_a["conf_gated"].reshape(B, P * K),
        idx_i.repeat_interleave(K), idx_j.repeat_interleave(K), cfg)
    out = fetch_packed([extr])[0]
    if profile is not None:
        profile["stage_b_s"] = time.perf_counter() - t0
    return out


def multi_view_pose_pipeline_batch(kpts, intr, matches0, conf, cfg=MultiViewPipelineConfig(),
                                   profile=None, device="cuda"):
    """Absolute extrinsics of a batch of view tuples, through the host trees.

    Stage A by `cfg.init_mode` (`w8pt_ba`: `multi_view_pose_stage_a` on the
    device; `ransac`, `ransac_ba`: `_ransac_stage_a` from host arrays), then
    `multi_view_pose_from_stage_a`.

    Args (host arrays):
        kpts: (B, V, K, 2) pixel keypoints per view.
        intr: (B, V, 3|4, 3|4) intrinsics.
        matches0: (B, P, K) match index into view j per pair (integer, or
            float32 with exact values as `fetch_packed` returns it), -1 =
            unmatched; pairs ordered as `pair_indices`.
        conf: (B, P, K) per-match confidences.
        profile: optional dict; filled with wall seconds per stage (`stage_a_s`
            stage A with its copy to the host, `tree_host_s` the trees,
            `stage_b_s` averaging + BA with the copy of the extrinsics).
        device: "cuda" by default; raises if no GPU is present.
    Returns:
        (B, V, 4, 4) float32 numpy extrinsics (world->cam, camera 0 = identity
        frame).
    """
    device = resolve_device(device)
    if cfg.init_mode not in INIT_MODES:
        raise ValueError(f"init_mode {cfg.init_mode!r} is not one of {INIT_MODES}")
    t0 = time.perf_counter()
    if cfg.init_mode == "w8pt_ba":
        stage_a = multi_view_pose_stage_a(
            *(to_device(x, device) for x in (kpts, intr, matches0, conf)), cfg)
    else:
        stage_a = _ransac_stage_a(kpts, intr, matches0, conf, cfg, device)
    out = multi_view_pose_from_stage_a(stage_a, cfg, profile=profile)
    if profile is not None:
        profile.pop("stage_a_fetch_s", None)
        profile["stage_a_s"] = (time.perf_counter() - t0) - (
            profile["tree_host_s"] + profile["stage_b_s"])
    return out


def multi_view_pose_pipeline(kpts, intr, matches0, conf, cfg=MultiViewPipelineConfig(),
                             device="cuda"):
    """`multi_view_pose_pipeline_batch` of one tuple: kpts (V, K, 2), intr
    (V, 3|4, 3|4), matches0 and conf (P, K) -> (V, 4, 4) numpy extrinsics."""
    return multi_view_pose_pipeline_batch(kpts[None], intr[None], matches0[None], conf[None],
                                          cfg, device=device)[0]
