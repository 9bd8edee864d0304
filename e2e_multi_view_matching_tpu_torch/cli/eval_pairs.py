"""Two-view 1500-pair benchmark: SuperPoint -> two-view matcher -> relative pose.

Counterpart of `e2e_multi_view_matching_tpu/cli/eval_pairs.py`:

    python -m e2e_multi_view_matching_tpu_torch.cli.eval_pairs \
        --data_dir ... --checkpoint_dir ... --exp_name <run> \
        --dataset scannet|megadepth|yfcc100m [--eval_mode w8pt_ba] \
        [--assets_dir <pair lists>] [--device cpu]

`main()` evaluates the run's `model.ckpt` (a two-view matcher with the conf
MLP) and `superpoint.ckpt` on the fixed pair lists under `--assets_dir`
(LoFTR's `scannet_test_1500/test.npz` and `megadepth_test_1500_scene_info/`,
SuperGlue's `yfcc_test_pairs_with_gt.txt`), and writes pose AUC@5/10/20 to
`<exp_dir>/two_view_<mode>_<dataset>.json`. The relative pose of a pair comes
from one of five modes:
- `w8pt`, `w8pt_ba`, `w8pt_irls_ba`: SuperPoint, the matcher and the
  confidence-weighted eight-point solve (then the two-view BA, or the
  IRLS-gated solve and BA of `mvba/pipeline.py::robust_relative_poses`) run on
  the device, with no host sync inside a sub-chunk;
- `ransac`, `ransac_ba`: the matcher runs on the device, OpenCV's RANSAC of
  each pair on the host (`geom/ransac.py`), `ransac_ba` then refines it with
  the two-view BA on the device. Matches count above a confidence of 0.02
  in these modes and above 0 in the others.

`evaluate` groups the pairs into shape buckets (each side rounded up to a
multiple of `--shape_bucket`, images zero-padded onto the bucket's canvas,
SuperPoint given each image's true extent), keeps one open chunk per bucket
pair, pads every chunk to a full grid of `eval_scan` sub-chunks of
`eval_batch` pairs, and queues one chunk ahead of the one whose results it
copies back (one packed copy a chunk).

Not ported yet: `--data_parallel` above 1 (ROADMAP Queue 1 item 3).
"""

import argparse
import json
import logging
import os

import numpy as np
import torch

from e2e_multi_view_matching_tpu_torch.data.pairs import PairMatchingDataset
from e2e_multi_view_matching_tpu_torch.geom.eightpoint import estimate_relative_pose_w8pt
from e2e_multi_view_matching_tpu_torch.geom.metrics import pose_auc
from e2e_multi_view_matching_tpu_torch.geom.ransac import estimate_pose_ransac
from e2e_multi_view_matching_tpu_torch.models.matcher import (
    MatcherConfig,
    MultiViewMatcher,
    default_gnn_layers,
)
from e2e_multi_view_matching_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from e2e_multi_view_matching_tpu_torch.mvba.pipeline import robust_relative_poses
from e2e_multi_view_matching_tpu_torch.pose.two_view_ba import bundle_adjust_two_view
from e2e_multi_view_matching_tpu_torch.train.checkpoint import load_eval_weights
from e2e_multi_view_matching_tpu_torch.utils.config import (
    add_generic_arguments,
    fetch_packed,
    get_exp_dir,
    pad_to_grid,
    resolve_device,
    resolve_kernel_impls,
    strict_float32,
    to_device,
)

log = logging.getLogger("eval_pairs")

EVAL_MODES = ("ransac", "ransac_ba", "w8pt", "w8pt_ba", "w8pt_irls_ba")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate image pairs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser = add_generic_arguments(parser)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--eval_mode", type=str, default="w8pt_ba", choices=EVAL_MODES)
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--sinkhorn_iterations", type=int, default=100,
                        help="reference semantics (upstream SuperGlue default 100)")
    parser.add_argument("--eval_batch", type=int, default=8,
                        help="same-bucket pairs per sub-chunk (one SuperPoint + "
                             "matcher + pose batch)")
    parser.add_argument("--eval_scan", type=int, default=2,
                        help="sub-chunks per chunk; the host copies a chunk's "
                             "results back once")
    parser.add_argument("--shape_bucket", type=int, default=128,
                        help="pad images up to multiples of this, so that "
                             "variable-shape datasets (megadepth/yfcc, long side "
                             "1600) fill chunks per bucket pair instead of per "
                             "exact shape; SuperPoint masks the pad region before "
                             "NMS. 0 = exact-shape chunks")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="devices a chunk is sharded over (only 1 until "
                             "parallel/mesh.py is ported)")
    parser.add_argument("--assets_dir", type=str, default=None,
                        help="directory holding the LoFTR/SuperGlue pair lists "
                             "(default: <repo>/assets)")
    parser.add_argument("--allow_random_superpoint", action="store_true",
                        help="permit running with freshly initialized SuperPoint "
                             "weights when superpoint.ckpt is absent (meaningless "
                             "AUC; debugging only)")
    opt = parser.parse_args(argv)
    if opt.data_parallel != 1:
        parser.error("--data_parallel above 1 waits for the port of parallel/mesh.py "
                     "(ROADMAP Queue 1 item 3)")
    return opt


def relative_pose_errors(T_gt, R, t):
    """(translation, rotation) angle errors in degrees of (R, t) against T_gt."""
    cos_r = np.clip((np.trace(T_gt[:3, :3].T @ R) - 1) / 2, -1, 1)
    err_R = np.degrees(np.arccos(cos_r))
    n = np.linalg.norm(T_gt[:3, 3]) * np.linalg.norm(t)
    err_t = np.degrees(np.arccos(np.clip(T_gt[:3, 3] @ t / n, -1, 1))) if n > 1e-9 else 0.0
    return err_t, err_R


def infer_pairs(superpoint, matcher, images0, images1, image_size, valid0, valid1):
    """SuperPoint on both sides of B pairs, then the two-view matcher.

    Args:
        images0 (B, H0, W0, 1), images1 (B, H1, W1, 1): zero-padded onto the
        bucket's canvas; image_size (B, 2, 2): the true (h, w) of both sides,
        which also normalizes the keypoints, so that the bucketing is
        invisible downstream; valid0, valid1 (B, 2): the same extents.
    Returns:
        (kpts (B, 2, K, 2), matches0 (B, K), conf_scores (B, K)).
    """
    sp0 = superpoint(images0, valid0)
    sp1 = superpoint(images1, valid1)
    kpts = torch.stack([sp0["keypoints"], sp1["keypoints"]], dim=1)
    scores = torch.stack([sp0["scores"], sp1["scores"]], dim=1)
    descs = torch.stack([sp0["descriptors"], sp1["descriptors"]], dim=1)
    out = matcher(kpts, scores, descs, image_size)
    return kpts, out["matches0"][:, 0], out["conf_scores"][:, 0]


def pose_w8pt_batch(mode, kpts0, mk1, K0, K1, conf_w):
    """The batched pose of the w8pt modes: (T021 (B, 4, 4), valid (B,))."""
    if mode == "w8pt_irls_ba":
        # epipolar-inlier-gated IRLS re-estimates, then the two-view BA
        T_rel, _, valid, _ = robust_relative_poses(kpts0, mk1, K0, K1, conf_w, 10)
        return T_rel, valid
    T_w8, info = estimate_relative_pose_w8pt(kpts0, mk1, K0, K1, conf_w,
                                             determine_inliers=True)
    T_pred = T_w8
    if mode == "w8pt_ba":
        conf_ba = torch.where(info.pos_depth_mask, info.confidence, 0.0)
        T_ba, ok = bundle_adjust_two_view(info.kpts0_norm, info.kpts1_norm, conf_ba, T_w8,
                                          n_iterations=10)
        T_pred = torch.where(ok[:, None, None], T_ba, T_w8)
    return T_pred, info.valid


def infer_pose_subchunk(superpoint, matcher, mode, images0, images1, image_size, valid0,
                        valid1, K0, K1, match_threshold=0.0):
    """A w8pt-mode sub-chunk on the device, no host sync: `infer_pairs`, the
    confidence weights of the matches above `match_threshold`, and
    `pose_w8pt_batch` with K0, K1 (B, 3, 3). Returns (T021 (B, 4, 4), valid (B,))."""
    kpts, matches, conf = infer_pairs(superpoint, matcher, images0, images1, image_size,
                                      valid0, valid1)
    conf_w = torch.where((matches >= 0) & (conf > match_threshold), conf, 0.0)
    gather = torch.clamp(matches, 0, kpts.shape[2] - 1).to(torch.int64)
    mk1 = torch.gather(kpts[:, 1], 1, gather[..., None].expand(-1, -1, 2))
    return pose_w8pt_batch(mode, kpts[:, 0], mk1, K0, K1, conf_w)


def _canvas(img, bucket):
    h, w = img.shape[:2]
    if (h, w) == tuple(bucket):
        return img
    out = np.zeros(tuple(bucket) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


def evaluate(opt, superpoint, matcher, dataset, device="cuda"):
    """Run the pair benchmark; returns (errors, failures, n_signatures).

    Args:
        opt: namespace with eval_mode, max_pairs, eval_batch, eval_scan,
            shape_bucket, compute_dtype (see `parse_args`; the last four
            optional).
        superpoint, matcher: the port's modules, weights loaded; the matcher
            takes two views.
        dataset: sequence of {"image0", "image1" (H, W, 1), "intr0", "intr1"
            (3|4, 3|4), "T021" (4, 4)} pair dicts (`data/pairs.py`).
        device: "cuda" by default; raises if no GPU is present.
    Returns:
        (per-pair max(translation, rotation) error in degrees, inf where no
        pose was found; the count of those; the number of distinct (bucket
        pair, S, eval_batch) chunk signatures).
    """
    device = resolve_device(device)
    strict_float32(opt)
    superpoint.to(device).eval()
    matcher.to(device).eval()
    mode = opt.eval_mode
    w8pt = mode.startswith("w8pt")
    # matches count above 0.02 in the ransac modes, above 0 in the weighted ones
    match_threshold = 0.02 if "ransac" in mode else 0.0
    pose_errors = {}
    failures = 0
    eval_batch = max(1, getattr(opt, "eval_batch", 1))
    chunk_len = eval_batch * max(1, getattr(opt, "eval_scan", 1))
    bucket = max(0, getattr(opt, "shape_bucket", 128))
    n_signatures = set()

    def dispatch(chunk, buckets):
        """Queue one chunk's device work; returns what `collect` needs."""
        idxs = [i for i, _ in chunk]
        datas = [d for _, d in chunk]
        padded, S = pad_to_grid(datas, eval_batch)
        n_signatures.add((buckets, S, eval_batch))

        def grid(arrays):
            a = np.stack(arrays)
            return to_device(a.reshape((S, eval_batch) + a.shape[1:]), device)

        images0 = grid([_canvas(d["image0"], buckets[0]) for d in padded])
        images1 = grid([_canvas(d["image1"], buckets[1]) for d in padded])
        valid0 = grid([d["image0"].shape[:2] for d in padded])
        valid1 = grid([d["image1"].shape[:2] for d in padded])
        sizes = grid([[d["image0"].shape[:2], d["image1"].shape[:2]] for d in padded])
        K0 = np.stack([d["intr0"][:3, :3] for d in padded])
        K1 = np.stack([d["intr1"][:3, :3] for d in padded])
        outs = []
        with torch.inference_mode():
            if w8pt:
                K0_d, K1_d = grid(K0), grid(K1)
                for s in range(S):
                    outs.append(infer_pose_subchunk(
                        superpoint, matcher, mode, images0[s], images1[s], sizes[s],
                        valid0[s], valid1[s], K0_d[s], K1_d[s], match_threshold))
            else:
                for s in range(S):
                    outs.append(infer_pairs(superpoint, matcher, images0[s], images1[s],
                                            sizes[s], valid0[s], valid1[s]))
        return idxs, datas, K0, K1, [torch.cat(x) for x in zip(*outs)]

    def ransac_pose(b, kpts, matches, conf, K0, K1):
        """Host RANSAC of pair b, then (ransac_ba) the two-view BA on the
        device from its inliers; (R, t) or None."""
        mask = (matches >= 0) & (conf > match_threshold)
        mk0 = kpts[0][mask]
        mk1 = kpts[1][np.clip(matches, 0, len(kpts[1]) - 1)][mask]
        ret = estimate_pose_ransac(mk0, mk1, K0[b], K1[b])
        if ret is None:
            return None
        R, t, inliers = ret
        if mode == "ransac_ba":
            T_init = np.eye(4, dtype=np.float32)
            T_init[:3, :3] = R
            T_init[:3, 3] = t
            k0n = (mk0[inliers] - K0[b][[0, 1], [2, 2]]) / K0[b][[0, 1], [0, 1]]
            k1n = (mk1[inliers] - K1[b][[0, 1], [2, 2]]) / K1[b][[0, 1], [0, 1]]
            with torch.inference_mode():
                T_ref, ok = bundle_adjust_two_view(
                    to_device(k0n[None], device), to_device(k1n[None], device),
                    to_device(conf[mask][inliers][None], device),
                    to_device(T_init[None], device), n_iterations=10)
                T_ref, ok = fetch_packed([T_ref[0], ok[0]])
            if ok > 0.5:
                R, t = T_ref[:3, :3], T_ref[:3, 3]
        return R, t

    def collect(state):
        nonlocal failures
        idxs, datas, K0, K1, handle = state
        host = fetch_packed(handle)  # the chunk's one copy to the host
        if w8pt:
            T_pred, valid = host
            rets = [(T_pred[b][:3, :3], T_pred[b][:3, 3]) if valid[b] > 0.5 else None
                    for b in range(len(datas))]
        else:
            kpts, matches, conf = host
            matches = matches.astype(np.int64)
            rets = [ransac_pose(b, kpts[b], matches[b], conf[b], K0, K1)
                    for b in range(len(datas))]
        for ret, i, data in zip(rets, idxs, datas):
            if ret is None:
                err_t, err_R = np.inf, np.inf
                failures += 1
            else:
                err_t, err_R = relative_pose_errors(data["T021"], ret[0], ret[1])
                log.info("%4d: rot %5.1f deg\tt %5.1f deg", i, err_R, err_t)
            pose_errors[i] = max(err_t, err_R)

    def bucket_of(shape):
        if bucket <= 0:
            return tuple(shape[:2])
        return tuple(-(-d // bucket) * bucket for d in shape[:2])

    in_flight = None  # one queued chunk ahead of the one being collected

    def flush(chunk, buckets):
        nonlocal in_flight
        if not chunk:
            return
        state = dispatch(chunk, buckets)
        if in_flight is not None:
            collect(in_flight)
        in_flight = state

    n = len(dataset) if opt.max_pairs is None else min(opt.max_pairs, len(dataset))
    # one open chunk per bucket pair: same-bucket pairs fill whole chunks even
    # where differently-shaped pairs interleave (megadepth, yfcc)
    open_chunks = {}
    for i in range(n):
        data = dataset[i]
        key = (bucket_of(data["image0"].shape), bucket_of(data["image1"].shape))
        c = open_chunks.setdefault(key, [])
        c.append((i, data))
        if len(c) >= chunk_len:
            flush(c, key)
            open_chunks[key] = []
    for key, c in open_chunks.items():
        flush(c, key)
    if in_flight is not None:
        collect(in_flight)
    log.info("chunk signatures: %d (shape_bucket=%d)", len(n_signatures), bucket)
    return [pose_errors[i] for i in range(n)], failures, len(n_signatures)


# each dataset's pair lists under --assets_dir, SuperPoint's max_keypoints,
# nms_radius and keypoint_threshold, and the images' long side (the JAX main's)
DATASETS = {
    "megadepth": ([f"megadepth_test_1500_scene_info/{f}.npz" for f in (
        "0015_0.1_0.3", "0015_0.3_0.5", "0022_0.1_0.3", "0022_0.3_0.5", "0022_0.5_0.7")],
        2048, 3, 0.005, 1600),
    "yfcc100m": (["yfcc_test_pairs_with_gt.txt"], 2048, 3, 0.005, 1600),
    "scannet": (["scannet_test_1500/test.npz"], 1024, 4, 0.001, 720),
}


def main(argv=None):
    """Evaluate a run on the fixed pair list of `--dataset`; returns the AUCs."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    resolve_kernel_impls(opt, device)
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assets = opt.assets_dir or os.path.join(source_dir, "assets")
    ds_key = next((k for k in ("megadepth", "yfcc100m") if k in opt.dataset), "scannet")
    lists, opt.max_keypoints, opt.nms_radius, opt.keypoint_threshold, img_size = DATASETS[ds_key]
    input_files = [os.path.join(assets, f) for f in lists]

    exp_dir, _ = get_exp_dir(opt.checkpoint_dir, opt.exp_name)
    superpoint = SuperPoint(SuperPointConfig(
        nms_radius=opt.nms_radius, keypoint_threshold=opt.keypoint_threshold,
        max_keypoints=opt.max_keypoints, remove_borders=0,
        fill_with_random_keypoints=False, compute_dtype=opt.compute_dtype,
    ))
    matcher = MultiViewMatcher(MatcherConfig(
        gnn_layers=default_gnn_layers(9, 1), sinkhorn_iterations=opt.sinkhorn_iterations,
        conf_mlp=True, multi_frame_matching=False,
        attention_impl=opt.attention_impl, sinkhorn_impl=opt.sinkhorn_impl,
        compute_dtype=opt.compute_dtype,
    ))
    load_eval_weights(exp_dir, superpoint, matcher, opt.allow_random_superpoint)

    dataset = PairMatchingDataset(os.path.join(opt.data_dir, opt.dataset), input_files,
                                  img_size, ds_key)
    pose_errors, failures, _ = evaluate(opt, superpoint, matcher, dataset, device=device)
    aucs = pose_auc(pose_errors, [5, 10, 20])
    result = {f"AUC@{t}deg": 100.0 * a for t, a in zip((5, 10, 20), aucs)}
    for k, v in result.items():
        log.info("%s: %.3f%%", k, v)
    log.info("failed poses: %d", failures)
    with open(os.path.join(exp_dir, f"two_view_{opt.eval_mode}_{opt.dataset}.json"), "w") as f:
        json.dump(result, f, indent=4)
    return result


if __name__ == "__main__":
    main()
