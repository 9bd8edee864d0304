"""Multi-view 5-tuple evaluation: SuperPoint -> multi-view matcher -> multi-view pose.

Counterpart of `e2e_multi_view_matching_tpu/cli/eval_multi_view.py`:

    python -m e2e_multi_view_matching_tpu_torch.cli.eval_multi_view \
        --data_dir ... --checkpoint_dir ... --exp_name <run> --dataset scannet \
        --tuple_size 5 [--test_tuple_file <csv>] [--init_mode w8pt_ba|ransac|ransac_ba]

`main()` evaluates the run's `model.ckpt` (matcher) with the run's
`superpoint.ckpt` (a state dict of the port's `SuperPoint`, e.g. from
`tools/torch_import_weights.py`) on the fixed test tuples, and writes
`<exp_dir>/multi_view_<dataset>.json`. `evaluate` runs fixed tuples through
SuperPoint over all B*V frames and the matcher on the device, then the pose
pipeline of `--init_mode`, and scores pairwise pose/rotation/translation
errors on the host; `write_result` turns them into AUC@5/10/20 JSON.

- `w8pt_ba` (default): the fused pose pipeline on the device. Chunks of
  `eval_scan x eval_batch` tuples are queued one ahead: the next chunk's
  device work is enqueued before the current chunk's extrinsics are copied
  to the host, the only sync of a chunk.
- `ransac`, `ransac_ba`: one packed copy of the chunk's keypoints, matches
  and confidences to the host, OpenCV's RANSAC of every pair there, the
  host-tree pipeline (`mvba/pipeline.py::multi_view_pose_pipeline_batch`);
  synchronous, as the JAX package's unfused path is.

Not ported yet: `--data_parallel` above 1 (ROADMAP Queue 1, the distributed
modes).
"""

import argparse
import json
import logging
import os

import numpy as np
import torch

from e2e_multi_view_matching_tpu_torch.data.tuples import MatchingTupleDataset
from e2e_multi_view_matching_tpu_torch.geom.metrics import pose_auc
from e2e_multi_view_matching_tpu_torch.models.matcher import (
    MatcherConfig,
    MultiViewMatcher,
    default_gnn_layers,
)
from e2e_multi_view_matching_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from e2e_multi_view_matching_tpu_torch.mvba.pipeline import (
    INIT_MODES,
    MultiViewPipelineConfig,
    multi_view_pose_device,
    multi_view_pose_pipeline_batch,
)
from e2e_multi_view_matching_tpu_torch.train.checkpoint import load_config, load_eval_weights
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

log = logging.getLogger("eval_multi_view")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate multi-view",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser = add_generic_arguments(parser)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--test_tuple_file", type=str, default=None,
                        help="CSV of fixed test tuples; defaults to assets/")
    parser.add_argument("--max_tuples", type=int, default=None)
    parser.add_argument("--sinkhorn_iterations", type=int, default=100,
                        help="reference semantics (upstream SuperGlue default 100)")
    parser.add_argument("--eval_batch", type=int, default=8,
                        help="tuples per sub-chunk (one SuperPoint + matcher + "
                             "pose batch)")
    parser.add_argument("--eval_scan", type=int, default=2,
                        help="sub-chunks per chunk; the host copies a chunk's "
                             "extrinsics back once")
    parser.add_argument("--no_pipeline", action="store_true",
                        help="do not queue the next chunk before fetching the "
                             "current one")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="devices a chunk is sharded over (only 1 until "
                             "parallel/mesh.py is ported)")
    parser.add_argument("--init_mode", type=str, default="w8pt_ba",
                        choices=list(INIT_MODES),
                        help="per-pair relative-pose initialization: w8pt_ba on the "
                             "device, ransac / ransac_ba with OpenCV's RANSAC on the "
                             "host (ransac_ba then refines with the two-view BA)")
    parser.add_argument("--allow_resampled_tuples", action="store_true",
                        help="permit evaluating freshly sampled tuples when the "
                             "fixed benchmark CSV is absent (NOT the benchmark)")
    parser.add_argument("--allow_random_superpoint", action="store_true",
                        help="permit running with freshly initialized SuperPoint "
                             "weights when superpoint.ckpt is absent (meaningless "
                             "AUC; debugging only)")
    opt = parser.parse_args(argv)
    if opt.data_parallel != 1:
        parser.error("--data_parallel above 1 waits for the port of parallel/mesh.py "
                     "(ROADMAP Queue 1, the distributed modes)")
    return opt


def write_result(pose_errors, file):
    """AUC table + JSON output."""
    thresholds = [5, 10, 20]
    aucs = pose_auc(pose_errors[0], thresholds)
    t_aucs = pose_auc(pose_errors[1], thresholds)
    r_aucs = pose_auc(pose_errors[2], thresholds)
    metrics = {}
    for t, a, ta, ra in zip(thresholds, aucs, t_aucs, r_aucs):
        metrics[f"pose_AUC@{t}deg"] = a * 100.0
        metrics[f"transl_AUC@{t}deg"] = ta * 100.0
        metrics[f"rot_AUC@{t}deg"] = ra * 100.0
    for k, v in metrics.items():
        log.info("%s: %6.3f%%", k, v)
    with open(file, "w") as f:
        json.dump(metrics, f, indent=4)
    return metrics


def infer_subchunk(superpoint, matcher, images, intr, image_size,
                   pipeline_cfg=MultiViewPipelineConfig()):
    """One sub-chunk on the device, no host sync.

    Args:
        images: (B, V, H, W, 1); intr: (B, V, 3, 3); image_size: (B, V, 2) (H, W).
    Returns:
        (kpts (B, V, K, 2), matches0 (B, P, K), conf_scores (B, P, K),
         extrinsics (B, V, 4, 4) of the fused `w8pt_ba` pipeline, or None in
         the other init modes, whose pose stage runs on the host).
    """
    B, V = images.shape[:2]
    sp_out = superpoint(images.reshape((B * V,) + images.shape[2:]))
    kpts = sp_out["keypoints"].reshape(B, V, -1, 2)
    K = kpts.shape[2]
    scores = sp_out["scores"].reshape(B, V, K)
    descs = sp_out["descriptors"].reshape(B, V, K, -1)
    out = matcher(kpts, scores, descs, image_size)
    extr = None
    if pipeline_cfg.init_mode == "w8pt_ba":
        extr = multi_view_pose_device(kpts, intr, out["matches0"], out["conf_scores"],
                                      pipeline_cfg)
    return kpts, out["matches0"], out["conf_scores"], extr


def _pair_errors(sample, extr, V):
    """(pose, translation, rotation) errors in degrees of every pair (i < j)."""
    out = []
    for j in range(V):
        for i in range(j):
            pose0, pose1 = sample["poses"][i], sample["poses"][j]
            T_gt = np.linalg.inv(pose1) @ pose0
            T_pred = extr[j] @ np.linalg.inv(extr[i])
            cos_r = np.clip((np.trace(T_gt[:3, :3].T @ T_pred[:3, :3]) - 1) / 2, -1, 1)
            err_R = np.degrees(np.arccos(cos_r))
            nrm = np.linalg.norm(T_gt[:3, 3]) * np.linalg.norm(T_pred[:3, 3])
            if nrm > 1e-9:
                err_t = np.degrees(np.arccos(np.clip(
                    T_gt[:3, 3] @ T_pred[:3, 3] / nrm, -1, 1)))
            else:
                err_t = 0.0
            out.append((max(err_t, err_R), err_t, err_R))
    return out


def evaluate(opt, superpoint, matcher, dataset, pipeline_cfg=MultiViewPipelineConfig(),
             device="cuda"):
    """Run the benchmark loop; returns (pose, transl, rot) error lists.

    Args:
        opt: namespace with tuple_size, eval_batch, eval_scan, max_tuples,
            no_pipeline, compute_dtype (see `parse_args`).
        superpoint, matcher: the port's modules, weights loaded.
        dataset: sequence of {"images" (V, H, W, 1), "intr" (V, 3|4, 3|4),
            "poses" (V, 4, 4)} sample dicts.
        pipeline_cfg: the pose pipeline; its `init_mode` picks the fused
            device pipeline (`w8pt_ba`) or the host-tree one.
        device: "cuda" by default; raises if no GPU is present.
    """
    device = resolve_device(device)
    fuse = pipeline_cfg.init_mode == "w8pt_ba"
    strict_float32()
    superpoint.to(device).eval()
    matcher.to(device).eval()
    pose_errors = ([], [], [])
    V = opt.tuple_size
    n = len(dataset) if opt.max_tuples is None else min(opt.max_tuples, len(dataset))
    eval_batch = max(1, getattr(opt, "eval_batch", 1))
    scan = max(1, getattr(opt, "eval_scan", 1))
    chunk_len = eval_batch * scan

    def dispatch(lo):
        """Enqueue one chunk on the device; returns (samples, extrinsics: on
        the device in `w8pt_ba`, already on the host in the other modes)."""
        samples = [dataset[i] for i in range(lo, min(lo + chunk_len, n))]
        padded, S = pad_to_grid(samples, eval_batch)
        images = np.stack([s["images"] for s in padded])
        images = to_device(images.reshape((S, eval_batch) + images.shape[1:]), device)
        intr_np = np.stack([s["intr"][:, :3, :3] for s in padded])
        intr = to_device(intr_np.reshape(S, eval_batch, V, 3, 3), device)
        H, W = images.shape[3:5]
        image_size = torch.empty((eval_batch, V, 2), device=device)
        image_size[..., 0] = H
        image_size[..., 1] = W
        outs = [infer_subchunk(superpoint, matcher, images[s], intr[s], image_size,
                               pipeline_cfg) for s in range(S)]
        if fuse:
            return samples, torch.stack([o[3] for o in outs])
        # host-tree init modes: one packed copy of the chunk's matcher outputs,
        # then the pose pipeline, synchronous; the padding rides along
        kpts, matches0, conf = fetch_packed(
            [torch.cat([o[i] for o in outs]) for i in range(3)])
        return samples, multi_view_pose_pipeline_batch(kpts, intr_np, matches0, conf,
                                                       pipeline_cfg, device=device)

    chunk_starts = list(range(0, n, chunk_len))
    pipeline = not getattr(opt, "no_pipeline", False)
    with torch.inference_mode():
        in_flight = dispatch(chunk_starts[0]) if (chunk_starts and pipeline) else None
        for ci, lo in enumerate(chunk_starts):
            if pipeline:
                samples, extr_dev = in_flight
                if ci + 1 < len(chunk_starts):  # keep the next chunk in flight
                    in_flight = dispatch(chunk_starts[ci + 1])
            else:
                samples, extr_dev = dispatch(lo)
            if fuse:
                extr_dev = fetch_packed([extr_dev])[0]
            extr_b = extr_dev.reshape(-1, V, 4, 4)[:len(samples)]
            for sample, extr in zip(samples, extr_b):
                for e_pose, e_t, e_r in _pair_errors(sample, extr, V):
                    pose_errors[0].append(e_pose)
                    pose_errors[1].append(e_t)
                    pose_errors[2].append(e_r)
            log.info("tuple %d/%d done", min(lo + chunk_len, n), n)
    return pose_errors


def main(argv=None):
    """Evaluate a run on the fixed test tuples; returns the AUC metrics."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    resolve_kernel_impls(opt, device)
    exp_dir, _ = get_exp_dir(opt.checkpoint_dir, opt.exp_name)
    train_cfg = load_config(exp_dir)
    # detector and GNN shape come from the training run
    for k in ("remove_borders", "nms_radius", "keypoint_threshold", "cross_attention_layers",
              "gnn_layers"):
        setattr(opt, k, train_cfg[k])
    opt.max_keypoints = 2048 if "megadepth" in opt.dataset else 1024

    superpoint = SuperPoint(SuperPointConfig(
        nms_radius=opt.nms_radius, keypoint_threshold=opt.keypoint_threshold,
        max_keypoints=opt.max_keypoints, remove_borders=opt.remove_borders,
        fill_with_random_keypoints=False, compute_dtype=opt.compute_dtype,
    ))
    matcher = MultiViewMatcher(MatcherConfig(
        gnn_layers=default_gnn_layers(opt.gnn_layers, opt.cross_attention_layers),
        sinkhorn_iterations=opt.sinkhorn_iterations,
        conf_mlp=True, multi_frame_matching=True,
        attention_impl=opt.attention_impl, sinkhorn_impl=opt.sinkhorn_impl,
        compute_dtype=opt.compute_dtype,
    ))
    load_eval_weights(exp_dir, superpoint, matcher, opt.allow_random_superpoint)

    dataset_dir = os.path.join(opt.data_dir, opt.dataset)
    test_dataset = MatchingTupleDataset(
        dataset_dir, split="test", tuple_size=opt.tuple_size, shuffle_tuple=False,
        n_samples=1,
    )
    tuple_file = opt.test_tuple_file or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets", f"{opt.dataset.split('_')[0]}_test_5tuples.csv",
    )
    if os.path.exists(tuple_file):
        test_dataset.read_sampled_tuples(tuple_file)
    elif opt.test_tuple_file is not None or not opt.allow_resampled_tuples:
        # the benchmark is the fixed tuple list; resampling measures another thing
        raise FileNotFoundError(
            f"fixed test-tuple CSV not found: {tuple_file}. Pass "
            "--test_tuple_file or --allow_resampled_tuples to evaluate on "
            "freshly sampled (non-benchmark) tuples."
        )
    else:
        log.warning("no fixed tuple CSV; evaluating on RESAMPLED tuples "
                    "(not the reference benchmark)")
    log.info("loaded %d test tuples", len(test_dataset))

    pose_errors = evaluate(opt, superpoint, matcher, test_dataset,
                           pipeline_cfg=MultiViewPipelineConfig(init_mode=opt.init_mode),
                           device=device)
    out_json = os.path.join(exp_dir, f"multi_view_{opt.dataset.split('_')[0]}.json")
    return write_result(pose_errors, out_json)


if __name__ == "__main__":
    main()
