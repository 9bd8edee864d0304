"""Entry `eval_multi_view`: the port's multi-view eval loop.

The window calls `cli/eval_multi_view.py::evaluate` with the default
`MultiViewPipelineConfig()` (`w8pt_ba`), `eval_scan` 1, one chunk in flight
and the kernels resolved by "auto", on successive slices of the input pool
(`chunks_per_call` sub-chunks of `eval_batch` tuples each), until `--seconds`
have passed; the window ends when the last call returns. SuperPoint and the
matcher are built as `cli/eval_multi_view.py::main` builds them, with the
configuration's widths and the benchmark's seeded weights.

Forward hooks on the program's SuperPoint, matcher and the matcher's
`final_proj` keep the outputs of the sub-chunks that the seed draws for the
check, which judges each stage alone on the program's outputs of the stage
before. In a traced run, span
hooks time every call of both modules in the window, and once the window
has closed the profiler covers one more call of `evaluate`
(`chunks_per_call` sub-chunks): its post-processing, and the per-launch cost
that CUPTI keeps once a profiler has run in the process, stay out of the
window.
"""

import dataclasses
import math
import time
import types

import numpy as np
import torch

from benchmark.harness import seeds, traffic, weights
from benchmark.harness.trace import DeviceTrace, Spans
from benchmark import reference
from benchmark.reference import judge
from benchmark.reference.matcher import MatcherConfig as RefMatcherConfig
from benchmark.reference.matcher import MultiViewMatcher as RefMatcher
from benchmark.reference.matcher import default_gnn_layers as ref_gnn_layers
from benchmark.reference.matcher import extract_matches
from benchmark.reference.pose.pipeline import MultiViewPipelineConfig as RefPoseConfig
from benchmark.reference.pose.pipeline import multi_view_pose_device as ref_pose
from benchmark.reference.superpoint import SuperPoint as RefSuperPoint
from benchmark.reference.superpoint import SuperPointConfig as RefSuperPointConfig

# tuples of a sub-chunk whose pair scores and Sinkhorn the reference takes at
# a time
PAIR_ROWS = 8


def shapes(run):
    c, t = run.cell.config, run.cell.traffic
    m = c["matcher"]
    return {"batch": t["eval_batch"], "views": c["tuple_size"], "kpts": c["eval_keypoints"],
            "height": t["height"], "width": t["width"], "dim": m["descriptor_dim"],
            "heads": m["num_heads"],
            "layers": ref_gnn_layers(m["gnn_layers"], m["cross_attention_layers"]),
            "sinkhorn_iters": m["sinkhorn_iterations"], "conf_mlp": m["conf_mlp"],
            "keypoint_encoder": m["keypoint_encoder"], "conf_mlp_hidden": m["conf_mlp_hidden"]}


def _reference_models(run, on_meta=False):
    c = run.cell.config
    sp, m = c["superpoint"], c["matcher"]
    dev = "meta" if on_meta else run.device
    with torch.device(dev):
        ref_sp = RefSuperPoint(RefSuperPointConfig(
            nms_radius=sp["nms_radius"], keypoint_threshold=sp["keypoint_threshold"],
            max_keypoints=c["eval_keypoints"], remove_borders=sp["remove_borders"],
            descriptor_dim=sp["descriptor_dim"]))
        ref_m = RefMatcher(RefMatcherConfig(
            descriptor_dim=m["descriptor_dim"], keypoint_encoder=tuple(m["keypoint_encoder"]),
            gnn_layers=ref_gnn_layers(m["gnn_layers"], m["cross_attention_layers"]),
            num_heads=m["num_heads"], sinkhorn_iterations=m["sinkhorn_iterations"],
            sinkhorn="scaling", match_threshold=m["match_threshold"], conf_mlp=m["conf_mlp"],
            conf_mlp_hidden=tuple(m["conf_mlp_hidden"]),
            attn_rows=run.cell.workload["check"]["attn_rows"]))
    return ref_sp, ref_m


def model_weights(run):
    """{"superpoint": state dict, "matcher": state dict} drawn from the seed
    on the device, in the layout both the port and the reference load."""
    ref_sp, ref_m = _reference_models(run, on_meta=True)
    g = seeds.generator(run.seed, "weights", run.device)
    return {"superpoint": weights.draw(weights.state_shapes(ref_sp), g, run.device),
            "matcher": weights.draw(weights.state_shapes(ref_m), g, run.device)}


def _program(run, w):
    from e2e_multi_view_matching_tpu_torch.models.matcher import (
        MatcherConfig,
        MultiViewMatcher,
        default_gnn_layers,
    )
    from e2e_multi_view_matching_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
    from e2e_multi_view_matching_tpu_torch.utils.config import resolve_kernel_impls

    c = run.cell.config
    sp, m = c["superpoint"], c["matcher"]
    impls = resolve_kernel_impls(
        types.SimpleNamespace(attention_impl="auto", sinkhorn_impl="auto"), run.device)
    with torch.device("meta"):
        superpoint = SuperPoint(SuperPointConfig(
            nms_radius=sp["nms_radius"], keypoint_threshold=sp["keypoint_threshold"],
            max_keypoints=c["eval_keypoints"], remove_borders=sp["remove_borders"],
            fill_with_random_keypoints=False, descriptor_dim=sp["descriptor_dim"],
            compute_dtype=c["compute_dtype"]))
        matcher = MultiViewMatcher(MatcherConfig(
            descriptor_dim=m["descriptor_dim"], keypoint_encoder=tuple(m["keypoint_encoder"]),
            gnn_layers=default_gnn_layers(m["gnn_layers"], m["cross_attention_layers"]),
            num_heads=m["num_heads"], sinkhorn_iterations=m["sinkhorn_iterations"],
            conf_mlp=m["conf_mlp"], conf_mlp_hidden=tuple(m["conf_mlp_hidden"]),
            match_threshold=m["match_threshold"], multi_frame_matching=True,
            attention_impl=impls.attention_impl, sinkhorn_impl=impls.sinkhorn_impl,
            compute_dtype=c["compute_dtype"]))
    superpoint = superpoint.to_empty(device=run.device)
    matcher = matcher.to_empty(device=run.device)
    superpoint.load_state_dict(w["superpoint"])
    matcher.load_state_dict(w["matcher"])
    return superpoint.eval(), matcher


class _Capture:
    """Forward hooks that keep the outputs of the sub-chunks in `wanted`
    (indices counted from `reset()`): SuperPoint's, the matcher's and the
    matcher's projected descriptors (the output of its `final_proj`, from
    which the pair scores are taken)."""

    def __init__(self, superpoint, matcher, wanted):
        self.wanted = set(wanted)
        self.sp, self.m, self.md = {}, {}, {}
        self.count_sp = self.count_m = self.count_md = 0
        self.on = False
        self._handles = [superpoint.register_forward_hook(self._keep_sp),
                         matcher.register_forward_hook(self._keep_m),
                         matcher.final_proj.register_forward_hook(self._keep_md)]

    def reset(self):
        self.count_sp = self.count_m = self.count_md = 0
        self.on = True

    def _keep_md(self, module, args, out):
        if self.on and self.count_md in self.wanted:
            self.md[self.count_md] = out
        self.count_md += self.on

    def _keep_sp(self, module, args, out):
        if self.on and self.count_sp in self.wanted:
            self.sp[self.count_sp] = out
        self.count_sp += self.on

    def _keep_m(self, module, args, out):
        if self.on and self.count_m in self.wanted:
            self.m[self.count_m] = {"mdesc": self.md.pop(self.count_m, None),
                                    **{k: out[k] for k in
                                       ("log_assignment", "matches0", "conf_scores")}}
        self.count_m += self.on

    def remove(self):
        for h in self._handles:
            h.remove()


def check_units(run):
    """The sub-chunks the check judges: `units` of the window's first
    `from_first_units`, drawn from the seed."""
    chk = run.cell.workload["check"]
    rng = np.random.default_rng(seeds.derive(run.seed, "check"))
    return sorted(rng.choice(chk["from_first_units"], chk["units"], replace=False).tolist())


def setup(run):
    from e2e_multi_view_matching_tpu_torch.cli.eval_multi_view import evaluate
    from e2e_multi_view_matching_tpu_torch.mvba.pipeline import MultiViewPipelineConfig
    from e2e_multi_view_matching_tpu_torch.utils.config import strict_float32

    strict_float32()
    t = run.cell.traffic
    run.shapes = shapes(run)
    w = model_weights(run)
    superpoint, matcher = _program(run, w)
    pool = traffic.eval_tuples(t, t["pool_tuples"], seeds.generator(run.seed, "inputs", run.device),
                               run.device)
    wanted = check_units(run)
    state = types.SimpleNamespace(
        evaluate=evaluate, pipeline_cfg=MultiViewPipelineConfig(), superpoint=superpoint,
        matcher=matcher, weights=w, pool=pool, capture=_Capture(superpoint, matcher, wanted),
        wanted=wanted,
        opt=types.SimpleNamespace(tuple_size=run.cell.config["tuple_size"],
                                  eval_batch=t["eval_batch"], eval_scan=1, max_tuples=None,
                                  no_pipeline=False, compute_dtype=run.cell.config["compute_dtype"]))
    # warm-up: the kernels' builds and loads, cuDNN's plans, the allocator
    _call(run, state, 0)
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    return state


def _slice(run, state, call):
    t = run.cell.traffic
    n = t["chunks_per_call"] * t["eval_batch"]
    pool = state.pool
    return [pool[(call * n + i) % len(pool)] for i in range(n)]


def _call(run, state, call):
    samples = _slice(run, state, call)
    errors = state.evaluate(state.opt, state.superpoint, state.matcher, samples,
                            pipeline_cfg=state.pipeline_cfg, device=run.device)
    return np.asarray(errors, np.float64).T.reshape(len(samples), -1, 3)


def _launches():
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda, sinkhorn_cuda

    return {**attention_cuda.launches, **sinkhorn_cuda.launches}


def window(run, state):
    t = run.cell.traffic
    cuda = torch.device(run.device).type == "cuda"
    if run.traced:
        run.spans = {"superpoint": Spans(state.superpoint, cuda), "matcher": Spans(state.matcher, cuda)}
    before = _launches()
    state.capture.reset()
    errors, call, times, cpu = [], 0, [], []
    t0 = time.perf_counter()
    while True:
        tc, cc = time.perf_counter(), time.thread_time()
        errors.append(_call(run, state, call))
        times.append(time.perf_counter() - tc)
        cpu.append(time.thread_time() - cc)
        call += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.extra["unit_s"] = times
    run.extra["unit_cpu_s"] = cpu  # the calling thread's CPU time a call
    state.capture.on = False
    for s in run.spans.values():
        s.remove()
    after = _launches()
    state.launched = {k: after[k] - before[k] for k in after}
    state.errors = np.concatenate(errors)
    run.tuples = len(state.errors)
    run.units = call * t["chunks_per_call"]
    if run.traced:  # the profiled stretch: one more call, after the window
        run.trace = DeviceTrace(cuda)
        run.trace.start()
        _call(run, state, call)
        run.trace.stop(t["chunks_per_call"])
    failed = int((~np.isfinite(state.errors).all(axis=(1, 2))).sum())
    return {"eval_tuples_per_s": run.tuples / run.window_s}, run.tuples, failed


def _inputs(run, state, unit):
    """(images (B, V, H, W, 1), intr (B, V, 3, 3), poses (B, V, 4, 4)) of
    sub-chunk `unit` of the window, on the device / the host."""
    eb = run.cell.traffic["eval_batch"]
    samples = [state.pool[(unit * eb + i) % len(state.pool)] for i in range(eb)]
    images = torch.from_numpy(np.stack([s["images"] for s in samples])).to(run.device)
    intr = torch.from_numpy(np.stack([s["intr"][:, :3, :3] for s in samples])).to(run.device)
    return images, intr, np.stack([s["poses"] for s in samples])


def judge_unit(run, ref_sp, ref_m, images, intr, poses, sp_out, m_out, errors):
    """The readings of one sub-chunk: the program's (or the control's)
    SuperPoint outputs `sp_out`, matcher outputs `m_out` (with its projected
    descriptors "mdesc") and pair errors `errors` (B, P, 3) against the
    reference, each stage on the program's outputs of the stage before."""
    c = run.cell.config
    B, V, H, W = images.shape[:4]
    K = c["eval_keypoints"]
    with torch.no_grad():
        raw, nms, desc_map = ref_sp.detection_map(images.reshape(B * V, H, W, 1))
        out = judge.keypoint_readings(raw, nms, desc_map, sp_out["keypoints"], sp_out["scores"],
                                      sp_out["descriptors"], c["superpoint"]["keypoint_threshold"],
                                      c["superpoint"]["nms_radius"])
        del raw, nms, desc_map
        kpts = sp_out["keypoints"].reshape(B, V, K, 2)
        if m_out["mdesc"] is None:  # the projected descriptors never came
            return {**out, "gnn_err": math.inf, "sinkhorn_err": math.inf,
                    "matches_off": math.inf, "conf_err": math.inf, "pose_gap": math.inf}
        ref_mdesc = ref_m.descriptors(kpts, sp_out["scores"].reshape(B, V, K),
                                      sp_out["descriptors"].reshape(B, V, K, -1), (H, W))
        mdesc = m_out["mdesc"].reshape(B, V, K, -1)
        log_p = ref_m.assignment(mdesc, pair_rows=PAIR_ROWS)
        P = log_p.shape[1]
        _, _, ms0 = extract_matches(m_out["log_assignment"].reshape(B * P, K + 1, K + 1),
                                    c["matcher"]["match_threshold"])
        conf = ref_m.confidence(mdesc, m_out["matches0"], ms0.reshape(B, P, K))
        out.update(judge.matcher_readings(ref_mdesc, log_p, conf, m_out,
                                          c["matcher"]["match_threshold"]))
        del ref_mdesc, log_p, conf
        extr = ref_pose(kpts, intr, m_out["matches0"], m_out["conf_scores"])
    out.update(judge.pose_readings(judge.pair_errors(poses, extr.double().cpu().numpy()),
                                   errors))
    return out


def _reference(run, w):
    ref_sp, ref_m = _reference_models(run)
    ref_sp.load_state_dict(w["superpoint"])
    ref_m.load_state_dict(w["matcher"])
    return ref_sp, ref_m


def check(run, state):
    t, chk = run.cell.traffic, run.cell.workload["check"]
    eb = t["eval_batch"]
    state.capture.remove()
    kept = [(u, state.capture.sp.get(u), state.capture.m.get(u)) for u in state.wanted]
    # the program's state goes before the reference runs
    del state.superpoint, state.matcher, state.capture
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    reference.float32()
    ref_sp, ref_m = _reference(run, state.weights)
    readings = {}
    missing = 0
    for u, sp_out, m_out in kept:
        if sp_out is None or m_out is None or len(state.errors) < (u + 1) * eb:
            missing += 1  # a sub-chunk the seed drew that the window never ran
            continue
        images, intr, poses = _inputs(run, state, u)
        r = judge_unit(run, ref_sp, ref_m, images, intr, poses, sp_out, m_out,
                       state.errors[u * eb:(u + 1) * eb])
        judge.merge(readings, r)
    limits = chk["limits"]
    run.extra["readings"] = {k: readings.get(k) for k in chk["reported"]}
    out = [(k, readings.get(k, float("inf")), limits[k]) for k in limits]
    out.append(("units_not_checked", float(missing), 0.0))
    silent = [k for k in chk["kernels"] if state.launched.get(k, 0) == 0]
    out.append(("kernels_not_launched", float(len(silent)), 0.0))
    return out


FAULTS = ("sinkhorn_round_fewer", "ba_iteration_fewer", "two_view_ba_iteration_fewer",
          "view_turned")


def _reference_path(run, ref_sp, ref_m, images, intr, fault=None):
    """The reference in the program's place on one sub-chunk: (SuperPoint
    outputs, matcher outputs with "mdesc", extrinsics), with `fault`
    planted (`FAULTS`)."""
    B, V, H, W = images.shape[:4]
    K = run.cell.config["eval_keypoints"]
    cfg = RefPoseConfig()
    if fault == "ba_iteration_fewer":
        cfg = RefPoseConfig(ba_iterations=cfg.ba_iterations - 1)
    elif fault == "two_view_ba_iteration_fewer":
        cfg = RefPoseConfig(two_view_ba_iterations=cfg.two_view_ba_iterations - 1)
    with torch.no_grad():
        sp_out = ref_sp(images.reshape(B * V, H, W, 1))
        kpts = sp_out["keypoints"].reshape(B, V, K, 2)
        mdesc = ref_m.descriptors(kpts, sp_out["scores"].reshape(B, V, K),
                                  sp_out["descriptors"].reshape(B, V, K, -1), (H, W))
        iters = ref_m.config.sinkhorn_iterations
        if fault == "sinkhorn_round_fewer":  # ten iterations: the scaling domain's round
            ref_m.config = dataclasses.replace(ref_m.config, sinkhorn_iterations=iters - 10)
        log_p = ref_m.assignment(mdesc, pair_rows=PAIR_ROWS)
        ref_m.config = dataclasses.replace(ref_m.config, sinkhorn_iterations=iters)
        P = log_p.shape[1]
        m0, _, ms0 = extract_matches(log_p.reshape(B * P, K + 1, K + 1),
                                     ref_m.config.match_threshold)
        m0, ms0 = m0.reshape(B, P, K), ms0.reshape(B, P, K)
        m_out = {"mdesc": mdesc, "log_assignment": log_p, "matches0": m0,
                 "conf_scores": ref_m.confidence(mdesc, m0, ms0)}
        extr = ref_pose(kpts, intr, m0, m_out["conf_scores"], cfg)
    if fault == "view_turned":  # view 1 turned by 0.5 degrees about its axis
        a = math.radians(0.5)
        turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                             [0.0, 0.0, 1.0]], dtype=extr.dtype, device=extr.device)
        extr = extr.clone()
        extr[:, 1, :3, :3] = turn @ extr[:, 1, :3, :3]
    return sp_out, m_out, extr


def control(run, units, fault=None):
    """The readings of the control: the reference itself, with TF32 on
    (the precision below the configuration's float32 with TF32 off), in the
    program's place on sub-chunks `units` of the cell's inputs; or, with
    `fault`, the reference at float32 with that fault planted."""
    t = run.cell.traffic
    w = model_weights(run)
    pool = traffic.eval_tuples(t, t["pool_tuples"], seeds.generator(run.seed, "inputs", run.device),
                               run.device)
    state = types.SimpleNamespace(pool=pool)
    ref_sp, ref_m = _reference(run, w)
    readings = {}
    for u in units:
        images, intr, poses = _inputs(run, state, u)
        reference.float32(tf32=fault is None)
        sp_out, m_out, extr = _reference_path(run, ref_sp, ref_m, images, intr, fault)
        reference.float32()
        errors = judge.pair_errors(poses, extr.double().cpu().numpy())
        r = judge_unit(run, ref_sp, ref_m, images, intr, poses, sp_out, m_out, errors)
        judge.merge(readings, r)
        del sp_out, m_out
    return readings


def chain(run, state):
    """The reference from the images through the pose stage on its own
    outputs, beside the program, on the sub-chunks the check judges (run in
    place of `check`): the share of frames whose keypoints, and of pair
    rows whose matches, the two agree on; over the tuples whose frames and
    matches all agree, their count, the widest gap between the two sides'
    confidences, and the pose-error gaps (the widest, the median tuple's,
    and the share of tuples within 1e-3 degrees); and the widest pose-error
    gap over all tuples."""
    eb = run.cell.traffic["eval_batch"]
    state.capture.remove()
    kept = [(u, state.capture.sp.get(u), state.capture.m.get(u)) for u in state.wanted]
    del state.superpoint, state.matcher, state.capture
    torch.cuda.empty_cache()
    reference.float32()
    ref_sp, ref_m = _reference(run, state.weights)
    frames = rows = same_frames = same_rows = 0
    gaps, gaps_same, conf_gap = [], [], 0.0
    for u, sp_out, m_out in kept:
        if sp_out is None or m_out is None:
            continue
        images, intr, poses = _inputs(run, state, u)
        r_sp, r_m, extr = _reference_path(run, ref_sp, ref_m, images, intr)
        B, V = images.shape[:2]
        kp_same = (r_sp["keypoints"].sort(dim=1).values
                   == sp_out["keypoints"].sort(dim=1).values).all(dim=(1, 2)).reshape(B, V)
        m_same = (r_m["matches0"] == m_out["matches0"]).all(dim=2)  # (B, P)
        frames += B * V
        same_frames += int(kp_same.sum())
        rows += m_same.numel()
        same_rows += int(m_same.sum())
        ref_err = judge.pair_errors(poses, extr.double().cpu().numpy())
        gap = np.abs(ref_err - state.errors[u * eb:(u + 1) * eb]).max(axis=(1, 2))
        agree = (kp_same.all(dim=1) & m_same.all(dim=1)).cpu().numpy()
        gaps.extend(gap.tolist())
        gaps_same.extend(gap[agree].tolist())
        if agree.any():
            d = (r_m["conf_scores"] - m_out["conf_scores"]).abs()[torch.from_numpy(agree)]
            conf_gap = max(conf_gap, float(d.amax()))
        del r_sp, r_m
    same = np.asarray(gaps_same)
    return {"frames_same": same_frames / max(frames, 1), "pair_rows_same": same_rows / max(rows, 1),
            "tuples_same": len(same), "conf_gap_same": conf_gap,
            "pose_gap_same": float(same.max()) if len(same) else None,
            "pose_gap_same_median": float(np.median(same)) if len(same) else None,
            "share_same_within_1e-3": float((same < 1e-3).mean()) if len(same) else None,
            "pose_gap_all": max(gaps, default=0.0)}
