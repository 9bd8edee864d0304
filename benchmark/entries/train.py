"""Entry `train`: the port's stage-1 training step (the match loss; no
confidence head, as `cli/train.py::build_models` leaves it out of stage 1).

The models, the optimizer and the `TrainState` are built as
`cli/train.py::_train_loop` builds them, from `cli/train.py::parse_args` and
`utils/config.py::apply_dataset_defaults` for the configuration's dataset,
tuple size and batch, with the learning-rate law of `setup_run`; the weights
are the benchmark's, drawn from the seed. Each step hands a batch of the
input pool (plane scenes made on the device, cycled) and the keypoint-fill
generator to `train/step.py::make_train_step`'s `train_step`, then reads the
metrics, the step's one sync, as the training loop does. No validation,
checkpoint or TensorBoard.

Set-up drives that same state through its first `warmup_steps` steps. Of
the first three, on three different batches, it keeps each loss, the first
gradient as the optimizer holds it (its first moment after one step over
1 - b1) and the parameters' change after the third, for the check; then the
window continues the same state. In a traced run span hooks time every call
of SuperPoint and of the matcher's forward in the window, and once the
window has closed the profiler covers `trace_steps` more steps.
"""

import statistics
import time
import types

import numpy as np
import torch

from benchmark.harness import seeds, traffic, weights
from benchmark.harness.trace import DeviceTrace, Spans
from benchmark import reference
from benchmark.reference import judge
from benchmark.reference import train as ref_train
from benchmark.reference.matcher import MatcherConfig as RefMatcherConfig
from benchmark.reference.matcher import MultiViewMatcher as RefMatcher
from benchmark.reference.matcher import default_gnn_layers as ref_gnn_layers
from benchmark.reference.superpoint import SuperPoint as RefSuperPoint
from benchmark.reference.superpoint import SuperPointConfig as RefSuperPointConfig

CHECKED_STEPS = 3
B1 = 0.9  # Adam's first-moment decay: after one step m = (1 - b1) g


def shapes(run):
    c, t = run.cell.config, run.cell.traffic
    m = c["matcher"]
    return {"batch": t["batch"], "views": c["tuple_size"], "kpts": c["superpoint"]["max_keypoints"],
            "height": t["height"], "width": t["width"], "dim": m["descriptor_dim"],
            "heads": m["num_heads"],
            "layers": ref_gnn_layers(m["gnn_layers"], m["cross_attention_layers"]),
            "sinkhorn_iters": m["sinkhorn_iterations"], "conf_mlp": False,
            "keypoint_encoder": m["keypoint_encoder"], "conf_mlp_hidden": m["conf_mlp_hidden"]}


def _reference_models(run, on_meta=False):
    c = run.cell.config
    sp, m = c["superpoint"], c["matcher"]
    with torch.device("meta" if on_meta else run.device):
        ref_sp = RefSuperPoint(RefSuperPointConfig(
            nms_radius=sp["nms_radius"], keypoint_threshold=sp["keypoint_threshold"],
            max_keypoints=sp["max_keypoints"], remove_borders=sp["remove_borders"],
            fill_with_random_keypoints=True, descriptor_dim=sp["descriptor_dim"]))
        ref_m = RefMatcher(RefMatcherConfig(
            descriptor_dim=m["descriptor_dim"], keypoint_encoder=tuple(m["keypoint_encoder"]),
            gnn_layers=ref_gnn_layers(m["gnn_layers"], m["cross_attention_layers"]),
            num_heads=m["num_heads"], sinkhorn_iterations=m["sinkhorn_iterations"],
            sinkhorn="log", match_threshold=m["match_threshold"], conf_mlp=False,
            conf_mlp_hidden=tuple(m["conf_mlp_hidden"]),
            attn_rows=run.cell.workload["check"]["attn_rows"]))
    return ref_sp, ref_m


def model_weights(run):
    ref_sp, ref_m = _reference_models(run, on_meta=True)
    g = seeds.generator(run.seed, "weights", run.device)
    return {"superpoint": weights.draw(weights.state_shapes(ref_sp), g, run.device),
            "matcher": weights.draw(weights.state_shapes(ref_m), g, run.device)}


def inputs(run):
    """The pool of training batches, made on the device from the seed."""
    t = run.cell.traffic
    g = seeds.generator(run.seed, "inputs", run.device)
    return [traffic.plane_scenes(t, t["batch"], g, run.device) for _ in range(t["pool_batches"])]


def options(run):
    """The training options as `cli/train.py` settles them for the cell."""
    from e2e_multi_view_matching_tpu_torch.cli.train import parse_args
    from e2e_multi_view_matching_tpu_torch.train.optim import scale_lr
    from e2e_multi_view_matching_tpu_torch.utils.config import apply_dataset_defaults

    c, t = run.cell.config, run.cell.traffic
    opt = parse_args(["--dataset", c["dataset"], "--tuple_size", str(c["tuple_size"]),
                      "--batch_size", str(t["batch"]), "--device", str(run.device)])
    apply_dataset_defaults(opt, run.device)
    opt.lr, opt.decay_rate, opt.start_decay, opt.end_decay = scale_lr(
        opt.tuple_size, opt.batch_size * opt.grad_accum, 1, opt.lr, opt.decay_rate,
        opt.start_decay, opt.end_decay, opt.dataset)
    sp, m = c["superpoint"], c["matcher"]
    for key, want in (("max_keypoints", sp["max_keypoints"]), ("nms_radius", sp["nms_radius"]),
                      ("keypoint_threshold", sp["keypoint_threshold"]),
                      ("remove_borders", sp["remove_borders"]), ("gnn_layers", m["gnn_layers"]),
                      ("cross_attention_layers", m["cross_attention_layers"]),
                      ("sinkhorn_iterations", m["sinkhorn_iterations"]),
                      ("pose_loss", False), ("compute_dtype", c["compute_dtype"])):
        if getattr(opt, key) != want:
            raise ValueError(f"cli/train.py sets {key}={getattr(opt, key)!r}; the "
                             f"configuration says {want!r}")
    return opt


def hyperparameters(opt):
    return {k: getattr(opt, k) for k in ("lr", "decay_rate", "start_decay", "end_decay",
                                         "match_reproj_err", "unmatch_reproj_err")}


def _program(run, opt, w):
    """SuperPoint and the matcher as `cli/train.py::build_models` configures
    them, holding the benchmark's weights."""
    from e2e_multi_view_matching_tpu_torch.models.matcher import (
        MatcherConfig,
        MultiViewMatcher,
        default_gnn_layers,
    )
    from e2e_multi_view_matching_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig

    with torch.device("meta"):
        superpoint = SuperPoint(SuperPointConfig(
            nms_radius=opt.nms_radius, keypoint_threshold=opt.keypoint_threshold,
            max_keypoints=opt.max_keypoints, remove_borders=opt.remove_borders,
            fill_with_random_keypoints=True, compute_dtype=opt.compute_dtype))
        matcher = MultiViewMatcher(MatcherConfig(
            gnn_layers=default_gnn_layers(opt.gnn_layers, opt.cross_attention_layers),
            sinkhorn_iterations=opt.sinkhorn_iterations, conf_mlp=bool(opt.pose_loss),
            multi_frame_matching=opt.tuple_size > 2, attention_impl=opt.attention_impl,
            sinkhorn_impl=opt.sinkhorn_impl, compute_dtype=opt.compute_dtype))
    superpoint = superpoint.to_empty(device=run.device)
    matcher = matcher.to_empty(device=run.device)
    superpoint.load_state_dict(w["superpoint"])
    matcher.load_state_dict(w["matcher"])
    return superpoint.eval(), matcher


def _norms(tensors):
    return [float(x) for x in torch.stack(torch._foreach_norm(list(tensors))).cpu()]


def setup(run):
    from e2e_multi_view_matching_tpu_torch.train.optim import build_optimizer
    from e2e_multi_view_matching_tpu_torch.train.step import TrainState, make_train_step
    from e2e_multi_view_matching_tpu_torch.utils.config import strict_float32

    t = run.cell.traffic
    run.shapes = shapes(run)
    opt = options(run)
    strict_float32()
    w = model_weights(run)
    superpoint, matcher = _program(run, opt, w)
    optimizer = build_optimizer(matcher.named_parameters(), opt.lr, opt.decay_rate,
                                opt.start_decay, opt.end_decay, pose_loss=opt.pose_loss,
                                grad_clip=opt.grad_clip)
    state = types.SimpleNamespace(
        train_state=TrainState(matcher=matcher, optimizer=optimizer),
        train_step=make_train_step(superpoint, opt, grad_accum=opt.grad_accum),
        superpoint=superpoint, matcher=matcher, weights=w, hp=hyperparameters(opt),
        pool=inputs(run), generator=seeds.generator(run.seed, "keypoint_fill", run.device),
        steps_done=0)
    sp_out = []
    hook = superpoint.register_forward_hook(lambda mod, args, out: sp_out.append(out))
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append(_step(state)["train_loss"])
        if i == 0:
            grad_norms = [x / (1.0 - B1) for x in _norms(optimizer.m)]
    hook.remove()
    start = [w["matcher"][n] for n in optimizer.names]
    change = _norms(torch._foreach_sub([p.detach() for p in optimizer.params], start))
    state.prog = {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
                  "names": list(optimizer.names)}
    state.sp_out = sp_out
    for _ in range(t["warmup_steps"] - CHECKED_STEPS):
        _step(state)
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    return state


def _step(state):
    batch = state.pool[state.steps_done % len(state.pool)]
    metrics = state.train_step(state.train_state, batch, state.generator)
    state.steps_done += 1
    return {k: float(v) for k, v in metrics.items()}


def _launches():
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda, sinkhorn_cuda

    return {**attention_cuda.launches, **sinkhorn_cuda.launches}


def window(run, state):
    t = run.cell.traffic
    cuda = torch.device(run.device).type == "cuda"
    if run.traced:
        run.spans = {"superpoint": Spans(state.superpoint, cuda), "matcher": Spans(state.matcher, cuda)}
    before = _launches()
    times, failed, n = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        metrics = _step(state)
        times.append(time.perf_counter() - ts)
        failed += not np.isfinite(metrics["train_loss"])
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    for s in run.spans.values():
        s.remove()
    after = _launches()
    state.launched = {k: after[k] - before[k] for k in after}
    run.units = n
    run.tuples = n * t["batch"]
    run.extra["unit_s"] = times
    if run.traced:  # the profiled stretch: more steps of the same state, after the window
        run.trace = DeviceTrace(cuda)
        run.trace.start()
        for _ in range(t["trace_steps"]):
            _step(state)
        run.trace.stop(t["trace_steps"])
    p90 = statistics.quantiles(times, n=10)[-1] if n > 1 else times[0]
    return ({"train_steps_per_s": n / run.window_s, "train_step_p90_ms": p90 * 1e3},
            n, failed)


def _sp_outputs(run, outs):
    B, V = run.cell.traffic["batch"], run.cell.config["tuple_size"]
    return [(o["keypoints"].reshape(B, V, -1, 2), o["scores"].reshape(B, V, -1),
             o["descriptors"].reshape(B, V, o["keypoints"].shape[1], -1)) for o in outs]


def _reference_steps(run, w, batches, sp_outputs, hp):
    _, ref_m = _reference_models(run)
    ref_m.load_state_dict(w["matcher"])
    out = ref_train.run_steps(ref_m, batches, sp_outputs, hp)
    del ref_m
    return out


def _keypoint_readings(run, w, batches, outs):
    """SuperPoint's readings (`judge.keypoint_readings`, the worst of the
    steps) of the detector outputs `outs` of `batches`, one a step."""
    sp = run.cell.config["superpoint"]
    ref_sp, _ = _reference_models(run)
    ref_sp.load_state_dict(w["superpoint"])
    readings = {}
    for batch, out in zip(batches, outs):
        B, V, H, W = batch["images"].shape[:4]
        raw, nms, desc_map = ref_sp.detection_map(batch["images"].reshape(B * V, H, W, 1),
                                                  chunk=V)
        r = judge.keypoint_readings(raw, nms, desc_map, out["keypoints"], out["scores"],
                                    out["descriptors"], sp["keypoint_threshold"],
                                    sp["nms_radius"])
        judge.merge(readings, r)
        del raw, nms, desc_map
    return readings


def check(run, state):
    chk = run.cell.workload["check"]
    frames = run.cell.traffic["batch"] * run.cell.config["tuple_size"]
    if any(o["keypoints"].shape[0] != frames for o in state.sp_out[:CHECKED_STEPS]):
        # the step did not detect on every frame of its batch
        return [(k, float("inf"), chk["limits"][k]) for k in chk["limits"]]
    sp_raw = state.sp_out[:CHECKED_STEPS]
    sp_outputs = _sp_outputs(run, sp_raw)
    prog = state.prog
    # the program's state goes before the reference runs
    del state.train_state, state.train_step, state.superpoint, state.matcher, state.sp_out
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    reference.float32()
    readings = _keypoint_readings(run, state.weights, state.pool[:CHECKED_STEPS], sp_raw)
    del sp_raw
    ref = _reference_steps(run, state.weights, state.pool[:CHECKED_STEPS], sp_outputs, state.hp)
    if ref["names"] != prog["names"]:
        raise ValueError("the reference's parameters are not the program's")
    readings.update(judge.training_readings(prog, ref))
    run.extra["readings"] = {k: readings[k] for k in chk["reported"]}
    out = [(k, readings[k], chk["limits"][k]) for k in chk["limits"]]
    silent = [k for k in chk["kernels"] if state.launched.get(k, 0) == 0]
    out.append(("kernels_not_launched", float(len(silent)), 0.0))
    return out


def control(run, fault=None):
    """The readings of the control, the reference with TF32 on in the
    program's place (`fault=None`): its SuperPoint against the reference
    detector, and its steps against the reference's on the reference
    detector's outputs; or of a planted fault: "half_batch", the reference
    over the first half of each batch, its loss the mean over those rows."""
    w = model_weights(run)
    pool = inputs(run)[:CHECKED_STEPS]
    opt = options(run)
    hp = hyperparameters(opt)
    ref_sp, _ = _reference_models(run)
    ref_sp.load_state_dict(w["superpoint"])
    B, V = run.cell.traffic["batch"], run.cell.config["tuple_size"]

    def detect():
        g = seeds.generator(run.seed, "keypoint_fill", run.device)
        outs = []
        for batch in pool:
            H, W = batch["images"].shape[2:4]
            outs.append(ref_sp(batch["images"].reshape(B * V, H, W, 1), generator=g, chunk=V))
        return outs

    reference.float32()
    sp_raw = detect()
    sp_outputs = _sp_outputs(run, sp_raw)
    readings = {}
    if fault is None:
        reference.float32(tf32=True)
        sp_control = detect()
        reference.float32()
        readings = _keypoint_readings(run, w, pool, sp_control)
        del sp_control
    del ref_sp, sp_raw
    ref = _reference_steps(run, w, pool, sp_outputs, hp)
    if fault is None:
        reference.float32(tf32=True)
        other = _reference_steps(run, w, pool, sp_outputs, hp)
        reference.float32()
    elif fault == "half_batch":
        half = B // 2
        other = _reference_steps(run, w, [{k: v[:half] for k, v in b.items()} for b in pool],
                                 [tuple(x[:half] for x in s) for s in sp_outputs], hp)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return {**readings, **judge.training_readings(other, ref)}
