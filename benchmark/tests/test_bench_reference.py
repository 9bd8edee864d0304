"""The plain reference against the port's plain path at tiny sizes on the
CPU, on the same weights and inputs: SuperPoint, the matcher in both
Sinkhorn domains, the pose stage, and three training steps."""

import numpy as np
import pytest
import torch

from benchmark.harness import seeds, traffic, weights
from benchmark.reference import judge
from benchmark.reference import matcher as ref_matcher
from benchmark.reference import superpoint as ref_superpoint
from benchmark.reference import train as ref_train
from benchmark.reference.pose import pipeline as ref_pipeline
from e2e_multi_view_matching_tpu_torch.models import matcher as port_matcher
from e2e_multi_view_matching_tpu_torch.models import superpoint as port_superpoint
from e2e_multi_view_matching_tpu_torch.mvba import pipeline as port_pipeline

EVAL = {"views": 3, "height": 64, "width": 64, "waves": 12, "wave_scale": 0.08, "noise": 0.3,
        "focal": [50.0, 80.0], "rot_sigma": 0.1, "trans_sigma": 1.0}
SP = dict(nms_radius=3, keypoint_threshold=0.005, max_keypoints=32, remove_borders=0)
LAYERS = (1, 1)


def _weights(module, seed):
    return weights.draw(weights.state_shapes(module), seeds.generator(seed, "w", "cpu"), "cpu")


@pytest.fixture(scope="module")
def detected():
    torch.manual_seed(0)
    samples = traffic.eval_tuples(EVAL, 2, seeds.generator(5, "inputs", "cpu"), "cpu")
    images = torch.from_numpy(np.stack([s["images"] for s in samples]))
    B, V, H, W = images.shape[:4]
    ref = ref_superpoint.SuperPoint(ref_superpoint.SuperPointConfig(**SP))
    port = port_superpoint.SuperPoint(port_superpoint.SuperPointConfig(**SP))
    w = _weights(ref, 1)
    ref.load_state_dict(w)
    port.load_state_dict(w)
    frames = images.reshape(B * V, H, W, 1)
    return samples, ref, frames, port(frames), ref(frames)


def test_superpoint_matches_the_port(detected):
    samples, ref, frames, port_out, ref_out = detected
    raw, nms, desc_map = ref.detection_map(frames)
    r = judge.keypoint_readings(raw, nms, desc_map, port_out["keypoints"], port_out["scores"],
                                port_out["descriptors"], SP["keypoint_threshold"],
                                SP["nms_radius"])
    assert r["kp_gap"] == 0.0 and r["score_err"] < 1e-7 and r["desc_err"] < 1e-6
    assert torch.equal(port_out["keypoints"].sort(dim=1).values,
                       ref_out["keypoints"].sort(dim=1).values)


@pytest.mark.parametrize("domain, impl", [("scaling", "mxu"), ("log", "xla")])
def test_matcher_matches_the_port(detected, domain, impl):
    samples, _, frames, sp_out, _ = detected
    B, V = len(samples), EVAL["views"]
    K = SP["max_keypoints"]
    layers = ref_matcher.default_gnn_layers(*LAYERS)
    ref = ref_matcher.MultiViewMatcher(ref_matcher.MatcherConfig(
        gnn_layers=layers, sinkhorn_iterations=10, sinkhorn=domain, conf_mlp=True,
        match_threshold=0.01))
    port = port_matcher.MultiViewMatcher(port_matcher.MatcherConfig(
        gnn_layers=port_matcher.default_gnn_layers(*LAYERS), sinkhorn_iterations=10,
        conf_mlp=True, multi_frame_matching=True, attention_impl="xla", sinkhorn_impl=impl,
        match_threshold=0.01))
    w = _weights(ref, 2)
    ref.load_state_dict(w)
    port.load_state_dict(w)
    args = (sp_out["keypoints"].reshape(B, V, K, 2), sp_out["scores"].reshape(B, V, K),
            sp_out["descriptors"].reshape(B, V, K, -1))
    size = torch.tensor([64.0, 64.0]).expand(B, V, 2)
    kept = []
    hook = port.final_proj.register_forward_hook(lambda m, a, o: kept.append(o))
    with torch.no_grad():
        out_p = port(*args, size)
        out_r = ref(*args, (64, 64))
        mdesc = kept[0].reshape(B, V, K, -1)
        ref_mdesc = ref.descriptors(*args, (64, 64))
        log_p = ref.assignment(mdesc, pair_rows=1)
        conf = ref.confidence(mdesc, out_p["matches0"], out_p["matching_scores0"])
    hook.remove()
    r = judge.matcher_readings(ref_mdesc, log_p, conf, {**out_p, "mdesc": kept[0]}, 0.01)
    assert int((out_r["matches0"] >= 0).sum()) > 0
    assert r["gnn_err"] < 1e-6 and r["sinkhorn_err"] < 1e-5 and r["matches_off"] == 0
    assert r["conf_err"] < 1e-6
    assert torch.equal(out_p["matches0"], out_r["matches0"])
    torch.testing.assert_close(out_r["log_assignment"], log_p, rtol=0, atol=1e-5)


def test_pose_stage_matches_the_port():
    g = torch.Generator().manual_seed(3)
    B, V, K = 2, 3, 40
    kpts = torch.rand((B, V, K, 2), generator=g) * 64
    intr = torch.tensor([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]).expand(B, V, 3, 3)
    P = V * (V - 1) // 2
    matches0 = torch.stack([torch.randperm(K, generator=g) for _ in range(B * P)])
    matches0 = matches0.reshape(B, P, K).to(torch.int32)
    matches0[..., ::7] = -1
    conf = torch.rand((B, P, K), generator=g)
    e_port = port_pipeline.multi_view_pose_device(kpts, intr, matches0, conf)
    e_ref = ref_pipeline.multi_view_pose_device(kpts, intr, matches0, conf)
    torch.testing.assert_close(e_ref, e_port, rtol=0, atol=1e-6)


def test_training_steps_match_the_port():
    """Three stage-1 steps of the port's `train_step` (plain path, CPU)
    against the reference's, from the same weights, batches and detector
    outputs: losses, the first gradients and the parameters' change."""
    import types

    from e2e_multi_view_matching_tpu_torch.train.optim import build_optimizer
    from e2e_multi_view_matching_tpu_torch.train.step import TrainState, make_train_step

    p = {"views": 3, "height": 48, "width": 64, "focal": 50.0, "plane_z": 5.0, "tilt": 0.15,
         "baseline": 0.5, "rot_jitter": 0.08, "waves": 24, "wave_freq": [2.0, 9.0],
         "wave_amp": [0.3, 1.0]}
    g = seeds.generator(9, "inputs", "cpu")
    batches = [traffic.plane_scenes(p, 2, g, "cpu") for _ in range(3)]
    layers = ref_matcher.default_gnn_layers(*LAYERS)
    ref = ref_matcher.MultiViewMatcher(ref_matcher.MatcherConfig(gnn_layers=layers,
                                                                 sinkhorn_iterations=10))
    port = port_matcher.MultiViewMatcher(port_matcher.MatcherConfig(
        gnn_layers=port_matcher.default_gnn_layers(*LAYERS), sinkhorn_iterations=10,
        multi_frame_matching=True))
    w = _weights(ref, 4)
    ref.load_state_dict(w)
    port.load_state_dict(w)
    sp = port_superpoint.SuperPoint(port_superpoint.SuperPointConfig(
        max_keypoints=24, fill_with_random_keypoints=True))
    sp.load_state_dict(_weights(sp, 6))
    hp = {"lr": 1e-3, "decay_rate": 0.999, "start_decay": 0, "end_decay": 10,
          "match_reproj_err": 5.0, "unmatch_reproj_err": 15.0}
    opt = types.SimpleNamespace(pose_loss=False, rot_weight=0.0, trans_weight=0.0,
                                final_pose_match_ratio=0.99, tuple_size=3, **hp)
    optimizer = build_optimizer(port.named_parameters(), hp["lr"], hp["decay_rate"],
                                hp["start_decay"], hp["end_decay"])
    state = TrainState(matcher=port, optimizer=optimizer)
    step = make_train_step(sp, opt)
    outs = []
    hook = sp.register_forward_hook(lambda m, a, o: outs.append(o))
    fill = torch.Generator().manual_seed(1)
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(state, b, fill)["train_loss"]))
        if i == 0:
            grads = [float(torch.linalg.vector_norm(m)) / 0.1 for m in optimizer.m]
    hook.remove()
    change = [float(torch.linalg.vector_norm(q.detach() - w[n]))
              for n, q in zip(optimizer.names, optimizer.params)]
    sp_out = [(o["keypoints"].reshape(2, 3, -1, 2), o["scores"].reshape(2, 3, -1),
               o["descriptors"].reshape(2, 3, 24, -1)) for o in outs]
    r = ref_train.run_steps(ref, batches, sp_out, hp)
    assert r["names"] == optimizer.names
    readings = judge.training_readings(
        {"losses": losses, "grad_norms": grads, "change_norms": change}, r)
    assert readings["loss_gap"] < 1e-5 and readings["grad_gap"] < 1e-4
    assert readings["change_gap"] < 1e-3


def test_a_reading_that_is_not_a_number_reads_infinite():
    readings = judge.merge({}, {"a": 1e-7, "b": float("nan")})
    judge.merge(readings, {"a": 0.0, "b": 2.0})
    assert readings == {"a": 1e-7, "b": float("inf")}
