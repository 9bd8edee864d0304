"""Parity of the PyTorch port's training pieces with the JAX package: GT
matches, losses, the optimizer and its schedule, checkpoints (CPU).

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in the port; each tolerance is stated where it is used.
"""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import gt_matches as jgt  # noqa: E402
from e2e_multi_view_matching_tpu.data.synthetic import PlaneScene  # noqa: E402
from e2e_multi_view_matching_tpu.train import losses as jlosses  # noqa: E402
from e2e_multi_view_matching_tpu.train import optim as joptim  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import gt_matches as tgt  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import losses as tlosses  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import optim as toptim  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train.step import TrainState  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401


def t(x):
    return torch.from_numpy(np.array(x))


def tuple_case(rng, V=3, K=48, n_true=24):
    """One V-view plane scene: the first keypoints of every view are exact
    projections of the same world points, the rest are random pixels."""
    scene = PlaneScene(rng, n_views=V)
    pix0 = rng.uniform([15, 15], [scene.W - 15, scene.H - 15], size=(4 * n_true, 2))
    X = scene.unproject(0, pix0)
    proj = [scene.project(v, X)[0] for v in range(V)]
    inside = np.all([(p[:, 0] > 10) & (p[:, 0] < scene.W - 10) & (p[:, 1] > 10)
                     & (p[:, 1] < scene.H - 10) for p in proj], axis=0)
    keep = np.flatnonzero(inside)[:n_true]
    assert len(keep) >= n_true // 2
    kpts = np.stack([np.concatenate([
        p[keep], rng.uniform([10, 10], [scene.W - 10, scene.H - 10], size=(K - len(keep), 2))])
        for p in proj]).astype(np.float32)
    depths = np.stack([scene.depth_map(v) for v in range(V)])
    return kpts, scene.intr.astype(np.float32), scene.poses.astype(np.float32), depths


class TestGtMatches:
    def test_all_pairs_match_jax(self, rng):
        """Three tuples: true matches; a view with a band of invalid depth;
        and a tuple without any depth (every entry dropped, the `invalid_w`
        edge). Indices equal; weights to 1e-6 (the same f32 formulas)."""
        cases = [tuple_case(rng) for _ in range(3)]
        kpts, intr, poses, depths = (np.stack([c[i] for c in cases]) for i in range(4))
        depths[1, 1, 30:70] = 0.0
        depths[2] = 0.0
        gi_ref, gw_ref = jgt.gt_matches_all_pairs(kpts, intr, poses, depths)
        gi, gw = tgt.gt_matches_all_pairs(t(kpts), t(intr), t(poses), t(depths))
        assert gi.dtype == torch.int32 and gi.shape == (3, 3, 2, 49)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(gi_ref))
        np.testing.assert_allclose(gw.numpy(), np.asarray(gw_ref), atol=1e-6)
        assert (gi.numpy()[0, :, 0, :-1] >= 0).sum() >= 30  # true matches were found
        assert (gi.numpy()[2] == -1).all() and (gw.numpy()[2] == 0).all()
        assert 0 < (gi.numpy()[1, 0, 0] >= 0).sum() < (gi.numpy()[0, 0, 0] >= 0).sum() + 24

    def test_pair_thresholds_and_4x4_intrinsics(self, rng):
        """`gt_matches_of_pair` with (4, 4) intrinsics and tighter thresholds."""
        kpts, intr, poses, depths = tuple_case(rng, V=2)
        intr4 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        intr4[:, :3, :3] = intr
        T = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
        args = (kpts[0][None], kpts[1][None], intr4[0][None], intr4[1][None], T[None],
                depths[0][None], depths[1][None])
        gi_ref, gw_ref = jgt.gt_matches_of_pair(*(jnp.asarray(a) for a in args), 2.0, 8.0)
        gi, gw = tgt.gt_matches_of_pair(*(t(a) for a in args), 2.0, 8.0)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(gi_ref))
        np.testing.assert_allclose(gw.numpy(), np.asarray(gw_ref), atol=1e-6)


class TestLosses:
    def _case(self, rng, B=2, P=3, K=12):
        log_p = np.log(rng.uniform(0.01, 1.0, size=(B, P, K + 1, K + 1))).astype(np.float32)
        gi = rng.integers(-1, K, size=(B, P, 2, K + 1)).astype(np.int32)
        gw = rng.uniform(0, 2, size=(B, P, 2, K + 1)).astype(np.float32)
        return log_p, gi, gw

    def test_match_loss_of_pair(self, rng):
        """1e-5 relative: one gather and one weighted sum in f32."""
        log_p, gi, gw = self._case(rng)
        ref = jlosses.match_loss_of_pair(log_p[:, 0], gi[:, 0], gw[:, 0])
        out = tlosses.match_loss_of_pair(t(log_p[:, 0]), t(gi[:, 0]), t(gw[:, 0]))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)

    def test_matcher_and_combined_losses(self, rng):
        """Stage 1: the sum over pairs and the blend, 1e-5 relative."""
        log_p, gi, gw = self._case(rng)
        ref = jlosses.matcher_losses({"log_assignment": jnp.asarray(log_p)}, gi, gw,
                                     None, None, None, pose_loss=False)
        out = tlosses.matcher_losses({"log_assignment": t(log_p)}, t(gi), t(gw),
                                     None, None, None, pose_loss=False)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5)
        tot_ref, sc_ref = jlosses.combine_losses(ref, 3, 0.25, 726.0, 244.0)
        tot, sc = tlosses.combine_losses(out, 3, 0.25, 726.0, 244.0)
        np.testing.assert_allclose(float(tot), float(tot_ref), rtol=1e-5)
        for k in sc_ref:
            np.testing.assert_allclose(float(sc[k]), float(sc_ref[k]), rtol=1e-5)


def _opt_case(rng):
    """Parameters and three fixed gradient sets, as a flax-style tree and as
    the port's (name, parameter) list; one group is the conf MLP's."""
    shapes = {"gnn.w": (4, 3), "gnn.b": (3,), "conf_mlp.dense_0.w": (5,)}
    values = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]

    def tree(flat):
        return {"gnn": {"w": jnp.asarray(flat["gnn.w"]), "b": jnp.asarray(flat["gnn.b"])},
                "conf_mlp": {"dense_0": {"w": jnp.asarray(flat["conf_mlp.dense_0.w"])}}}

    def flat(tr):
        return {"gnn.w": np.asarray(tr["gnn"]["w"]), "gnn.b": np.asarray(tr["gnn"]["b"]),
                "conf_mlp.dense_0.w": np.asarray(tr["conf_mlp"]["dense_0"]["w"])}

    named = [(n, t(v).clone()) for n, v in values.items()]
    return values, grads, tree, flat, named


class TestOptim:
    @pytest.mark.parametrize("args", [
        (5, 8, 1, 1e-4, 0.999992, 1e5, 9e5, "scannet"),
        (5, 8, 3, 1e-4, 0.999992, 1e5, 9e5, "scannet"),
        (2, 16, 1, 1e-4, 0.999992, 5e4, 9e5, "megadepth"),
        (5, 4, 2, 2e-4, 0.99999, 5e4, 9e5, "matterport")])
    def test_scale_lr_is_exact(self, args):
        assert toptim.scale_lr(*args) == joptim.scale_lr(*args)

    def test_schedule_matches_jax_over_the_window_edges(self):
        """The ScanNet 5-tuple batch-8 schedule at the window's edges. Both
        sides raise the float32-rounded decay rate to a float32 exponent;
        1e-7 relative allows the last bit of the two `pow` implementations."""
        base, rate, start, end = joptim.scale_lr(5, 8, 1, 1e-4, 0.999992, 1e5, 9e5, "scannet")
        ref = joptim.windowed_exponential_schedule(base, rate, start, end)
        ours = toptim.windowed_exponential_schedule(base, rate, start, end)
        for step in (0, 1, start - 1, start, start + 1, (start + end) // 2, end - 1, end,
                     end + 1, 3 * end):
            a = float(ours(torch.tensor(step)))
            b = float(ref(jnp.asarray(step)))
            np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=f"step {step}")
        assert float(ours(torch.tensor(start))) == np.float32(base)
        assert float(ours(torch.tensor(3 * end))) == float(ours(torch.tensor(end)))
        assert float(ours(torch.tensor(end))) < 0.01 * base

    @pytest.mark.parametrize("pose_loss", [False, True])
    def test_adam_three_steps_match_optax(self, rng, pose_loss):
        """Three updates on fixed gradients inside the decay window against
        `build_optimizer` of the JAX package (optax): parameters to 1e-6.
        With `pose_loss` the value clip (0.1, before Adam) and the conf-MLP
        group's fixed rate take part."""
        values, grads, tree, flat, named = _opt_case(rng)
        tx = joptim.build_optimizer(1e-2, 0.9, 1, 3, pose_loss=pose_loss, conf_mlp_lr=1e-3)
        params = tree(values)
        state = tx.init(params)
        opt = toptim.build_optimizer(named, 1e-2, 0.9, 1, 3, pose_loss=pose_loss,
                                     conf_mlp_lr=1e-3)
        for g in grads:
            updates, state = tx.update(tree(g), state, params)
            params = optax.apply_updates(params, updates)
            opt.step([t(g[n]) for n in opt.names])
            ref = flat(params)
            for n, p in zip(opt.names, opt.params):
                np.testing.assert_allclose(p.numpy(), ref[n], atol=1e-6, err_msg=n)
        assert int(opt.count) == 3 and int(opt.skipped) == 0

    def test_conf_mlp_group_has_its_fixed_rate(self):
        """Adam's first update has the size of the rate: the schedule's for
        the main group, 1e-4 for the conf MLP (the JAX test's check)."""
        named = [("gnn.w", torch.ones(4)), ("conf_mlp.dense_0.w", torch.ones(4))]
        opt = toptim.build_optimizer(named, 1e-3, 1.0, 0, 0, pose_loss=True,
                                     conf_mlp_lr=1e-4, grad_clip=-1)
        opt.step([torch.ones(4), torch.ones(4)])
        np.testing.assert_allclose(1.0 - named[0][1].numpy(), 1e-3, rtol=1e-3)
        np.testing.assert_allclose(1.0 - named[1][1].numpy(), 1e-4, rtol=1e-3)

    def test_nonfinite_step_is_skipped_and_counted(self, rng):
        """A NaN gradient leaves parameters, moments and the step count as
        they were and counts the skip; the next good step equals optax's
        (whose guard did the same). Without `pose_loss` there is no guard."""
        values, grads, tree, flat, named = _opt_case(rng)
        tx = joptim.build_optimizer(1e-2, 0.9, 0, 10, pose_loss=True)
        params = tree(values)
        state = tx.init(params)
        opt = toptim.build_optimizer(named, 1e-2, 0.9, 0, 10, pose_loss=True)
        bad = {n: g.copy() for n, g in grads[1].items()}
        bad["gnn.b"][1] = np.nan
        for i, g in enumerate((grads[0], bad, grads[2])):
            before = ([p.clone() for p in opt.params], [m.clone() for m in opt.m],
                      [v.clone() for v in opt.v], int(opt.count))
            updates, state = tx.update(tree(g), state, params)
            params = optax.apply_updates(params, updates)
            opt.step([t(g[n]) for n in opt.names])
            if i == 1:
                for old, new in zip(before[0] + before[1] + before[2],
                                    opt.params + opt.m + opt.v):
                    assert torch.equal(old, new)
                assert int(opt.count) == before[3] == 1
            ref = flat(params)
            for n, p in zip(opt.names, opt.params):
                np.testing.assert_allclose(p.numpy(), ref[n], atol=1e-6, err_msg=n)
        assert int(opt.skipped) == int(state.skipped) == 1 and int(opt.count) == 2
        plain = toptim.build_optimizer([("w", torch.ones(2))], 1e-2, 0.9, 0, 10)
        assert not plain.skip_nonfinite and plain.grad_clip < 0


def _state(conf_mlp, seed):
    torch.manual_seed(seed)
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        descriptor_dim=32, keypoint_encoder=(16,), gnn_layers=("self", "cross"),
        conf_mlp=conf_mlp, conf_mlp_hidden=(16,)))
    opt = toptim.build_optimizer(matcher.named_parameters(), 1e-3, 0.999, 0, 10,
                                 pose_loss=conf_mlp)
    return TrainState(matcher=matcher, optimizer=opt)


class TestCheckpoint:
    def test_round_trip(self, tmp_path):
        """Weights, running statistics, moments, counters and scalars come
        back bit for bit, under the reference's file names."""
        state = _state(False, 0)
        state.optimizer.step([torch.full_like(p, 0.01) for p in state.optimizer.params])
        state.step, state.pose_match_ratio = 7, 0.125
        for name in ("last_model.ckpt", "000003_model.ckpt", "best_model.ckpt"):
            tckpt.save_checkpoint(str(tmp_path), name, state, 3, 0.5)
        assert not list(tmp_path.glob("*.tmp"))
        for model_id in ("last", 3, "best"):
            fresh = _state(False, 1)
            fresh, epoch, min_val, info = tckpt.load_checkpoint(str(tmp_path), fresh, model_id)
            assert (epoch, min_val, fresh.step, fresh.pose_match_ratio) == (3, 0.5, 7, 0.125)
            assert info == {"missing": [], "unexpected": []}
            for (k, a), b in zip(state.matcher.state_dict().items(),
                                 fresh.matcher.state_dict().values()):
                assert torch.equal(a, b), k
            for a, b in zip(state.optimizer.m + state.optimizer.v,
                            fresh.optimizer.m + fresh.optimizer.v):
                assert torch.equal(a, b)
            assert int(fresh.optimizer.count) == 1
        kept = _state(False, 1)
        tckpt.load_checkpoint(str(tmp_path), kept, "last", load_opt_state=False)
        assert int(kept.optimizer.count) == 0

    def test_stage1_checkpoint_grafts_into_stage2_model(self, tmp_path):
        """A stage-1 checkpoint (no conf MLP) loaded into a stage-2 model:
        shared weights are taken, the fresh conf MLP is kept and reported as
        missing, and the optimizer of another grouping keeps its fresh state."""
        stage1 = _state(False, 0)
        stage1.optimizer.step([torch.full_like(p, 0.01) for p in stage1.optimizer.params])
        tckpt.save_checkpoint(str(tmp_path), "best_model.ckpt", stage1, 0, 1.0)
        stage2 = _state(True, 1)
        fresh_conf = stage2.matcher.conf_mlp.dense_0.weight.clone()
        stage2, _, _, info = tckpt.load_checkpoint(str(tmp_path), stage2, "best")
        assert info["missing"] and all(k.startswith("conf_mlp.") for k in info["missing"])
        assert info["unexpected"] == []
        assert torch.equal(stage2.matcher.conf_mlp.dense_0.weight, fresh_conf)
        assert torch.equal(stage2.matcher.final_proj.weight, stage1.matcher.final_proj.weight)
        assert int(stage2.optimizer.count) == 0

    def test_config_round_trip(self, tmp_path):
        cfg = vars(types.SimpleNamespace(dataset="scannet", lr=1e-4, exp_name=None))
        tckpt.save_config(str(tmp_path / "exp"), cfg)
        assert (tmp_path / "exp" / "cfg.json").exists()
        assert tckpt.load_config(str(tmp_path / "exp")) == cfg
