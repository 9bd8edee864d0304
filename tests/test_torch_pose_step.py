"""Stage-2 training as a whole: one train step with the pose loss of the JAX
package against the PyTorch port on the same seeded sphere-field batch and
bridged weights (CPU), then `cli.train.train` for stage 1 and stage 2.

As in `tests/test_torch_train_step.py`: the port's "cuda" ops run their plain
versions on CPU tensors (the cross layers through the same autograd function
as on the card), the JAX step runs its XLA ops, and SuperPoint runs with
threshold 0, so that both packages see the same keypoints without the random
fill.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu.train import optim as joptim  # noqa: E402
from e2e_multi_view_matching_tpu.train import step as jstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import train as tcli  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from e2e_multi_view_matching_tpu_torch.train import optim as toptim  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import step as tstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.utils import config as tconfig  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

B, V, K, H, W, D = 2, 3, 32, 64, 96, 64
SP_CFG = dict(nms_radius=4, keypoint_threshold=0.0, max_keypoints=K, remove_borders=4,
              fill_with_random_keypoints=True, descriptor_dim=D)
# match threshold 0: every mutual best match counts, so that the random-init
# matcher gives the eight-point solve enough weighted matches
MATCHER_CFG = dict(descriptor_dim=D, keypoint_encoder=(32, 64),
                   gnn_layers=("self", "cross", "self", "cross"), num_heads=4,
                   sinkhorn_iterations=20, conf_mlp=True, conf_mlp_hidden=(32, 16),
                   multi_frame_matching=True, match_threshold=0.0)
# hand-set pose weights (tuple size 3 has none of its own); pose_match_ratio
# 0.5 below, so that the pose term carries half of the loss
OPT = dict(pose_loss=True, rot_weight=2.0, trans_weight=1.0, final_pose_match_ratio=0.99,
           match_reproj_err=3.0, unmatch_reproj_err=6.0, tuple_size=V)
LR = (1e-3, 0.999992, 100, 1000)
RATIO = 0.5


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def env():
    batch = tsyn.training_batch(np.random.default_rng(0), B, V, H, W, f=80.0,
                                scene_cls=tsyn.SphereFieldScene)
    opt = types.SimpleNamespace(**OPT)
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    j_m = jm.MultiViewMatcher(jm.MatcherConfig(**MATCHER_CFG))
    sp_vars = j_sp.init({"params": jax.random.PRNGKey(1), "keypoints": jax.random.PRNGKey(2)},
                        jnp.zeros((1, H, W, 1)))
    m_vars = j_m.init(jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
                      jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), float(H)))
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG)).eval()
    sp.load_state_dict(state_dict_from_flax(to_np(sp_vars)))
    return types.SimpleNamespace(batch=batch, opt=opt, j_sp=j_sp, j_m=j_m, sp_vars=sp_vars,
                                 m_vars=to_np(m_vars), sp=sp)


def test_stage2_train_step_matches_jax(env):
    """One stage-2 step (conf MLP in train mode, pose loss through the
    weighted eight-point solve, ratio 0.5), same weights, the port's own
    SuperPoint in the loop. Losses 1e-4 relative; every gradient leaf, the
    conf MLP's included, within 1e-4 of the largest leaf norm; running
    statistics 1e-5; the ramp moves the ratio by 2.5e-5."""
    tx = joptim.build_optimizer(*LR, pose_loss=True, grad_clip=0.1)
    j_state = jstep.create_train_state(env.m_vars["params"], env.m_vars["batch_stats"],
                                       tx)._replace(pose_match_ratio=jnp.asarray(RATIO))
    step = jax.jit(jstep.make_train_step(env.j_sp, env.j_m, tx, env.opt, return_grads=True))
    new_state, metrics = step(j_state, env.sp_vars,
                              {k: jnp.asarray(v) for k, v in env.batch.items()},
                              jax.random.PRNGKey(5))
    metrics = to_np(metrics)

    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        **MATCHER_CFG, attention_impl="cuda", sinkhorn_impl="cuda"))
    matcher.load_state_dict(state_dict_from_flax(env.m_vars))
    state = tstep.TrainState(matcher=matcher, optimizer=toptim.build_optimizer(
        matcher.named_parameters(), *LR, pose_loss=True, grad_clip=0.1),
        pose_match_ratio=RATIO)
    out = tstep.make_train_step(env.sp, env.opt, return_grads=True)(
        state, {k: t(v) for k, v in env.batch.items()}, torch.Generator().manual_seed(0))
    assert float(metrics["rot_loss"]) > 0 and float(metrics["transl_loss"]) > 0
    for k in ("train_loss", "match_loss", "rot_loss", "transl_loss"):
        np.testing.assert_allclose(float(out[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    assert state.pose_match_ratio == pytest.approx(float(new_state.pose_match_ratio))
    assert state.pose_match_ratio == pytest.approx(RATIO + 2.5e-5)

    ref = flat(metrics["grads"])
    ours = flat(flax_from_state_dict(out["grads"])["params"])
    assert set(ours) == set(ref) and any(k.startswith("conf_mlp/") for k in ref)
    top = max(np.linalg.norm(g) for g in ref.values())
    assert top > 0 and np.linalg.norm(ref["conf_mlp/dense_0/kernel"]) > 0
    worst = max(np.linalg.norm(ours[k] - ref[k]) / top for k in ref)
    assert worst <= 1e-4, worst

    after = flax_from_state_dict(state.matcher.state_dict())
    ref_bs, ours_bs = flat(to_np(new_state.batch_stats)), flat(after["batch_stats"])
    assert set(ref_bs) == set(ours_bs) and any(k.startswith("conf_mlp/") for k in ref_bs)
    for k in ref_bs:
        np.testing.assert_allclose(ours_bs[k], ref_bs[k], atol=1e-5, err_msg=k)


def test_cli_train_stage1_then_stage2(tmp_path, monkeypatch):
    """`cli.train.train` on the CPU, the two stages in sequence on sphere-field
    pairs: stage 1 writes its checkpoints; stage 2 (`--pose_loss
    --init_exp_name`) takes the stage-1 run's best weights, keeps its fresh
    conf MLP and a fresh optimizer (another parameter grouping), starts at the
    next epoch, continues the step count and the ratio ramp from the
    checkpoint, and trains to finite match and pose losses."""
    full = tconfig.apply_dataset_defaults

    def small(opt, device):
        full(opt, device)
        opt.max_keypoints, opt.remove_borders, opt.keypoint_threshold = 16, 4, 0.0
        opt.gnn_layers, opt.cross_attention_layers = 1, 1
        opt.match_reproj_err, opt.unmatch_reproj_err = 3.0, 6.0
        return opt

    monkeypatch.setattr(tcli, "apply_dataset_defaults", small)
    rng = np.random.default_rng(1)
    batches = [tsyn.training_batch(rng, 2, 2, H, W, f=80.0, scene_cls=tsyn.SphereFieldScene)
               for _ in range(2)]
    feed = lambda epoch: iter(batches)  # noqa: E731
    common = ["--checkpoint_dir", str(tmp_path), "--dataset", "scannet", "--tuple_size", "2",
              "--batch_size", "2", "--sinkhorn_iterations", "10", "--i_train", "1",
              "--no_tensorboard"]
    opt1 = tcli.parse_args(common + ["--n_epochs", "1", "--max_steps", "2"])
    stage1 = tcli.train(opt1, feed, feed, device="cpu")
    assert stage1.step == 2 and not hasattr(stage1.matcher, "conf_mlp")

    logged = []
    monkeypatch.setattr(tcli.log, "info", lambda msg, *a: logged.append(msg % a))
    opt2 = tcli.parse_args(common + ["--pose_loss", "--init_exp_name", opt1.exp_name,
                                     "--n_epochs", "2", "--max_steps", "4"])
    stage2 = tcli.train(opt2, feed, feed, device="cpu")
    assert (opt2.rot_weight, opt2.trans_weight, opt2.grad_clip) == (1597.0, 270.0, 0.1)
    assert stage2.step == 4 and int(stage2.optimizer.count) == 2
    assert stage2.pose_match_ratio == pytest.approx(2 * tstep.RATIO_INCREMENT)
    assert stage2.optimizer.skip_nonfinite and stage2.optimizer.grad_clip == 0.1
    assert int(stage2.optimizer.skipped) == 0
    assert any(n.startswith("conf_mlp.") for n in stage2.optimizer.names)
    for a, b in zip(stage1.matcher.final_proj.parameters(),
                    stage2.matcher.final_proj.parameters()):
        assert not torch.equal(a, b)  # loaded, then trained on
    exp2 = tmp_path / opt2.exp_name
    assert (exp2 / "000001_model.ckpt").exists() and not (exp2 / "000000_model.ckpt").exists()
    assert any(m.startswith("initialized from") and "conf_mlp" in m for m in logged)
    losses = [float(m.rsplit(" ", 1)[1]) for m in logged if " it " in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
