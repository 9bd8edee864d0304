"""The stage-1 training slice as a whole: one train step of the JAX package
against the PyTorch port on the same seeded batch and bridged weights (CPU),
then the port's `cli.train.train` loop.

The port's "cuda" ops run their plain versions on CPU tensors; the JAX step
runs its XLA ops (no TPU here). SuperPoint runs with threshold 0, so every
frame yields K detections and the random keypoint fill, whose generators
differ between the packages, never fires; the port's own SuperPoint must then
find the JAX keypoints exactly.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import synthetic as jsyn  # noqa: E402
from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu.train import optim as joptim  # noqa: E402
from e2e_multi_view_matching_tpu.train import step as jstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import train as tcli  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import gt_matches as tgt  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import optim as toptim  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import step as tstep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.utils import config as tconfig  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

B, V, K, H, W, D = 2, 3, 32, 64, 96, 64
SP_CFG = dict(nms_radius=4, keypoint_threshold=0.0, max_keypoints=K, remove_borders=4,
              fill_with_random_keypoints=True, descriptor_dim=D)
MATCHER_CFG = dict(descriptor_dim=D, keypoint_encoder=(32, 64),
                   gnn_layers=("self", "cross", "self", "cross"), num_heads=4,
                   sinkhorn_iterations=20, conf_mlp=False, multi_frame_matching=True)
# thresholds shrunk in proportion to the small frames, as the JAX train tests do
OPT = dict(pose_loss=False, rot_weight=0.0, trans_weight=0.0, final_pose_match_ratio=0.99,
           match_reproj_err=3.0, unmatch_reproj_err=6.0, tuple_size=V)
LR = (1e-3, 0.999992, 100, 1000)


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


def port_state(m_vars):
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        **MATCHER_CFG, attention_impl="cuda", sinkhorn_impl="cuda"))
    matcher.load_state_dict(state_dict_from_flax(m_vars))
    return tstep.TrainState(matcher=matcher, optimizer=toptim.build_optimizer(
        matcher.named_parameters(), *LR))


@pytest.fixture(scope="module")
def env():
    batch = tsyn.training_batch(np.random.default_rng(0), 2 * B, V, H, W, f=80.0)
    opt = types.SimpleNamespace(**OPT)
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    j_m = jm.MultiViewMatcher(jm.MatcherConfig(**MATCHER_CFG))
    sp_vars = j_sp.init({"params": jax.random.PRNGKey(1), "keypoints": jax.random.PRNGKey(2)},
                        jnp.zeros((1, H, W, 1)))
    m_vars = j_m.init(jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
                      jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), float(H)))
    tx = joptim.build_optimizer(*LR)
    j_state = jstep.create_train_state(m_vars["params"], m_vars["batch_stats"], tx)
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG)).eval()
    sp.load_state_dict(state_dict_from_flax(to_np(sp_vars)))
    first = {k: v[:B] for k, v in batch.items()}
    return types.SimpleNamespace(
        batch=batch, first=first, opt=opt, j_sp=j_sp, j_m=j_m, sp_vars=sp_vars,
        m_vars=to_np(m_vars), tx=tx, j_state=j_state, sp=sp,
        gen=torch.Generator().manual_seed(0), key=jax.random.PRNGKey(5))


@pytest.fixture(scope="module")
def jax_step(env):
    """One jitted JAX train step on the first B tuples, shared by the tests."""
    step = jax.jit(jstep.make_train_step(env.j_sp, env.j_m, env.tx, env.opt,
                                         return_grads=True))
    new_state, metrics = step(env.j_state, env.sp_vars,
                              {k: jnp.asarray(v) for k, v in env.first.items()}, env.key)
    return new_state, to_np(metrics)


def test_synthetic_batch_matches_the_jax_package(env):
    """The port's copy of the plane scene and its Fourier texture give the
    JAX package's arrays for the same seed (same numpy code: exact)."""
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    ours = tsyn.PlaneScene(rng_a, n_views=V, H=H, W=W, f=80.0)
    ref = jsyn.PlaneScene(rng_b, n_views=V, H=H, W=W, f=80.0)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    np.testing.assert_array_equal(ours.intr, ref.intr)
    for v in range(V):
        np.testing.assert_array_equal(ours.depth_map(v), ref.depth_map(v))
        np.testing.assert_array_equal(tsyn.fourier_texture_image(ours, v, rng=rng_a),
                                      jsyn.fourier_texture_image(ref, v, rng=rng_b))
    assert env.batch["images"].shape == (2 * B, V, H, W, 1)
    assert env.batch["images"].dtype == env.batch["depths"].dtype == np.float32
    assert 0.1 <= env.batch["images"].min() and env.batch["images"].max() <= 0.9


def test_train_step_matches_jax(env, jax_step):
    """One stage-1 step, same weights, the port's own SuperPoint in the loop.
    Loss 1e-5 relative; every gradient leaf within 1e-4 of the largest leaf
    norm (f32 reduction order through 4 GNN layers and 20 Sinkhorn
    iterations); running statistics after the step 1e-5 (flax's biased
    variance and momentum); the step counter. Parameters after Adam only
    loosely (5e-3 absolute, and 95% of the entries to 1e-5): Adam turns
    reduction-order ulps on near-zero gradients, such as the biases in front
    of a BatchNorm, into rate-sized sign flips."""
    new_state, metrics = jax_step
    state = port_state(env.m_vars)
    step = tstep.make_train_step(env.sp, env.opt, return_grads=True)
    out = step(state, {k: t(v) for k, v in env.first.items()}, env.gen)
    assert state.step == int(new_state.step) == 1 and state.pose_match_ratio == 0.0
    for k in ("train_loss", "match_loss", "rot_loss", "transl_loss"):
        np.testing.assert_allclose(float(out[k]), float(metrics[k]), rtol=1e-5)
    assert float(out["train_loss"]) > 0

    ref = flat(metrics["grads"])
    ours = flat(flax_from_state_dict(out["grads"])["params"])
    assert set(ours) == set(ref) and len(ref) > 40
    top = max(np.linalg.norm(g) for g in ref.values())
    assert top > 0
    for k in ref:
        assert np.linalg.norm(ours[k] - ref[k]) <= 1e-4 * top, k

    after = flax_from_state_dict(state.matcher.state_dict())
    ref_bs, ours_bs = flat(to_np(new_state.batch_stats)), flat(after["batch_stats"])
    assert set(ref_bs) == set(ours_bs)
    for k in ref_bs:
        np.testing.assert_allclose(ours_bs[k], ref_bs[k], atol=1e-5, err_msg=k)
    assert any(np.abs(ref_bs[k] - flat(env.m_vars["batch_stats"])[k]).max() > 1e-3
               for k in ref_bs)  # the statistics did move

    ref_p, ours_p = flat(to_np(new_state.params)), flat(after["params"])
    diffs = np.concatenate([np.abs(ours_p[k] - ref_p[k]).ravel() for k in ref_p])
    assert diffs.max() <= 5e-3
    assert np.mean(diffs <= 1e-5) >= 0.95


def test_superpoint_in_the_step_finds_the_jax_keypoints_without_fill(env):
    """The premise of the step comparison: K detections per frame (no random
    fill on either side), identical keypoints, and GT matches among them."""
    images = env.first["images"].reshape(B * V, H, W, 1)
    ref = to_np(env.j_sp.apply(env.sp_vars, images, rngs={"keypoints": env.key}))
    out = env.sp(t(images), generator=env.gen)
    assert (ref["scores"] > 0).all()
    np.testing.assert_array_equal(out["keypoints"].numpy(), ref["keypoints"])
    np.testing.assert_allclose(out["descriptors"].numpy(), ref["descriptors"], atol=1e-5)
    gi, gw = tgt.gt_matches_all_pairs(
        out["keypoints"].reshape(B, V, K, 2), *(t(env.first[k]) for k in
                                                ("intr", "poses", "depths")), 3.0, 6.0)
    assert int((gi[:, :, 0, :-1] >= 0).sum()) >= 10 and int((gw > 0).sum()) > 100


def test_grad_accum_matches_full_batch_and_jax(env):
    """grad_accum=2. In the port, against the full batch: BatchNorm sees each
    microbatch on its own, so the comparison is the JAX test's, a duplicated
    batch, whose two halves each give the full batch's gradients (1e-5
    relative on the loss, 1e-5 of the largest leaf norm on the gradients).
    Against JAX: the same accumulated step
    (`lax.scan` over the microbatches) on 2B different tuples: loss 1e-5,
    gradients 1e-4 of the largest leaf norm, running statistics (moved twice)
    1e-5."""
    as_t = lambda b: {k: t(v) for k, v in b.items()}  # noqa: E731
    dup = {k: np.concatenate([v, v]) for k, v in env.first.items()}
    one = tstep.make_train_step(env.sp, env.opt, return_grads=True)
    two = tstep.make_train_step(env.sp, env.opt, grad_accum=2, return_grads=True)
    m1 = one(port_state(env.m_vars), as_t(env.first), env.gen)
    m2 = two(port_state(env.m_vars), as_t(dup), env.gen)
    np.testing.assert_allclose(float(m2["train_loss"]), float(m1["train_loss"]), rtol=1e-5)
    top = max(float(g.norm()) for g in m1["grads"].values())
    for k, g in m1["grads"].items():
        assert float((m2["grads"][k] - g).norm()) <= 1e-5 * top, k

    j_two = jax.jit(jstep.make_train_step(env.j_sp, env.j_m, env.tx, env.opt, grad_accum=2,
                                          return_grads=True))
    new_state, metrics = j_two(env.j_state, env.sp_vars,
                               {k: jnp.asarray(v) for k, v in env.batch.items()}, env.key)
    state = port_state(env.m_vars)
    out = two(state, as_t(env.batch), env.gen)
    np.testing.assert_allclose(float(out["train_loss"]), float(metrics["train_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["match_loss"]), float(metrics["match_loss"]),
                               rtol=1e-5)
    ref = flat(to_np(metrics["grads"]))
    ours = flat(flax_from_state_dict(out["grads"])["params"])
    top = max(np.linalg.norm(g) for g in ref.values())
    for k in ref:
        assert np.linalg.norm(ours[k] - ref[k]) <= 1e-4 * top, k
    ref_bs = flat(to_np(new_state.batch_stats))
    ours_bs = flat(flax_from_state_dict(state.matcher.state_dict())["batch_stats"])
    for k in ref_bs:
        np.testing.assert_allclose(ours_bs[k], ref_bs[k], atol=1e-5, err_msg=k)


def test_eval_step_matches_jax_and_takes_the_eval_sinkhorn(env, monkeypatch):
    """Validation loss 1e-5 relative. And the forward value under grad is not
    the eval forward: without grad the "cuda" Sinkhorn solves in the scaling
    domain, under grad in the log domain at the rounded-up count (on the CPU:
    their plain versions). The spies see which one each step takes."""
    ev = jax.jit(jstep.make_eval_step(env.j_sp, env.j_m, env.opt))
    ref = to_np(ev(env.j_state, env.sp_vars,
                   {k: jnp.asarray(v) for k, v in env.first.items()}, env.key))
    calls = []
    for name in ("log_sinkhorn", "log_sinkhorn_mxu"):
        fn = getattr(sinkhorn_cuda, name)
        monkeypatch.setattr(sinkhorn_cuda, name, lambda *a, _n=name, _f=fn, **k:
                            (calls.append((_n, a[3], torch.is_grad_enabled())), _f(*a, **k))[1])
    state = port_state(env.m_vars)
    state.matcher = tm.MultiViewMatcher(dataclasses.replace(
        state.matcher.config, sinkhorn_iterations=15))
    state.matcher.load_state_dict(state_dict_from_flax(env.m_vars))
    batch = {k: t(v) for k, v in env.first.items()}
    tstep.make_eval_step(env.sp, env.opt)(state, batch, env.gen)
    tstep.make_train_step(env.sp, env.opt)(
        tstep.TrainState(state.matcher, toptim.build_optimizer(
            state.matcher.named_parameters(), *LR)), batch, env.gen)
    assert calls == [("log_sinkhorn_mxu", 15, False), ("log_sinkhorn", 20, True)]

    state = port_state(env.m_vars)
    before = {k: v.clone() for k, v in state.matcher.state_dict().items()}
    out = tstep.make_eval_step(env.sp, env.opt)(state, batch, env.gen)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, atol=1e-7)
    assert not out["val_loss"].requires_grad
    for k, v in state.matcher.state_dict().items():
        assert torch.equal(v, before[k]), k  # no update, running statistics untouched


def _small_defaults(monkeypatch):
    """`apply_dataset_defaults` at a test size: the ScanNet blocks with fewer
    keypoints, one GNN block and thresholds in proportion to 64 x 96 frames."""
    full = tconfig.apply_dataset_defaults

    def small(opt, device):
        full(opt, device)
        opt.max_keypoints, opt.remove_borders, opt.keypoint_threshold = 16, 4, 0.0
        opt.gnn_layers, opt.cross_attention_layers = 1, 1
        opt.match_reproj_err, opt.unmatch_reproj_err = 3.0, 6.0
        return opt

    monkeypatch.setattr(tcli, "apply_dataset_defaults", small)


def test_cli_train_writes_checkpoints_resumes_and_initializes(env, tmp_path, monkeypatch):
    """`cli.train.train` on the CPU: two steps write `cfg.json` and the three
    checkpoint names; `--exp_name` resumes at step 2 with the saved weights
    and config; `--init_exp_name` starts a new run from the best weights with
    a fresh optimizer; the first step's gradients are dumped on request."""
    _small_defaults(monkeypatch)
    batches = [{k: v[i:i + 2] for k, v in env.batch.items()} for i in (0, 2)]
    feed = lambda epoch: iter(batches)  # noqa: E731
    common = ["--checkpoint_dir", str(tmp_path), "--dataset", "scannet", "--tuple_size",
              str(V), "--batch_size", "2", "--sinkhorn_iterations", "10", "--i_train", "1",
              "--no_tensorboard"]
    dump = str(tmp_path / "grads")
    opt = tcli.parse_args(common + ["--n_epochs", "1", "--max_steps", "2",
                                    "--dump_first_grad", dump])
    state = tcli.train(opt, feed, feed, device="cpu")
    assert state.step == 2 and int(state.optimizer.count) == 2
    exp_dir = tmp_path / opt.exp_name
    assert {p.name for p in exp_dir.iterdir()} == {
        "cfg.json", "last_model.ckpt", "000000_model.ckpt", "best_model.ckpt"}
    cfg = json.load(open(exp_dir / "cfg.json"))
    assert cfg["max_keypoints"] == 16 and cfg["attention_impl"] == "xla"
    assert cfg["lr"] == pytest.approx(1e-4 * np.sqrt(V * 2 / 128.0))
    grads = np.load(dump + "_p0.npz")
    assert set(grads.files) == set(state.optimizer.names)
    assert all(np.isfinite(grads[k]).all() for k in grads.files)
    assert any(np.abs(grads[k]).max() > 0 for k in grads.files)

    resumed_opt = tcli.parse_args(common + ["--exp_name", opt.exp_name, "--n_epochs", "2"])
    resumed = tcli.train(resumed_opt, feed, feed, device="cpu")
    # the saved config rules (max_steps 2, n_epochs 1): nothing is left to do
    assert resumed.step == 2 and resumed_opt.max_steps == 2
    for a, b in zip(state.matcher.state_dict().values(),
                    resumed.matcher.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(state.optimizer.m[0], resumed.optimizer.m[0])

    init_opt = tcli.parse_args(common + ["--init_exp_name", opt.exp_name, "--n_epochs", "1",
                                         "--max_steps", "1"])
    started = tcli.train(init_opt, feed, feed, device="cpu")
    assert init_opt.exp_name != opt.exp_name and os.path.isdir(tmp_path / init_opt.exp_name)
    # weights and the step counter come from the checkpoint, the optimizer is fresh
    assert started.step == 3 and int(started.optimizer.count) == 1


def test_cli_flags_match_jax_and_unported_modes_are_refused(capsys):
    """`parse_args` keeps the JAX flags' names and defaults (the port adds
    `--device`); distributed flags, profiling and `main()` say what they
    wait for instead of running something else."""
    from e2e_multi_view_matching_tpu.cli import train as jcli

    ours, ref = vars(tcli.parse_args([])), vars(jcli.parse_args([]))
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    for k in ref:
        assert ours[k] == ref[k], k
    for flags in (["--model_parallel", "2"], ["--multi_host"], ["--profile_steps", "1,2"]):
        with pytest.raises(SystemExit):
            tcli.parse_args(flags)
    assert "Queue 1 item 13" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="dataset readers"):
        tcli.main(["--checkpoint_dir", "x"])
