"""Both CLI `main()`s of the port on the CPU (`--device cpu`), from
ScanNet-format trees written by `data/synthetic.py::write_scannet_format`:
training (stage 1 with TensorBoard and a profiler window, stage 2 from it),
the batches `main()` feeds against the JAX `main()`'s, and evaluation against
the JAX `main()` on one tree, one tuple CSV and one set of weights (the JAX
checkpoints carried over by `models/convert.py`)."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import tuples as jtuples  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import train as tcli  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data.sampling import create_sequential_subsets  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data.synthetic import (  # noqa: E402
    SphereFieldScene,
    fourier_texture_image,
    write_scannet_format,
)
from e2e_multi_view_matching_tpu_torch.data.tuples import MatchingTupleDataset  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

H, W = 96, 128


def _tree(root, splits):
    """Seeded sphere-field scenes of `splits` = {split: views} at 96x128."""
    rng = np.random.default_rng(0)
    for split, n_views in splits.items():
        scene = SphereFieldScene(rng, n_views=n_views, H=H, W=W)
        write_scannet_format(scene, root, scene_name=f"{split}0000_00", split=split,
                             image_fn=fourier_texture_image)
    return root


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    # 4 train views: 4 tuples, two steps of 2; 3 val views: one batch of 2
    return _tree(str(tmp_path_factory.mktemp("cli_data")), {"train": 4, "val": 3, "test": 5})


def _runs(ckpt_dir):
    return sorted(e for e in os.listdir(ckpt_dir) if e != "runs")


def test_train_main_two_stages_with_scalars_and_trace(data_dir, tmp_path):
    """Stage 1 from --data_dir: the dataset defaults in cfg.json, the
    checkpoints, TensorBoard scalars under runs/<exp> and the Chrome trace of
    the --profile_steps window. Then stage 2 through `main()` with --pose_loss
    --init_exp_name: it starts at the stage-1 run's epoch + 1 and step, with
    the conf MLP, and --no_tensorboard writes no runs/<exp>. (Tuples of 2:
    the pose-loss weights exist for 2 and 5 views.)"""
    ckpt = str(tmp_path)
    common = ["--data_dir", data_dir, "--checkpoint_dir", ckpt, "--dataset", "scannet",
              "--tuple_size", "2", "--batch_size", "2", "--i_train", "1",
              "--sinkhorn_iterations", "10", "--device", "cpu"]
    state = tcli.main(common + ["--n_epochs", "1", "--max_steps", "2",
                                "--profile_steps", "1,2"])
    assert state.step == 2
    (stage1,) = _runs(ckpt)
    exp_dir = os.path.join(ckpt, stage1)
    cfg = json.load(open(os.path.join(exp_dir, "cfg.json")))
    assert (cfg["max_keypoints"], cfg["n_samples"], cfg["color_jitter"], cfg["gnn_layers"],
            cfg["cross_attention_layers"]) == (400, 200, 0.2, 9, 1)
    assert cfg["lr"] == pytest.approx(1e-4 * np.sqrt(2 * 2 / 128.0))
    for name in ("last_model.ckpt", "best_model.ckpt", "000000_model.ckpt"):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    for tag in ("loss_train", "loss_val"):
        events = os.listdir(os.path.join(ckpt, "runs", stage1, tag))
        assert any(f.startswith("events.out.tfevents") for f in events), tag
    with open(os.path.join(exp_dir, "profile", "trace_steps_1_2.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "addmm" in n for n in names)

    state = tcli.main(common + ["--pose_loss", "--init_exp_name", stage1, "--n_epochs", "2",
                                "--max_steps", "3", "--no_tensorboard"])
    assert state.step == 3 and hasattr(state.matcher, "conf_mlp")
    (stage2,) = [e for e in _runs(ckpt) if e != stage1]
    saved = torch.load(os.path.join(ckpt, stage2, "000001_model.ckpt"), weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 3 and np.isfinite(saved["min_val_loss"])
    assert any(k.startswith("conf_mlp.") for k in saved["model"])
    assert os.listdir(os.path.join(ckpt, "runs")) == [stage1]


def test_main_feeds_the_jax_mains_batches(data_dir):
    """`TupleBatches` gives what the JAX `main()` loads: training batches
    shuffled with the epoch as the seed, tuples resampled before every epoch
    after the first, with the jitter; validation over the sequential subsets."""
    opt = tcli.parse_args(["--data_dir", data_dir, "--dataset", "scannet",
                           "--tuple_size", "3", "--batch_size", "1", "--grad_accum", "2"])
    opt.n_samples, opt.color_jitter = 200, 0.2  # what `setup_run` applies
    feed = tcli.TupleBatches(opt)
    root = os.path.join(data_dir, "scannet")
    j_train = jtuples.MatchingTupleDataset(root, "train", 3, n_samples=200, jitter=0.2,
                                           use_native=False)
    # the validation set takes the native path when the runtime builds (no
    # jitter): the JAX set runs in the mode that the port's resolved to
    assert not feed.train_set.use_native
    j_val = jtuples.MatchingTupleDataset(root, "val", 3, n_samples=200,
                                         use_native=feed.val_set.use_native)
    subsets = create_sequential_subsets(len(j_val), 60000)
    for epoch in (3, 4):
        if epoch == 4:
            j_train.start_epoch()
        ref = list(jtuples.batch_iterator(j_train, 2, shuffle=True, seed=epoch))
        ref += list(jtuples.batch_iterator(j_val, 2, shuffle=False,
                                           indices=subsets[0].copy()))
        ours = list(feed.train_batches(epoch)) + list(feed.val_batches(epoch))
        assert len(ours) == len(ref) == 3
        for a, b in zip(ref, ours):
            assert a["ids"] == b["ids"]
            for k in ("images", "intr", "poses", "depths"):
                np.testing.assert_array_equal(a[k], b[k])


def test_tblog_without_tensorboard_and_with_an_open_window(tmp_path, monkeypatch, caplog):
    """Without the tensorboard package the writer logs once and writes
    nothing; a run that ends inside the profiler window still writes its
    trace when the profiler closes."""
    import logging
    import sys

    from e2e_multi_view_matching_tpu_torch.utils.tblog import StepProfiler, TBWriter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = TBWriter(str(tmp_path), "exp")
    with caplog.at_level(logging.WARNING, logger="tblog"):
        for step in range(3):
            tb.scalars("loss", {"train": 1.0}, step)
    tb.close()
    assert len(caplog.records) == 1 and "tensorboard" in caplog.records[0].getMessage()
    assert not os.path.exists(tmp_path / "runs")

    prof = StepProfiler(str(tmp_path / "profile"), 0, 5)
    prof.maybe_start(0)
    torch.ones(4).sum()
    assert not prof.maybe_stop(1)
    prof.close()
    assert os.path.exists(tmp_path / "profile" / "trace_steps_0_5.json")


# -- evaluation ----------------------------------------------------------

EVAL_CFG = {"remove_borders": 8, "nms_radius": 4, "keypoint_threshold": 1e-4,
            "cross_attention_layers": 1, "gnn_layers": 1, "dataset": "scannet"}


@pytest.fixture(scope="module")
def eval_env(data_dir, tmp_path_factory):
    """One seeded set of weights (flax init) as a JAX run and as a port run,
    and a fixed CSV of 2 test 3-tuples."""
    import optax
    from flax import serialization

    from e2e_multi_view_matching_tpu.models import matcher as jm
    from e2e_multi_view_matching_tpu.models import superpoint as jsp
    from e2e_multi_view_matching_tpu.train import checkpoint as jckpt
    from e2e_multi_view_matching_tpu.train.step import TrainState as JTrainState

    V = 3
    key = jax.random.PRNGKey(0)
    sp_vars = jax.jit(jsp.SuperPoint(jsp.SuperPointConfig(max_keypoints=1024)).init)(
        {"params": jax.random.PRNGKey(1), "keypoints": key}, jnp.zeros((1, 64, 64, 1)))
    # the weights do not depend on the keypoint count: initialize at 8
    m_vars = jax.jit(jm.MultiViewMatcher(jm.MatcherConfig(
        gnn_layers=jm.default_gnn_layers(1, 1), conf_mlp=True, multi_frame_matching=True,
        sinkhorn_iterations=10)).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, V, 8, 2)), jnp.zeros((1, V, 8)),
        jnp.zeros((1, V, 8, 256)), jnp.full((1, V, 2), 64.0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

    runs = {}
    for pkg in ("jax", "torch"):
        ckpt = str(tmp_path_factory.mktemp(f"eval_{pkg}"))
        exp_dir = os.path.join(ckpt, "exp")
        os.makedirs(exp_dir)
        with open(os.path.join(exp_dir, "cfg.json"), "w") as f:
            json.dump(EVAL_CFG, f)
        if pkg == "jax":
            state = JTrainState(m_vars["params"], m_vars["batch_stats"],
                                optax.identity().init(m_vars["params"]),
                                jnp.zeros((), jnp.int32), jnp.zeros(()))
            jckpt.save_checkpoint(exp_dir, "model.ckpt", state, epoch=0, min_val_loss=1.0)
            with open(os.path.join(exp_dir, "superpoint.ckpt"), "wb") as f:
                f.write(serialization.to_bytes(sp_vars))
        else:
            torch.save({"epoch": 0, "model": state_dict_from_flax(to_np(m_vars)), "step": 0,
                        "min_val_loss": 1.0, "pose_match_ratio": 0.0},
                       os.path.join(exp_dir, "model.ckpt"))
            torch.save(state_dict_from_flax(to_np(sp_vars)),
                       os.path.join(exp_dir, "superpoint.ckpt"))
        runs[pkg] = ckpt
    csv = str(tmp_path_factory.mktemp("eval_csv") / "tuples.csv")
    MatchingTupleDataset(os.path.join(data_dir, "scannet"), "test", V, n_samples=2,
                         shuffle_tuple=False).write_sampled_tuples(csv)
    return types.SimpleNamespace(data_dir=data_dir, runs=runs, csv=csv,
                                 sp_state=state_dict_from_flax(to_np(sp_vars)),
                                 m_state=state_dict_from_flax(to_np(m_vars)))


def _eval_args(env, pkg, *extra):
    return ["--data_dir", env.data_dir, "--checkpoint_dir", env.runs[pkg], "--exp_name",
            "exp", "--dataset", "scannet", "--tuple_size", "3", "--sinkhorn_iterations",
            "10", "--eval_batch", "2", "--eval_scan", "1", *extra]


def test_eval_main_matches_jax(eval_env, monkeypatch):
    """The JAX and the port's `main()` on one tree, CSV and set of weights: the
    per-pair errors of their `evaluate` calls within 1e-2 degrees (the bound of
    `test_torch_slice.py`), the two JSONs within 0.5 AUC points. With random
    weights no pair gets a relative pose, so both return the identity tree:
    the errors hold the readers and the scoring, and the modules the port's
    `main()` hands to `evaluate` are held to the weights of model.ckpt and
    superpoint.ckpt, exactly. The stages on real matches are compared in
    `test_torch_slice.py` and `test_torch_geom.py`. Both `main()`s build their
    test set with the default `use_native="auto"`, which must resolve alike."""
    from e2e_multi_view_matching_tpu.cli import eval_multi_view as jev

    errors, modules, native = {}, {}, {}
    for pkg, mod in (("jax", jev), ("torch", tev)):
        evaluate = mod.evaluate

        def recording(*args, _pkg=pkg, _evaluate=evaluate, **kwargs):
            if _pkg == "torch":
                modules["superpoint"], modules["matcher"] = args[1], args[2]
            native[_pkg] = args[3 if _pkg == "torch" else 5].use_native
            errors[_pkg] = _evaluate(*args, **kwargs)
            return errors[_pkg]

        monkeypatch.setattr(mod, "evaluate", recording)
    ref = jev.main(_eval_args(eval_env, "jax", "--test_tuple_file", eval_env.csv))
    ours = tev.main(_eval_args(eval_env, "torch", "--test_tuple_file", eval_env.csv,
                               "--device", "cpu"))
    assert native["torch"] == native["jax"]
    for name, want in (("superpoint", eval_env.sp_state), ("matcher", eval_env.m_state)):
        got = modules[name].state_dict()
        assert got.keys() == want.keys(), name
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{name} {k}")
    assert np.shape(errors["torch"]) == np.shape(errors["jax"]) == (3, 2 * 3)
    np.testing.assert_allclose(np.asarray(errors["torch"]), np.asarray(errors["jax"]),
                               atol=1e-2)
    assert ours.keys() == ref.keys() and len(ours) == 9
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 0.5, k
    with open(os.path.join(eval_env.runs["torch"], "exp", "multi_view_scannet.json")) as f:
        assert json.load(f) == ours


def test_eval_main_fails_loudly_without_weights_or_tuples(eval_env, tmp_path):
    """As the JAX `main()`: no superpoint.ckpt and no --allow_random_superpoint
    raises; a missing tuple CSV raises instead of resampling."""
    sp = os.path.join(eval_env.runs["torch"], "exp", "superpoint.ckpt")
    moved = str(tmp_path / "superpoint.ckpt")
    os.replace(sp, moved)
    try:
        with pytest.raises(FileNotFoundError, match="SuperPoint weights"):
            tev.main(_eval_args(eval_env, "torch", "--test_tuple_file", eval_env.csv,
                                "--device", "cpu"))
    finally:
        os.replace(moved, sp)
    with pytest.raises(FileNotFoundError, match="tuple CSV"):
        tev.main(_eval_args(eval_env, "torch", "--test_tuple_file",
                            str(tmp_path / "missing.csv"), "--device", "cpu"))


def test_eval_main_passes_the_init_mode(eval_env, monkeypatch):
    """`main()` hands `--init_mode` to `evaluate` in its pipeline config, as
    the JAX `main()` does, and the host-tree `ransac_ba` run writes finite
    AUCs (with random weights no pair gets a relative pose)."""
    seen = {}
    evaluate = tev.evaluate

    def recording(*args, **kwargs):
        seen["cfg"] = kwargs["pipeline_cfg"]
        return evaluate(*args, **kwargs)

    monkeypatch.setattr(tev, "evaluate", recording)
    metrics = tev.main(_eval_args(eval_env, "torch", "--test_tuple_file", eval_env.csv,
                                  "--device", "cpu", "--init_mode", "ransac_ba"))
    assert seen["cfg"].init_mode == "ransac_ba"
    assert len(metrics) == 9 and all(np.isfinite(v) for v in metrics.values())
