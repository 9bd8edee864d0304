"""The pair benchmark's `evaluate` and `main()` of the port on the CPU
(`device="cpu"`, `--device cpu`) against the JAX package's, on synthetic pair
lists (`tests/test_torch_pairs.py::write_pair_lists`) and one set of weights
carried over by `models/convert.py`.

The weights: seeded flax initialization, with the matcher's GNN updates,
keypoint encoding and final projection set so that it matches SuperPoint's
descriptors directly (each layer's last MLP layer and the encoder's last layer
zero, the final projection the identity). With the random matcher itself
most pairs keep fewer than 8 weighted matches, and the weighted modes would
compare failures only; so every pair gets a pose in every mode, and the
per-pair errors, the failure counts and the chunk signatures are compared."""

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

from e2e_multi_view_matching_tpu.cli import eval_pairs as jev  # noqa: E402
from e2e_multi_view_matching_tpu.data.pairs import PairMatchingDataset as JPairs  # noqa: E402
from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_pairs as tev  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data.pairs import PairMatchingDataset  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    init_like_flax_,
    state_dict_from_flax,
)
from tests.test_torch_pairs import write_pair_lists  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

K = 128
# no border removal, as `main()` runs SuperPoint: the border mask is the
# canvas's (as in the JAX package), so with borders a bucketed image keeps
# detections near its own right and bottom edges that an exact-size run drops
SP_CFG = dict(nms_radius=4, keypoint_threshold=1e-4, max_keypoints=K, remove_borders=0,
              fill_with_random_keypoints=False)
M_CFG = dict(gnn_layers=("self", "cross") * 2, sinkhorn_iterations=10, conf_mlp=True,
             match_threshold=0.0)


def _descriptor_matcher(m_vars):
    """The flax matcher variables with the GNN's updates, the keypoint
    encoding and the final projection turned off (see the module docstring)."""
    params = m_vars["params"]
    for name, layer in params.items():
        if name.startswith("gnn_"):
            last = layer["mlp"]["dense_1"]
            last["kernel"], last["bias"] = np.zeros_like(last["kernel"]), np.zeros_like(last["bias"])
    last = params["kenc"][max(k for k in params["kenc"] if k.startswith("dense_"))]
    last["kernel"], last["bias"] = np.zeros_like(last["kernel"]), np.zeros_like(last["bias"])
    proj = params["final_proj"]
    proj["kernel"] = np.eye(proj["kernel"].shape[0], dtype=np.float32)
    proj["bias"] = np.zeros_like(proj["bias"])
    return m_vars


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    lists = write_pair_lists(str(tmp_path_factory.mktemp("pair_lists")))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    sp_vars = to_np(jax.jit(j_sp.init)({"params": jax.random.PRNGKey(1),
                                        "keypoints": jax.random.PRNGKey(0)},
                                       jnp.zeros((1, 64, 64, 1))))
    j_m = jm.MultiViewMatcher(jm.MatcherConfig(**M_CFG))
    m_vars = _descriptor_matcher(to_np(jax.jit(j_m.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 2, 8, 2)), jnp.zeros((1, 2, 8)),
        jnp.zeros((1, 2, 8, 256)), jnp.full((1, 2, 2), 64.0))))
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG))
    sp.load_state_dict(state_dict_from_flax(sp_vars))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(**M_CFG))
    matcher.load_state_dict(state_dict_from_flax(m_vars))
    data_dir, files = lists["scannet"]
    return types.SimpleNamespace(
        lists=lists, j_sp=j_sp, sp_vars=sp_vars, j_m=j_m, m_vars=m_vars, sp=sp.eval(),
        matcher=matcher.eval(), scannet=PairMatchingDataset(data_dir, files, 128, "scannet"),
        j_scannet=JPairs(data_dir, files, 128, "scannet"))


def _opt(mode, **kw):
    return types.SimpleNamespace(**{"eval_mode": mode, "max_pairs": None, "eval_batch": 2,
                                    "eval_scan": 2, "shape_bucket": 128, **kw})


@pytest.mark.parametrize("mode", tev.EVAL_MODES)
def test_evaluate_matches_jax(env, mode):
    """Five 96 x 128 pairs in sub-chunks of two (the last one padded: one
    program on the JAX side; the grids of several sub-chunks are held by
    `test_buckets_and_scan_give_the_same_errors`): failure counts and chunk
    signatures equal JAX's, per-pair errors
    within 0.05 deg of JAX's (the two packages' float32 rounding, amplified
    by the solves; in the RANSAC modes the matches are equal, and so are
    OpenCV's inputs). In w8pt_irls_ba the two re-weightings gate every match
    by a hard epipolar threshold, and with random weights (errors of 40-140
    deg) a match may sit on a threshold, where a difference of an ulp takes
    it across: there one pair of the five may differ more, within 5 deg."""
    opt = _opt(mode, max_pairs=5, eval_scan=1)
    ref, ref_fail, ref_sig = jev.evaluate(opt, env.j_sp, env.sp_vars, env.j_m, env.m_vars,
                                          env.j_scannet)
    ours, fail, sig = tev.evaluate(opt, env.sp, env.matcher, env.scannet, device="cpu")
    assert len(ours) == 5 and (fail, sig) == (ref_fail, ref_sig) == (0, 1)
    assert np.all(np.isfinite(ours))
    diff = np.abs(np.asarray(ours) - np.asarray(ref))
    if mode == "w8pt_irls_ba":
        assert np.sum(diff > 0.05) <= 1 and diff.max() < 5.0, diff
    else:
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=0.05)


@pytest.mark.parametrize("mode", ["w8pt_ba", "ransac"])
def test_buckets_and_scan_give_the_same_errors(env, mode):
    """MegaDepth-format pairs of three shapes (landscape and portrait, long
    side 160): chunks per bucket pair (shape_bucket 128) against chunks per
    exact shape (0), and two sub-chunks a chunk against one: the same
    per-pair errors (within 0.05 deg: the convolutions over a padded canvas
    round otherwise; 1e-4 between the two groupings of one bucketing), fewer
    signatures with buckets."""
    data_dir, files = env.lists["megadepth"]
    dataset = PairMatchingDataset(data_dir, files, 160, "megadepth")
    runs = {}
    for key, kw in (("exact", dict(shape_bucket=0)), ("bucket", {}),
                    ("bucket_scan1", dict(eval_scan=1))):
        runs[key] = tev.evaluate(_opt(mode, **kw), env.sp, env.matcher, dataset, device="cpu")
    exact, bucket, scan1 = (np.asarray(runs[k][0]) for k in ("exact", "bucket", "bucket_scan1"))
    assert np.all(np.isfinite(exact)) and runs["exact"][1] == runs["bucket"][1] == 0
    # four exact shape pairs, three bucket pairs (one of three pairs: a chunk of
    # two sub-chunks with eval_scan 2)
    assert [runs[k][2] for k in ("exact", "bucket", "bucket_scan1")] == [4, 3, 3]
    np.testing.assert_allclose(bucket, exact, atol=0.05)
    np.testing.assert_allclose(scan1, bucket, atol=1e-4)


# -- main() ----------------------------------------------------------------

@pytest.fixture(scope="module")
def main_env(env, tmp_path_factory):
    """The two-view matcher of `main()` (9 x (self + cross), conf MLP) and the
    SuperPoint weights as a JAX run and as a port run."""
    import optax
    from flax import serialization

    from e2e_multi_view_matching_tpu.train import checkpoint as jckpt
    from e2e_multi_view_matching_tpu.train.step import TrainState as JTrainState

    # drawn on the port's side as flax draws them (no JAX compile), carried over
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(gnn_layers=tm.default_gnn_layers(9, 1),
                                                   conf_mlp=True))
    init_like_flax_(matcher, torch.Generator().manual_seed(3))
    m_vars = flax_from_state_dict(matcher.state_dict())
    runs = {}
    for pkg in ("jax", "torch"):
        ckpt = str(tmp_path_factory.mktemp(f"pairs_{pkg}"))
        exp_dir = os.path.join(ckpt, "exp")
        os.makedirs(exp_dir)
        if pkg == "jax":
            state = JTrainState(m_vars["params"], m_vars["batch_stats"],
                                optax.identity().init(m_vars["params"]),
                                jnp.zeros((), jnp.int32), jnp.zeros(()))
            jckpt.save_checkpoint(exp_dir, "model.ckpt", state, epoch=0, min_val_loss=1.0)
            with open(os.path.join(exp_dir, "superpoint.ckpt"), "wb") as f:
                f.write(serialization.to_bytes(env.sp_vars))
        else:
            torch.save({"epoch": 0, "model": state_dict_from_flax(m_vars), "step": 0,
                        "min_val_loss": 1.0, "pose_match_ratio": 0.0},
                       os.path.join(exp_dir, "model.ckpt"))
            torch.save(state_dict_from_flax(env.sp_vars), os.path.join(exp_dir, "superpoint.ckpt"))
        runs[pkg] = ckpt
    return types.SimpleNamespace(runs=runs, m_state=state_dict_from_flax(m_vars),
                                 sp_state=state_dict_from_flax(env.sp_vars))


def _main_args(env, main_env, pkg, *extra):
    data_dir = os.path.dirname(env.lists["scannet"][0])
    assets = os.path.dirname(os.path.dirname(env.lists["scannet"][1][0]))
    return ["--data_dir", data_dir, "--checkpoint_dir", main_env.runs[pkg], "--exp_name", "exp",
            "--dataset", "scannet", "--assets_dir", assets, "--eval_mode", "ransac",
            "--max_pairs", "1", "--sinkhorn_iterations", "10", "--eval_batch", "1",
            "--eval_scan", "1", *extra]


def test_main_matches_jax(env, main_env, monkeypatch):
    """The JAX and the port's `main()` on one pair list and one set of weights
    (ScanNet's settings: K = 1024, long side 720, so the 96 x 128 frames become
    540 x 720): the modules the port's `main()` hands to `evaluate` hold the
    weights of model.ckpt and superpoint.ckpt exactly, the per-pair errors
    and failures equal JAX's (with the random two-view matcher no match
    passes the 0.2 threshold, so no pair gets a pose in either package: the
    stages on real matches are compared by `test_evaluate_matches_jax`), the
    AUCs within 0.5 points, and the JSON is written."""
    got = {}
    for pkg, mod in (("jax", jev), ("torch", tev)):
        def recording(*args, _pkg=pkg, _evaluate=mod.evaluate, **kwargs):
            if _pkg == "torch":
                got["superpoint"], got["matcher"] = args[1], args[2]
            got[_pkg] = _evaluate(*args, **kwargs)
            return got[_pkg]

        monkeypatch.setattr(mod, "evaluate", recording)
    ref = jev.main(_main_args(env, main_env, "jax"))
    ours = tev.main(_main_args(env, main_env, "torch", "--device", "cpu"))
    for name, want in (("superpoint", main_env.sp_state), ("matcher", main_env.m_state)):
        state = got[name].state_dict()
        assert state.keys() == want.keys(), name
        for k in want:
            torch.testing.assert_close(state[k], torch.as_tensor(want[k]), rtol=0, atol=0,
                                       msg=f"{name} {k}")
    assert got["torch"][1:] == got["jax"][1:]
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], atol=1e-2)
    assert ours.keys() == ref.keys() == {"AUC@5deg", "AUC@10deg", "AUC@20deg"}
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 0.5, k
    out = os.path.join(main_env.runs["torch"], "exp", "two_view_ransac_scannet.json")
    with open(out) as f:
        assert json.load(f) == ours


def test_main_refuses_without_weights_or_with_data_parallel(env, main_env, tmp_path):
    """As the JAX `main()`: no superpoint.ckpt and no --allow_random_superpoint
    raises; --data_parallel above 1 is a parser error until parallel/mesh.py
    is ported; with no GPU the default device raises instead of running on
    the CPU."""
    sp = os.path.join(main_env.runs["torch"], "exp", "superpoint.ckpt")
    moved = str(tmp_path / "superpoint.ckpt")
    os.replace(sp, moved)
    try:
        with pytest.raises(FileNotFoundError, match="SuperPoint weights"):
            tev.main(_main_args(env, main_env, "torch", "--device", "cpu"))
    finally:
        os.replace(moved, sp)
    with pytest.raises(SystemExit):
        tev.parse_args(_main_args(env, main_env, "torch", "--data_parallel", "2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tev.main(_main_args(env, main_env, "torch"))
