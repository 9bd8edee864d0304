"""The multi-view pipeline's init modes and host trees: the PyTorch port
against the JAX package on the same seeded inputs (CPU).

- the host tree (`maximum_spanning_tree`, `spanning_tree_poses`);
- the RANSAC stage A (`ransac`, `ransac_ba`) on the synthetic 5-tuples of
  `test_mv_pipeline.build_tuple_case`: the matched coordinates are gathered
  by indexing alone, so OpenCV's RANSAC sees the same float32 arrays in both
  packages and returns the same poses, inliers and gated confidences;
- the host-tree pipeline `multi_view_pose_pipeline_batch` in all three modes;
- `cli.eval_multi_view.evaluate` in the RANSAC modes against the port's
  pipeline on its own `infer_subchunk` outputs, and the `--init_mode` choices.
"""

import argparse
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

from test_mv_pipeline import rot_err_deg, transl_angle_deg  # noqa: E402
from test_torch_geom import tuple_batch  # noqa: E402

from e2e_multi_view_matching_tpu.geom import lie as jlie  # noqa: E402
from e2e_multi_view_matching_tpu.geom.epipolar import normalize_keypoints as j_norm  # noqa: E402
from e2e_multi_view_matching_tpu.mvba import pipeline as jpipe  # noqa: E402
from e2e_multi_view_matching_tpu.mvba import spanning_tree as jtree  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data.synthetic import (  # noqa: E402
    PlaneScene,
    fourier_texture_image,
)
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import pipeline as tpipe  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import spanning_tree as ttree  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

V = 5
PAIRS = [(i, j) for j in range(V) for i in range(j)]
MODES = ("w8pt_ba", "ransac", "ransac_ba")
# the bounds of the JAX package's test_ransac_modes_match_w8pt_on_high_inlier_fixture
# (max pairwise rotation / translation-direction error in degrees)
GT_TOL = {"w8pt_ba": (1.0, 5.0), "ransac_ba": (1.5, 8.0), "ransac": (10.0, 45.0)}


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tuples():
    """Two synthetic 5-tuples (K = 64, 10% outliers) as one batch."""
    return types.SimpleNamespace(**tuple_batch(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def jax_extr(tuples):
    """JAX's `multi_view_pose_pipeline_batch` of the tuples in every mode."""
    return {mode: jpipe.multi_view_pose_pipeline_batch(
        tuples.kpts, tuples.intr, tuples.matches0, tuples.conf,
        jpipe.MultiViewPipelineConfig(init_mode=mode)) for mode in MODES}


def jax_ransac_inputs(d):
    """The per-pair arrays JAX's pipeline hands `_ransac_relative_poses`,
    gathered with its own array code."""
    kpts, intr = jnp.asarray(d.kpts), jnp.asarray(d.intr)[..., :3, :3]
    matches0, conf = jnp.asarray(d.matches0), jnp.asarray(d.conf)
    B, _, K, _ = kpts.shape
    idx_i = np.asarray([p[0] for p in PAIRS])
    idx_j = np.asarray([p[1] for p in PAIRS])
    gather = jnp.clip(matches0, 0, K - 1)
    kpts_j = jnp.take_along_axis(kpts[:, idx_j], gather[..., None], axis=2)
    conf_m = jnp.where((matches0 >= 0) & (conf > 0.0), conf, 0.0)
    flat = lambda x, *s: np.asarray(x).reshape((B * len(PAIRS),) + s)  # noqa: E731
    return (flat(kpts[:, idx_i], K, 2), flat(kpts_j, K, 2), flat(intr[:, idx_i], 3, 3),
            flat(intr[:, idx_j], 3, 3), flat(conf_m, K))


def test_host_tree_matches_jax():
    """`maximum_spanning_tree` and `spanning_tree_poses` against JAX's over 40
    random graphs with weight ties, zero counts and invalid pairs: the same
    tree edges in the same order and bit-equal extrinsics (the same numpy
    arithmetic); the port's device tree agrees within 1e-5 (float32 chaining
    on the device against float64 on the host)."""
    rng = np.random.default_rng(0)
    P, n = len(PAIRS), 40
    idx_i, idx_j = tpipe.pair_indices(V, "cpu")
    A = rng.normal(size=(n, P, 3, 3))
    R = np.stack([[np.linalg.qr(a)[0] for a in row] for row in A])
    R[..., 0] *= np.linalg.det(R)[..., None]
    T_rel = np.asarray(jlie.make_transform(jnp.asarray(R, jnp.float32),
                                           jnp.asarray(rng.normal(size=(n, P, 3)), jnp.float32)))
    counts = rng.integers(0, 6, size=(n, P)).astype(np.int32)
    valid = rng.random((n, P)) > 0.25
    extr_dev, on_tree = ttree.spanning_tree_poses_device(t(T_rel), t(counts), t(valid),
                                                         idx_i, idx_j, V)
    for b in range(n):
        W = rng.integers(0, 4, size=(V, V)).astype(np.float64)
        assert ttree.maximum_spanning_tree(W) == jtree.maximum_spanning_tree(W)
        rel = {PAIRS[p]: T_rel[b, p] for p in range(P) if valid[b, p]}
        cnt = {PAIRS[p]: int(counts[b, p]) for p in range(P) if valid[b, p]}
        extr, tree = ttree.spanning_tree_poses(V, rel, cnt)
        extr_j, tree_j = jtree.spanning_tree_poses(V, rel, cnt)
        assert tree == tree_j
        assert extr.dtype == np.float32
        np.testing.assert_array_equal(extr, extr_j)
        assert {PAIRS[p] for p in range(P) if on_tree[b, p]} == set(tree)
        np.testing.assert_allclose(extr, extr_dev[b].numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["ransac", "ransac_ba"])
def test_ransac_stage_a_matches_jax(tuples, mode):
    """The port's RANSAC stage A (host gather + `_ransac_relative_poses`)
    against JAX's `_ransac_relative_poses` on JAX's own gather of the same
    tuples. `ransac`: T_rel, inlier counts, validity and gated confidences
    bit-equal. `ransac_ba`: the same counts, validity and confidences, T_rel
    within 1e-3 (the two-view BA's parity bound, 10 LM iterations)."""
    cfg_j = jpipe.MultiViewPipelineConfig(init_mode=mode)
    ref = jpipe._ransac_relative_poses(*jax_ransac_inputs(tuples), cfg_j)
    stage_a = tpipe._ransac_stage_a(tuples.kpts, tuples.intr, tuples.matches0, tuples.conf,
                                    tpipe.MultiViewPipelineConfig(init_mode=mode),
                                    torch.device("cpu"))
    B, P, K = stage_a["conf_gated"].shape
    out = [stage_a["T_rel"].numpy().reshape(B * P, 4, 4),
           stage_a["counts"].numpy().reshape(B * P), stage_a["valid"].numpy().reshape(B * P),
           stage_a["conf_gated"].numpy().reshape(B * P, K)]
    assert ref[2].sum() == B * P  # every pair has a pose
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    if mode == "ransac":
        np.testing.assert_array_equal(out[0], ref[0])
    else:
        np.testing.assert_allclose(out[0], ref[0], atol=1e-3)
        assert np.abs(out[0] - ref[0]).max() > 0  # the BA ran (floats differ)
    # the observations of stage B: JAX's normalization of the same points
    np.testing.assert_allclose(
        stage_a["x_i_n"].numpy().reshape(B * P, K, 2),
        np.asarray(j_norm(jnp.asarray(jax_ransac_inputs(tuples)[0]),
                          jnp.asarray(jax_ransac_inputs(tuples)[2]))), atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_batch_matches_jax(tuples, jax_extr, mode):
    """`multi_view_pose_pipeline_batch` on `device="cpu"` against JAX's on
    the same tuples: extrinsics within 5e-4 (the JAX package's own bound for
    its batched pipeline), and the poses within the JAX package's per-mode
    bounds of the ground truth; its profile has JAX's keys."""
    profile = {}
    extr = tpipe.multi_view_pose_pipeline_batch(
        tuples.kpts, tuples.intr, tuples.matches0, tuples.conf,
        tpipe.MultiViewPipelineConfig(init_mode=mode), profile=profile, device="cpu")
    assert extr.shape == (2, V, 4, 4) and extr.dtype == np.float32
    np.testing.assert_allclose(extr, jax_extr[mode], atol=5e-4)
    assert sorted(profile) == ["stage_a_s", "stage_b_s", "tree_host_s"]
    for b, scene in enumerate(tuples.scenes):
        T = [(scene.relative_pose(i, j), extr[b, j] @ np.linalg.inv(extr[b, i]))
             for i, j in PAIRS]
        assert max(rot_err_deg(g[:3, :3], p[:3, :3]) for g, p in T) < GT_TOL[mode][0]
        assert max(transl_angle_deg(g[:3, 3], p[:3, 3]) for g, p in T) < GT_TOL[mode][1]


def test_host_tree_pipeline_matches_device_pipeline(tuples):
    """The host-tree `w8pt_ba` pipeline against the port's fused
    `multi_view_pose_device` (JAX's test_device_pipeline_matches_host_tree_pipeline):
    within 5e-4, and the one-tuple wrapper gives the batch's first tuple."""
    args = (tuples.kpts, tuples.intr, tuples.matches0, tuples.conf)
    extr = tpipe.multi_view_pose_pipeline_batch(*args, device="cpu")
    extr_dev = tpipe.multi_view_pose_device(*map(t, args)).numpy()
    np.testing.assert_allclose(extr, extr_dev, atol=5e-4)
    one = tpipe.multi_view_pose_pipeline(*(a[0] for a in args), device="cpu")
    np.testing.assert_allclose(one, extr[0], atol=5e-4)


def test_unknown_init_mode_raises(tuples):
    with pytest.raises(ValueError, match="init_mode"):
        tpipe.multi_view_pose_pipeline_batch(
            tuples.kpts, tuples.intr, tuples.matches0, tuples.conf,
            tpipe.MultiViewPipelineConfig(init_mode="ransac_w8pt"), device="cpu")


@pytest.fixture(scope="module")
def eval_env():
    """A small SuperPoint and 5-view matcher of the port with seeded weights,
    the matcher at threshold 0 so that every pair has matches for RANSAC, and
    three seeded plane-scene tuples."""
    K, H, W, D = 64, 96, 128, 64
    g = torch.Generator().manual_seed(0)
    sp = tsp.SuperPoint(tsp.SuperPointConfig(
        nms_radius=4, keypoint_threshold=0.001, max_keypoints=K, remove_borders=4,
        fill_with_random_keypoints=False, descriptor_dim=D))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        descriptor_dim=D, keypoint_encoder=(32, 64), gnn_layers=("self", "cross"),
        num_heads=4, sinkhorn_iterations=10, conf_mlp=True, multi_frame_matching=True,
        conf_mlp_hidden=(64, 16), match_threshold=0.0))
    init_like_flax_(sp, g)
    init_like_flax_(matcher, g)
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(3):
        scene = PlaneScene(rng, n_views=V, H=H, W=W)
        images = np.stack([fourier_texture_image(scene, v) for v in range(V)])
        samples.append({"images": images[..., None].astype(np.float32),
                        "intr": np.tile(scene.intr[0].astype(np.float32), (V, 1, 1)),
                        "poses": np.stack(scene.poses).astype(np.float32)})
    return types.SimpleNamespace(sp=sp.eval(), matcher=matcher.eval(), samples=samples,
                                 size=np.tile(np.asarray([H, W], np.float32), (2, V, 1)))


@pytest.mark.parametrize("mode", ["ransac", "ransac_ba"])
def test_evaluate_equals_pipeline_on_infer_subchunk(eval_env, mode):
    """`evaluate` in a RANSAC mode (one chunk of two sub-chunks of 2 tuples,
    the last tuple a padding copy) gives exactly the errors of the port's
    host-tree pipeline applied to its own `infer_subchunk` outputs of the same
    sub-chunks: the same arithmetic in the same order. Most pairs get a pose."""
    opt = types.SimpleNamespace(tuple_size=V, max_tuples=None, eval_batch=2, eval_scan=2,
                                no_pipeline=False, compute_dtype="float32")
    cfg = tpipe.MultiViewPipelineConfig(init_mode=mode)
    errors = np.asarray(tev.evaluate(opt, eval_env.sp, eval_env.matcher, eval_env.samples,
                                     pipeline_cfg=cfg, device="cpu"))
    padded = eval_env.samples + eval_env.samples[-1:]
    outs = []
    with torch.inference_mode():
        for s in (padded[:2], padded[2:]):
            out = tev.infer_subchunk(eval_env.sp, eval_env.matcher,
                                     t(np.stack([x["images"] for x in s])),
                                     t(np.stack([x["intr"][:, :3, :3] for x in s])),
                                     t(eval_env.size), cfg)
            assert out[3] is None
            outs.append(out)
        kpts, matches0, conf = (torch.cat([o[i] for o in outs]).numpy() for i in range(3))
        extr = tpipe.multi_view_pose_pipeline_batch(
            kpts, np.stack([x["intr"][:, :3, :3] for x in padded]),
            matches0.astype(np.float32), conf, cfg, device="cpu")
    assert np.all(np.isfinite(extr))
    ref = np.concatenate([tev._pair_errors(s, e, V) for s, e in zip(eval_env.samples, extr)])
    np.testing.assert_array_equal(errors.T, ref)
    stage_a = tpipe._ransac_stage_a(kpts, np.stack([x["intr"] for x in padded]), matches0,
                                    conf, cfg, torch.device("cpu"))
    assert stage_a["valid"].float().mean() >= 0.5


def test_init_mode_choices_match_jax(monkeypatch):
    """`--init_mode` takes JAX's choices, in JAX's order."""
    from e2e_multi_view_matching_tpu.cli import eval_multi_view as jev

    seen = {}
    add_argument = argparse.ArgumentParser.add_argument

    def spy(self, *args, **kw):
        if "--init_mode" in args:
            seen.setdefault("choices", []).append(list(kw["choices"]))
        return add_argument(self, *args, **kw)

    monkeypatch.setattr(argparse.ArgumentParser, "add_argument", spy)
    jev.parse_args([])
    tev.parse_args([])
    assert seen["choices"][0] == seen["choices"][1] == list(MODES)
    for mode in MODES:
        assert tev.parse_args(["--init_mode", mode]).init_mode == mode
