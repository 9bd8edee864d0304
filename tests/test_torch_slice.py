"""The 5-tuple eval slice as a whole: SuperPoint -> multi-view matcher ->
multi-view pose, JAX package against the PyTorch port on the same seeded
images and bridged weights (CPU; the port's "cuda" ops run their plain
versions on CPU tensors, JAX's kernels are off the TPU).

With random weights the matcher accepts no match above the 0.2 threshold on
these images, so every pose pair is invalid and both packages return the
identity tree; the pose stage on real matches is compared in
`test_torch_geom.py::TestMultiView::test_pipeline_matches_jax`."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data.synthetic import (  # noqa: E402
    PlaneScene,
    fourier_texture_image,
)
from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu.mvba.pipeline import multi_view_pose_device as j_pose  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba.pipeline import (  # noqa: E402
    MultiViewPipelineConfig,
    multi_view_pose_device,
    multi_view_pose_pipeline_batch,
)
from tests.torch_memory import teardown_module  # noqa: E402,F401

V, K, H, W, D = 5, 64, 96, 128, 64
SP_CFG = dict(nms_radius=4, keypoint_threshold=0.001, max_keypoints=K, remove_borders=4,
              fill_with_random_keypoints=False, descriptor_dim=D)
MATCHER_CFG = dict(descriptor_dim=D, keypoint_encoder=(32, 64), gnn_layers=("self", "cross"),
                   num_heads=4, sinkhorn_iterations=10, conf_mlp=True,
                   multi_frame_matching=True, conf_mlp_hidden=(64, 16))


def t(x):
    return torch.from_numpy(np.array(x))


def ref_pair_errors(sample, extr):
    """(pose, transl, rot) errors of every pair, as the JAX evaluate scores them."""
    out = []
    for j in range(V):
        for i in range(j):
            T_gt = np.linalg.inv(sample["poses"][j]) @ sample["poses"][i]
            T_pred = extr[j] @ np.linalg.inv(extr[i])
            err_r = np.degrees(np.arccos(np.clip(
                (np.trace(T_gt[:3, :3].T @ T_pred[:3, :3]) - 1) / 2, -1, 1)))
            nrm = np.linalg.norm(T_gt[:3, 3]) * np.linalg.norm(T_pred[:3, 3])
            err_t = (np.degrees(np.arccos(np.clip(T_gt[:3, 3] @ T_pred[:3, 3] / nrm, -1, 1)))
                     if nrm > 1e-9 else 0.0)
            out.append((max(err_t, err_r), err_t, err_r))
    return np.asarray(out)


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(3):
        scene = PlaneScene(rng, n_views=V, H=H, W=W)
        images = np.stack([fourier_texture_image(scene, v) for v in range(V)])
        samples.append({"images": images[..., None].astype(np.float32),
                        "intr": np.tile(scene.intr[0].astype(np.float32), (V, 1, 1)),
                        "poses": np.stack(scene.poses).astype(np.float32)})
    j_sp = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    sp_vars = j_sp.init({"params": jax.random.PRNGKey(1), "keypoints": jax.random.PRNGKey(2)},
                        jnp.zeros((1, H, W, 1)))
    j_m = jm.MultiViewMatcher(jm.MatcherConfig(**MATCHER_CFG))
    m_vars = j_m.init(jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
                      jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), 64.0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG))
    sp.load_state_dict(state_dict_from_flax(to_np(sp_vars)))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(
        **MATCHER_CFG, attention_impl="cuda", sinkhorn_impl="cuda"))
    matcher.load_state_dict(state_dict_from_flax(to_np(m_vars)))

    # the JAX stages of `infer_subchunk` on all three tuples
    images = np.stack([s["images"] for s in samples])
    intr = np.stack([s["intr"] for s in samples])
    size = np.tile(np.asarray([H, W], np.float32), (3, V, 1))
    sp_out = to_np(jax.jit(j_sp.apply)(sp_vars, images.reshape(3 * V, H, W, 1)))
    kpts = sp_out["keypoints"].reshape(3, V, K, 2)
    scores = sp_out["scores"].reshape(3, V, K)
    descs = sp_out["descriptors"].reshape(3, V, K, D)
    m_out = to_np(jax.jit(j_m.apply)(m_vars, kpts, scores, descs, size))
    extr = np.asarray(jax.jit(j_pose)(kpts, intr, m_out["matches0"], m_out["conf_scores"]))
    return types.SimpleNamespace(
        samples=samples, sp=sp.eval(), matcher=matcher.eval(), images=images, intr=intr,
        size=size, sp_out=sp_out, kpts=kpts, scores=scores, descs=descs, m_out=m_out,
        extr=extr)


def test_superpoint_stage(env):
    """Keypoints identical (no score ties among the detections here), scores
    and descriptors within 1e-5 (f32 convolution reduction order)."""
    with torch.no_grad():
        out = env.sp(t(env.images.reshape(3 * V, H, W, 1)))
    np.testing.assert_array_equal(out["keypoints"].numpy(), env.sp_out["keypoints"])
    np.testing.assert_allclose(out["scores"].numpy(), env.sp_out["scores"], atol=1e-5)
    np.testing.assert_allclose(out["descriptors"].numpy(), env.sp_out["descriptors"],
                               atol=1e-5)


def test_matcher_stage_on_jax_keypoints(env):
    """Fed the JAX SuperPoint outputs (so top-K ties cannot shift the input):
    probabilities within 1e-5 (relative above 1), matches identical,
    confidences within 1e-5."""
    with torch.no_grad():
        out = env.matcher(t(env.kpts), t(env.scores), t(env.descs), t(env.size))
    p, p_ref = out["log_assignment"].exp().numpy(), np.exp(env.m_out["log_assignment"])
    assert np.max(np.abs(p - p_ref) / np.maximum(p_ref, 1.0)) < 1e-5
    np.testing.assert_array_equal(out["matches0"].numpy(), env.m_out["matches0"])
    np.testing.assert_allclose(out["conf_scores"].numpy(), env.m_out["conf_scores"],
                               atol=1e-5)


def test_pose_stage_on_jax_matches(env):
    """Fed the JAX matcher outputs (so the match threshold cannot flip a
    match): extrinsics within 5e-4, the bound the JAX package's own batched
    pipeline tests hold to f32 noise."""
    extr = multi_view_pose_device(t(env.kpts), t(env.intr), t(env.m_out["matches0"]),
                                  t(env.m_out["conf_scores"])).numpy()
    np.testing.assert_allclose(extr, env.extr, atol=5e-4)


@pytest.mark.parametrize("mode", ["w8pt_ba", "ransac", "ransac_ba"])
def test_pose_stage_by_init_mode_on_jax_matches(env, mode):
    """The host-tree pipeline of each init mode fed the JAX matcher outputs,
    against JAX's `multi_view_pose_pipeline_batch` in the same mode:
    extrinsics within 5e-4. No match clears the threshold here, so every pair
    is invalid in every mode and both return the identity tree; the modes on
    real matches are compared in `test_torch_init_modes.py`."""
    from e2e_multi_view_matching_tpu.mvba import pipeline as jpipe

    args = (env.kpts, env.intr, env.m_out["matches0"], env.m_out["conf_scores"])
    ref = jpipe.multi_view_pose_pipeline_batch(*args, jpipe.MultiViewPipelineConfig(
        init_mode=mode))
    extr = multi_view_pose_pipeline_batch(*args, MultiViewPipelineConfig(init_mode=mode),
                                          device="cpu")
    np.testing.assert_allclose(extr, ref, atol=5e-4)


def test_evaluate_matches_jax(env):
    """The port's `evaluate` end to end (2 chunks of 2 tuples, the last padded)
    against the JAX stages: `infer_subchunk` extrinsics within 5e-4, and the
    per-pair errors in degrees within 1e-2."""
    opt = types.SimpleNamespace(tuple_size=V, max_tuples=None, eval_batch=2, eval_scan=1,
                                no_pipeline=False, compute_dtype="float32")
    errors = tev.evaluate(opt, env.sp, env.matcher, env.samples, device="cpu")
    ref = np.concatenate([ref_pair_errors(s, e) for s, e in zip(env.samples, env.extr)])
    np.testing.assert_allclose(np.asarray(errors).T, ref, atol=1e-2)
    with torch.no_grad():
        extr = tev.infer_subchunk(env.sp, env.matcher, t(env.images), t(env.intr),
                                  t(env.size))[3].numpy()
    np.testing.assert_allclose(extr, env.extr, atol=5e-4)


def test_evaluate_chunking_is_invariant(env):
    """Sub-chunk grouping, the one-chunk-in-flight order and batch padding do
    not change any error (each tuple's arithmetic is independent: 1e-4)."""
    base = dict(tuple_size=V, max_tuples=None, compute_dtype="float32")
    runs = [dict(eval_batch=2, eval_scan=1, no_pipeline=False),
            dict(eval_batch=2, eval_scan=1, no_pipeline=True),
            dict(eval_batch=1, eval_scan=2, no_pipeline=False),
            dict(eval_batch=3, eval_scan=1, no_pipeline=False)]
    errs = [np.asarray(tev.evaluate(types.SimpleNamespace(**base, **r), env.sp, env.matcher,
                                    env.samples, device="cpu")) for r in runs]
    for e in errs[1:]:
        np.testing.assert_allclose(e, errs[0], atol=1e-4)


def test_cli_flags_and_result_file_match_jax(tmp_path):
    """`parse_args` keeps the JAX flags' names and defaults (the port adds
    `--device`, and its kernel choices say "cuda" for "pallas"); `write_result`
    writes the same AUC JSON from the same errors."""
    from e2e_multi_view_matching_tpu.cli import eval_multi_view as jev

    ours, ref = vars(tev.parse_args([])), vars(jev.parse_args([]))
    assert set(ours) - set(ref) == {"device"}
    for k in set(ours) - {"device"}:
        assert ours[k] == ref[k], k
    errs = np.random.default_rng(0).uniform(0, 30, size=(3, 40)).tolist()
    a = tev.write_result(errs, str(tmp_path / "port.json"))
    b = jev.write_result(errs, str(tmp_path / "jax.json"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-9)
