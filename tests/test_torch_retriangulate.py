"""The variable-projection bundle adjusters (`retriangulate=True`): the
PyTorch port against the JAX package on the same seeded inputs (CPU), and
`MultiViewPipelineConfig.ba_retriangulate` reaching the multi-view BA."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from test_mv_pipeline import rot_err_deg, transl_angle_deg  # noqa: E402
from test_torch_geom import tuple_batch  # noqa: E402
from test_two_view_ba import make_case  # noqa: E402

from e2e_multi_view_matching_tpu.mvba import pipeline as jpipe  # noqa: E402
from e2e_multi_view_matching_tpu.mvba import spanning_tree as jtree  # noqa: E402
from e2e_multi_view_matching_tpu.pose.two_view_ba import (  # noqa: E402
    bundle_adjust_two_view as j_two_view_ba,
)
from e2e_multi_view_matching_tpu_torch.mvba import bundle_adjust as tba  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import pipeline as tpipe  # noqa: E402
from e2e_multi_view_matching_tpu_torch.pose.two_view_ba import (  # noqa: E402
    bundle_adjust_two_view as t_two_view_ba,
)
from tests.torch_memory import teardown_module  # noqa: E402,F401

# the JAX `mvba` package re-exports functions under their modules' names
jba = importlib.import_module("e2e_multi_view_matching_tpu.mvba.bundle_adjust")

V = 5
PAIRS = [(i, j) for j in range(V) for i in range(j)]


def t(x):
    return torch.from_numpy(np.array(x))


def reprojection_residual(extr, cam_a, cam_b, x_i, x_j, w):
    """sum w^2 |pi(X) - x|^2 per tuple in float64, X the DLT points of `extr`:
    the objective the variable-projection LM minimises."""
    E = torch.as_tensor(np.array(extr, np.float64))
    xs = [torch.as_tensor(np.array(x, np.float64)) for x in (x_i, x_j)]
    X = tba._triangulate_pairwise_dlt(E, cam_a, cam_b, *xs)
    r = 0.0
    for cam, x in zip((cam_a, cam_b), xs):
        T = E[:, cam]
        Ap = torch.einsum("bpij,bpj->bpi", T[..., :3, :3], X) + T[..., :3, 3]
        r = r + ((torch.as_tensor(w, dtype=torch.float64)[..., None]
                  * (Ap[..., :2] / Ap[..., 2:] - x)) ** 2).sum((1, 2))
    return r.numpy()


def test_multi_view_ba_retriangulate_matches_jax():
    """`bundle_adjust_multi_view(retriangulate=True)` against JAX's on the JAX
    stage A of two synthetic 5-tuples, 10 LM iterations, from the tree init.

    The structure solve, `_triangulate_pairwise_dlt` (the 4x4 DLT by inverse
    iteration, 3 steps and a Rayleigh step), agrees with JAX's within 1e-3
    relative (measured: 1.6e-5 relative, 3.4e-4 absolute at the farthest
    points). The LM does not reach the 1e-4 that the default mode's parity
    test holds: the two agree to 2e-6 through iteration 5, the DLT's float32
    noise then adds ~1e-4 an iteration, and near the optimum the
    retriangulated residual is flat. On tuple 0 the 10-iteration extrinsics of
    JAX and the port are 0.26 apart in one translation entry (rotations
    0.60 deg, translation directions 1.55 deg apart) at residuals 5.35e-7 and
    5.29e-7; against the same LM in float64 (5.29e-7) the port is 1.4e-3 away
    and JAX 0.26. So held: the port within 5e-3 of float64 and its residual
    within 1% of float64's; against JAX, rotations within 1 deg, translation
    directions within 2 deg and the residual within 2%; both at most half the
    tree init's residual (measured 940x and 3x below it: 4.97e-4 and 1.6e-7
    at the tree)."""
    d = tuple_batch(np.random.default_rng(0))
    stage_a = jpipe.multi_view_pose_stage_a(d["kpts"], d["intr"], d["matches0"], d["conf"])
    K = d["kpts"].shape[2]
    idx_i, idx_j = tpipe.pair_indices(V, "cpu")
    extr_tree = np.asarray(jax.vmap(lambda T, c, v: jtree.spanning_tree_poses_device(
        T, c, v, idx_i.numpy(), idx_j.numpy(), V))(
        stage_a["T_rel"], stage_a["counts"], stage_a["valid"])[0])
    x_i = np.asarray(stage_a["x_i_n"]).reshape(2, -1, 2)
    x_j = np.asarray(stage_a["x_j_n"]).reshape(2, -1, 2)
    w = np.asarray(stage_a["conf_gated"]).reshape(2, -1)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-6) * 2.0
    cam_a, cam_b = idx_i.repeat_interleave(K), idx_j.repeat_interleave(K)
    ca, cb = cam_a.numpy().astype(np.int32), cam_b.numpy().astype(np.int32)

    live = w > 0
    dlt = tba._triangulate_pairwise_dlt(t(extr_tree), cam_a, cam_b, t(x_i), t(x_j)).numpy()
    dlt_j = np.asarray(jax.vmap(lambda e, a, b: jba._triangulate_pairwise_dlt(e, ca, cb, a, b))(
        extr_tree, x_i, x_j))
    np.testing.assert_allclose(dlt[live], dlt_j[live], rtol=1e-3, atol=1e-4)

    X0 = np.zeros(x_i.shape[:2] + (3,), np.float32)  # not read when retriangulating
    args = (cam_a, cam_b, t(x_i), t(x_j), t(w))
    out = tba.bundle_adjust_multi_view(t(extr_tree), t(X0), *args, n_iterations=10,
                                       retriangulate=True)[0].numpy()
    out64 = tba.bundle_adjust_multi_view(
        t(extr_tree).double(), t(X0).double(), cam_a, cam_b,
        *(a.double() for a in args[2:]), n_iterations=10, retriangulate=True)[0].numpy()
    out_j = np.asarray(jax.vmap(lambda e, X, a, b, ww: jba.bundle_adjust_multi_view(
        e, X, ca, cb, a, b, ww, n_iterations=10, retriangulate=True)[0])(
        extr_tree, X0, x_i, x_j, w))
    np.testing.assert_allclose(out, out64, atol=5e-3)
    r, r64, r_j, r_tree = (reprojection_residual(e, cam_a, cam_b, x_i, x_j, w)
                           for e in (out, out64, out_j, extr_tree))
    np.testing.assert_allclose(r, r64, rtol=1e-2)
    np.testing.assert_allclose(r, r_j, rtol=2e-2)
    assert np.all(r < r_tree / 2) and np.all(r_j < r_tree / 2)
    for b in range(2):
        for v in range(1, V):
            assert rot_err_deg(out[b, v, :3, :3], out_j[b, v, :3, :3]) < 1.0
            assert transl_angle_deg(out[b, v, :3, 3], out_j[b, v, :3, 3]) < 2.0


def test_two_view_ba_retriangulate_matches_jax():
    """`bundle_adjust_two_view(retriangulate=True)` against JAX's on the JAX
    test fixture's perturbed inits, 10 iterations: validity equal, poses
    within 1e-3, the default mode's parity bound (the midpoint is closed
    form)."""
    rng = np.random.default_rng(1)
    cases = [make_case(rng, n_pts=128, noise=3e-4) for _ in range(4)]
    x0, x1 = (np.stack([c[i] for c in cases]) for i in (0, 1))
    T_init = np.stack([c[3] for c in cases])
    conf = np.ones(x0.shape[:2], np.float32)
    T_ba, valid = t_two_view_ba(t(x0), t(x1), t(conf), t(T_init), n_iterations=10,
                                retriangulate=True)
    T_j, valid_j = j_two_view_ba(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(conf),
                                 jnp.asarray(T_init), n_iterations=10, retriangulate=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(T_ba.numpy(), np.asarray(T_j), atol=1e-3)
    T_default, _ = t_two_view_ba(t(x0), t(x1), t(conf), t(T_init), n_iterations=10)
    assert np.abs(T_ba.numpy() - T_default.numpy()).max() > 0


def test_pipeline_ba_retriangulate():
    """`ba_retriangulate=True` reaches the multi-view BA of both pipelines:
    the extrinsics change, the fused and the host-tree pipelines agree within
    5e-4, and the poses stay within the w8pt_ba bound of the ground truth
    (1 deg)."""
    d = tuple_batch(np.random.default_rng(0))
    args = (d["kpts"], d["intr"], d["matches0"], d["conf"])
    cfg = tpipe.MultiViewPipelineConfig(ba_retriangulate=True)
    base = tpipe.multi_view_pose_device(*map(t, args)).numpy()
    extr = tpipe.multi_view_pose_device(*map(t, args), cfg).numpy()
    host = tpipe.multi_view_pose_pipeline_batch(*args, cfg, device="cpu")
    assert np.abs(extr - base).max() > 0
    np.testing.assert_allclose(host, extr, atol=5e-4)
    for b, scene in enumerate(d["scenes"]):
        for i, j in PAIRS:
            T_pred = extr[b, j] @ np.linalg.inv(extr[b, i])
            assert rot_err_deg(scene.relative_pose(i, j)[:3, :3], T_pred[:3, :3]) < 1.0
