"""Parity of the PyTorch port's geometry, two-view BA and multi-view pose
pipeline with the JAX package, on the same seeded inputs (CPU)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from test_mv_pipeline import build_tuple_case  # noqa: E402
from test_two_view_ba import make_case  # noqa: E402

from e2e_multi_view_matching_tpu.geom import eightpoint as j8  # noqa: E402
from e2e_multi_view_matching_tpu.geom import epipolar as jepi  # noqa: E402
from e2e_multi_view_matching_tpu.geom import metrics as jmet  # noqa: E402
from e2e_multi_view_matching_tpu.geom import lie as jlie  # noqa: E402
from e2e_multi_view_matching_tpu.geom import linalg as jlin  # noqa: E402
from e2e_multi_view_matching_tpu.mvba import pipeline as jpipe  # noqa: E402
from e2e_multi_view_matching_tpu.mvba import spanning_tree as jtree  # noqa: E402
from e2e_multi_view_matching_tpu.pose.two_view_ba import (  # noqa: E402
    bundle_adjust_two_view as j_two_view_ba,
)
# the JAX `mvba` package re-exports functions under their modules' names
jba = importlib.import_module("e2e_multi_view_matching_tpu.mvba.bundle_adjust")
jrot = importlib.import_module("e2e_multi_view_matching_tpu.mvba.rotation_averaging")
jtrans = importlib.import_module("e2e_multi_view_matching_tpu.mvba.translation_averaging")

from e2e_multi_view_matching_tpu_torch.geom import eightpoint as t8  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import epipolar as tepi  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import metrics as tmet  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import lie as tlie  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import linalg as tlin  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom.metrics import pose_auc  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import bundle_adjust as tba  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import pipeline as tpipe  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import rotation_averaging as trot  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import spanning_tree as ttree  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import translation_averaging as ttrans  # noqa: E402
from e2e_multi_view_matching_tpu_torch.pose.two_view_ba import (  # noqa: E402
    bundle_adjust_two_view as t_two_view_ba,
)
from tests.torch_memory import teardown_module  # noqa: E402,F401


def t(x):
    return torch.from_numpy(np.array(x))


def rot_err_deg(Ra, Rb):
    tr = np.clip((np.trace(np.swapaxes(Ra, -1, -2) @ Rb, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def random_spd(rng, n, batch, null_dims=0):
    """Q diag(lam) Q^T with lam in [1, 10] and `null_dims` exact zeros."""
    Q = np.linalg.qr(rng.normal(size=(batch, n, n)))[0]
    lam = rng.uniform(1.0, 10.0, size=(batch, n))
    lam[:, :null_dims] = 0.0
    return ((Q * lam[:, None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32)


def same_up_to_sign(a, b, atol):
    sign = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * sign, b, atol=atol)


class TestLie:
    def test_matches_jax(self, rng):
        """exp/log/inverse on random tangents below pi (1e-5: f32 roundoff)."""
        w = rng.normal(size=(32, 3)).astype(np.float32)
        w *= rng.uniform(0.01, 2.8, size=(32, 1)).astype(np.float32) / np.linalg.norm(
            w, axis=-1, keepdims=True)
        xi = np.concatenate([w, rng.normal(size=(32, 3)).astype(np.float32)], -1)
        R = tlie.so3_exp(t(w))
        np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(w)), atol=1e-5)
        np.testing.assert_allclose(tlie.so3_log(R).numpy(),
                                   np.asarray(jlie.so3_log(jnp.asarray(R.numpy()))), atol=1e-5)
        T = tlie.se3_exp(t(xi))
        np.testing.assert_allclose(T.numpy(), np.asarray(jlie.se3_exp(xi)), atol=1e-5)
        np.testing.assert_allclose(tlie.se3_log(T).numpy(),
                                   np.asarray(jlie.se3_log(jnp.asarray(T.numpy()))), atol=1e-4)
        np.testing.assert_allclose(tlie.invert_transform(T).numpy(),
                                   np.asarray(jlie.invert_transform(jnp.asarray(T.numpy()))),
                                   atol=1e-5)
        # near-pi fallback
        Rpi = np.asarray(jlie.so3_exp(np.asarray([[np.pi - 1e-4, 0.0, 0.0]], np.float32)))
        np.testing.assert_allclose(tlie.so3_log(t(Rpi)).numpy(),
                                   np.asarray(jlie.so3_log(Rpi)), atol=1e-4)


class TestLinalg:
    @pytest.mark.parametrize("n", [6, 24])
    def test_jacobi_eigh_and_thresholded_solve(self, rng, n):
        """Unrolled Jacobi against JAX's (eigenvalues sorted, 1e-4 relative) and
        the reconstruction; the thresholded solve on a system with a 1-D null
        space (the BA scale gauge) against JAX to 1e-4 relative."""
        A = random_spd(rng, n, 4, null_dims=1)
        lam, V = tlin.jacobi_eigh(t(A))
        lam_j, _ = jlin.jacobi_eigh(jnp.asarray(A))
        scale = np.abs(A).max()
        np.testing.assert_allclose(np.sort(lam.numpy()), np.sort(np.asarray(lam_j)),
                                   atol=1e-4 * scale)
        recon = V.numpy() @ (lam.numpy()[..., None] * np.swapaxes(V.numpy(), -1, -2))
        np.testing.assert_allclose(recon, A, atol=1e-4 * scale)
        rhs = rng.normal(size=(4, n)).astype(np.float32)
        x = tlin.eig_thresholded_solve(t(A), t(rhs)).numpy()
        x_j = np.asarray(jlin.eig_thresholded_solve(jnp.asarray(A), jnp.asarray(rhs)))
        np.testing.assert_allclose(x, x_j, atol=1e-4 * np.abs(x_j).max())

    def test_safe_eigh_matches_numpy(self, rng):
        """The port's eigh (sorted Jacobi, no host sync) against LAPACK: values
        1e-4 relative, vectors up to sign (eigenvector signs are arbitrary)."""
        A = random_spd(rng, 9, 8)
        w, V = tlin.safe_eigh(t(A))
        w_np, V_np = np.linalg.eigh(A.astype(np.float64))
        np.testing.assert_allclose(w.numpy(), w_np, atol=1e-4 * np.abs(w_np).max())
        same_up_to_sign(np.swapaxes(V.numpy(), -1, -2), np.swapaxes(V_np, -1, -2), atol=1e-3)
        X = rng.normal(size=(3, 20, 9)).astype(np.float32)
        wts = rng.uniform(0.1, 1.0, size=(3, 20)).astype(np.float32)
        same_up_to_sign(tlin.weighted_nullvec(t(X), t(wts)).numpy(),
                        np.asarray(jlin.weighted_nullvec(X, wts)), atol=1e-4)

    @pytest.mark.parametrize("n", [3, 4, 12])
    def test_smallest_eigvec_ii_matches_jax(self, rng, n):
        """Adjugate (3, 4) and Cholesky (12) inverse iteration, up to sign, 1e-4."""
        G = random_spd(rng, n, 16, null_dims=1)
        same_up_to_sign(tlin.smallest_eigvec_ii(t(G)).numpy(),
                        np.asarray(jlin.smallest_eigvec_ii(jnp.asarray(G))), atol=1e-4)

    def test_cached_constants_serve_inference_and_autograd(self, rng):
        """The cached inverse-iteration seeds and Jacobi indices are normal
        tensors even when first made under torch.inference_mode (as the eval
        loops run): a later call under autograd (training, in the same
        process) can save them for its backward."""
        tlin._ii_seed.cache_clear()
        tlin._jacobi_indices.cache_clear()
        G = t(random_spd(rng, 3, 4, null_dims=1))
        A = t(random_spd(rng, 6, 4))
        with torch.inference_mode():
            tlin.smallest_eigvec_ii(G)
            tlin.jacobi_eigh(A)
        G, A = G.clone().requires_grad_(), A.clone().requires_grad_()
        (tlin.smallest_eigvec_ii(G).sum() + tlin.jacobi_eigh(A)[0].sum()).backward()
        assert torch.isfinite(G.grad).all() and torch.isfinite(A.grad).all()

    def test_small_inverses_and_psd_solve(self, rng):
        M3 = rng.normal(size=(8, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
        M4 = rng.normal(size=(8, 4, 4)).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)
        np.testing.assert_allclose(tlin.inv3x3(t(M3)).numpy(), np.linalg.inv(M3), atol=1e-4)
        np.testing.assert_allclose(tlin.inv4x4(t(M4)).numpy(), np.linalg.inv(M4), atol=1e-4)
        A = random_spd(rng, 5, 4) + np.eye(5, dtype=np.float32)
        b = rng.normal(size=(4, 5)).astype(np.float32)
        np.testing.assert_allclose(tlin.solve_psd(t(A), t(b), 0.1).numpy(),
                                   np.asarray(jlin.solve_psd(A, b, 0.1)), atol=1e-4)
        # a failed factorization is NaN, as JAX's cho_factor returns it
        assert torch.isnan(tlin.cholesky_nan(-t(A))).all()


class TestEpipolarAndMetrics:
    def test_primitives_match_jax(self, rng):
        """Normalization, DLT/midpoint triangulation, depths, epipolar
        distances and pose error metrics on noisy two-view points (1e-4
        relative: f32 roundoff, triangulation amplifies it at long range)."""
        cases = [make_case(rng, n_pts=32, noise=1e-3) for _ in range(3)]
        x0, x1, T = (np.stack([c[i] for c in cases]) for i in (0, 1, 2))
        w = rng.uniform(0.1, 1.0, size=x0.shape[:2]).astype(np.float32)
        intr = np.tile(np.asarray([[100, 0, 64], [0, 90, 48], [0, 0, 1]], np.float32), (3, 1, 1))
        R, tr = T[:, :3, :3], T[:, :3, 3]
        P0 = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
        pairs = [
            (tepi.normalize_keypoints(t(x0), t(intr)), jepi.normalize_keypoints(x0, intr)),
            (tepi.hartley_normalize(t(x0), t(w))[0], jepi.hartley_normalize(x0, w)[0]),
            (tepi.hartley_normalize(t(x0), t(w))[1], jepi.hartley_normalize(x0, w)[1]),
            (tepi.triangulate_points(t(P0), t(T[:, :3]), t(x0), t(x1)),
             jepi.triangulate_points(P0, T[:, :3], x0, x1)),
            (tepi.midpoint_triangulate_rel(t(R), t(tr), t(x0), t(x1)),
             jepi.midpoint_triangulate_rel(R, tr, x0, x1)),
            (tepi.sym_epipolar_distance(t(x0), t(x1), t(T[:, :3, :3]), squared=False),
             jepi.sym_epipolar_distance(x0, x1, T[:, :3, :3], squared=False)),
            (tmet.pose_error_max(t(T), t(T[::-1].copy())),
             jmet.pose_error_max(T, T[::-1].copy())),
            (tmet.translation_angle_error(t(T), t(T[::-1].copy())),
             jmet.translation_angle_error(T, T[::-1].copy())),
        ]
        X = pairs[3][0]
        pairs.append((tepi.depth_from_point(t(R), t(tr), X),
                      jepi.depth_from_point(R, tr, jnp.asarray(X.numpy()))))
        for a, b in pairs:
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def two_view_batch(rng, n_scenes=4, n_pts=64, noise=1e-3):
    """Synthetic pairs in pixels (f=100, c=(64, 48)) with 10% outliers."""
    K = np.asarray([[100, 0, 64], [0, 100, 48], [0, 0, 1]], np.float32)
    out = {"k0": [], "k1": [], "T": [], "conf": []}
    for _ in range(n_scenes):
        x0, x1, T, _ = make_case(rng, n_pts=n_pts, noise=noise)
        n_out = n_pts // 10
        x1[:n_out] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
        out["k0"].append(x0 * 100 + K[:2, 2])
        out["k1"].append(x1 * 100 + K[:2, 2])
        out["T"].append(T)
        out["conf"].append(rng.uniform(0.3, 1.0, size=n_pts))
    out = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    out["intr"] = np.tile(K, (n_scenes, 1, 1))
    return out


class TestTwoView:
    def test_w8pt_matches_jax(self, rng):
        """Eight-point pose, inliers and depth masks on pairs with outliers:
        T within 1e-4 of JAX; masks identical."""
        d = two_view_batch(rng)
        args = (d["k0"], d["k1"], d["intr"], d["intr"], d["conf"])
        T, info = t8.estimate_relative_pose_w8pt(*map(t, args), determine_inliers=True)
        T_j, info_j = j8.estimate_relative_pose_w8pt(*map(jnp.asarray, args),
                                                     determine_inliers=True)
        np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=1e-4)
        for name in ("inliers", "pos_depth_mask", "valid"):
            np.testing.assert_array_equal(getattr(info, name).numpy(),
                                          np.asarray(getattr(info_j, name)))
        T_c, _ = t8.estimate_relative_pose_w8pt(*map(t, args), choose_closest=True,
                                                target_T021=t(d["T"]))
        T_cj, _ = j8.estimate_relative_pose_w8pt(*map(jnp.asarray, args), choose_closest=True,
                                                 target_T021=jnp.asarray(d["T"]))
        np.testing.assert_allclose(T_c.numpy(), np.asarray(T_cj), atol=1e-4)

    def test_robust_relative_poses_and_two_view_ba_match_jax(self, rng):
        """The IRLS w8pt + two-view LM BA of the pose stage (10 iterations)
        against JAX: counts and validity identical, poses within 1e-3 (LM
        steps amplify f32 reduction-order noise)."""
        d = two_view_batch(rng, n_scenes=6)
        args = (d["k0"], d["k1"], d["intr"], d["intr"], d["conf"])
        out = tpipe.robust_relative_poses(*map(t, args), 10)
        ref = jpipe.robust_relative_poses(*map(jnp.asarray, args), 10)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-3)
        for a, b in zip(out[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_two_view_ba_fixture_matches_jax(self, rng):
        """The JAX test fixture's perturbed inits (test_two_view_ba.make_case):
        the refined pose agrees with JAX within 1e-3."""
        cases = [make_case(rng, n_pts=128, noise=3e-4) for _ in range(4)]
        x0, x1 = (np.stack([c[i] for c in cases]) for i in (0, 1))
        T_init = np.stack([c[3] for c in cases])
        conf = np.ones(x0.shape[:2], np.float32)
        T_ba, valid = t_two_view_ba(t(x0), t(x1), t(conf), t(T_init), n_iterations=10)
        T_j, valid_j = j_two_view_ba(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(conf),
                                     jnp.asarray(T_init), n_iterations=10)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
        np.testing.assert_allclose(T_ba.numpy(), np.asarray(T_j), atol=1e-3)


def tuple_batch(rng, n=2, **kw):
    cases = [build_tuple_case(rng, **kw) for _ in range(n)]
    return {
        "scenes": [c[0] for c in cases],
        "kpts": np.stack([c[1] for c in cases]),
        "matches0": np.stack([c[2] for c in cases]).astype(np.int32),
        "conf": np.stack([c[3] for c in cases]),
        "intr": np.stack([np.tile(c[0].intr[0].astype(np.float32), (5, 1, 1))
                          for c in cases]),
    }


class TestMultiView:
    def test_spanning_tree_matches_jax(self):
        """Device Prim's over 40 random graphs at once, with deliberate weight
        ties, zero counts and invalid pairs: same trees, extrinsics to 1e-5."""
        rng = np.random.default_rng(0)
        V, P, n = 5, 10, 40
        idx_i, idx_j = tpipe.pair_indices(V, "cpu")
        A = rng.normal(size=(n, P, 3, 3))
        R = np.stack([[np.linalg.qr(a)[0] for a in row] for row in A])
        R[..., 0] *= np.linalg.det(R)[..., None]
        T_rel = np.asarray(jlie.make_transform(jnp.asarray(R, jnp.float32),
                                               jnp.asarray(rng.normal(size=(n, P, 3)),
                                                           jnp.float32)))
        counts = rng.integers(0, 6, size=(n, P)).astype(np.int32)
        valid = rng.random((n, P)) > 0.25
        extr, on_tree = ttree.spanning_tree_poses_device(t(T_rel), t(counts), t(valid),
                                                          idx_i, idx_j, V)
        tree_fn = jax.jit(jax.vmap(lambda T, c, v: jtree.spanning_tree_poses_device(
            T, c, v, idx_i.numpy(), idx_j.numpy(), V)))
        extr_j, on_tree_j = tree_fn(jnp.asarray(T_rel), jnp.asarray(counts), jnp.asarray(valid))
        np.testing.assert_array_equal(on_tree.numpy(), np.asarray(on_tree_j))
        np.testing.assert_allclose(extr.numpy(), np.asarray(extr_j), atol=1e-5)

    def test_averaging_and_bundle_adjust_match_jax(self, rng):
        """Rotation and translation averaging and the multi-camera BA on the
        JAX stage A of the synthetic 5-tuples (test_mv_pipeline), fed to both:
        rotations and centers within 1e-4, BA extrinsics after 10 LM iterations
        within 1e-4. (Run to convergence, the LM's best-iterate test compares
        residuals that tie to f32 noise, and on this fixture one tuple then
        keeps a different iterate in each package.)"""
        d = tuple_batch(rng)
        stage_a = jpipe.multi_view_pose_stage_a(d["kpts"], d["intr"], d["matches0"], d["conf"])
        V, K = 5, d["kpts"].shape[2]
        idx_i, idx_j = tpipe.pair_indices(V, "cpu")
        T_rel = np.asarray(stage_a["T_rel"])
        extr_tree, on_tree = jax.vmap(lambda T, c, v: jtree.spanning_tree_poses_device(
            T, c, v, idx_i.numpy(), idx_j.numpy(), V))(
            stage_a["T_rel"], stage_a["counts"], stage_a["valid"])
        extr_tree = np.asarray(extr_tree)
        edge_valid = np.asarray(stage_a["valid"]) & (
            (np.asarray(stage_a["counts"]) >= 20) | np.asarray(on_tree))
        ei, ej = idx_i.numpy().astype(np.int32), idx_j.numpy().astype(np.int32)

        R = trot.rotation_averaging(t(extr_tree[..., :3, :3]), idx_i, idx_j,
                                    t(T_rel[..., :3, :3]), t(edge_valid))
        R_j = jax.vmap(lambda a, b, c: jrot.rotation_averaging(a, ei, ej, b, c))(
            extr_tree[..., :3, :3], T_rel[..., :3, :3], edge_valid)
        np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=1e-4)

        R_np = np.asarray(R_j)
        c_tree = -np.einsum("bvji,bvj->bvi", extr_tree[..., :3, :3], extr_tree[..., :3, 3])
        gamma = np.asarray(jax.vmap(jtrans.edge_directions)(
            R_np[:, ei], T_rel[..., :3, :3], T_rel[..., :3, 3]))
        np.testing.assert_allclose(
            ttrans.edge_directions(t(R_np[:, ei]), t(T_rel[..., :3, :3]),
                                   t(T_rel[..., :3, 3])).numpy(), gamma, atol=1e-5)
        c = ttrans.translation_averaging(t(c_tree), idx_i, idx_j, t(gamma), t(edge_valid))
        c_j = jax.vmap(lambda a, b, v: jtrans.translation_averaging(a, ei, ej, b, v))(
            c_tree, gamma, edge_valid)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-4)

        extr = extr_tree.copy()
        x_i = np.asarray(stage_a["x_i_n"]).reshape(2, -1, 2)
        x_j = np.asarray(stage_a["x_j_n"]).reshape(2, -1, 2)
        w = np.asarray(stage_a["conf_gated"]).reshape(2, -1)
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-6) * 2.0
        cam_a, cam_b = idx_i.repeat_interleave(K), idx_j.repeat_interleave(K)
        X0 = tba._triangulate_pairwise(t(extr), cam_a, cam_b, t(x_i), t(x_j))
        X0_j = jax.vmap(lambda e, a, b: jba._triangulate_pairwise(
            e, cam_a.numpy(), cam_b.numpy(), a, b))(extr, x_i, x_j)
        # near-parallel rays amplify roundoff in the midpoint: 1e-3 relative
        np.testing.assert_allclose(X0.numpy(), np.asarray(X0_j), rtol=1e-3, atol=1e-4)
        out, _ = tba.bundle_adjust_multi_view(t(extr), t(X0_j), cam_a, cam_b, t(x_i), t(x_j),
                                              t(w), n_iterations=10)
        out_j = jax.vmap(lambda e, X, a, b, ww: jba.bundle_adjust_multi_view(
            e, X, cam_a.numpy().astype(np.int32), cam_b.numpy().astype(np.int32), a, b, ww,
            n_iterations=10)[0])(extr, np.asarray(X0_j), x_i, x_j, w)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-4)

    def test_pipeline_matches_jax(self, rng):
        """`multi_view_pose_device` end to end on synthetic 5-tuples with
        outliers: extrinsics within 5e-4 of JAX and poses within 1 deg of the
        ground truth. A third tuple with a matchless pair and a 5-match pair
        stays finite; it is not compared: the 5-match pair is underdetermined
        for the eight-point solve, so which of its matches pass the inlier gate
        into the multi-view BA flips on f32 noise, in JAX as in the port."""
        d = tuple_batch(rng, n=3)
        d["conf"][2, 0, :] = 0.0
        d["conf"][2, 3, 5:] = 0.0
        args = (d["kpts"], d["intr"], d["matches0"], d["conf"])
        extr = tpipe.multi_view_pose_device(*map(t, args)).numpy()
        extr_j = np.asarray(jax.jit(jpipe.multi_view_pose_device)(*map(jnp.asarray, args)))
        assert np.all(np.isfinite(extr))
        np.testing.assert_allclose(extr[:2], extr_j[:2], atol=5e-4)
        for b, scene in enumerate(d["scenes"][:2]):
            for j in range(5):
                for i in range(j):
                    T_pred = extr[b, j] @ np.linalg.inv(extr[b, i])
                    assert rot_err_deg(scene.relative_pose(i, j)[:3, :3], T_pred[:3, :3]) < 1.0


def test_pose_auc_matches_numpy_reference():
    errs = np.asarray([0.5, 3.0, 7.5, 12.0, np.inf, 30.0])
    from e2e_multi_view_matching_tpu.geom.metrics import pose_auc as j_pose_auc
    np.testing.assert_allclose(pose_auc(errs), j_pose_auc(errs), atol=1e-12)
