"""The differentiable pieces of the stage-2 pose loss in the PyTorch port
against the JAX package: the gap-clamped gradient of `safe_eigh`, the gradient
of the weighted eight-point solve with `choose_closest`, the pose-loss branch
of `matcher_losses`, and the sphere-field scenes it trains on (CPU).

The same numpy inputs go through both packages. Float64 comparisons run JAX
inside `jax.enable_x64(True)`: the eight-point gradient is ill-conditioned
enough that two float32 runs of the same formula differ in the third digit,
so float64 shows that the formulas agree, and float32 is held to float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import synthetic as jsyn  # noqa: E402
from e2e_multi_view_matching_tpu.geom import eightpoint as jep  # noqa: E402
from e2e_multi_view_matching_tpu.geom import linalg as jlin  # noqa: E402
from e2e_multi_view_matching_tpu.geom import metrics as jmet  # noqa: E402
from e2e_multi_view_matching_tpu.train import losses as jlosses  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import eightpoint as tep  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import linalg as tlin  # noqa: E402
from e2e_multi_view_matching_tpu_torch.geom import metrics as tmet  # noqa: E402
from e2e_multi_view_matching_tpu_torch.train import losses as tlosses  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401


def t(x):
    return torch.from_numpy(np.array(x))


def _sym_with_spectrum(rng, lam):
    Q = np.linalg.qr(rng.normal(size=lam.shape + (lam.shape[-1],)))[0]
    return ((Q * lam[..., None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32)


def _eig_objective(w, V, c, d, M, xp):
    """A scalar of the eigenpairs that a sign flip of any eigenvector leaves
    unchanged: sum_k d_k w_k + c_k v_k^T M v_k."""
    return (w * d).sum() + (c * xp.einsum("bin,ij,bjn->bn", V, M, V)).sum()


class TestSafeEighGradient:
    def test_vjp_matches_jax_on_separated_spectra(self, rng):
        """Random symmetric 9x9 matrices with eigenvalues at least 0.3 apart:
        the VJP of the port's sorted-Jacobi `safe_eigh` against `jax.grad`
        through JAX's `safe_eigh` (LAPACK eigh + custom JVP), 1e-4 of the
        largest entry (f32)."""
        n = 9
        lam = np.sort(rng.uniform(0, 3, size=(6, n)), -1) + 0.3 * np.arange(n)
        A = _sym_with_spectrum(rng, lam)
        M = rng.normal(size=(n, n)).astype(np.float32)
        M = M + M.T
        c, d = (rng.normal(size=n).astype(np.float32) for _ in range(2))
        ref = np.asarray(jax.grad(lambda A: _eig_objective(*jlin.safe_eigh(A), c, d, M, jnp))(A))
        At = t(A).requires_grad_()
        f = _eig_objective(*tlin.safe_eigh(At), t(c), t(d), t(M), torch)
        g = torch.autograd.grad(f, At)[0].numpy()
        np.testing.assert_allclose(g, ref, atol=1e-4 * np.abs(ref).max())
        np.testing.assert_allclose(g, np.swapaxes(g, -1, -2), atol=1e-6)  # symmetrized

    def test_repeated_pair_gives_a_bounded_gradient(self, rng):
        """Two equal eigenvalues: the basis inside their plane is arbitrary, so
        only finiteness and the clamp's bound are checked, |gA| <= |gw| + |V^T
        gV| / 1e-6 entry-wise over the spectrum."""
        n = 9
        lam = np.arange(n, dtype=np.float64)
        lam[4] = lam[3]
        A = _sym_with_spectrum(rng, np.tile(lam, (2, 1)))
        At = t(A).requires_grad_()
        w, V = tlin.safe_eigh(At)
        gw, gV = (t(rng.normal(size=x.shape).astype(np.float32)) for x in (w, V))
        gA = torch.autograd.grad((w * gw).sum() + (V * gV).sum(), At)[0]
        assert bool(torch.isfinite(gA).all())
        bound = n * (float(gw.abs().max()) + float(gV.abs().sum(-2).max()) / 1e-6)
        assert float(gA.abs().max()) <= bound
        assert float(gA.abs().max()) > 1e3  # the clamped 1/gap term is live


def _sphere_pairs(rng, n_pairs=3, n_pts=64, noise_px=0.5):
    """Exact co-visible correspondences of JAX sphere-field scenes, view 0
    perturbed by pixel noise, with their relative poses and intrinsics."""
    k0, k1, T = [], [], []
    for _ in range(n_pairs):
        scene = jsyn.SphereFieldScene(rng, n_views=2)
        p0, p1 = scene.correspondences(0, 1, n_pts, rng)
        assert len(p0) == n_pts
        k0.append(p0 + rng.normal(size=p0.shape).astype(np.float32) * noise_px)
        k1.append(p1)
        T.append(scene.relative_pose(0, 1))
    intr = np.tile(scene.intr[0].astype(np.float32), (n_pairs, 1, 1))
    conf = rng.uniform(0.1, 1.0, size=(n_pairs, n_pts)).astype(np.float32)
    return np.stack(k0), np.stack(k1), intr, np.stack(T), conf


def _w8pt_error_jax(k0, k1, intr, T, conf):
    Tp, _ = jep.estimate_relative_pose_w8pt(k0, k1, intr, intr, conf, choose_closest=True,
                                            target_T021=T)
    return (jnp.sum(jmet.rotation_angle_error(Tp, T, reduce=False))
            + jnp.sum(jmet.translation_angle_error(Tp, T, reduce=False)))


def _w8pt_error_torch(k0, k1, intr, T, conf):
    Tp, _ = tep.estimate_relative_pose_w8pt(k0, k1, intr, intr, conf, choose_closest=True,
                                            target_T021=T)
    return (tmet.rotation_angle_error(Tp, T, reduce=False).sum()
            + tmet.translation_angle_error(Tp, T, reduce=False).sum())


def test_w8pt_choose_closest_gradient_matches_jax(rng):
    """d(rotation + translation angle error) / d(kpts0, kpts1, confidence) of
    the eight-point solve with `choose_closest`, on noisy sphere-field pairs.
    Float64: value and gradients 1e-8 relative to JAX's. Float32 (the training
    dtype): finite, within 1e-2 of the largest float64 entry (the float32
    spread of this gradient: JAX's own float32 run is ~6e-4 away from float64
    here, the port's ~3e-3)."""
    k0, k1, intr, T, conf = _sphere_pairs(rng)
    with jax.enable_x64(True):
        args64 = [x.astype(np.float64) for x in (k0, k1, intr, T, conf)]
        val_ref, refs = jax.jit(jax.value_and_grad(
            lambda a, b, c: _w8pt_error_jax(a, b, args64[2], args64[3], c),
            argnums=(0, 1, 2)))(args64[0], args64[1], args64[4])
        refs = [np.asarray(r) for r in refs]
    for dtype, tol in ((np.float64, 1e-8), (np.float32, 1e-2)):
        xs = [t(x.astype(dtype)) for x in (k0, k1, intr, T, conf)]
        leaves = [xs[0].requires_grad_(), xs[1].requires_grad_(), xs[4].requires_grad_()]
        val = _w8pt_error_torch(xs[0], xs[1], xs[2], xs[3], xs[4])
        grads = torch.autograd.grad(val, leaves)
        np.testing.assert_allclose(float(val.detach()), float(val_ref), rtol=max(tol, 1e-12))
        for g, r in zip(grads, refs):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.double().numpy(), r, atol=tol * np.abs(r).max())


def _pose_loss_case(rng, B=2, V=3, K=24):
    """A matcher output over the pairs of sphere-field V-tuples: matches0
    pointing at true correspondences (a few left unmatched), confidences in
    (0, 1), a normalized log assignment, GT indices and weights."""
    P = V * (V - 1) // 2
    kpts, intr, poses = [], [], []
    for _ in range(B):
        scene = jsyn.SphereFieldScene(rng, n_views=V)
        pix0 = rng.uniform([10, 10], [scene.W - 10, scene.H - 10], size=(K, 2))
        X = scene.unproject(0, pix0)
        kpts.append(np.stack([scene.project(v, X)[0] for v in range(V)]))
        intr.append(scene.intr)
        poses.append(scene.poses)
    kpts = np.stack(kpts).astype(np.float32)
    kpts += rng.normal(size=kpts.shape).astype(np.float32) * 0.5
    pairs = np.asarray([(i, j) for j in range(V) for i in range(j)], np.int32)
    matches0 = np.tile(np.arange(K, dtype=np.int32), (B, P, 1))
    matches0[rng.uniform(size=matches0.shape) < 0.15] = -1
    conf = rng.uniform(0.05, 1.0, size=(B, P, K)).astype(np.float32)
    logits = rng.normal(size=(B, P, K + 1, K + 1))
    log_p = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    gi = rng.integers(-1, K, size=(B, P, 2, K + 1)).astype(np.int32)
    gw = rng.uniform(0, 2, size=(B, P, 2, K + 1)).astype(np.float32)
    return (log_p, conf, matches0, pairs, kpts, np.stack(intr).astype(np.float32),
            np.stack(poses).astype(np.float32), gi, gw)


def test_pose_loss_branch_matches_jax(rng):
    """`matcher_losses(pose_loss=True)` and the blend: the (B*P)-batched
    eight-point solve, rot = sum_p mean_B, transl with the per-pair valid
    count. Float64: the three losses and the gradients of the blended total
    with respect to `conf_scores` and `log_assignment` 1e-8 relative to JAX's.
    Float32: losses 1e-3 relative to float64, gradients finite."""
    log_p, conf, m0, pairs, kpts, intr, poses, gi, gw = _pose_loss_case(rng)
    n_pairs = pairs.shape[0]

    def jax_total(log_p, conf, intr, poses, kpts, gw):
        res = {"log_assignment": log_p, "conf_scores": conf, "matches0": jnp.asarray(m0),
               "pairs": jnp.asarray(pairs)}
        losses = jlosses.matcher_losses(res, jnp.asarray(gi), gw, kpts, intr, poses, True)
        return jlosses.combine_losses(losses, n_pairs, 0.5, 726.0, 244.0)[0], losses

    with jax.enable_x64(True):
        f64 = [x.astype(np.float64) for x in (log_p, conf, intr, poses, kpts, gw)]
        (total_ref, losses_ref), refs = jax.jit(jax.value_and_grad(
            jax_total, argnums=(0, 1), has_aux=True))(*f64)
        losses_ref = {k: float(v) for k, v in losses_ref.items()}
        refs = [np.asarray(r) for r in refs]
    assert losses_ref["rot_loss"] > 0 and losses_ref["transl_loss"] > 0
    for dtype, tol in ((np.float64, 1e-8), (np.float32, 1e-3)):
        lp, cf, it, ps, kp, w = (t(x.astype(dtype)) for x in (log_p, conf, intr, poses, kpts, gw))
        lp.requires_grad_()
        cf.requires_grad_()
        res = {"log_assignment": lp, "conf_scores": cf, "matches0": t(m0), "pairs": t(pairs)}
        losses = tlosses.matcher_losses(res, t(gi), w, kp, it, ps, pose_loss=True)
        total, _ = tlosses.combine_losses(losses, n_pairs, 0.5, 726.0, 244.0)
        for k, v in losses.items():
            np.testing.assert_allclose(float(v.detach()), losses_ref[k], rtol=tol, err_msg=k)
        grads = torch.autograd.grad(total, (lp, cf))
        for g, r in zip(grads, refs):
            assert bool(torch.isfinite(g).all())
            if dtype == np.float64:
                np.testing.assert_allclose(g.numpy(), r, atol=tol * np.abs(r).max())
    assert np.abs(refs[1]).max() > 0  # the pose term reaches the confidences


def test_sphere_field_scene_matches_jax():
    """The port's sphere-field scene gives the JAX package's poses, depth maps
    and texture for the same seed, bit for bit."""
    ours = tsyn.SphereFieldScene(np.random.default_rng(4), n_views=3, H=48, W=64, f=60.0)
    ref = jsyn.SphereFieldScene(np.random.default_rng(4), n_views=3, H=48, W=64, f=60.0)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    np.testing.assert_array_equal(ours.sphere_c, ref.sphere_c)
    rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
    for v in range(3):
        depth = ours.depth_map(v)
        np.testing.assert_array_equal(depth, ref.depth_map(v))
        assert depth.min() > 0  # every ray hits a sphere or the plane
        np.testing.assert_array_equal(tsyn.fourier_texture_image(ours, v, rng=rng_a),
                                      jsyn.fourier_texture_image(ref, v, rng=rng_b))
    batch = tsyn.training_batch(np.random.default_rng(0), 2, 3, 48, 64, 60.0,
                                scene_cls=tsyn.SphereFieldScene)
    assert batch["images"].shape == (2, 3, 48, 64, 1) and batch["depths"].min() > 0
