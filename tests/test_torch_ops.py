"""Parity of the PyTorch port's attention and Sinkhorn ops with the JAX package.

CPU tests feed the same numpy inputs to both packages; the JAX Pallas
functions run in interpret mode, as the JAX package's own tests run them. The
`cuda` tests hold each hand-written kernel against its plain PyTorch version
and skip without a GPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2e_multi_view_matching_tpu.ops import attention as jattn  # noqa: E402
from e2e_multi_view_matching_tpu.ops import sinkhorn as jsink  # noqa: E402
from e2e_multi_view_matching_tpu.ops.attention_pallas import (  # noqa: E402
    fused_view_attention as j_fused_view_attention,
)
from e2e_multi_view_matching_tpu.ops.sinkhorn_pallas import (  # noqa: E402
    _pallas_sinkhorn_stash,
    log_optimal_transport_pallas,
)
from e2e_multi_view_matching_tpu_torch.ops import attention as tattn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import attention_cuda  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as tsink  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda  # noqa: E402


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


class TestAttention:
    @pytest.mark.parametrize("mode", ["full", "self", "cross"])
    def test_plain_matches_jax(self, rng, mode):
        """The port's plain masked attention (what `fused_view_attention` runs on
        a CPU tensor) against JAX's `multi_head_attention` with the same mask
        (1e-5: f32 reduction order) and JAX's Pallas kernels in interpret mode
        (2e-5: their online softmax reorders the sums, the JAX tests' bound)."""
        V, K, D, h = 3, 64, 32, 2
        q, k, v = (rng.normal(size=(2, V * K, D)).astype(np.float32) for _ in range(3))
        out = attention_cuda.fused_view_attention(t(q), t(k), t(v), h, V, K, mode).numpy()
        mask = {"full": None, "self": jattn.self_view_mask(V, K),
                "cross": jattn.cross_view_mask(V, K)}[mode]
        ref = np.asarray(jattn.multi_head_attention(q, k, v, h, mask=mask))
        np.testing.assert_allclose(out, ref, atol=1e-5)
        pallas = np.asarray(j_fused_view_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, V, K, mode, True))
        np.testing.assert_allclose(out, pallas, atol=2e-5)

    @pytest.mark.parametrize("mode", ["full", "cross"])
    def test_recompute_vjp_matches_jax(self, rng, mode, monkeypatch):
        """The autograd function that carries the kernels' forward: its
        backward recomputes the VJP through the plain attention from the saved
        q, k, v. Here its forward is the plain version too (no card), so the
        test holds the backward against `jax.grad` through JAX's
        `multi_head_attention`: 5e-5, the JAX package's bound for its own
        attention gradients in f32."""
        V, K, D, h = 3, 16, 32, 2
        q, k, v, w = (rng.normal(size=(2, V * K, D)).astype(np.float32) for _ in range(4))
        monkeypatch.setattr(attention_cuda, "_kernel_view_attention",
                            attention_cuda.plain_view_attention)
        qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
        out = attention_cuda._FusedViewAttention.apply(qt, kt, vt, h, V, K, mode)
        grads = torch.autograd.grad((out * t(w)).sum(), (qt, kt, vt))
        mask = None if mode == "full" else jattn.cross_view_mask(V, K)
        ref = jax.grad(lambda *a: jnp.sum(jattn.multi_head_attention(*a, h, mask=mask) * w),
                       argnums=(0, 1, 2))(q, k, v)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)
        # on a CPU tensor the public function differentiates its plain version
        out = attention_cuda.fused_view_attention(qt, kt, vt, h, V, K, mode)
        for g, r in zip(torch.autograd.grad((out * t(w)).sum(), (qt, kt, vt)), ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)

    def test_masks_match_jax(self):
        for fn in ("cross_view_mask", "self_view_mask"):
            np.testing.assert_array_equal(getattr(tattn, fn)(3, 4).numpy(),
                                          np.asarray(getattr(jattn, fn)(3, 4)))

    def test_kernel_wrappers_reject_cpu_tensors(self):
        """The raw kernel wrappers never fall back: a CPU tensor is refused."""
        x = torch.zeros(2, 128, 16)
        with pytest.raises(ValueError):
            attention_cuda.attn_fwd(x, x, x, 64, "full", 0.25)
        with pytest.raises(ValueError):
            attention_cuda.cross_attn_fwd(x, x, x, 2, 64, 0.25)
        c = torch.zeros(2, 9, 9)
        with pytest.raises(ValueError):
            sinkhorn_cuda.sinkhorn_scaling(c, c[:, :, 0], c[:, 0], 10, 0.0)
        with pytest.raises(ValueError):
            sinkhorn_cuda.sinkhorn_log(c, c[:, :, 0], c[:, 0], 10, 0.0)
        with pytest.raises(ValueError):
            sinkhorn_cuda.sinkhorn_log_stash(c, c[:, :, 0], c[:, 0], 10, 0.0)
        with pytest.raises(ValueError):
            sinkhorn_cuda.sinkhorn_bwd(c, c[:, None, :, 0], c[:, None, 0], c, c[:, :, 0],
                                       c[:, 0])


class TestSinkhorn:
    @pytest.mark.parametrize("iters", [10, 30, 100])
    def test_matches_jax(self, rng, iters):
        """Transport probabilities agree to 2e-4 (the JAX tests' bound between
        its Sinkhorn implementations) for the log domain (xla), the scaling
        domain (mxu) and the kernel's wrapper on a CPU tensor (its plain
        version) against JAX's Pallas scaling kernel in interpret mode."""
        scores = (rng.normal(size=(3, 33, 29)) * 4).astype(np.float32)
        s_t = t(scores)
        for impl in ("xla", "mxu"):
            z = tsink.log_optimal_transport(s_t, 1.0, iters, impl=impl).numpy()
            z_ref = np.asarray(jsink.log_optimal_transport(scores, 1.0, iters, impl=impl))
            np.testing.assert_allclose(np.exp(z), np.exp(z_ref), atol=2e-4)
        z = sinkhorn_cuda.log_optimal_transport_cuda(s_t, 1.0, iters).numpy()
        z_pal = np.asarray(log_optimal_transport_pallas(jnp.asarray(scores), 1.0, iters,
                                                        interpret=True))
        np.testing.assert_allclose(np.exp(z), np.exp(z_pal), atol=2e-4)

    def test_marginals(self, rng):
        scores = t((rng.normal(size=(2, 12, 10))).astype(np.float32))
        P = tsink.log_optimal_transport(scores, 1.0, 50).exp().numpy()
        np.testing.assert_allclose(P[:, :-1, :].sum(-1), 1.0, atol=1e-3)
        np.testing.assert_allclose(P[:, :, :-1].sum(-2), 1.0, atol=1e-3)
        np.testing.assert_allclose(P[:, -1, :].sum(-1), 10.0, atol=1e-2)
        np.testing.assert_allclose(P[:, :, -1].sum(-1), 12.0, atol=1e-2)

    @pytest.mark.parametrize("scale", [100.0, 400.0])
    def test_extreme_scores_stay_below_ceiling(self, rng, scale):
        """Scores of random-init magnitude: the scaling domain must rebuild K
        from the couplings at every absorption (a multiplicative carry lost
        whole rows of mass and pushed log_p to +hundreds). Max log_p stays
        below log(M+N)+1, nothing is NaN, and probabilities agree with JAX's
        log domain to 5e-4 (the JAX regression test's bound)."""
        scores = (rng.normal(size=(2, 200, 200)) * scale).astype(np.float32)
        z = sinkhorn_cuda.log_optimal_transport_cuda(t(scores), 1.0, 100).numpy()
        z_ref = np.asarray(jsink.log_optimal_transport(scores, 1.0, 100))
        assert np.all(np.isfinite(z))
        assert z.max() < np.log(400.0) + 1.0
        np.testing.assert_allclose(np.exp(z), np.exp(z_ref), atol=5e-4)

    def test_extract_matches_matches_jax(self, rng):
        scores = (rng.normal(size=(3, 20, 17)) * 4).astype(np.float32)
        z = np.asarray(jsink.log_optimal_transport(scores, 1.0, 20))
        for thr in (0.0, 0.2):
            out = tsink.extract_matches(t(z), thr)
            ref = jsink.extract_matches(jnp.asarray(z), thr)
            for a, b in zip(out, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _grad_case(rng, shape, mult):
    scores = (rng.normal(size=shape) * mult).astype(np.float32)
    w = rng.normal(size=(shape[0], shape[1] + 1, shape[2] + 1)).astype(np.float32)
    return scores, w


class TestSinkhornTraining:
    """The log-domain forward with its stash and the manual reverse sweep (the
    plain versions of the training kernels) against the JAX package."""

    @pytest.mark.parametrize("iters", [5, 15])
    def test_stash_forward_matches_jax(self, rng, iters):
        """Z against JAX's exact log-domain Pallas kernel in interpret mode and
        the XLA scan, U and V against the stash kernel in interpret mode:
        atol 1e-5, the JAX package's bound between its log-domain paths. The
        wrapper's `algorithm="log"` on a CPU tensor gives the same Z."""
        scores = (rng.normal(size=(2, 17, 23)) * 4).astype(np.float32)
        C, log_mu, log_nu, norm = tsink.augment_couplings(t(scores), 1.0)
        Z, U, V = tsink.log_sinkhorn_stash(C, log_mu, log_nu, iters)
        z_pal = np.asarray(log_optimal_transport_pallas(jnp.asarray(scores), 1.0, iters,
                                                        interpret=True, algorithm="log"))
        z_xla = np.asarray(jsink.log_optimal_transport(scores, 1.0, iters))
        np.testing.assert_allclose((Z - norm).numpy(), z_pal, atol=1e-5)
        np.testing.assert_allclose((Z - norm).numpy(), z_xla, atol=1e-5)
        _, U_ref, V_ref = _pallas_sinkhorn_stash(
            jnp.asarray(C.numpy()), jnp.asarray(log_mu.numpy()), jnp.asarray(log_nu.numpy()),
            iters, interpret=True)
        assert U.shape == (2, iters, 18) and V.shape == (2, iters, 24)
        np.testing.assert_allclose(U.numpy(), np.asarray(U_ref)[:, :iters, :18], atol=1e-5)
        np.testing.assert_allclose(V.numpy(), np.asarray(V_ref)[:, :iters, :24], atol=1e-5)
        z_wrap = sinkhorn_cuda.log_optimal_transport_cuda(t(scores), 1.0, iters,
                                                          algorithm="log")
        np.testing.assert_allclose(z_wrap.numpy(), z_xla, atol=1e-5)

    @pytest.mark.parametrize("shape,mult", [((3, 33, 29), 4), ((2, 127, 127), 4),
                                            ((2, 16, 16), 30)])
    def test_gradient_three_ways_matches_jax(self, rng, shape, mult):
        """d sum(Z * w) / d(scores, alpha) at 20 iterations, three ways in the
        port (autograd through the wrapper on a CPU tensor = through
        `log_sinkhorn`; the manual `log_sinkhorn_bwd` over the stash) against
        JAX's backward Pallas kernel in interpret mode, at the shapes of the
        JAX package's own test: scores 2e-4 of max(1, max|g|), alpha 2e-3
        (absolute and relative), its bounds."""
        scores, w = _grad_case(rng, shape, mult)
        gs_ref, ga_ref = jax.grad(
            lambda s, a: jnp.sum(log_optimal_transport_pallas(s, a, 20, True, "scaling",
                                                              "pallas") * w),
            argnums=(0, 1))(jnp.asarray(scores), 1.0)
        gs_ref, ga_ref = np.asarray(gs_ref), float(ga_ref)
        scale = max(float(np.abs(gs_ref).max()), 1.0)

        s_t = t(scores).requires_grad_()
        a_t = torch.ones((), requires_grad=True)
        z = sinkhorn_cuda.log_optimal_transport_cuda(s_t, a_t, 20)
        gs_auto, ga_auto = torch.autograd.grad((z * t(w)).sum(), (s_t, a_t))
        C, log_mu, log_nu, norm = tsink.augment_couplings(t(scores), 1.0)
        Z, U, V = tsink.log_sinkhorn_stash(C, log_mu, log_nu, 20)
        np.testing.assert_allclose((Z - norm).numpy(), z.detach().numpy(), atol=1e-5)
        gs_man, ga_man = sinkhorn_cuda.dustbin_grads(
            tsink.log_sinkhorn_bwd(C, U, V, t(w), log_mu, log_nu), shape[1], shape[2])
        for gs, ga in ((gs_auto, ga_auto), (gs_man, ga_man)):
            assert bool(torch.isfinite(gs).all())
            np.testing.assert_allclose(gs.numpy() / scale, gs_ref / scale, atol=2e-4)
            np.testing.assert_allclose(float(ga), ga_ref, rtol=2e-3, atol=2e-3)

    def test_gradient_differentiates_the_rounded_up_count(self, rng):
        """25 iterations of the scaling domain round up to 30: value and
        gradient under grad are those of 30 log-domain iterations (1e-5, the
        JAX test's bound), while `algorithm="log"` keeps the exact count."""
        scores = (rng.normal(size=(3, 33, 29)) * 4).astype(np.float32)

        def loss(z):
            return -z[0, :-1, :-1].diagonal().mean()

        g_ref = np.asarray(jax.grad(lambda s: -jnp.mean(jnp.diagonal(
            jsink.log_optimal_transport(s, 1.0, 30)[0, :-1, :-1])))(jnp.asarray(scores)))
        s_t = t(scores).requires_grad_()
        z = sinkhorn_cuda.log_optimal_transport_cuda(s_t, 1.0, 25)
        np.testing.assert_allclose(torch.autograd.grad(loss(z), s_t)[0].numpy(), g_ref,
                                   atol=1e-5)
        np.testing.assert_allclose(
            z.detach().numpy(), np.asarray(jsink.log_optimal_transport(scores, 1.0, 30)),
            atol=1e-5)
        z_log = sinkhorn_cuda.log_optimal_transport_cuda(s_t, 1.0, 25, algorithm="log")
        np.testing.assert_allclose(
            z_log.detach().numpy(), np.asarray(jsink.log_optimal_transport(scores, 1.0, 25)),
            atol=1e-5)
        assert sinkhorn_cuda._eff_iters(25) == 30 and sinkhorn_cuda._eff_iters(25, "log") == 25
        with pytest.raises(ValueError):
            sinkhorn_cuda.log_optimal_transport_cuda(s_t, 1.0, 25, algorithm="exact")

    def test_gradients_stay_finite_at_extreme_scores(self, rng):
        """Scores of random-init magnitude (scale 400): the exponents of the
        reverse sweep are grouped so that every rebuilt softmax entry is <= 1;
        nothing overflows, in autograd or in the manual sweep."""
        scores, w = _grad_case(rng, (2, 40, 40), 400)
        s_t = t(scores).requires_grad_()
        a_t = torch.ones((), requires_grad=True)
        z = sinkhorn_cuda.log_optimal_transport_cuda(s_t, a_t, 100)
        gs, ga = torch.autograd.grad((z * t(w)).sum(), (s_t, a_t))
        C, log_mu, log_nu, _ = tsink.augment_couplings(t(scores), 1.0)
        _, U, V = tsink.log_sinkhorn_stash(C, log_mu, log_nu, 100)
        G = tsink.log_sinkhorn_bwd(C, U, V, t(w), log_mu, log_nu)
        assert bool(torch.isfinite(z).all() and torch.isfinite(gs).all()
                    and torch.isfinite(ga) and torch.isfinite(G).all())
        assert float(z.detach().max()) < np.log(80.0) + 1.0


@pytest.mark.cuda
class TestKernels:
    """Each kernel against its plain version on the card (route: nvcc-built
    CUDA C++, sm_90a). Tolerances: attention 2e-3, the online-softmax drift
    bound of the JAX kernel; Sinkhorn probabilities 2e-4 (5e-4 at extreme
    scores), the JAX tests' bounds."""

    @pytest.mark.parametrize("mode,V,K,dh", [
        ("full", 1, 256, 64), ("full", 1, 333, 32), ("self", 3, 128, 16),
        ("cross", 3, 100, 64), ("cross", 5, 128, 64), ("cross", 2, 256, 16)])
    def test_attention_kernels(self, cuda, mode, V, K, dh):
        g = torch.Generator(device=cuda).manual_seed(0)
        h = 4
        q, k, v = (torch.randn(2, V * K, h * dh, generator=g, device=cuda)
                   for _ in range(3))
        before = dict(attention_cuda.launches)
        out = attention_cuda.fused_view_attention(q, k, v, h, V, K, mode)
        ref = attention_cuda.plain_view_attention(q, k, v, h, V, K, mode)
        assert float((out - ref).abs().max()) < 2e-3
        name = "cross_attn_fwd" if mode == "cross" and K % 64 == 0 else "attn_fwd"
        assert attention_cuda.launches[name] == before[name] + 1

    @pytest.mark.parametrize("shape,scale,tol", [
        ((3, 33, 29), 4.0, 2e-4), ((2, 200, 200), 400.0, 5e-4), ((4, 64, 64), 1.0, 2e-4)])
    def test_sinkhorn_kernel(self, cuda, shape, scale, tol):
        g = torch.Generator(device=cuda).manual_seed(0)
        scores = torch.randn(*shape, generator=g, device=cuda) * scale
        z = sinkhorn_cuda.log_optimal_transport_cuda(scores, 1.0, 100)
        z_ref = tsink.log_optimal_transport(scores, 1.0, 100, impl="mxu")
        assert bool(torch.isfinite(z).all())
        assert float(z.max()) < np.log(shape[1] + shape[2]) + 1.0
        p, p_ref = z.exp(), z_ref.exp()
        assert float(((p - p_ref).abs() / p_ref.clamp(min=1.0)).max()) < tol

    @pytest.mark.parametrize("shape,iters,scale", [
        ((3, 33, 29), 20, 4.0), ((2, 127, 127), 20, 4.0), ((4, 400, 400), 100, 4.0),
        ((2, 40, 40), 100, 400.0)])
    def test_sinkhorn_training_kernels(self, cuda, shape, iters, scale):
        """`sinkhorn_log`, `sinkhorn_log_stash` and `sinkhorn_bwd` against their
        plain versions and autograd: probabilities 2e-4, duals 1e-4, dscores
        2e-4 of max(1, max|g|), dalpha 2e-3; two sweeps give the same bits."""
        g = torch.Generator(device=cuda).manual_seed(0)
        scores = torch.randn(*shape, generator=g, device=cuda) * scale
        w = torch.randn(shape[0], shape[1] + 1, shape[2] + 1, generator=g, device=cuda)
        C, log_mu, log_nu, norm = tsink.augment_couplings(scores, 1.0)
        Z_ref, U_ref, V_ref = tsink.log_sinkhorn_stash(C, log_mu, log_nu, iters)
        before = dict(sinkhorn_cuda.launches)
        z = sinkhorn_cuda.sinkhorn_log(C, log_mu, log_nu, iters, norm)
        z_st, U, V = sinkhorn_cuda.sinkhorn_log_stash(C, log_mu, log_nu, iters, norm)
        assert torch.equal(z, z_st)
        p, p_ref = z.exp(), (Z_ref - norm).exp()
        assert float(((p - p_ref).abs() / p_ref.clamp(min=1.0)).max()) < 2e-4
        assert float((U - U_ref).abs().max()) < 1e-4 * max(1.0, scale / 4)
        assert float((V - V_ref).abs().max()) < 1e-4 * max(1.0, scale / 4)
        G = sinkhorn_cuda.sinkhorn_bwd(C, U, V, w, log_mu, log_nu)
        assert torch.equal(G, sinkhorn_cuda.sinkhorn_bwd(C, U, V, w, log_mu, log_nu))
        G_ref = tsink.log_sinkhorn_bwd(C, U_ref, V_ref, w, log_mu, log_nu)
        s_ag = scores.clone().requires_grad_()
        a_ag = torch.ones((), device=cuda, requires_grad=True)
        z_ag = tsink.log_optimal_transport(s_ag, a_ag, iters, impl="xla")
        refs = [sinkhorn_cuda.dustbin_grads(G_ref, shape[1], shape[2]),
                torch.autograd.grad((z_ag * w).sum(), (s_ag, a_ag))]
        s_k = scores.clone().requires_grad_()
        a_k = torch.ones((), device=cuda, requires_grad=True)
        z_k = sinkhorn_cuda.log_optimal_transport_cuda(s_k, a_k, iters, algorithm="log")
        outs = [sinkhorn_cuda.dustbin_grads(G, shape[1], shape[2]),
                torch.autograd.grad((z_k * w).sum(), (s_k, a_k))]
        for (gs, ga), (gs_ref, ga_ref) in zip(outs, refs):
            assert bool(torch.isfinite(gs).all())
            gscale = max(float(gs_ref.abs().max()), 1.0)
            assert float((gs - gs_ref).abs().max()) / gscale < 2e-4
            assert abs(float(ga) - float(ga_ref)) < 2e-3 * max(1.0, abs(float(ga_ref)))
        after = sinkhorn_cuda.launches
        assert after["sinkhorn_log"] == before["sinkhorn_log"] + 1
        assert after["sinkhorn_log_stash"] == before["sinkhorn_log_stash"] + 2
        assert after["sinkhorn_bwd"] == before["sinkhorn_bwd"] + 3
