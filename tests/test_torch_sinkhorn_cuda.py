"""The cluster kernels `sinkhorn_scaling`, `sinkhorn_log` (with and without
the stash) and `sinkhorn_bwd` on the card, and their launch plan on the CPU.

The `cuda`-marked tests hold the kernels against their plain versions
(`ops/sinkhorn.py::log_sinkhorn_mxu`, `log_sinkhorn_stash`,
`log_sinkhorn_bwd`) at ragged shapes on both sides of the residency threshold
(401 x 401 stays on chip, 1025 x 1025 streams from L2): probabilities 2e-4
(5e-4 at score scale 400), stashed duals 1e-4 (at score scale 400, 1e-4 of
max(1, max |dual|): the duals reach ~1e3 there, where one float32 ulp is
6e-5-1.2e-4), dscores 2e-4 of max(1, max |reference|), dalpha 2e-3; two runs
give the same bits, and so do the log kernel with and without the stash; one
launch-counter step per call. They skip without a GPU. The plan tests run
anywhere. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sinkhorn_cuda.py
"""

import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as ts  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc  # noqa: E402

SOURCE = Path(sc.__file__).resolve().parent / "csrc" / "sinkhorn_cuda.cu"
# score shapes (B, M, N) and scales; the couplings add the dustbin row and column
SHAPES = [((3, 33, 29), 4.0), ((2, 127, 127), 4.0), ((4, 401, 401), 4.0),
          ((2, 401, 333), 4.0), ((2, 1025, 1025), 4.0), ((2, 40, 40), 400.0)]
SINKHORN_DUAL_TOL = 1e-4  # stashed duals u_t, v_t (f32 reduction order over 100 iterations)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _prob_err(z, z_ref):
    p, p_ref = z.exp(), z_ref.exp()
    return float(((p - p_ref).abs() / p_ref.clamp(min=1.0)).max())


def _scores(cuda, shape, scale):
    g = torch.Generator(device=cuda).manual_seed(shape[1] * 1000 + shape[2])
    return torch.randn(*shape, generator=g, device=cuda) * scale, g


@pytest.mark.cuda
class TestClusterKernels:
    @pytest.mark.parametrize("shape,scale", SHAPES)
    def test_scaling_matches_plain(self, cuda, shape, scale):
        scores, _ = _scores(cuda, shape, scale)
        before = sc.launches["sinkhorn_scaling"]
        z = sc.log_optimal_transport_cuda(scores, 1.0, 100)
        z_ref = ts.log_optimal_transport(scores, 1.0, 100, impl="mxu")
        assert bool(torch.isfinite(z).all())
        assert float(z.max()) < math.log(shape[1] + shape[2]) + 1.0
        assert _prob_err(z, z_ref) < (5e-4 if scale > 100 else 2e-4)
        assert torch.equal(z, sc.log_optimal_transport_cuda(scores, 1.0, 100))
        assert sc.launches["sinkhorn_scaling"] == before + 2

    @pytest.mark.parametrize("shape,scale", SHAPES)
    def test_bwd_matches_plain(self, cuda, shape, scale):
        """The sweep from the plain forward's duals against the plain sweep,
        and autograd through the kernels against autograd of the plain log
        domain."""
        scores, g = _scores(cuda, shape, scale)
        B, M, N = shape
        w = torch.randn(B, M + 1, N + 1, generator=g, device=cuda)
        C, log_mu, log_nu, _ = ts.augment_couplings(scores, 1.0)
        _, U, V = ts.log_sinkhorn_stash(C, log_mu, log_nu, 100)
        before = sc.launches["sinkhorn_bwd"]
        G = sc.sinkhorn_bwd(C, U, V, w, log_mu, log_nu)
        assert torch.equal(G, sc.sinkhorn_bwd(C, U, V, w, log_mu, log_nu))
        assert sc.launches["sinkhorn_bwd"] == before + 2
        G_ref = ts.log_sinkhorn_bwd(C, U, V, w, log_mu, log_nu)
        s_k = scores.clone().requires_grad_()
        a_k = torch.ones((), device=cuda, requires_grad=True)
        z_k = sc.log_optimal_transport_cuda(s_k, a_k, 100)
        s_p = scores.clone().requires_grad_()
        a_p = torch.ones((), device=cuda, requires_grad=True)
        z_p = ts.log_optimal_transport(s_p, a_p, 100, impl="xla")
        pairs = [(sc.dustbin_grads(G, M, N), sc.dustbin_grads(G_ref, M, N)),
                 (torch.autograd.grad((z_k * w).sum(), (s_k, a_k)),
                  torch.autograd.grad((z_p * w).sum(), (s_p, a_p)))]
        assert sc.launches["sinkhorn_bwd"] == before + 3
        for (gs, ga), (gs_ref, ga_ref) in pairs:
            assert bool(torch.isfinite(gs).all() and torch.isfinite(ga))
            gscale = max(float(gs_ref.abs().max()), 1.0)
            assert float((gs - gs_ref).abs().max()) / gscale < 2e-4
            assert abs(float(ga) - float(ga_ref)) < 2e-3 * max(1.0, abs(float(ga_ref)))
        assert float(z_k.detach().max()) < math.log(M + N) + 1.0

    @pytest.mark.parametrize("shape,scale", SHAPES)
    def test_log_matches_plain(self, cuda, shape, scale):
        """`sinkhorn_log` and `sinkhorn_log_stash` against the plain stashed
        forward: the output, every stashed dual, and the last duals that the
        solve without the stash returns; the same bits with and without the
        stash and on two runs."""
        scores, _ = _scores(cuda, shape, scale)
        C, log_mu, log_nu, norm = ts.augment_couplings(scores, 1.0)
        z_ref, U_ref, V_ref = ts.log_sinkhorn_stash(C, log_mu, log_nu, 100)
        before = dict(sc.launches)
        z, U_last, V_last = sc._sinkhorn_log(C, log_mu, log_nu, 100, norm, False)
        z_st, U, V = sc.sinkhorn_log_stash(C, log_mu, log_nu, 100, norm)
        assert sc.launches["sinkhorn_log"] == before["sinkhorn_log"] + 1
        assert sc.launches["sinkhorn_log_stash"] == before["sinkhorn_log_stash"] + 1
        assert bool(torch.isfinite(z).all())
        assert _prob_err(z, z_ref - norm) < (5e-4 if scale > 100 else 2e-4)
        dual_tol = SINKHORN_DUAL_TOL * (max(1.0, float(U_ref.abs().max()),
                                            float(V_ref.abs().max())) if scale > 100 else 1.0)
        assert float((U - U_ref).abs().max()) < dual_tol
        assert float((V - V_ref).abs().max()) < dual_tol
        assert torch.equal(z, z_st)
        assert torch.equal(U_last, U[:, -1]) and torch.equal(V_last, V[:, -1])
        assert torch.equal(z, sc.sinkhorn_log(C, log_mu, log_nu, 100, norm))
        assert sc.launches["sinkhorn_log"] == before["sinkhorn_log"] + 2

    @pytest.mark.parametrize("kind", ["scaling", "bwd", "log"])
    def test_plans_schedule(self, cuda, kind):
        """At the paths' shapes the runtime fits the planned clusters; the
        resident kernels (the training and validation shape) keep every value
        in registers."""
        for K, resident in ((400, True), (1024, False)):
            plan = sc.kernel_plan(kind, 80, K + 1, K + 1)
            assert plan["resident"] is resident
            assert 1 <= plan["n_clusters"] <= plan["clusters_that_fit"]
            if resident:
                assert plan["local_bytes"] == 0


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


class TestPlan:
    """The plan is made in Python; these hold it to the source's layout and
    instantiations, and to the shapes of both paths."""

    @pytest.mark.parametrize("kind,cs,band,smem", [
        ("scaling", 4, 101, 216592), ("bwd", 8, 51, 214144), ("log", 4, 101, 230352)])
    def test_resident_at_401(self, kind, cs, band, smem):
        """The smallest cluster that holds the band on chip: K in 4 SMs' shared
        memory; C and G in 8 SMs' shared memory for the sweep; C, in rows of
        32 x 13 floats, in 4 SMs' for the log domain."""
        plan = sc.cluster_plan(kind, 80, 401, 401)
        assert (plan["cluster_size"], plan["band"], plan["resident"]) == (cs, band, True)
        assert plan["n_clusters"] == 80 and plan["workspace"] == {}
        assert plan["smem_bytes"] == smem

    @pytest.mark.parametrize("kind,n_clusters,workspace", [
        ("scaling", 9, {"K": (80, 1025, 1025)}), ("bwd", 4, {}), ("log", 9, {})])
    def test_streamed_at_1025(self, kind, n_clusters, workspace):
        """Persistent clusters of 8: K or C (4.2 MB a pair), or C and G, of the
        clusters stay inside the 40 MB L2 budget."""
        plan = sc.cluster_plan(kind, 80, 1025, 1025)
        assert (plan["cluster_size"], plan["band"], plan["resident"]) == (8, 129, False)
        assert plan["n_clusters"] == n_clusters and plan["workspace"] == workspace
        in_flight = (2 if kind == "bwd" else 1) * 4 * 1025 * 1025 * n_clusters
        assert in_flight <= sc.L2_BUDGET_BYTES

    def test_capacity_caps_the_clusters(self):
        assert sc.cluster_plan("scaling", 80, 401, 401, capacity=16)["n_clusters"] == 16
        assert sc.cluster_plan("bwd", 80, 1025, 1025, capacity=2)["n_clusters"] == 2
        assert sc.cluster_plan("bwd", 3, 34, 30, capacity=16)["n_clusters"] == 3
        assert sc.cluster_plan("log", 80, 401, 401, capacity=30)["n_clusters"] == 30

    def test_small_and_unknown(self):
        plan = sc.cluster_plan("scaling", 3, 34, 30)
        assert (plan["cluster_size"], plan["band"], plan["resident"]) == (1, 34, True)
        with pytest.raises(ValueError):
            sc.cluster_plan("sweep", 2, 40, 40)

    @pytest.mark.parametrize("kind", ["scaling", "bwd", "log"])
    def test_every_plan_fits_the_source(self, kind):
        """Over ragged shapes: the source's constants, a band per block that
        covers the rows and leaves none empty, shared bytes within a block's
        limit, and a row within the lanes' registers."""
        assert _source_constant("CT") == sc.CLUSTER_THREADS
        assert _source_constant("CS_MAX") == sc.CLUSTER_SIZES[-1]
        assert _source_constant("KC_STREAMED") == sc.COLUMN_SLOTS[-1]
        for name in ("scaling_cluster_kernel", "bwd_cluster_kernel", "log_cluster_kernel"):
            cases = re.findall(rf"case (\w+): return {name}<true", SOURCE.read_text())
            assert {sc.COLUMN_SLOTS[-1] if k == "KC_STREAMED" else int(k) for k in cases} \
                == set(sc.COLUMN_SLOTS)
        for M in (2, 17, 34, 128, 129, 257, 401, 402, 513, 700, 1025, 1100):
            for N in (2, 30, 129, 334, 402, 513, 800, 1025, 1056):
                plan = sc.cluster_plan(kind, 5, M, N)
                assert plan["band"] * plan["cluster_size"] >= M
                assert plan["band"] * (plan["cluster_size"] - 1) < M
                assert plan["smem_bytes"] <= sc.SMEM_BYTES
                assert 32 * plan["column_slots"] >= N

    def test_cpu_tensors_are_refused(self):
        c = torch.zeros(2, 9, 9)
        mu = torch.zeros(2, 9)
        with pytest.raises(ValueError):
            sc.sinkhorn_scaling(c, mu, mu, 10, 0.0)
        with pytest.raises(ValueError):
            sc.sinkhorn_bwd(c, mu[:, None], mu[:, None], c, mu, mu)
        with pytest.raises(ValueError):
            sc.sinkhorn_log(c, mu, mu, 10, 0.0)
        with pytest.raises(ValueError):
            sc.sinkhorn_log_stash(c, mu, mu, 10, 0.0)

    @pytest.mark.parametrize("kind", ["scaling", "bwd", "log"])
    def test_wider_than_the_lanes_is_refused(self, kind):
        """N <= 32 x 33 = 1056: a wider pair matrix raises before any launch."""
        assert sc.cluster_plan(kind, 2, 40, 1056)["column_slots"] == 33
        with pytest.raises(ValueError, match="N <= 1056"):
            sc.cluster_plan(kind, 2, 40, 1057)
