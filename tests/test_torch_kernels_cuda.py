"""The hand-written cross-attention kernels of the training path on the card:
the repaired cross forward (any n_kpts, ragged per-view tiles), the forward
with the LSE stash, dq and dk/dv against their plain PyTorch versions, and
the autograd function that joins them.

Every test is marked `cuda` and skips without a GPU. The file imports neither
JAX nor the JAX package, so it also runs on a machine that has only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCrossKernels:
    """The three training kernels and the repaired forward against their plain
    versions on the card (route: nvcc-built CUDA C++, sm_90a). Tolerances:
    outputs and gradients 2e-4 of max |reference| (f32 reduction order over
    up to 1600 keys), LSE 1e-5 absolute; two runs give the same bits."""

    @pytest.mark.parametrize("V,K,dh,BH", [
        (5, 400, 64, 4), (3, 100, 64, 2), (5, 40, 16, 3), (2, 64, 32, 2), (3, 1, 32, 1)])
    def test_kernels_match_plain(self, cuda, V, K, dh, BH):
        g = torch.Generator(device=cuda).manual_seed(0)
        S = V * K
        q, k, v, do = (torch.randn(BH, S, dh, generator=g, device=cuda) for _ in range(4))
        scale = 1.0 / dh ** 0.5
        before = dict(ac.launches)
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        o_ref, lse_ref = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        o_eval = ac.cross_attn_fwd(q, k, v, V, K, scale)
        assert torch.equal(o, o_eval)
        assert float((o - o_ref).abs().max()) <= 2e-4 * float(o_ref.abs().max())
        assert float((lse - lse_ref).abs().max()) <= 1e-5 * max(1.0, float(lse_ref.abs().max()))
        dvec = (do * o).sum(-1)
        dq = ac.cross_attn_bwd_dq(q, k, v, do, lse, dvec, V, K, scale)
        dk, dv = ac.cross_attn_bwd_dkv(q, k, v, do, lse, dvec, V, K, scale)
        refs = ac.cross_attn_bwd_plain(q, k, v, do, lse, dvec, V, K, scale)
        for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            assert float((a - r).abs().max()) <= 2e-4 * float(r.abs().max()), name
        assert torch.equal(dq, ac.cross_attn_bwd_dq(q, k, v, do, lse, dvec, V, K, scale))
        dk2, dv2 = ac.cross_attn_bwd_dkv(q, k, v, do, lse, dvec, V, K, scale)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        for name, n in (("cross_attn_fwd_lse", 1), ("cross_attn_fwd", 1),
                        ("cross_attn_bwd_dq", 2), ("cross_attn_bwd_dkv", 2)):
            assert ac.launches[name] == before[name] + n, name

    def test_autograd_on_the_kernels_matches_plain_autograd(self, cuda):
        """`fused_view_attention` under grad on CUDA tensors (the kernels)
        against autograd through the plain masked attention: 2e-4 of max|g|."""
        g = torch.Generator(device=cuda).manual_seed(1)
        V, K, h, dh = 5, 72, 4, 32
        q, k, v, w = (torch.randn(2, V * K, h * dh, generator=g, device=cuda)
                      for _ in range(4))
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        ys = [x.clone().requires_grad_() for x in (q, k, v)]
        before = dict(ac.launches)
        out = ac.fused_view_attention(*xs, h, V, K, "cross")
        grads = torch.autograd.grad((out * w).sum(), xs)
        ref = ac.plain_view_attention(*ys, h, V, K, "cross")
        refs = torch.autograd.grad((ref * w).sum(), ys)
        assert float((out - ref).detach().abs().max()) <= 2e-4 * float(ref.detach().abs().max())
        for a, r in zip(grads, refs):
            assert float((a - r).abs().max()) <= 2e-4 * float(r.abs().max())
        for name in ("cross_attn_fwd_lse", "cross_attn_bwd_dq", "cross_attn_bwd_dkv"):
            assert ac.launches[name] == before[name] + 1, name

    def test_wrappers_raise_instead_of_falling_back(self, cuda):
        """bf16 and an unsupported head width raise on CUDA tensors."""
        x = torch.zeros(2, 48, 16, device=cuda)
        r = torch.zeros(2, 48, device=cuda)
        with pytest.raises(ValueError):
            ac.cross_attn_fwd_lse(x.bfloat16(), x.bfloat16(), x.bfloat16(), 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dq(x, x, x, x.bfloat16(), r, r, 3, 16, 0.25)
        y = torch.zeros(2, 48, 8, device=cuda)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dkv(y, y, y, y, r, r, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.fused_view_attention(torch.zeros(1, 48, 32, device=cuda, dtype=torch.bfloat16),
                                    *(torch.zeros(1, 48, 32, device=cuda,
                                                  dtype=torch.bfloat16),) * 2,
                                    2, 3, 16, "cross")
