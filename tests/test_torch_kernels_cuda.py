"""The hand-written attention kernels on the card: the register-tiled forward
kernels (`attn_fwd` in its three modes, `cross_attn_fwd`, `cross_attn_fwd_lse`),
their bfloat16 tensor-core counterparts (`attn_fwd` and `cross_attn_fwd` on
bfloat16 tensors), the backward kernels (`cross_attn_bwd_dq`, `cross_attn_bwd_dkv`) at ragged and
tiny shapes, the bfloat16 tensor-core kernels of the training path
(`cross_attn_fwd_lse`, `cross_attn_bwd_dq` and `cross_attn_bwd_dkv` on bfloat16
tensors) at the same shapes, the cross-attention kernels of the training path
(the forward with the LSE stash, dq and dk/dv) against their plain PyTorch
versions, and the autograd function that joins them, in float32 and bfloat16.

Every test is marked `cuda` and skips without a GPU, except `TestHopperPlan`,
`TestHopperDkvPlan` and `TestHopperDqPlan`, which hold the launch plans and the
walks of the Hopper kernels (`attn_fwd_bf16`, `cross_attn_fwd_bf16`,
`cross_attn_fwd_lse_bf16`; `cross_attn_bwd_dkv_bf16`; `cross_attn_bwd_dq_bf16`)
on the CPU. The file imports neither
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


# n_kpts around the forward's 80-row query tiles, 64-key tiles and 8-key
# lanes; S = V * n_kpts below one tile takes BH = 1
FWD_SHAPES = [(V, K, dh) for K in (1, 15, 16, 17, 63, 65, 200, 400)
              for V in (2, 5) for dh in (16, 32, 64)]
# the Hopper forward kernels' edges: 64-key tiles, 128-row work items
HOPPER_EDGE_SHAPES = [(V, K, dh) for K in (127, 128, 129, 255, 1024)
                      for V in (2, 5) for dh in (16, 32, 64)]
# the Hopper training kernels' edges (the LSE forward, dq, dk/dv): 64-row tiles
# of the streamed rows and of a consumer warpgroup's owned rows, 128-row work
# items, the ranges before and after the own view (V = 3: both ranges non-empty)
TRAIN_EDGE_SHAPES = [(V, K, dh) for K in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 400)
                     for V in (2, 3, 5) for dh in (16, 32, 64)]


def _fwd_inputs(cuda, V, K, dh):
    g = torch.Generator(device=cuda).manual_seed(1000 * K + 10 * V + dh)
    BH = 1 if V * K < 80 else 3
    return tuple(2 * torch.randn(BH, V * K, dh, generator=g, device=cuda) for _ in range(3))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
class TestForwardKernels:
    """The register-tiled forward kernels against their plain versions
    (route: nvcc-built CUDA C++, sm_90a): outputs 2e-4 of max |reference|
    (f32 reduction order over up to 2000 keys), LSE 1e-5 absolute; two runs
    give the same bits."""

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_attn_fwd_modes_match_plain(self, cuda, V, K, dh):
        q, k, v = _fwd_inputs(cuda, V, K, dh)
        before = ac.launches["attn_fwd"]
        for mode in ("full", "self", "cross"):
            o = ac.attn_fwd(q, k, v, K, mode, 1.0 / dh ** 0.5)
            ref = ac.plain_view_attention(q, k, v, 1, V, K, mode)
            assert _rel(o, ref) <= 2e-4, mode
            assert torch.equal(o, ac.attn_fwd(q, k, v, K, mode, 1.0 / dh ** 0.5)), mode
        assert ac.launches["attn_fwd"] == before + 6

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_cross_fwd_matches_plain(self, cuda, V, K, dh):
        q, k, v = _fwd_inputs(cuda, V, K, dh)
        scale = 1.0 / dh ** 0.5
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        o_ref, lse_ref = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        assert _rel(o, o_ref) <= 2e-4
        assert float((lse - lse_ref).abs().max()) <= 1e-5 * max(1.0, float(lse_ref.abs().max()))
        assert _rel(o, ac.plain_view_attention(q, k, v, 1, V, K, "cross")) <= 2e-4
        o2, lse2 = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(o, ac.cross_attn_fwd(q, k, v, V, K, scale))

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_forward_kernels_do_not_spill(self, cuda, dh):
        """Local memory 0 (no spills) and at least 2 blocks per SM, from the
        CUDA runtime's view of each forward kernel."""
        for name, mode in (("attn_fwd", "full"), ("attn_fwd", "self"), ("attn_fwd", "cross"),
                           ("cross_attn_fwd", "cross"), ("cross_attn_fwd_lse", "cross")):
            info = ac.kernel_info(name, dh, mode)
            assert info["local_bytes"] == 0, (name, mode, info)
            assert info["blocks_per_sm"] >= 2, (name, mode, info)


@pytest.mark.cuda
class TestBf16ForwardKernels:
    """The bfloat16 tensor-core forward kernels (`attn_fwd` in its three modes,
    `cross_attn_fwd`; route: nvcc-built CUDA C++, sm_90a, TMA and wgmma) against
    their plain version, `plain_view_attention` on the same bfloat16 tensors
    (float32 arithmetic on the upcast inputs, the output rounded once): every
    element within one bfloat16 ulp of the reference + 1e-6 + 2^-18 of its
    absolute scale sum p |v| / l (`bf16_ulp_error` <= 1; the kernels sum in
    another order, so a rounding may land on the neighbouring bfloat16 value,
    and the tensor cores truncate in their float32 sums, which shows on the
    outputs that cancel to near 0); two runs give the same bits; only the
    bfloat16 counters move."""

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_attn_fwd_bf16_modes_match_plain(self, cuda, V, K, dh):
        q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
        before = dict(ac.launches)
        for mode in ("full", "self", "cross"):
            o = ac.attn_fwd(q, k, v, K, mode, 1.0 / dh ** 0.5)
            assert o.dtype == torch.bfloat16
            ref = ac.plain_view_attention(q, k, v, 1, V, K, mode)
            scale = ac.plain_view_attention(q.float(), k.float(), v.float().abs(), 1, V, K,
                                            mode)
            assert ac.bf16_ulp_error(o, ref, scale) <= 1.0, mode
            assert torch.equal(o, ac.attn_fwd(q, k, v, K, mode, 1.0 / dh ** 0.5)), mode
        assert ac.launches["attn_fwd_bf16"] == before["attn_fwd_bf16"] + 6
        assert ac.launches["attn_fwd"] == before["attn_fwd"]

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_cross_fwd_bf16_matches_plain(self, cuda, V, K, dh):
        q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
        before = dict(ac.launches)
        o = ac.cross_attn_fwd(q, k, v, V, K, 1.0 / dh ** 0.5)
        assert o.dtype == torch.bfloat16
        scale = ac.plain_view_attention(q.float(), k.float(), v.float().abs(), 1, V, K, "cross")
        ref = ac.plain_view_attention(q, k, v, 1, V, K, "cross")
        assert ac.bf16_ulp_error(o, ref, scale) <= 1.0
        assert torch.equal(o, ac.cross_attn_fwd(q, k, v, V, K, 1.0 / dh ** 0.5))
        assert ac.launches["cross_attn_fwd_bf16"] == before["cross_attn_fwd_bf16"] + 2
        assert ac.launches["cross_attn_fwd"] == before["cross_attn_fwd"]

    @pytest.mark.parametrize("V,K,dh", HOPPER_EDGE_SHAPES)
    def test_hopper_fwd_kernels_at_tile_edges(self, cuda, V, K, dh):
        """Both Hopper kernels where their tiles end: K around the 64-key tiles
        and the 128-row work items, in all three masks of `attn_fwd` and in the
        cross kernel; the one-ulp gate and the same bits on two runs."""
        q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
        s = 1.0 / dh ** 0.5
        refs = {mode: (ac.plain_view_attention(q, k, v, 1, V, K, mode),
                       ac.plain_view_attention(q.float(), k.float(), v.float().abs(), 1, V,
                                               K, mode))
                for mode in ("full", "self", "cross")}
        for mode, (ref, scale) in refs.items():
            o = ac.attn_fwd(q, k, v, K, mode, s)
            assert ac.bf16_ulp_error(o, ref, scale) <= 1.0, mode
            assert torch.equal(o, ac.attn_fwd(q, k, v, K, mode, s)), mode
        o = ac.cross_attn_fwd(q, k, v, V, K, s)
        assert ac.bf16_ulp_error(o, *refs["cross"]) <= 1.0
        assert torch.equal(o, ac.cross_attn_fwd(q, k, v, V, K, s))

    def test_hopper_fwd_same_bits_at_the_eval_shapes(self, cuda):
        """Two runs of each Hopper kernel at the eval shapes (160 x 1024 x 64
        self, 32 x 5120 x 64 cross) give the same bits: a persistent block
        walks its work items in a fixed order, no atomics."""
        g = torch.Generator(device=cuda).manual_seed(5)
        for BH, V, K in ((160, 1, 1024), (32, 5, 1024)):
            q, k, v = (torch.randn(BH, V * K, 64, generator=g, device=cuda).bfloat16()
                       for _ in range(3))
            if V == 1:
                runs = [ac.attn_fwd(q, k, v, K, "full", 0.125) for _ in range(2)]
            else:
                runs = [ac.cross_attn_fwd(q, k, v, V, K, 0.125) for _ in range(2)]
            assert torch.equal(*runs), (BH, V, K)

    def test_misaligned_operand_raises(self, cuda):
        """A TMA map takes only a 16-byte aligned base: an operand at an offset
        of 2 bytes raises before any launch, and nothing runs in its place."""
        x = torch.zeros(2 * 48 * 16 + 1, device=cuda, dtype=torch.bfloat16)
        odd = x[1:].view(2, 48, 16)
        ok = torch.zeros(2, 48, 16, device=cuda, dtype=torch.bfloat16)
        before = dict(ac.launches)
        for qkv in ((odd, ok, ok), (ok, odd, ok), (ok, ok, odd)):
            with pytest.raises(ValueError):
                ac.attn_fwd(*qkv, 16, "full", 0.25)
            with pytest.raises(ValueError):
                ac.cross_attn_fwd(*qkv, 3, 16, 0.25)
        assert ac.launches == before

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_bf16_forward_kernels_do_not_spill(self, cuda, dh):
        """Local memory 0 (no spills), from the CUDA runtime's view of each
        bfloat16 forward kernel, asked at the kernel's own block size: the
        Hopper kernels one persistent block of 384 threads (12 warps) an SM,
        with the shared bytes and rows of `hopper_fwd_plan`."""
        for name, mode in (("attn_fwd_bf16", "full"), ("attn_fwd_bf16", "self"),
                           ("attn_fwd_bf16", "cross"), ("cross_attn_fwd_bf16", "cross")):
            info = ac.kernel_info(name, dh, mode)
            plan = ac.hopper_fwd_plan(name, 1, 2 * 64, dh, 2, 64)
            assert info["local_bytes"] == 0, (name, mode, info)
            assert info["persistent"] and info["blocks_per_sm"] >= 1, (name, mode, info)
            assert info["blocks_per_sm"] * info["threads"] >= 384, (name, mode, info)
            for key in ("threads", "tile_rows", "shared_bytes"):
                assert info[key] == plan[key], (name, mode, key, info, plan)

    def test_bf16_forward_launches(self, cuda):
        """`fused_view_attention` on bfloat16 CUDA tensors without grad launches
        the bfloat16 kernels (self layers: `attn_fwd` in mode full on per-view
        tokens; cross layers: `cross_attn_fwd`), none of the float32 ones, and
        agrees with the plain version within one bfloat16 ulp."""
        g = torch.Generator(device=cuda).manual_seed(2)
        V, K, h, dh = 3, 72, 4, 32
        q, k, v = (torch.randn(2, V * K, h * dh, generator=g, device=cuda).bfloat16()
                   for _ in range(3))
        before = dict(ac.launches)
        out = ac.fused_view_attention(q, k, v, h, V, K, "cross")
        scale = ac.plain_view_attention(q.float(), k.float(), v.float().abs(), h, V, K, "cross")
        ref = ac.plain_view_attention(q, k, v, h, V, K, "cross")
        assert ac.bf16_ulp_error(out, ref, scale) <= 1
        t = q.reshape(2 * V, K, h * dh)
        out = ac.fused_view_attention(t, t, t, h, 1, K, "full")
        scale = ac.plain_view_attention(t.float(), t.float(), t.float().abs(), h, 1, K, "full")
        assert ac.bf16_ulp_error(out, ac.plain_view_attention(t, t, t, h, 1, K, "full"),
                                 scale) <= 1
        moved = {n: ac.launches[n] - before[n] for n in before}
        assert moved == {**{n: 0 for n in before}, "attn_fwd_bf16": 1,
                         "cross_attn_fwd_bf16": 1}


def _bf16_bwd_inputs(cuda, V, K, dh):
    """bfloat16 q, k, v, dO, the plain forward's float32 LSE and dvec = rowsum(dO
    O) in float32 plus a unit normal (as `TestBackwardKernels` takes it)."""
    q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
    g = torch.Generator(device=cuda).manual_seed(7 + 1000 * K + 10 * V + dh)
    do = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
    scale = 1.0 / dh ** 0.5
    o, lse = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
    dvec = (do.float() * o.float()).sum(-1) + torch.randn(lse.shape, generator=g, device=cuda)
    return q, k, v, do, lse, dvec, V, K, scale


@pytest.mark.cuda
class TestBf16TrainingKernels:
    """The bfloat16 tensor-core kernels of the training path (route: nvcc-built
    CUDA C++, sm_90a; all three TMA and wgmma, warp-specialised, persistent):
    `cross_attn_fwd_lse` on bfloat16 q, k, v
    against `cross_attn_fwd_lse_plain` (the output within the forward's
    one-ulp gate, as the eval kernel's, which has another body; the float32
    LSE within 1e-5 absolute, relative above 1), `cross_attn_bwd_dq` and `cross_attn_bwd_dkv` on
    bfloat16 q, k, v, dO against `cross_attn_bwd_plain` (the Pallas bodies'
    roundings): every element within one bfloat16 ulp of the plain version +
    1e-6 + 2^-18 of its absolute scale + one bfloat16 ulp of every rounded p
    or ds times its partner (`cross_attn_bwd_bf16_slack`: the kernels form p
    and ds in another order, so a rounding may land on the neighbour); two
    runs give the same bits; only the bfloat16 counters move."""

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_cross_fwd_lse_bf16_matches_plain(self, cuda, V, K, dh):
        q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
        scale = 1.0 / dh ** 0.5
        before = dict(ac.launches)
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        o_ref, lse_ref = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        abs_scale = ac.plain_view_attention(q.float(), k.float(), v.float().abs(), 1, V, K,
                                            "cross")
        assert ac.bf16_ulp_error(o, o_ref, abs_scale) <= 1.0
        assert float((lse - lse_ref).abs().max()) <= 1e-5 * max(1.0, float(lse_ref.abs().max()))
        o2, lse2 = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert ac.bf16_ulp_error(ac.cross_attn_fwd(q, k, v, V, K, scale), o_ref,
                                 abs_scale) <= 1.0
        moved = {n: ac.launches[n] - before[n] for n in before}
        assert moved == {**{n: 0 for n in before}, "cross_attn_fwd_lse_bf16": 2,
                         "cross_attn_fwd_bf16": 1}

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_bwd_bf16_kernels_match_plain(self, cuda, V, K, dh):
        args = _bf16_bwd_inputs(cuda, V, K, dh)
        before = dict(ac.launches)
        dq = ac.cross_attn_bwd_dq(*args)
        dk, dv = ac.cross_attn_bwd_dkv(*args)
        refs = ac.cross_attn_bwd_plain(*args)
        slack = ac.cross_attn_bwd_bf16_slack(*args)
        for name, a, r, (abs_scale, flips) in zip(("dq", "dk", "dv"), (dq, dk, dv), refs,
                                                  slack):
            assert a.dtype == r.dtype == torch.bfloat16, name
            assert ac.bf16_ulp_error(a, r, abs_scale, flips) <= 1.0, name
        assert torch.equal(dq, ac.cross_attn_bwd_dq(*args))
        dk2, dv2 = ac.cross_attn_bwd_dkv(*args)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        moved = {n: ac.launches[n] - before[n] for n in before}
        assert moved == {**{n: 0 for n in before}, "cross_attn_bwd_dq_bf16": 2,
                         "cross_attn_bwd_dkv_bf16": 2}

    @pytest.mark.parametrize("V,K,dh", TRAIN_EDGE_SHAPES)
    def test_hopper_training_kernels_at_tile_edges(self, cuda, V, K, dh):
        """The LSE forward, dq and dk/dv where their tiles and items end: the
        output within the one-ulp gate, the LSE within 1e-5, dq, dk and dv
        within the backward's gate, the same bits on two runs."""
        q, k, v = (x.bfloat16() for x in _fwd_inputs(cuda, V, K, dh))
        scale = 1.0 / dh ** 0.5
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        o_ref, lse_ref = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        abs_scale = ac.plain_view_attention(q.float(), k.float(), v.float().abs(), 1, V, K,
                                            "cross")
        assert ac.bf16_ulp_error(o, o_ref, abs_scale) <= 1.0
        assert float((lse - lse_ref).abs().max()) <= 1e-5 * max(1.0, float(lse_ref.abs().max()))
        o2, lse2 = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        args = _bf16_bwd_inputs(cuda, V, K, dh)
        dq = ac.cross_attn_bwd_dq(*args)
        dk, dv = ac.cross_attn_bwd_dkv(*args)
        rq, rk, rv = ac.cross_attn_bwd_plain(*args)
        sq, sk, sv = ac.cross_attn_bwd_bf16_slack(*args)
        assert ac.bf16_ulp_error(dq, rq, *sq) <= 1.0
        assert ac.bf16_ulp_error(dk, rk, *sk) <= 1.0
        assert ac.bf16_ulp_error(dv, rv, *sv) <= 1.0
        assert torch.equal(dq, ac.cross_attn_bwd_dq(*args))
        dk2, dv2 = ac.cross_attn_bwd_dkv(*args)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)

    def test_hopper_training_kernels_same_bits_at_the_training_shape(self, cuda):
        """Two runs of the LSE forward, of dq and of dk/dv at 32 x 2000 x 64 (V =
        5, K = 400) give the same bits: a persistent block walks its work items
        in a fixed order, no atomics."""
        args = _bf16_bwd_inputs(cuda, 5, 400, 64)
        q, k, v = args[:3]
        runs = [ac.cross_attn_fwd_lse(q, k, v, 5, 400, 0.125) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        assert torch.equal(ac.cross_attn_bwd_dq(*args), ac.cross_attn_bwd_dq(*args))
        a, b = (ac.cross_attn_bwd_dkv(*args) for _ in range(2))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_misaligned_operand_raises(self, cuda):
        """A TMA map takes only a 16-byte aligned base: a q, k, v (or dO) at an
        offset of 2 bytes raises before any launch of the LSE forward, dq or
        dk/dv, and nothing runs in its place."""
        x = torch.zeros(2 * 48 * 16 + 1, device=cuda, dtype=torch.bfloat16)
        odd = x[1:].view(2, 48, 16)
        ok = torch.zeros(2, 48, 16, device=cuda, dtype=torch.bfloat16)
        r = torch.zeros(2, 48, device=cuda)
        before = dict(ac.launches)
        for qkv in ((odd, ok, ok), (ok, odd, ok), (ok, ok, odd)):
            with pytest.raises(ValueError):
                ac.cross_attn_fwd_lse(*qkv, 3, 16, 0.25)
        for qkvd in ((odd, ok, ok, ok), (ok, odd, ok, ok), (ok, ok, odd, ok), (ok, ok, ok, odd)):
            with pytest.raises(ValueError):
                ac.cross_attn_bwd_dq(*qkvd, r, r, 3, 16, 0.25)
            with pytest.raises(ValueError):
                ac.cross_attn_bwd_dkv(*qkvd, r, r, 3, 16, 0.25)
        assert ac.launches == before

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_bf16_training_kernels_do_not_spill(self, cuda, dh):
        """Local memory 0 (no spills), from the CUDA runtime's view of each
        bfloat16 training kernel at its own block size: each one persistent
        block of 384 threads an SM, with the shared bytes and rows of
        `hopper_fwd_plan` / `hopper_dq_plan` / `hopper_dkv_plan`."""
        plans = {"cross_attn_fwd_lse_bf16": ac.hopper_fwd_plan(
                     "cross_attn_fwd_lse_bf16", 1, 128, dh, 2, 64),
                 "cross_attn_bwd_dq_bf16": ac.hopper_dq_plan(1, 128, dh, 2, 64),
                 "cross_attn_bwd_dkv_bf16": ac.hopper_dkv_plan(1, 128, dh, 2, 64)}
        for name, plan in plans.items():
            info = ac.kernel_info(name, dh)
            assert info["local_bytes"] == 0, (name, info)
            assert info["persistent"] and info["blocks_per_sm"] >= 1, (name, info)
            assert info["blocks_per_sm"] * info["threads"] >= 384, (name, info)
            for key in ("threads", "tile_rows", "shared_bytes"):
                assert info[key] == plan[key], (name, key, info, plan)

    def test_bf16_autograd_launches_the_bf16_kernels(self, cuda):
        """`fused_view_attention` under grad on bfloat16 CUDA tensors: a cross
        layer launches the bfloat16 LSE forward, dq and dk/dv kernels once each
        and its gradients meet the gate against the plain version from the
        same LSE; a full layer launches `attn_fwd_bf16` and takes the VJP of
        bfloat16 `multi_head_attention` (the same bits as autograd through
        it); no float32 kernel runs."""
        g = torch.Generator(device=cuda).manual_seed(1)
        V, K, h, dh = 5, 72, 4, 32
        q, k, v, w = (torch.randn(2, V * K, h * dh, generator=g, device=cuda).bfloat16()
                      for _ in range(4))
        before = dict(ac.launches)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ac.fused_view_attention(*xs, h, V, K, "cross")
        grads = torch.autograd.grad(out, xs, w)

        def split(x):
            return x.reshape(2, V * K, h, dh).transpose(1, 2).reshape(2 * h, V * K, dh)

        qs, ks, vs, ws = (split(x).contiguous() for x in (q, k, v, w))
        o, lse = ac.cross_attn_fwd_lse_plain(qs, ks, vs, V, K, dh ** -0.5)
        dvec = (ws.float() * o.float()).sum(-1)
        args = (qs, ks, vs, ws, lse, dvec, V, K, dh ** -0.5)
        for a, r, (abs_scale, flips) in zip(grads, ac.cross_attn_bwd_plain(*args),
                                            ac.cross_attn_bwd_bf16_slack(*args)):
            assert a.dtype == torch.bfloat16
            assert ac.bf16_ulp_error(split(a), r, abs_scale, flips) <= 1.0
        t = [x.reshape(2 * V, K, h * dh).clone().requires_grad_() for x in (q, k, v)]
        out = ac.fused_view_attention(*t, h, 1, K, "full")
        grads = torch.autograd.grad(out, t, w.reshape(2 * V, K, h * dh))
        t2 = [x.detach().clone().requires_grad_() for x in t]
        ref = ac.multi_head_attention(*t2, h)
        for a, r in zip(grads, torch.autograd.grad(ref, t2, w.reshape(2 * V, K, h * dh))):
            assert torch.equal(a, r)
        moved = {n: ac.launches[n] - before[n] for n in before}
        assert moved == {**{n: 0 for n in before}, "attn_fwd_bf16": 1,
                         "cross_attn_fwd_lse_bf16": 1, "cross_attn_bwd_dq_bf16": 1,
                         "cross_attn_bwd_dkv_bf16": 1}


@pytest.mark.cuda
class TestBackwardKernels:
    """The register-tiled backward kernels against their plain version
    `cross_attn_bwd_plain` (route: nvcc-built CUDA C++, sm_90a): dq, dk and dv
    within 2e-4 of max |reference| (f32 reduction order over up to 1600 rows),
    and two runs give the same bits. The LSE is the forward's; dvec is
    rowsum(dO * O) plus a unit normal, so that dS = P (dP - dvec) stays away
    from 0 at every shape (at V = 2, K = 1 a query sees one key, p = 1, and
    the true dS is 0: dq and dk would be rounding noise in both versions)."""

    @pytest.mark.parametrize("V,K,dh", FWD_SHAPES)
    def test_bwd_kernels_match_plain(self, cuda, V, K, dh):
        q, k, v = _fwd_inputs(cuda, V, K, dh)
        g = torch.Generator(device=cuda).manual_seed(7 + 1000 * K + 10 * V + dh)
        do = torch.randn(q.shape, generator=g, device=cuda)
        scale = 1.0 / dh ** 0.5
        o, lse = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        dvec = (do * o).sum(-1) + torch.randn(lse.shape, generator=g, device=cuda)
        args = (q, k, v, do, lse, dvec, V, K, scale)
        before = dict(ac.launches)
        dq = ac.cross_attn_bwd_dq(*args)
        dk, dv = ac.cross_attn_bwd_dkv(*args)
        for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ac.cross_attn_bwd_plain(*args)):
            assert _rel(a, r) <= 2e-4, name
        assert torch.equal(dq, ac.cross_attn_bwd_dq(*args))
        dk2, dv2 = ac.cross_attn_bwd_dkv(*args)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        for name in ("cross_attn_bwd_dq", "cross_attn_bwd_dkv"):
            assert ac.launches[name] == before[name] + 2, name

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_backward_kernels_do_not_spill(self, cuda, dh):
        """Local memory 0 (no spills) and at least 2 blocks per SM, from the
        CUDA runtime's view of each backward kernel."""
        for name in ("cross_attn_bwd_dq", "cross_attn_bwd_dkv"):
            info = ac.kernel_info(name, dh)
            assert info["local_bytes"] == 0, (name, info)
            assert info["blocks_per_sm"] >= 2, (name, info)


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
        """Mixed dtypes, a bfloat16 LSE or dvec, an unsupported head width and
        a CPU operand raise on the card instead of falling back; bfloat16 under
        grad launches the bfloat16 kernels (their counters move, no float32
        kernel's)."""
        x = torch.zeros(2, 48, 16, device=cuda)
        r = torch.zeros(2, 48, device=cuda)
        xb = x.bfloat16()
        with pytest.raises(ValueError):
            ac.cross_attn_fwd_lse(xb, x, xb, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dq(xb, xb, xb, xb, r.bfloat16(), r, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dq(x, x, x, xb, r, r, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dkv(xb, xb, xb, xb, r, r.bfloat16(), 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_fwd(x, xb, x, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dkv(xb, xb.cpu(), xb, xb, r, r, 3, 16, 0.25)
        y = torch.zeros(2, 48, 8, device=cuda)
        with pytest.raises(ValueError):
            ac.cross_attn_bwd_dkv(y, y, y, y, r, r, 3, 16, 0.25)
        with pytest.raises(ValueError):
            ac.attn_fwd(y.bfloat16(), y.bfloat16(), y.bfloat16(), 16, "full", 0.25)
        for mode, moves in (("cross", ("cross_attn_fwd_lse_bf16", "cross_attn_bwd_dq_bf16",
                                       "cross_attn_bwd_dkv_bf16")),
                            ("full", ("attn_fwd_bf16",))):
            qkv = [torch.zeros(1, 48, 32, device=cuda, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3)]
            before = dict(ac.launches)
            out = ac.fused_view_attention(*qkv, 2, 3, 16, mode)
            grads = torch.autograd.grad(out.float().sum(), qkv)
            assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
                       for g in grads)
            moved = {n: ac.launches[n] - before[n] for n in before}
            assert moved == {**{n: 0 for n in before}, **{n: 1 for n in moves}}, mode


class TestHopperPlan:
    """The Hopper forward kernels' launch plan and walk (`hopper_fwd_plan`,
    `hopper_fwd_walk`), made in Python where the CPU tests reach them; the card
    tests hold the plan to the C layout (`kernel_info`). Every query row of a
    slice is stored by exactly one work item, every item lies inside one view
    (cross) and takes every key it must see exactly once, the cross kernel
    never its own view's."""

    @pytest.mark.parametrize("V", (2, 5))
    @pytest.mark.parametrize("K", (1, 15, 17, 400, 1024, 2048))
    def test_cross_walk_covers_rows_and_other_views_once(self, K, V):
        items = ac.hopper_fwd_walk("cross_attn_fwd_bf16", V * K, V, K)
        rows = [r for r0, n, _ in items for r in range(r0, r0 + n)]
        assert sorted(rows) == list(range(V * K))
        for r0, n_live, keys in items:
            qv = r0 // K
            assert 1 <= n_live <= ac.HOPPER_ROWS and (r0 + n_live - 1) // K == qv
            seen = []
            for k0, n_valid in keys:
                assert 1 <= n_valid <= ac.HOPPER_KEYS
                assert k0 // K != qv and (k0 + n_valid - 1) // K == k0 // K
                seen += range(k0, k0 + n_valid)
            assert sorted(seen) == [x for x in range(V * K) if x // K != qv]
        plan = ac.hopper_fwd_plan("cross_attn_fwd_bf16", 3, V * K, 64, V, K)
        assert plan["items"] == 3 * len(items)
        assert plan["key_tiles"] == len(items[0][2])

    @pytest.mark.parametrize("S", (1, 15, 17, 400, 1024, 2048))
    def test_masked_walk_covers_rows_and_keys_once(self, S):
        items = ac.hopper_fwd_walk("attn_fwd_bf16", S)
        assert sorted(r for r0, n, _ in items for r in range(r0, r0 + n)) == list(range(S))
        for _, n_live, keys in items:
            assert 1 <= n_live <= ac.HOPPER_ROWS
            assert sorted(x for k0, n in keys for x in range(k0, k0 + n)) == list(range(S))
        plan = ac.hopper_fwd_plan("attn_fwd_bf16", 5, S, 32)
        assert (plan["items"], plan["key_tiles"]) == (5 * len(items), len(items[0][2]))

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_shared_bytes_and_swizzle(self, dh):
        """Two Q buffers of 128 rows and 4 K/V stages of 64 rows, each row
        2 dh bytes, swizzled to the row width (128 B at dh = 64, 64 at 32,
        32 at 16), inside a block's 227 KB."""
        plan = ac.hopper_fwd_plan("attn_fwd_bf16", 1, 64, dh)
        assert plan["swizzle_bytes"] == 2 * dh
        assert plan["shared_bytes"] == 1024 + (2 * 128 + 2 * 4 * 64) * 2 * dh + 8 * 12
        assert plan["shared_bytes"] <= ac.SMEM_BYTES
        assert (plan["threads"], plan["tile_rows"], plan["stages"]) == (384, 128, 4)

    @pytest.mark.parametrize("name,BH,V,K,items,waves", [
        ("attn_fwd_bf16", 160, 1, 1024, 1280, 1280 / 132),
        ("cross_attn_fwd_bf16", 32, 5, 1024, 1280, 1280 / 132),
        ("attn_fwd_bf16", 160, 1, 400, 640, 640 / 132),
        ("cross_attn_fwd_bf16", 32, 5, 400, 640, 640 / 132),
        ("attn_fwd_bf16", 64, 1, 2048, 1024, 1024 / 132),
        ("cross_attn_fwd_bf16", 32, 2, 2048, 1024, 1024 / 132),
        ("attn_fwd_bf16", 1, 3, 16, 1, 1.0),
        ("cross_attn_fwd_lse_bf16", 32, 5, 400, 640, 640 / 132),
        ("cross_attn_fwd_lse_bf16", 32, 5, 1024, 1280, 1280 / 132),
        ("cross_attn_fwd_lse_bf16", 32, 2, 2048, 1024, 1024 / 132)])
    def test_persistent_grid(self, name, BH, V, K, items, waves):
        """One block an SM walks the work items (the path shapes: bf16 eval,
        validation, pairs; the LSE forward at the training shape 32x2000x64
        and at the eval and pair shapes the kernel phase times it at), never
        more blocks than items."""
        plan = ac.hopper_fwd_plan(name, BH, V * K, 64, V, K)
        assert (plan["items"], plan["grid"]) == (items, min(items, 132))
        assert plan["waves"] == pytest.approx(waves)

    def test_lse_forward_walks_as_the_cross_kernel(self):
        """`cross_attn_fwd_lse_bf16` runs `cross_attn_fwd_bf16`'s body: the same
        plan and the same walk."""
        for V, K in ((2, 15), (5, 400)):
            a = ac.hopper_fwd_plan("cross_attn_fwd_lse_bf16", 3, V * K, 32, V, K)
            assert a == ac.hopper_fwd_plan("cross_attn_fwd_bf16", 3, V * K, 32, V, K)
            assert (ac.hopper_fwd_walk("cross_attn_fwd_lse_bf16", V * K, V, K)
                    == ac.hopper_fwd_walk("cross_attn_fwd_bf16", V * K, V, K))

    def test_rejects_what_the_kernels_do_not_take(self):
        with pytest.raises(ValueError):
            ac.hopper_fwd_plan("attn_fwd_bf16", 1, 64, 48)
        with pytest.raises(ValueError):
            ac.hopper_fwd_plan("cross_attn_fwd_bf16", 1, 65, 64, 2, 32)
        with pytest.raises(ValueError):
            ac.hopper_fwd_plan("cross_attn_bwd_dq_bf16", 1, 64, 64, 2, 32)
        with pytest.raises(ValueError):
            ac.hopper_dkv_plan(1, 64, 48, 2, 32)
        with pytest.raises(ValueError):
            ac.hopper_dkv_plan(1, 64, 64, 1, 64)
        with pytest.raises(ValueError):
            ac.hopper_dkv_plan(1, 65, 64, 2, 32)
        with pytest.raises(ValueError):
            ac.hopper_dq_plan(1, 64, 48, 2, 32)
        with pytest.raises(ValueError):
            ac.hopper_dq_plan(1, 64, 64, 1, 64)


class TestHopperDkvPlan:
    """The Hopper dk/dv kernel's launch plan and walk (`hopper_dkv_plan`), on
    the CPU; the card tests hold the plan to the C layout (`kernel_info`).
    Every key row of every view is owned by exactly one work item, inside its
    view; each item streams every other view's query rows exactly once in
    64-row tiles, and a row of its own view never weighs."""

    @pytest.mark.parametrize("V", (2, 3, 5))
    @pytest.mark.parametrize("K", (1, 15, 17, 400, 1024, 2048))
    def test_walk_owns_keys_and_streams_other_views_once(self, K, V):
        S = V * K
        plan = ac.hopper_dkv_plan(3, S, 64, V, K)
        walk = plan["walk"]
        assert sorted(r for r0, n, _ in walk for r in range(r0, r0 + n)) == list(range(S))
        for row0, n_live, tiles in walk:
            kv = row0 // K
            assert 1 <= n_live <= ac.HOPPER_ROWS and (row0 + n_live - 1) // K == kv
            seen = []
            for x0, n_valid in tiles:
                assert 1 <= n_valid <= ac.HOPPER_KEYS and x0 + n_valid <= S
                seen += range(x0, x0 + n_valid)
            assert all(x // K != kv for x in seen)
            assert sorted(seen) == [x for x in range(S) if x // K != kv]
            assert len(tiles) == plan["query_tiles"][kv]
        assert plan["items"] == 3 * len(walk)
        assert plan["grid"] == min(plan["items"], 132)

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_shared_bytes_and_swizzle(self, dh):
        """Two K/V buffers of 128 rows each for K and V, 4 stages of 64 Q and
        64 dO rows (each row 2 dh bytes, swizzled to the row width) and of 64
        LSE and 64 dvec floats, 12 mbarriers, inside a block's 227 KB."""
        plan = ac.hopper_dkv_plan(1, 128, dh, 2, 64)
        assert plan["swizzle_bytes"] == 2 * dh
        assert plan["shared_bytes"] == 1024 + (4 * 128 + 2 * 4 * 64) * 2 * dh + 4 * 128 * 4 + 8 * 12
        assert plan["shared_bytes"] <= ac.SMEM_BYTES
        assert (plan["threads"], plan["tile_rows"], plan["query_rows"], plan["stages"]) == (
            384, 128, 64, 4)

    @pytest.mark.parametrize("BH,V,K,items,tiles,rows", [
        (32, 5, 400, 640, [25, 26, 26, 26, 25], 448 / 400),
        (32, 5, 1024, 1280, [64, 64, 64, 64, 64], 1.0),
        (32, 2, 1024, 512, [16, 16], 1.0),
        (32, 2, 2048, 1024, [32, 32], 1.0),
        (1, 2, 15, 2, [1, 1], 64 / 15)])
    def test_persistent_grid(self, BH, V, K, items, tiles, rows):
        """At the training shape 32x2000x64 the 640 items of 128 keys take 4.85
        waves of 132 blocks; the last item of each view keeps 16 live keys, so
        one consumer warpgroup computes 64 rows and the other none (448 key
        rows computed for 400 stored); the streamed ranges take 25-26 tiles of
        64 query rows where one view at a time would take 28."""
        plan = ac.hopper_dkv_plan(BH, V * K, 64, V, K)
        assert (plan["items"], plan["grid"]) == (items, min(items, 132))
        assert plan["waves"] == pytest.approx(items / min(items, 132))
        assert plan["query_tiles"] == tiles
        assert plan["rows_per_stored"] == pytest.approx(rows)


class TestHopperDqPlan:
    """The Hopper dq kernel's launch plan and walk (`hopper_dq_plan`), on the
    CPU; the card tests hold the plan to the C layout (`kernel_info`). Every
    query row of every view is owned by exactly one work item, inside its
    view; each item streams every other view's key exactly once in 64-key
    tiles, and a key of its own view never weighs."""

    @pytest.mark.parametrize("V", (2, 3, 5))
    @pytest.mark.parametrize("K", (1, 15, 17, 400, 1024, 2048))
    def test_walk_owns_queries_and_streams_other_views_keys_once(self, K, V):
        S = V * K
        plan = ac.hopper_dq_plan(3, S, 64, V, K)
        walk = plan["walk"]
        assert sorted(r for r0, n, _ in walk for r in range(r0, r0 + n)) == list(range(S))
        for row0, n_live, tiles in walk:
            qv = row0 // K
            assert 1 <= n_live <= ac.HOPPER_ROWS and (row0 + n_live - 1) // K == qv
            seen = []
            for x0, n_valid in tiles:
                assert 1 <= n_valid <= ac.HOPPER_KEYS and x0 + n_valid <= S
                seen += range(x0, x0 + n_valid)
            assert all(x // K != qv for x in seen)
            assert sorted(seen) == [x for x in range(S) if x // K != qv]
            assert len(tiles) == plan["key_tiles"][qv]
        assert plan["items"] == 3 * len(walk)
        assert plan["grid"] == min(plan["items"], 132)

    def test_walk_is_the_dkv_walk(self):
        """dq walks dk/dv's items with the roles of the rows swapped: one walk
        (`BwdWalk` in the source) for both kernels."""
        for V, K in ((2, 15), (3, 129), (5, 400)):
            dq = ac.hopper_dq_plan(2, V * K, 32, V, K)
            dkv = ac.hopper_dkv_plan(2, V * K, 32, V, K)
            assert dq["walk"] == dkv["walk"] and dq["key_tiles"] == dkv["query_tiles"]
            assert (dq["items"], dq["grid"]) == (dkv["items"], dkv["grid"])

    @pytest.mark.parametrize("dh", (16, 32, 64))
    def test_shared_bytes_and_swizzle(self, dh):
        """Two Q/dO buffers of 128 rows each for Q and dO, 4 stages of 64 K and
        64 V rows (each row 2 dh bytes, swizzled to the row width), 12
        mbarriers, inside a block's 227 KB."""
        plan = ac.hopper_dq_plan(1, 128, dh, 2, 64)
        assert plan["swizzle_bytes"] == 2 * dh
        assert plan["shared_bytes"] == 1024 + (4 * 128 + 2 * 4 * 64) * 2 * dh + 8 * 12
        assert plan["shared_bytes"] <= ac.SMEM_BYTES
        assert (plan["threads"], plan["tile_rows"], plan["key_rows"], plan["stages"]) == (
            384, 128, 64, 4)

    @pytest.mark.parametrize("BH,V,K,items,tiles,rows", [
        (32, 5, 400, 640, [25, 26, 26, 26, 25], 448 / 400),
        (32, 5, 1024, 1280, [64, 64, 64, 64, 64], 1.0),
        (32, 2, 1024, 512, [16, 16], 1.0),
        (32, 2, 2048, 1024, [32, 32], 1.0),
        (1, 2, 15, 2, [1, 1], 64 / 15)])
    def test_persistent_grid(self, BH, V, K, items, tiles, rows):
        """At the training shape 32x2000x64 the 640 items of 128 query rows
        take 4.85 waves of 132 blocks and stream 25-26 tiles of 64 keys (one
        view at a time would take 28); the eval (32x5120x64) and pair
        (32x2048x64, 32x4096x64) shapes as the kernel phase records them. The
        last item of each view at K = 400 keeps 16 live rows: one consumer
        warpgroup computes 64 rows and the other none."""
        plan = ac.hopper_dq_plan(BH, V * K, 64, V, K)
        assert (plan["items"], plan["grid"]) == (items, min(items, 132))
        assert plan["waves"] == pytest.approx(items / min(items, 132))
        assert plan["key_tiles"] == tiles
        assert plan["rows_per_stored"] == pytest.approx(rows)
