"""bfloat16 evaluation (`--compute_dtype bfloat16`) of the PyTorch port against
the JAX package's bfloat16 semantics, on the CPU and the same seeded inputs.

The attention has two bfloat16 semantics in the JAX package, and the port keeps
both: the Pallas kernels (float32 scores and softmax, P V with P in float32,
the output rounded once), whose plain twin is the port's
`plain_view_attention` on bfloat16 tensors (the CUDA kernels' reference on the
card), and `multi_head_attention` (the probabilities rounded to bfloat16 before
P V), the port's `--attention_impl xla`. Both are held within one bfloat16 ulp
of JAX's. SuperPoint and the matcher in bfloat16 are held against JAX's
bfloat16 at the tolerances each test states; both eval loops run in bfloat16
with `device="cpu"`.
"""

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

from e2e_multi_view_matching_tpu.ops import attention as jatt  # noqa: E402
from e2e_multi_view_matching_tpu.ops import attention_pallas as jap  # noqa: E402
from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import attention as tatt  # noqa: E402
from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

BF16 = torch.bfloat16


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bf16_inputs(rng, *shape, n=3, scale=2.0):
    """`n` float32 arrays already on the bfloat16 grid (both packages then start
    from the same bfloat16 values)."""
    return [np.asarray(torch.from_numpy(scale * rng.normal(size=shape).astype(np.float32))
                       .to(BF16).float()) for _ in range(n)]


def jax_bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def from_jax(x):
    """A JAX bfloat16 array as a torch bfloat16 tensor (exact)."""
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32))).to(BF16)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("K,dh", [(16, 16), (24, 32), (24, 16), (16, 32)])
def test_kernel_twin_matches_pallas_kernels(rng, K, dh):
    """The port's plain twin of the bfloat16 kernels (`plain_view_attention`
    on bfloat16 (BH, S, dh)) against JAX's `_fused_attention_raw` (modes full,
    self, cross) and `_fused_cross_attention_raw` on bfloat16 q, k, v in
    interpret mode, V = 3 (K = 24: query blocks and views that are no
    multiple of 16): every element within one bfloat16 ulp of JAX's + 1e-6
    (`bf16_ulp_error` <= 1; the sums run in another order, so a rounding may
    land on the neighbouring value)."""
    V, S = 3, 3 * K
    q, k, v = bf16_inputs(rng, 2, S, dh)
    jq, jk, jv = map(jax_bf16, (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(BF16) for x in (q, k, v))
    scale = 1.0 / dh ** 0.5
    for mode in ("full", "self", "cross"):
        ref = jap._fused_attention_raw(jq, jk, jv, scale, K, mode, jap._pick_block(S), True)
        assert ref.dtype == jnp.bfloat16
        out = ac.plain_view_attention(tq, tk, tv, 1, V, K, mode)
        assert out.dtype == BF16
        assert ac.bf16_ulp_error(out, from_jax(ref)) <= 1.0, mode
    ref = jap._fused_cross_attention_raw(jq, jk, jv, scale, V, K, jap._pick_block(K), True)
    out = ac.plain_view_attention(tq, tk, tv, 1, V, K, "cross")
    assert ac.bf16_ulp_error(out, from_jax(ref)) <= 1.0


@pytest.mark.parametrize("K,dh", [(16, 16), (24, 32)])
def test_multi_head_attention_matches_jax(rng, K, dh):
    """`multi_head_attention` on bfloat16 inputs with JAX's dtypes (float32
    logits and softmax, the probabilities rounded to bfloat16, float32
    accumulation, a bfloat16 output) against JAX's, 4 heads, unmasked and under
    the cross and self masks: within one bfloat16 ulp of JAX's + 1e-6. It is
    not the kernels' function: the rounded probabilities move some outputs
    further than that from the twin's."""
    V, h = 3, 4
    q, k, v = bf16_inputs(rng, 2, V * K, h * dh)
    tq, tk, tv = (torch.from_numpy(x).to(BF16) for x in (q, k, v))
    far = 0.0
    for mask_fn in (None, "cross_view_mask", "self_view_mask"):
        jmask = None if mask_fn is None else getattr(jatt, mask_fn)(V, K)
        tmask = None if mask_fn is None else getattr(tatt, mask_fn)(V, K)
        ref = jatt.multi_head_attention(*map(jax_bf16, (q, k, v)), h, mask=jmask)
        out = tatt.multi_head_attention(tq, tk, tv, h, mask=tmask)
        assert out.dtype == BF16
        assert ac.bf16_ulp_error(out, from_jax(ref)) <= 1.0, mask_fn
        mode = {None: "full", "cross_view_mask": "cross", "self_view_mask": "self"}[mask_fn]
        far = max(far, ac.bf16_ulp_error(out, ac.plain_view_attention(tq, tk, tv, h, V, K,
                                                                        mode)))
    assert far > 1.0  # the two semantics differ


def test_bf16_attention_on_cpu_takes_the_twin_and_refuses_grad():
    """A CPU bfloat16 tensor takes the kernels' plain twin (bit for bit); under
    grad (bfloat16 training) it takes the bfloat16 VJP: a cross layer the
    twins of the LSE forward and of dq and dk/dv (the LSE twin's value and
    the twins' gradients, bit for bit), a full layer the VJP of bfloat16
    `multi_head_attention` (bit for bit), with bfloat16 gradients. (The name
    is from the slice before bfloat16 training, when grad raised here.)"""
    g = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(2, 48, 64, generator=g).to(BF16) for _ in range(4))
    for mode, n_views in (("cross", 3), ("full", 1)):
        K_ = 48 // n_views
        out = ac.fused_view_attention(q, k, v, 4, n_views, K_, mode)
        assert torch.equal(out, ac.plain_view_attention(q, k, v, 4, n_views, K_, mode))
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ac.fused_view_attention(*xs, 4, n_views, K_, mode)
        grads = torch.autograd.grad(out, xs, w)
        assert all(gr.dtype == BF16 for gr in grads)
        if mode == "full":
            assert torch.equal(out.detach(), ac.plain_view_attention(q, k, v, 4, 1, K_, mode))
            ys = [x.clone().requires_grad_() for x in (q, k, v)]
            refs = torch.autograd.grad(tatt.multi_head_attention(*ys, 4), ys, w)
        else:
            def split(x):
                return x.reshape(2, 48, 4, 16).transpose(1, 2).reshape(8, 48, 16).contiguous()

            def merge(x):
                return x.reshape(2, 4, 48, 16).transpose(1, 2).reshape(2, 48, 64)

            qs, ks, vs, ws = map(split, (q, k, v, w))
            o, lse = ac.cross_attn_fwd_lse_plain(qs, ks, vs, n_views, K_, 0.25)
            assert torch.equal(out.detach(), merge(o))  # the LSE twin's value
            refs = [merge(x) for x in ac.cross_attn_bwd_plain(
                qs, ks, vs, ws, lse, (ws.float() * o.float()).sum(-1), n_views, K_, 0.25)]
        for gr, r in zip(grads, refs):
            assert torch.equal(gr, r), mode


# --------------------------------------------------------------- SuperPoint

SP_CFG = dict(nms_radius=4, keypoint_threshold=0.001, max_keypoints=32, remove_borders=4,
              fill_with_random_keypoints=False, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def superpoints():
    j = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    variables = to_numpy(jax.jit(j.init)({"params": jax.random.PRNGKey(0),
                                          "keypoints": jax.random.PRNGKey(1)},
                                         jnp.zeros((1, 64, 64, 1))))
    port = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG))
    port.load_state_dict(state_dict_from_flax(variables))
    return j, variables, port.eval()


def test_superpoint_net_maps_match_jax(superpoints):
    """`SuperPointNet`'s bfloat16 trunk against JAX's on a 64 x 64 image and a
    40 x 56 image on the same canvas (`valid_size`): the float32 `heat` and
    `desc` maps within 2^-6 of their largest |value| (measured 2^-7.7 and
    2^-7.3: each of the ten convolutions rounds its output to bfloat16, and
    the two packages sum in another order, so a rounding that flips upstream
    moves the maps by about a bfloat16 ulp)."""
    j, variables, port = superpoints
    image = np.random.default_rng(1).random((2, 64, 64, 1), dtype=np.float32)
    valid = np.asarray([[64, 64], [40, 56]], np.float32)
    net = jsp.SuperPointNet(256, "bfloat16")
    heat_ref, desc_ref = to_numpy(jax.jit(net.apply)({"params": variables["params"]["net"]},
                                                     jnp.asarray(image), jnp.asarray(valid)))
    with torch.no_grad():
        heat, desc = port.net(torch.from_numpy(image), torch.from_numpy(valid))
    assert heat.dtype == desc.dtype == torch.float32
    for out, ref in ((heat.numpy(), heat_ref), (desc.numpy(), desc_ref)):
        assert np.abs(out - ref).max() <= 2.0 ** -6 * np.abs(ref).max()


def test_superpoint_keypoints_overlap_jax(superpoints):
    """Detections in bfloat16 against JAX's bfloat16 and float32 ones: the
    keypoint sets overlap > 0.8, as JAX's own bfloat16 test asks (bfloat16
    quantizes the score map, so top-K ties, which `torch.topk` and
    `lax.top_k` order differently, get likelier); outputs float32,
    parameters float32."""
    j, variables, port = superpoints
    image = np.random.default_rng(2).random((2, 64, 64, 1), dtype=np.float32)
    ref = to_numpy(jax.jit(j.apply)(variables, jnp.asarray(image)))
    j32 = jsp.SuperPoint(jsp.SuperPointConfig(**{**SP_CFG, "compute_dtype": "float32"}))
    ref32 = to_numpy(jax.jit(j32.apply)(variables, jnp.asarray(image)))
    with torch.no_grad():
        out = port(torch.from_numpy(image))
    assert all(v.dtype == torch.float32 for v in out.values())
    assert all(p.dtype == torch.float32 for p in port.parameters())
    for b in range(2):
        ours = {tuple(k) for k in out["keypoints"][b].numpy().astype(int)}
        for r in (ref, ref32):
            theirs = {tuple(k) for k in r["keypoints"][b].astype(int)}
            assert len(ours & theirs) / len(theirs) > 0.8


# ------------------------------------------------------------------ matcher

M_CFG = dict(descriptor_dim=64, keypoint_encoder=(32, 64),
             gnn_layers=jm.default_gnn_layers(2, 1), num_heads=4, sinkhorn_iterations=20,
             conf_mlp=True, conf_mlp_hidden=(64, 16), match_threshold=0.0)


def _probs_err(z, z_ref):
    """Assignment probabilities: absolute on matches (<= 1), relative on the
    dustbin entries, which are scaled by M + N."""
    p, p_ref = np.exp(z), np.exp(z_ref)
    return float(np.max(np.abs(p - p_ref) / np.maximum(p_ref, 1.0)))


@pytest.fixture(scope="module", params=[2, 3], ids=["V2", "V3"])
def matcher_case(request):
    """Bridged weights (random BatchNorm statistics) and inputs for V views,
    K = 16, with JAX's float32 outputs on them."""
    V, K, D = request.param, 16, 64
    rng = np.random.default_rng(V)
    j32 = jm.MultiViewMatcher(jm.MatcherConfig(**M_CFG))
    variables = to_numpy(jax.jit(j32.init)(jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)),
                                           jnp.zeros((1, V, K)), jnp.zeros((1, V, K, D)),
                                           jnp.full((1, V, 2), 64.0)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim and x.min() > 0.5
                   else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    variables["params"]["bin_score"] = np.float32(0.7)
    kpts = rng.uniform(0, 64, size=(2, V, K, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, size=(2, V, K)).astype(np.float32)
    descs = rng.normal(size=(2, V, K, D)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    inputs = (kpts, scores, descs, np.tile(np.asarray([64.0, 96.0], np.float32), (2, V, 1)))
    ref32 = to_numpy(jax.jit(j32.apply)(variables, *map(jnp.asarray, inputs)))
    return variables, inputs, ref32


@pytest.mark.parametrize("impls", [("xla", "xla"), ("pallas", "cuda")])
def test_matcher_matches_jax(matcher_case, impls):
    """`MultiViewMatcher` in bfloat16 against JAX's in bfloat16 on bridged
    weights (random BatchNorm statistics), both fed the same keypoints and
    descriptors, V = 2 and 3, K = 16, mutual best matches (threshold 0). JAX "xla" against
    the port's "xla" (`multi_head_attention`), JAX "pallas" in interpret mode
    against the port's "cuda" on CPU tensors (the kernels' plain twin).
    Probabilities within 5e-3 (relative above 1) and confidences within 5e-3
    where the matches agree (measured up to 1.9e-3 and 2.2e-3: a bfloat16
    rounding that flips in one package moves the later layers by a bfloat16
    ulp, ~4e-3 relative); matches0 agree on >= 0.95 of the keypoints either
    run matched; and the port's probabilities are no farther from JAX's
    float32 run than JAX's bfloat16 run is, + 2e-3."""
    variables, inputs, ref32 = matcher_case
    j = jm.MultiViewMatcher(jm.MatcherConfig(**M_CFG, compute_dtype="bfloat16",
                                             attention_impl=impls[0]))
    port = tm.MultiViewMatcher(tm.MatcherConfig(**M_CFG, compute_dtype="bfloat16",
                                                attention_impl=impls[1]))
    port.load_state_dict(state_dict_from_flax(variables))
    ref = to_numpy(jax.jit(j.apply)(variables, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port.eval()(*map(torch.from_numpy, inputs)).items()}
    assert out["log_assignment"].dtype == out["conf_scores"].dtype == np.float32
    assert _probs_err(out["log_assignment"], ref["log_assignment"]) < 5e-3
    m, m_ref = out["matches0"], ref["matches0"]
    same = m == m_ref
    np.testing.assert_allclose(out["conf_scores"][same], ref["conf_scores"][same], atol=5e-3)
    matched = (m >= 0) | (m_ref >= 0)
    assert matched.sum() >= 10 and np.mean(same[matched]) >= 0.95
    assert (_probs_err(out["log_assignment"], ref32["log_assignment"])
            <= _probs_err(ref["log_assignment"], ref32["log_assignment"]) + 2e-3)


def test_matcher_refuses_bf16_training():
    """`train=True` in bfloat16 trains (the name is from the slice before
    bfloat16 training, when it raised), with either attention impl: on
    seeded weights (flax's initializers) the forward in training mode gives
    float32 log assignments and confidences, every parameter gets a finite
    float32 gradient, and the BatchNorm running statistics move from float32
    batch statistics of the upcast input: after one call the keypoint
    encoder's first running mean equals 0.9 x the old + 0.1 x the float32
    mean of its input, the first Dense layer's bfloat16 output upcast, to
    float32 rounding."""
    from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_

    rng = np.random.default_rng(5)
    V, K = 2, 16
    desc = rng.normal(size=(2, V, K, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    inputs = (torch.from_numpy(rng.uniform(0, 64, size=(2, V, K, 2)).astype(np.float32)),
              torch.from_numpy(rng.uniform(0, 1, size=(2, V, K)).astype(np.float32)),
              torch.from_numpy(desc), torch.full((2, V, 2), 64.0))
    orig = tm.batch_norm
    for impl in ("xla", "cuda"):
        port = tm.MultiViewMatcher(tm.MatcherConfig(**M_CFG, compute_dtype="bfloat16",
                                                    attention_impl=impl))
        init_like_flax_(port, torch.Generator().manual_seed(0))
        old = port.kenc.bn_0.running_mean.clone()
        seen = {}

        def spy(x, bn, train, seen=seen):
            seen.setdefault(id(bn), x)
            return orig(x, bn, train)

        tm.batch_norm = spy
        try:
            out = port(*inputs, train=True)
        finally:
            tm.batch_norm = orig
        assert out["log_assignment"].dtype == out["conf_scores"].dtype == torch.float32
        x0 = seen[id(port.kenc.bn_0)]
        assert x0.dtype == torch.float32 and torch.equal(x0, x0.to(BF16).float())
        expect = 0.9 * old + 0.1 * x0.reshape(-1, x0.shape[-1]).mean(0)
        torch.testing.assert_close(port.kenc.bn_0.running_mean, expect, rtol=1e-6, atol=1e-7)
        loss = out["log_assignment"].exp().mean() + out["conf_scores"].mean()
        grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
        assert all(g is not None and g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                   for g in grads), impl


# --------------------------------------------------------------- eval loops

def _correspondences(kpts, matches0, V):
    """{(b, i, j, xy_i, xy_j)} of the matches of every pair (i < j): the
    matches as keypoint coordinates, whatever slot order top-K gave."""
    out, p = set(), 0
    for j in range(V):
        for i in range(j):
            for b in range(kpts.shape[0]):
                for s in np.flatnonzero(matches0[b, p] >= 0):
                    out.add((b, i, j, tuple(kpts[b, i, s]), tuple(kpts[b, j, matches0[b, p, s]])))
            p += 1
    return out


def test_eval_multi_view_in_bf16_on_cpu():
    """`cli.eval_multi_view.evaluate` with `compute_dtype="bfloat16"` on
    `device="cpu"` (V = 5, K = 64, 96 x 128 plane scenes, 3 tuples in chunks
    of 2, the last padded), bfloat16 SuperPoint and matcher (descriptor
    matching: the GNN's updates off, the final projection the identity,
    threshold 0, as `test_torch_eval_pairs.py` sets it up, so that every pair
    has matches): every error finite. Its sub-chunk against JAX's bfloat16
    stages on the same tuples: the keypoint sets of every frame overlap >= 0.9
    (measured >= 0.97: bfloat16 quantizes the score map, and `torch.topk` and
    `lax.top_k` order ties differently, so slots also move), and the matches
    as keypoint coordinates agree on >= 0.8 of those either run made
    (measured 0.91: mutual best matches at threshold 0 on random weights are
    near ties, which a bfloat16 ulp decides). The
    pose stage, float32 in both modes, is held against JAX's in
    `test_torch_slice.py` and `test_torch_geom.py`."""
    from e2e_multi_view_matching_tpu.data.synthetic import PlaneScene, fourier_texture_image
    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev
    from tests.test_torch_eval_pairs import _descriptor_matcher

    V, K, H, W, D = 5, 64, 96, 128, 64
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(3):
        scene = PlaneScene(rng, n_views=V, H=H, W=W)
        images = np.stack([fourier_texture_image(scene, v) for v in range(V)])
        samples.append({"images": images[..., None].astype(np.float32),
                        "intr": np.tile(scene.intr[0].astype(np.float32), (V, 1, 1)),
                        "poses": np.stack(scene.poses).astype(np.float32)})
    sp_cfg = dict(nms_radius=4, keypoint_threshold=0.001, max_keypoints=K, remove_borders=4,
                  fill_with_random_keypoints=False, descriptor_dim=D, compute_dtype="bfloat16")
    m_cfg = dict(descriptor_dim=D, keypoint_encoder=(32, 64), gnn_layers=("self", "cross"),
                 num_heads=4, sinkhorn_iterations=10, conf_mlp=True, multi_frame_matching=True,
                 conf_mlp_hidden=(64, 16), match_threshold=0.0, compute_dtype="bfloat16")
    j_sp, j_m = jsp.SuperPoint(jsp.SuperPointConfig(**sp_cfg)), jm.MultiViewMatcher(
        jm.MatcherConfig(**m_cfg))
    sp_vars = to_numpy(jax.jit(j_sp.init)({"params": jax.random.PRNGKey(1),
                                           "keypoints": jax.random.PRNGKey(2)},
                                          jnp.zeros((1, H, W, 1))))
    m_vars = _descriptor_matcher(to_numpy(jax.jit(j_m.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
        jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), 64.0))))
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**sp_cfg))
    sp.load_state_dict(state_dict_from_flax(sp_vars))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(**m_cfg, attention_impl="cuda",
                                                   sinkhorn_impl="cuda"))
    matcher.load_state_dict(state_dict_from_flax(m_vars))
    opt = types.SimpleNamespace(tuple_size=V, max_tuples=None, eval_batch=2, eval_scan=1,
                                no_pipeline=False, compute_dtype="bfloat16")
    errors = np.asarray(tev.evaluate(opt, sp, matcher, samples, device="cpu"))
    assert errors.shape == (3, 30) and np.all(np.isfinite(errors))

    images = np.stack([s["images"] for s in samples]).reshape(3 * V, H, W, 1)
    size = np.tile(np.asarray([H, W], np.float32), (3, V, 1))
    sp_out = to_numpy(jax.jit(j_sp.apply)(sp_vars, images))
    kpts = sp_out["keypoints"].reshape(3, V, K, 2)
    m_out = to_numpy(jax.jit(j_m.apply)(m_vars, kpts, sp_out["scores"].reshape(3, V, K),
                                        sp_out["descriptors"].reshape(3, V, K, D), size))
    with torch.no_grad():
        ours = tev.infer_subchunk(sp, matcher, torch.from_numpy(images.reshape(3, V, H, W, 1)),
                                  torch.from_numpy(np.stack([s["intr"] for s in samples])),
                                  torch.from_numpy(size))
    k_ours = ours[0].numpy()
    for f in range(3 * V):
        a, b = ({tuple(x) for x in k.reshape(3 * V, K, 2)[f]} for k in (k_ours, kpts))
        assert len(a & b) >= 0.9 * K
    c_ours = _correspondences(k_ours, ours[1].numpy(), V)
    c_ref = _correspondences(kpts, m_out["matches0"], V)
    assert len(c_ref) >= 300 and len(c_ours & c_ref) >= 0.8 * len(c_ours | c_ref)


def test_eval_pairs_in_bf16_on_cpu(tmp_path):
    """`cli.eval_pairs.evaluate` in w8pt_ba with bfloat16 SuperPoint and
    matcher on `device="cpu"` against JAX's `evaluate` with its bfloat16
    models, on five ScanNet-format pairs (the descriptor matcher and weights
    of `test_torch_eval_pairs.py`): the same failure count and chunk
    signatures, every pose finite, per-pair errors within 5 deg of JAX's
    (measured up to 3.6 deg, on poses 40-125 deg off with random weights: in
    bfloat16 the two packages' SuperPoints keep slightly different keypoint
    sets, ~2% of a frame's, and a bfloat16 ulp decides near-tied matches;
    in float32 the same comparison holds 0.05 deg)."""
    from e2e_multi_view_matching_tpu.cli import eval_pairs as jev
    from e2e_multi_view_matching_tpu.data.pairs import PairMatchingDataset as JPairs
    from e2e_multi_view_matching_tpu_torch.cli import eval_pairs as tev
    from e2e_multi_view_matching_tpu_torch.data.pairs import PairMatchingDataset
    from tests.test_torch_eval_pairs import _descriptor_matcher
    from tests.test_torch_pairs import write_pair_lists

    data_dir, files = write_pair_lists(str(tmp_path))["scannet"]
    sp_cfg = dict(nms_radius=4, keypoint_threshold=1e-4, max_keypoints=128, remove_borders=0,
                  fill_with_random_keypoints=False, compute_dtype="bfloat16")
    m_cfg = dict(gnn_layers=("self", "cross") * 2, sinkhorn_iterations=10, conf_mlp=True,
                 match_threshold=0.0, compute_dtype="bfloat16")
    j_sp, j_m = jsp.SuperPoint(jsp.SuperPointConfig(**sp_cfg)), jm.MultiViewMatcher(
        jm.MatcherConfig(**m_cfg))
    sp_vars = to_numpy(jax.jit(j_sp.init)({"params": jax.random.PRNGKey(1),
                                           "keypoints": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, 64, 64, 1))))
    m_vars = _descriptor_matcher(to_numpy(jax.jit(j_m.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 2, 8, 2)), jnp.zeros((1, 2, 8)),
        jnp.zeros((1, 2, 8, 256)), jnp.full((1, 2, 2), 64.0))))
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**sp_cfg))
    sp.load_state_dict(state_dict_from_flax(sp_vars))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(**m_cfg))
    matcher.load_state_dict(state_dict_from_flax(m_vars))
    opt = types.SimpleNamespace(eval_mode="w8pt_ba", max_pairs=5, eval_batch=2, eval_scan=1,
                                shape_bucket=128, compute_dtype="bfloat16")
    ref, ref_fail, ref_sig = jev.evaluate(opt, j_sp, sp_vars, j_m, m_vars,
                                          JPairs(data_dir, files, 128, "scannet"))
    ours, fail, sig = tev.evaluate(opt, sp.eval(), matcher.eval(),
                                   PairMatchingDataset(data_dir, files, 128, "scannet"),
                                   device="cpu")
    assert len(ours) == 5 and (fail, sig) == (ref_fail, ref_sig) == (0, 1)
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=5.0)


# ------------------------------------------------------------ command lines

def test_cli_flags_take_bf16_for_eval_and_refuse_it_for_training():
    """All three command lines take `--compute_dtype bfloat16`, `cli.train`
    too since bfloat16 training (the name is from the slice before it, when
    `cli.train` refused the flag); float32 stays the default, and the flag
    builds bfloat16 models for training."""
    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view, eval_pairs, train

    for cli in (eval_multi_view, eval_pairs, train):
        assert cli.parse_args(["--compute_dtype", "bfloat16"]).compute_dtype == "bfloat16"
        assert cli.parse_args([]).compute_dtype == "float32"
    opt = train.parse_args(["--compute_dtype", "bfloat16", "--dataset", "scannet"])
    opt.gnn_layers, opt.cross_attention_layers, opt.tuple_size = 1, 1, 2
    opt.nms_radius, opt.keypoint_threshold, opt.max_keypoints, opt.remove_borders = 4, 0.0, 8, 4
    opt.attention_impl = opt.sinkhorn_impl = "xla"  # `setup_run` resolves "auto"
    sp, matcher = train.build_models(opt)
    assert sp.config.compute_dtype == matcher.config.compute_dtype == "bfloat16"
    assert sp.config.fill_with_random_keypoints


def test_strict_float32_turns_tf32_off_in_every_mode():
    """`evaluate` with a bfloat16 `opt` (and with a float32 one) turns TF32 off
    (cuDNN convolutions and cuBLAS float32 products) and cuBLAS's
    reduced-precision bfloat16 sums: in bfloat16 mode the pair scores,
    BatchNorm, the pose stage and the descriptor normalization stay float32,
    and bfloat16 products sum in float32, as in the JAX package."""
    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev

    flags = ((torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(m, a) for m, a in flags]
    sp = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG))
    matcher = tm.MultiViewMatcher(tm.MatcherConfig(**M_CFG, compute_dtype="bfloat16"))
    try:
        for dtype in ("bfloat16", "float32"):
            for m, a in flags:
                setattr(m, a, True)
            opt = types.SimpleNamespace(tuple_size=2, max_tuples=None, eval_batch=1,
                                        eval_scan=1, no_pipeline=False, compute_dtype=dtype)
            assert tev.evaluate(opt, sp, matcher, [], device="cpu") == ([], [], [])
            assert [getattr(m, a) for m, a in flags] == [False] * 3, dtype
    finally:
        for (m, a), v in zip(flags, saved):
            setattr(m, a, v)
