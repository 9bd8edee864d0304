"""Parity of the PyTorch port's SuperPoint, matcher and weight bridge with the
JAX package, on the same seeded inputs and bridged weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.models import matcher as jm  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    init_like_flax_,
    state_dict_from_flax,
)

SP_CFG = dict(nms_radius=4, keypoint_threshold=0.001, max_keypoints=32, remove_borders=4,
              fill_with_random_keypoints=False)
MATCHER_CFG = dict(descriptor_dim=64, keypoint_encoder=(32, 64),
                   gnn_layers=("self", "cross"), num_heads=4, sinkhorn_iterations=10,
                   conf_mlp=True, conf_mlp_hidden=(64, 16))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_superpoint(seed=0):
    j = jsp.SuperPoint(jsp.SuperPointConfig(**SP_CFG))
    variables = j.init({"params": jax.random.PRNGKey(seed), "keypoints": jax.random.PRNGKey(1)},
                       jnp.zeros((1, 64, 96, 1)))
    port = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG))
    port.load_state_dict(state_dict_from_flax(to_numpy(variables)))
    return j, variables, port.eval()


def build_matcher(rng, V, K, impls=("xla", "xla")):
    """JAX matcher with random params and random BatchNorm statistics, and the
    port with the bridged weights."""
    jcfg = dict(MATCHER_CFG, attention_impl=impls[0], sinkhorn_impl=impls[1])
    j = jm.MultiViewMatcher(jm.MatcherConfig(**jcfg))
    D = MATCHER_CFG["descriptor_dim"]
    variables = j.init(jax.random.PRNGKey(3), jnp.zeros((1, V, K, 2)), jnp.zeros((1, V, K)),
                       jnp.zeros((1, V, K, D)), jnp.full((1, V, 2), 64.0))
    variables = to_numpy(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim and x.min() > 0.5
                   else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    variables["params"]["bin_score"] = np.float32(0.7)
    tcfg = dict(jcfg, attention_impl={"xla": "xla", "pallas": "cuda"}[impls[0]],
                sinkhorn_impl={"xla": "xla", "mxu": "mxu", "pallas": "cuda"}[impls[1]])
    port = tm.MultiViewMatcher(tm.MatcherConfig(**tcfg))
    port.load_state_dict(state_dict_from_flax(variables))
    return j, variables, port.eval()


def matcher_inputs(rng, V, K, D=64):
    kpts = rng.uniform(0, 64, size=(2, V, K, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, size=(2, V, K)).astype(np.float32)
    descs = rng.normal(size=(2, V, K, D)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    size = np.tile(np.asarray([64.0, 96.0], np.float32), (2, V, 1))
    return kpts, scores, descs, size


class TestSuperPoint:
    def test_matches_jax(self, rng):
        """Keypoints identical except at score ties (top-K tie order differs
        between lax.top_k and torch.topk); scores and descriptors of the same
        keypoints within 1e-5 (f32 convolution reduction order)."""
        j, variables, port = build_superpoint()
        image = rng.random((2, 64, 96, 1), dtype=np.float32)
        ref = to_numpy(jax.jit(j.apply)(variables, jnp.asarray(image)))
        with torch.no_grad():
            out = {k: v.numpy() for k, v in port(torch.from_numpy(image)).items()}
        n_checked = 0
        for b in range(2):
            s_ref = ref["scores"][b]
            # a keypoint whose score ties another's may swap slots
            gaps = np.abs(s_ref[:, None] - s_ref[None, :]) + np.eye(len(s_ref))
            untied = (gaps.min(axis=1) > 1e-6) & (s_ref > 0)
            where = {tuple(p): i for i, p in enumerate(out["keypoints"][b])}
            for i in np.flatnonzero(untied):
                k = where[tuple(ref["keypoints"][b, i])]
                np.testing.assert_allclose(out["scores"][b, k], s_ref[i], atol=1e-5)
                np.testing.assert_allclose(out["descriptors"][b, k],
                                           ref["descriptors"][b, i], atol=1e-5)
                n_checked += 1
            np.testing.assert_allclose(np.sort(out["scores"][b]), np.sort(s_ref), atol=1e-5)
        assert n_checked >= 32

    def test_block_topk_matches_flat(self, rng):
        """The 4x4-block top-K (NMS radius >= 3 leaves one survivor per block)
        selects the same keypoints as the flat top-K fallback for distinct
        scores, with identical descriptors."""
        _, _, port = build_superpoint()
        flat = tsp.SuperPoint(tsp.SuperPointConfig(**SP_CFG, topk_impl="flat"))
        flat.load_state_dict(port.state_dict())
        image = torch.from_numpy(rng.random((2, 64, 96, 1), dtype=np.float32))
        with torch.no_grad():
            a, b = port(image), flat.eval()(image)
        for i in range(2):
            ka = {tuple(p): j for j, p in enumerate(a["keypoints"][i].tolist())}
            for j, p in enumerate(b["keypoints"][i].tolist()):
                if b["scores"][i, j] > 0:
                    k = ka[tuple(p)]
                    assert a["scores"][i, k] == b["scores"][i, j]
                    assert torch.equal(a["descriptors"][i, k], b["descriptors"][i, j])

    def test_simple_nms_matches_jax(self, rng):
        scores = rng.random((2, 40, 48)).astype(np.float32)
        scores[0, 5:9, 5:9] = 0.5  # a plateau: equal maxima
        for radius in (3, 4):
            out = tsp.simple_nms(torch.from_numpy(scores), radius).numpy()
            np.testing.assert_array_equal(out, np.asarray(jsp.simple_nms(scores, radius)))


class TestMatcher:
    @pytest.mark.parametrize("V", [5, 2])
    @pytest.mark.parametrize("impls", [("xla", "xla"), ("pallas", "pallas")])
    def test_matches_jax(self, rng, V, impls):
        """Eval-mode outputs on bridged weights. JAX "pallas" runs its kernels in
        interpret mode; the port's "cuda" ops on a CPU tensor run their plain
        versions. Tolerances: assignment probabilities 1e-5 (relative above 1)
        and confidences 1e-5 (f32 reduction order); matches identical."""
        K = 32
        j, variables, port = build_matcher(rng, V, K, impls)
        inputs = matcher_inputs(rng, V, K)
        ref = to_numpy(jax.jit(j.apply)(variables, *map(jnp.asarray, inputs)))
        with torch.no_grad():
            out = port(*map(torch.from_numpy, inputs))
        out = {k: v.numpy() for k, v in out.items()}
        # probabilities: absolute on matches (<= 1), relative on the dustbin
        # entries, which are scaled by M+N
        p, p_ref = np.exp(out["log_assignment"]), np.exp(ref["log_assignment"])
        assert np.max(np.abs(p - p_ref) / np.maximum(p_ref, 1.0)) < 1e-5
        np.testing.assert_array_equal(out["pairs"], ref["pairs"])
        np.testing.assert_array_equal(out["matches0"], ref["matches0"])
        np.testing.assert_array_equal(out["matches1"], ref["matches1"])
        np.testing.assert_allclose(out["conf_scores"], ref["conf_scores"], atol=1e-5)
        keys = tm.result_to_reference_keys(out, V)
        assert set(keys) == set(jm.result_to_reference_keys(ref, V))


class TestBridge:
    @pytest.mark.parametrize("model", ["superpoint", "matcher"])
    def test_round_trips_every_parameter(self, rng, model):
        """Every flax leaf lands in exactly one state-dict entry, the port loads
        it strictly, and each tensor equals its flax array under the layout map
        (Dense (in, out) -> (out, in), Conv HWIO -> OIHW)."""
        if model == "superpoint":
            _, variables, port = build_superpoint()
            variables = to_numpy(variables)
        else:
            _, variables, port = build_matcher(rng, 3, 16)
        sd = port.state_dict()
        bridged = state_dict_from_flax(variables)
        assert set(sd) == set(bridged)
        n_leaves = 0
        for coll, suffix_map in (("params", {"kernel": "weight", "scale": "weight",
                                             "bias": "bias", "bin_score": "bin_score"}),
                                 ("batch_stats", {"mean": "running_mean",
                                                  "var": "running_var"})):
            for path, arr in jax.tree_util.tree_flatten_with_path(variables.get(coll, {}))[0]:
                names = [p.key for p in path]
                key = ".".join(names[:-1] + [suffix_map[names[-1]]])
                arr = np.asarray(arr)
                if names[-1] == "kernel":
                    arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
                np.testing.assert_array_equal(sd[key].numpy(), arr)
                n_leaves += 1
        n_tracked = sum(k.endswith("num_batches_tracked") for k in sd)
        assert n_leaves + n_tracked == len(sd)


class TestTraining:
    """What training adds to the models: the matcher's train mode, the inverse
    weight bridge, the flax-style initialization, the random keypoint fill."""

    def test_matcher_train_mode_matches_flax_batchnorm(self, rng):
        """`train=True` on bridged weights and non-trivial running statistics,
        with the conf MLP: log assignment 1e-5 (relative above 1), and the
        running statistics after the call 1e-6. Flax normalises with, and
        stores, the biased batch variance E[x^2] - E[x]^2; at these B*V*K = 96
        rows torch's own train-mode BatchNorm (unbiased) would be 1% off."""
        V, K = 3, 16
        j, variables, port = build_matcher(rng, V, K)
        inputs = matcher_inputs(rng, V, K)
        ref, updates = jax.jit(lambda v, *a: j.apply(v, *a, train=True, mutable=["batch_stats"])
                               )(variables, *map(jnp.asarray, inputs))
        out = port(*map(torch.from_numpy, inputs), train=True)
        p, p_ref = out["log_assignment"].detach().exp().numpy(), np.exp(ref["log_assignment"])
        assert np.max(np.abs(p - p_ref) / np.maximum(p_ref, 1.0)) < 1e-5
        np.testing.assert_allclose(out["conf_scores"].detach().numpy(), ref["conf_scores"],
                                   atol=1e-5)
        new = flax_from_state_dict(port.state_dict())["batch_stats"]
        moved = 0.0
        for path, arr in jax.tree_util.tree_flatten_with_path(to_numpy(updates["batch_stats"]))[0]:
            node, old = new, variables["batch_stats"]
            for part in path:
                node, old = node[part.key], old[part.key]
            np.testing.assert_allclose(node, arr, atol=1e-6, err_msg=str(path))
            moved = max(moved, float(np.abs(arr - old).max()))
        assert moved > 1e-3
        # eval mode afterwards reads the moved statistics and moves nothing
        before = {k: v.clone() for k, v in port.state_dict().items()}
        with torch.no_grad():
            port(*map(torch.from_numpy, inputs))
        assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())

    @pytest.mark.parametrize("model", ["superpoint", "matcher"])
    def test_inverse_bridge_round_trips(self, rng, model):
        """`flax_from_state_dict(state_dict_from_flax(v)) == v`, leaf by leaf:
        the map that lets gradients and statistics compare with flax trees."""
        if model == "superpoint":
            variables = to_numpy(build_superpoint()[1])
        else:
            variables = build_matcher(rng, 3, 16)[1]
        back = flax_from_state_dict(state_dict_from_flax(variables))
        for coll in ("params", "batch_stats"):
            ref = jax.tree_util.tree_flatten_with_path(variables.get(coll, {}))[0]
            got = jax.tree_util.tree_flatten_with_path(back[coll])[0]
            assert [p for p, _ in ref] == [p for p, _ in got]
            for (path, a), (_, b) in zip(ref, got):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
        with pytest.raises(ValueError):
            flax_from_state_dict({"gnn.strange": torch.zeros(2)})

    def test_init_like_flax(self):
        """LeCun-normal kernels (std fan_in^-0.5), zero biases, BatchNorm at
        (1, 0, 0, 1), the dustbin score at 1; the same seed gives the same
        weights."""
        def make():
            m = tm.MultiViewMatcher(tm.MatcherConfig(**MATCHER_CFG))
            return init_like_flax_(m, torch.Generator().manual_seed(0))

        a, b = make(), make()
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
        w = a.gnn_0_self.mlp.dense_0.weight
        assert abs(float(w.detach().std()) * w.shape[1] ** 0.5 - 1.0) < 0.05
        assert float(a.final_proj.bias.detach().abs().max()) == 0.0
        assert float(a.bin_score.detach()) == 1.0
        bn = a.kenc.bn_0
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                    and (bn.running_mean == 0).all() and (bn.running_var == 1).all())

    def test_random_keypoint_fill(self, rng):
        """With a threshold no detection passes, every slot is filled:
        positions uniform inside the border, scores 0, unit descriptors, the
        same under the same seed and different under another (the JAX fill
        draws other numbers from its own generator, so only the distribution
        is compared); without a generator the fill refuses to run; detected
        slots are those of the run without fill."""
        b, K, H, W = 4, 32, 64, 96
        cfg = dict(SP_CFG, keypoint_threshold=2.0, fill_with_random_keypoints=True)
        sp = tsp.SuperPoint(tsp.SuperPointConfig(**cfg)).eval()
        sp.load_state_dict(build_superpoint()[2].state_dict())
        images = torch.from_numpy(rng.uniform(size=(3, H, W, 1)).astype(np.float32))
        out = sp(images, generator=torch.Generator().manual_seed(5))
        again = sp(images, generator=torch.Generator().manual_seed(5))
        other = sp(images, generator=torch.Generator().manual_seed(6))
        kp = out["keypoints"]
        assert kp.shape == (3, K, 2) and float(out["scores"].abs().max()) == 0.0
        assert float(kp[..., 0].min()) >= b and float(kp[..., 0].max()) < W - 1 - b
        assert float(kp[..., 1].min()) >= b and float(kp[..., 1].max()) < H - 1 - b
        assert float(kp[..., 0].std()) > 0.2 * (W - 2 * b) and not torch.equal(kp, kp.floor())
        assert torch.equal(kp, again["keypoints"]) and not torch.equal(kp, other["keypoints"])
        np.testing.assert_allclose(out["descriptors"].norm(dim=-1).numpy(), 1.0, atol=1e-5)
        with pytest.raises(ValueError, match="Generator"):
            sp(images)
        detect = tsp.SuperPoint(tsp.SuperPointConfig(
            **dict(cfg, keypoint_threshold=SP_CFG["keypoint_threshold"]))).eval()
        detect.load_state_dict(sp.state_dict())
        filled = detect(images, generator=torch.Generator().manual_seed(5))
        plain = build_superpoint()[2](images)
        found = plain["scores"] > 0
        assert bool(found.any())
        assert torch.equal(filled["keypoints"][found], plain["keypoints"][found])
        assert torch.equal(filled["scores"], plain["scores"])
