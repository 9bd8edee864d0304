"""The port's upstream-weight importer against the JAX package's (CPU).

Seeded synthetic state dicts in the upstream layouts (magicleap SuperPoint;
the reference matcher with the DataParallel `module.` prefix, random
BatchNorm statistics and the fork's `conf_mlp` head) go through both
importers: the port's state dicts equal `convert.state_dict_from_flax` of the
JAX import exactly, load with `strict=True`, and the port's forward on them
matches the JAX forward."""

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
from e2e_multi_view_matching_tpu.models import torch_import as jimport  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import matcher as tm  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import torch_import as timport  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

LAYERS = ("self", "cross")
MATCHER_CFG = dict(gnn_layers=LAYERS, sinkhorn_iterations=10, conf_mlp=True,
                   multi_frame_matching=True)


def superpoint_sd(rng):
    """Upstream magicleap SuperPoint shapes (OIHW), small weights."""
    chans = {"conv1a": (64, 1, 3), "conv1b": (64, 64, 3), "conv2a": (64, 64, 3),
             "conv2b": (64, 64, 3), "conv3a": (128, 64, 3), "conv3b": (128, 128, 3),
             "conv4a": (128, 128, 3), "conv4b": (128, 128, 3), "convPa": (256, 128, 3),
             "convPb": (65, 256, 1), "convDa": (256, 128, 3), "convDb": (256, 256, 1)}
    sd = {}
    for name, (o, i, k) in chans.items():
        sd[f"{name}.weight"] = (rng.normal(size=(o, i, k, k)) * 0.05).astype(np.float32)
        sd[f"{name}.bias"] = (rng.normal(size=(o,)) * 0.05).astype(np.float32)
    return sd


def matcher_sd(rng, D=256):
    """Upstream matcher state dict: Conv1d (out, in, 1) weights, BatchNorm1d
    with random running statistics, `module.` prefix, a conf_mlp head."""
    sd = {}

    def mlp(prefix, dims):
        for li in range(len(dims) - 1):
            i, o, ci = dims[li], dims[li + 1], 3 * li
            sd[f"{prefix}.{ci}.weight"] = (rng.normal(size=(o, i, 1)) * i ** -0.5).astype(
                np.float32)
            sd[f"{prefix}.{ci}.bias"] = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
            if li < len(dims) - 2:
                sd[f"{prefix}.{ci + 1}.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
                sd[f"{prefix}.{ci + 1}.bias"] = (rng.normal(size=o) * 0.1).astype(np.float32)
                sd[f"{prefix}.{ci + 1}.running_mean"] = (rng.normal(size=o) * 0.1).astype(
                    np.float32)
                sd[f"{prefix}.{ci + 1}.running_var"] = rng.uniform(0.5, 2.0, o).astype(
                    np.float32)

    mlp("kenc.encoder", (3, 32, 64, 128, 256, D))
    for li in range(len(LAYERS)):
        for name in ("proj.0", "proj.1", "proj.2", "merge"):
            sd[f"gnn.layers.{li}.attn.{name}.weight"] = (
                rng.normal(size=(D, D, 1)) * D ** -0.5).astype(np.float32)
            sd[f"gnn.layers.{li}.attn.{name}.bias"] = (rng.normal(size=D) * 0.1).astype(
                np.float32)
        mlp(f"gnn.layers.{li}.mlp", (2 * D, 2 * D, D))
    sd["final_proj.weight"] = (rng.normal(size=(D, D, 1)) * D ** -0.5).astype(np.float32)
    sd["final_proj.bias"] = (rng.normal(size=D) * 0.1).astype(np.float32)
    sd["bin_score"] = np.asarray(1.3, np.float32)
    mlp("conf_mlp", (2 * D + 1, 256, 64, 1))
    return {f"module.{k}": v for k, v in sd.items()}


def _assert_equal_dicts(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert torch.equal(ours[k], ref[k]), k


def test_superpoint_import_equals_the_jax_import(rng):
    sd = superpoint_sd(rng)
    ours = timport.import_superpoint({k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_equal_dicts(ours, state_dict_from_flax(jimport.import_superpoint(sd)))
    model = tsp.SuperPoint(tsp.SuperPointConfig(max_keypoints=32,
                                                fill_with_random_keypoints=False))
    model.load_state_dict(ours, strict=True)
    image = rng.uniform(size=(1, 64, 64, 1)).astype(np.float32)
    ref = jsp.SuperPoint(jsp.SuperPointConfig(max_keypoints=32,
                                              fill_with_random_keypoints=False)).apply(
        jimport.import_superpoint(sd), jnp.asarray(image))
    with torch.no_grad():
        out = model(torch.from_numpy(image))
    np.testing.assert_allclose(out["descriptors"].numpy(), np.asarray(ref["descriptors"]),
                               atol=1e-5)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_matcher_import_equals_the_jax_import(rng, as_tensors):
    """numpy arrays or torch tensors (what `torch.load` gives) in; the JAX
    import bridged by `state_dict_from_flax` out, bit for bit."""
    sd = matcher_sd(rng)
    src = {k: torch.from_numpy(v) for k, v in sd.items()} if as_tensors else sd
    ours = timport.import_matcher(src, LAYERS)
    _assert_equal_dicts(ours, state_dict_from_flax(jimport.import_matcher(sd, LAYERS)))
    tm.MultiViewMatcher(tm.MatcherConfig(**MATCHER_CFG)).load_state_dict(ours, strict=True)


def test_imported_matcher_forward_matches_jax(rng):
    """Two GNN layers on imported weights: probabilities within 1e-5 (relative
    above 1), the same matches, confidences within 1e-5; and the head
    permutation is needed (without it the port's heads would mix channels)."""
    sd = matcher_sd(rng)
    B, V, K = 1, 3, 24
    kpts = rng.uniform(0, 64, size=(B, V, K, 2)).astype(np.float32)
    scores = rng.uniform(size=(B, V, K)).astype(np.float32)
    descs = rng.normal(size=(B, V, K, 256)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    size = np.full((B, V, 2), 64.0, np.float32)
    ref = jm.MultiViewMatcher(jm.MatcherConfig(**MATCHER_CFG)).apply(
        jimport.import_matcher(sd, LAYERS), kpts, scores, descs, size)
    port = tm.MultiViewMatcher(tm.MatcherConfig(**MATCHER_CFG)).eval()
    port.load_state_dict(timport.import_matcher(sd, LAYERS), strict=True)
    with torch.no_grad():
        out = port(*(torch.from_numpy(x) for x in (kpts, scores, descs, size)))
    p, p_ref = out["log_assignment"].exp().numpy(), np.exp(np.asarray(ref["log_assignment"]))
    assert np.max(np.abs(p - p_ref) / np.maximum(p_ref, 1.0)) < 1e-5
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))
    np.testing.assert_allclose(out["conf_scores"].numpy(), np.asarray(ref["conf_scores"]),
                               atol=1e-5)

    unpermuted = timport.import_matcher(sd, LAYERS, num_heads=1)
    port.load_state_dict(unpermuted, strict=True)
    with torch.no_grad():
        wrong = port(*(torch.from_numpy(x) for x in (kpts, scores, descs, size)))
    assert np.max(np.abs(wrong["log_assignment"].numpy()
                         - np.asarray(ref["log_assignment"]))) > 1e-3


def test_import_rejects_what_the_model_lacks(rng):
    """A state dict without a key the model needs fails loudly at import, and
    a missing conf_mlp head fails the strict load of a conf-MLP matcher."""
    sd = matcher_sd(rng)
    broken = {k: v for k, v in sd.items() if "gnn.layers.1.attn.merge" not in k}
    with pytest.raises(KeyError, match="merge"):
        timport.import_matcher(broken, LAYERS)
    no_conf = timport.import_matcher({k: v for k, v in sd.items() if "conf_mlp" not in k},
                                     LAYERS)
    with pytest.raises(RuntimeError, match="conf_mlp"):
        tm.MultiViewMatcher(tm.MatcherConfig(**MATCHER_CFG)).load_state_dict(no_conf)
    assert timport.strip_module_prefix({"module.a.b": 1, "c": 2}) == {"a.b": 1, "c": 2}
