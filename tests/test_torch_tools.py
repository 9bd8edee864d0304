"""The port's data and weight tools against the JAX package's (CPU):
`cli/convert_megadepth.py` on a synthetic MegaDepth tree, and
`tools/torch_import_weights.py` on upstream-layout checkpoint files."""

import importlib.util
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from test_torch_weights_import import matcher_sd, superpoint_sd  # noqa: E402

from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.matcher import (  # noqa: E402
    MatcherConfig,
    MultiViewMatcher,
    default_gnn_layers,
)
from e2e_multi_view_matching_tpu_torch.models.superpoint import (  # noqa: E402
    SuperPoint,
    SuperPointConfig,
)
from e2e_multi_view_matching_tpu_torch.train.checkpoint import (  # noqa: E402
    load_config,
    load_eval_weights,
)
from tests.torch_memory import teardown_module  # noqa: E402,F401

try:  # the converter's fixture needs h5py; the import tool does not
    from test_convert_megadepth import megadepth_tree  # noqa: F401
except pytest.skip.Exception:
    megadepth_tree = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.skipif(megadepth_tree is None, reason="h5py is not installed")
def test_convert_megadepth_equals_jax(megadepth_tree, tmp_path):
    """Both converters on copies of one synthetic MegaDepth tree (5 images,
    scene_info npz, h5 depths), and each a second time (it resumes): the same
    files, equal JPEG bytes, h5 depth arrays, intrinsic/pose text and split
    lists, and equal overlap JSON."""
    import h5py

    from e2e_multi_view_matching_tpu.cli import convert_megadepth as jconv
    from e2e_multi_view_matching_tpu_torch.cli import convert_megadepth as tconv

    root, scene, n = megadepth_tree
    ours = str(tmp_path / "port" / "megadepth")
    shutil.copytree(root, ours)
    for conv, src in ((jconv, root), (tconv, ours)):
        for _ in range(2):
            conv.main(["--dataset_dir", src, "--image_size", "48", "--n_workers", "1"])
    out_j, out_t = f"{root}_48", f"{ours}_48"
    files = _files(out_j)
    assert files == _files(out_t)
    assert f"scans/{scene}/depth/{n - 1}.h5" in files
    assert f"overlap/scans/{scene}.json" in files
    for rel in files:
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        if rel.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                da, db = np.asarray(fa["depth"]), np.asarray(fb["depth"])
            assert da.dtype == db.dtype and da.shape == db.shape, rel
            np.testing.assert_array_equal(da, db)
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        else:  # JPEG, intrinsic / pose text, split lists
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.fixture(scope="module")
def upstream_files(tmp_path_factory):
    """An upstream SuperPoint state dict and a matcher training checkpoint
    (`module.` prefix, BatchNorm statistics, conf MLP, optimizer state) saved
    with `torch.save`, and a weights bundle zip holding both."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("upstream")
    sp, m = str(d / "superpoint_v1.pth"), str(d / "model.ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in superpoint_sd(rng).items()}, sp)
    torch.save({"epoch": 3, "model": {k: torch.from_numpy(v)
                                      for k, v in matcher_sd(rng).items()},
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0, 1]}]},
                "min_val_loss": 0.5, "pose_match_ratio": 0.1}, m)
    bundle = str(d / "pretrained_network_weights.zip")
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.write(sp, "weights/superpoint_v1.pth")
        zf.write(m, "weights/scannet/model.ckpt")
    return {"superpoint": sp, "matcher": m, "zip": bundle}


@pytest.mark.parametrize("source", ["files", "zip"])
def test_import_tool_equals_jax(upstream_files, tmp_path, source):
    """`tools/torch_import_weights.py` and the JAX package's
    `tools/import_weights.py` with the same flags on the same files (or the
    bundle zip): superpoint.ckpt and model.ckpt's matcher equal
    `state_dict_from_flax` of JAX's files bit for bit, cfg.json equal, and
    `load_eval_weights` reads the port's directory with nothing missing."""
    from flax import serialization

    flags = ["--gnn_layers", "1", "--cross_attention_layers", "1", "--tuple_size", "5"]
    if source == "files":
        flags += ["--superpoint", upstream_files["superpoint"],
                  "--matcher", upstream_files["matcher"]]
    else:
        flags += ["--weights_zip", upstream_files["zip"]]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _load_tool("import_weights").main(flags + ["--out_dir", jax_dir])
    written = _load_tool("torch_import_weights").main(flags + ["--out_dir", port_dir])
    assert sorted(written) == ["model.ckpt", "superpoint.ckpt"]

    def flax_file(name):
        with open(os.path.join(jax_dir, name), "rb") as f:
            return serialization.msgpack_restore(f.read())

    model = torch.load(os.path.join(port_dir, "model.ckpt"), weights_only=True)
    jmodel = flax_file("model.ckpt")
    pairs = [(torch.load(os.path.join(port_dir, "superpoint.ckpt"), weights_only=True),
              state_dict_from_flax(flax_file("superpoint.ckpt"))),
             (model["model"], state_dict_from_flax(
                 {"params": jmodel["params"], "batch_stats": jmodel["batch_stats"]}))]
    for ours, ref in pairs:
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k
    assert model["epoch"] == 0 and model["step"] == 0
    assert load_config(port_dir) == load_config(jax_dir)

    matcher = MultiViewMatcher(MatcherConfig(gnn_layers=default_gnn_layers(1, 1),
                                             conf_mlp=True, multi_frame_matching=True))
    assert load_eval_weights(port_dir, SuperPoint(SuperPointConfig()), matcher) == []
    for k, v in pairs[1][1].items():
        assert torch.equal(matcher.state_dict()[k], v), k


def test_import_tool_refuses_an_empty_call(tmp_path):
    with pytest.raises(SystemExit, match="nothing to import"):
        _load_tool("torch_import_weights").main(["--out_dir", str(tmp_path)])
