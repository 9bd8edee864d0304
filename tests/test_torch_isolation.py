"""The PyTorch port stands alone: it imports neither JAX nor flax nor anything
of the JAX package, and its entry points refuse to fall back to the CPU."""

import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import eval_pairs  # noqa: E402
from e2e_multi_view_matching_tpu_torch.cli import train as train_cli  # noqa: E402
from e2e_multi_view_matching_tpu_torch.mvba import pipeline  # noqa: E402
from e2e_multi_view_matching_tpu_torch.utils import config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, ROOT)
import e2e_multi_view_matching_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "e2e_multi_view_matching_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _PROBE],
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 30, result["modules"]
    # the walk reaches a subpackage only through its __init__.py
    for name in ("train.step", "train.optim", "train.checkpoint", "train.losses",
                 "data.gt_matches", "data.synthetic", "cli.train", "utils.trackers",
                 "geom.linalg", "geom.eightpoint", "ops.attention_cuda", "data.tuples",
                 "data.scannet", "data.sampling", "utils.tblog", "models.torch_import",
                 "cli.eval_pairs", "data.pairs", "geom.ransac", "cli.convert_megadepth",
                 "mvba.spanning_tree", "mvba.pipeline", "parallel.mesh",
                 "mvba.distributed", "data.native_loader"):
        assert f"e2e_multi_view_matching_tpu_torch.{name}" in result["modules"], name
    assert result["bad"] == [], f"the port pulled in {result['bad']}"


def _imports(path):
    """(the modules every import statement of `path` names, at any depth,
    and the parsed tree)."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names, tree


def _jax_side(names):
    return sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                                          "e2e_multi_view_matching_tpu"))


def test_chip_smoke_imports_no_jax_and_nothing_of_the_jax_package():
    """Every import statement of `chip_smoke.py`, at any depth (it imports
    most modules inside its phases), names torch, numpy, the standard library
    or the port, never JAX, flax or the JAX package."""
    names, tree = _imports("chip_smoke.py")
    assert "e2e_multi_view_matching_tpu_torch.ops.attention_cuda" in {
        f"{n}.{a.name}" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
        for n in [node.module] for a in node.names}
    bad = _jax_side(names)
    assert bad == [], f"chip_smoke.py imports {bad}"


@pytest.mark.parametrize("path", ["tests/test_torch_kernels_cuda.py",
                                  "tests/test_torch_sinkhorn_cuda.py"])
def test_card_test_files_import_no_jax(path):
    """The card's kernel tests run where JAX is not installed: their files
    import torch, pytest, the standard library and the port only."""
    names, _ = _imports(path)
    assert any(n.startswith("e2e_multi_view_matching_tpu_torch") for n in names)
    bad = _jax_side(names)
    assert bad == [], f"{path} imports {bad}"


_TOOL_PROBE = """
import importlib, importlib.util, json, sys
sys.path.insert(0, ROOT)
spec = importlib.util.spec_from_file_location("tool", ROOT + "/tools/torch_import_weights.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in NAMES:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "e2e_multi_view_matching_tpu"))))
"""


def test_import_tool_imports_no_jax():
    """`tools/torch_import_weights.py` names torch, the standard library and the
    port in its import statements, at any depth (its `main()` imports the port's
    modules), and a process that loads it and imports every module it names
    holds no JAX, flax or JAX-package module."""
    names, _ = _imports("tools/torch_import_weights.py")
    assert "e2e_multi_view_matching_tpu_torch.models.torch_import" in names
    assert _jax_side(names) == [], f"the tool imports {_jax_side(names)}"
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\nNAMES = {sorted(names)!r}\n" + _TOOL_PROBE],
        capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_NATIVE_PROBE = """
import json, os, sys
from pathlib import Path
sys.path.insert(0, ROOT)
from e2e_multi_view_matching_tpu_torch.data import native_loader as nl
default_build = nl.BUILD_DIR
nl.BUILD_DIR = Path(SCRATCH) / "build"
os.environ["CXX"] = FAKE_CXX
assert not nl.available()
for name in ("_lib", "_tool", "_error"):
    setattr(nl, name, None)
nl.BUILD_DIR = default_build
del os.environ["CXX"]
assert nl.available()
tool = nl.overlap_tool()
maps = [line.split()[-1] for line in open("/proc/self/maps") if "libemvm_native" in line]
print(json.dumps({"maps": sorted(set(maps)), "tool": tool, "build": str(default_build)}))
"""

_FAKE_CXX = """#!{python}
import json, sys
with open({log!r}, "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
sys.exit(1)
"""


def test_native_runtime_is_built_and_loaded_from_the_ports_own_copy(tmp_path):
    """The port never names the JAX package's `native/` tree: no module joins
    "native" with "build", "src" or "tools" or writes such a path, and every
    C++ include resolves inside the port's own `native/`; the
    compiler is handed the sources under the port's `native/` and writes into
    `build/native/` (a recording compiler that fails shows both), and the
    process that loads the library maps `libemvm_native` from `build/native/`
    at the repository root only."""
    pkg = os.path.join(ROOT, "e2e_multi_view_matching_tpu_torch")
    joined = re.compile(r"[\"']native[\"']\s*[,/]\s*[\"'](build|src|tools)[\"']"
                        r"|[\"'][^\"'\n]*\bnative/(build|src|tools)")
    native = os.path.join(pkg, "native", "")
    for d, _, files in os.walk(pkg):
        for f in files:
            text = open(os.path.join(d, f)).read() if f.endswith((".py", ".cpp", ".h")) else ""
            if f.endswith(".py"):
                assert not joined.search(text), (f, joined.search(text).group(0))
            for inc in re.findall(r'#include "([^"]+)"', text):
                assert os.path.realpath(os.path.join(d, inc)).startswith(native), (f, inc)
    log = tmp_path / "cxx.log"
    fake = tmp_path / "fake-c++"
    fake.write_text(_FAKE_CXX.format(python=sys.executable, log=str(log)))
    fake.chmod(0o755)
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\nSCRATCH = {str(tmp_path)!r}\n"
         f"FAKE_CXX = {str(fake)!r}\n" + _NATIVE_PROBE],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(calls) == 2  # the library and the tool, side by side
    for argv in calls:
        sources = [a for a in argv if a.endswith(".cpp")]
        target = argv[argv.index("-o") + 1]
        assert sources and all(a.startswith(os.path.join(pkg, "native", "")) for a in sources)
        assert target.startswith(str(tmp_path / "build") + os.sep)
    build = os.path.join(ROOT, "build", "native")
    assert result["build"] == build
    assert result["maps"] and all(m.startswith(build + os.sep) for m in result["maps"])
    assert result["tool"].startswith(build + os.sep)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """Asked for the default device "cuda" with no GPU, the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device()
    opt = types.SimpleNamespace(tuple_size=2, max_tuples=None, eval_batch=1, eval_scan=1,
                                no_pipeline=False, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_multi_view.evaluate(opt, torch.nn.Identity(), torch.nn.Identity(), [])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_pairs.evaluate(types.SimpleNamespace(eval_mode="w8pt_ba", max_pairs=None),
                            torch.nn.Identity(), torch.nn.Identity(), [])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.train(train_cli.parse_args([]), None, None)
    for mode in ("w8pt_ba", "ransac"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.multi_view_pose_pipeline_batch(
                None, None, None, None, pipeline.MultiViewPipelineConfig(init_mode=mode))
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_auto_kernels_follow_the_device():
    opt = types.SimpleNamespace(attention_impl="auto", sinkhorn_impl="auto")
    config.resolve_kernel_impls(opt, "cuda")
    assert (opt.attention_impl, opt.sinkhorn_impl) == ("cuda", "cuda")
    opt = types.SimpleNamespace(attention_impl="auto", sinkhorn_impl="mxu")
    config.resolve_kernel_impls(opt, "cpu")
    assert (opt.attention_impl, opt.sinkhorn_impl) == ("xla", "mxu")
