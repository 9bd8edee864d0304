"""Nothing under `benchmark/` imports JAX or the JAX package, and the plain
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "e2e_multi_view_matching_tpu"}
PORT = "e2e_multi_view_matching_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & BANNED


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_imports(path))
    assert "benchmark" not in set(_imports(path))  # nor the harness around it


def test_top_level_names_compared_whole():
    from benchmark.harness import session

    assert "e2e_multi_view_matching_tpu" in session.BANNED_MODULES
    assert PORT not in session.BANNED_MODULES
