"""The benchmark's layout: every name within the allowed characters, cells
and metrics found by name, and a cell and a metric added by adding files."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import registry

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[group]:
            yield item["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert "\n" not in metric["layer"] and 0 < len(metric["layer"]) <= 200
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in SPEC["workloads"]}
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


@pytest.mark.parametrize("workload", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(workload):
    cell = registry.cell(ROOT, workload["name"])
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(workload["why"]) <= 200 and "\n" not in workload["why"]
    for m in cell.per_layer:
        assert callable(registry.reader(m["name"]))
    assert hasattr(registry.entry(cell.workload["entry"]), "check")


def test_a_cell_and_a_metric_are_added_by_adding_files(tmp_path):
    """A copy of the benchmark gains a workload file, a traffic file and a
    metric file, and entries in BENCHMARK.json: the harness finds all three
    by name, and no file that was there changes."""
    import shutil

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cell = dict(spec["workloads"][0], name="megadepth5-eval-b8", traffic="eval_640x640_b8")
    spec["workloads"].append(cell)
    w = json.loads((bench / "workloads" / "megadepth5-eval.json").read_text())
    w["traffic"] = "eval_640x640_b8"
    (bench / "workloads" / "megadepth5-eval-b8.json").write_text(json.dumps(w))
    t = json.loads((bench / "traffic" / "eval_640x640.json").read_text())
    (bench / "traffic" / "eval_640x640_b8.json").write_text(json.dumps({**t, "eval_batch": 8}))
    spec["per_layer"].append({"name": "units.eval", "unit": "units", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "eval_tuples_per_s",
                              "workloads": ["megadepth5-eval-b8"]})
    (bench / "metrics" / "units.eval.py").write_text("def read(run):\n    return run.units\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = registry.cell(tmp_path, "megadepth5-eval-b8", bench=bench)
    assert found.traffic["eval_batch"] == 8
    assert "units.eval" in {m["name"] for m in found.per_layer}
    assert "units.eval" not in {m["name"] for m in registry.cell(tmp_path, "megadepth5-eval",
                                                                 bench=bench).per_layer}
    assert registry.reader("units.eval", bench=bench)(type("R", (), {"units": 3})) == 3
    assert all(p.read_bytes() == b for p, b in before.items())


def test_workload_files_agree_with_benchmark_json(tmp_path):
    import shutil

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["chips"] = 4
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError):
        registry.cell(tmp_path, spec["workloads"][0]["name"], bench=bench)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """No CUDA device: a non-zero exit and no result line."""
    import sys

    import torch

    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SPEC["workloads"][0]["name"], "--seed", "3000000000",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
