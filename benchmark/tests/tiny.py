"""A copy of the benchmark at CPU-test sizes, and one run of a cell on the
CPU, for the tests: the harness's look for a card is skipped, everything
else of a run is driven as `run.py` drives it."""

import json
import shutil
import time
from pathlib import Path

from benchmark.harness import registry, session

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY_CONFIG = {"image": [64, 64], "eval_keypoints": 32,
               "superpoint": {"max_keypoints": 32},
               "matcher": {"gnn_layers": 1, "cross_attention_layers": 1,
                           "sinkhorn_iterations": 10}}
TINY_TRAFFIC = {"eval_640x640": {"height": 64, "width": 64, "pool_tuples": 8, "eval_batch": 2,
                                 "chunks_per_call": 2},
                "train_480x640_b8": {"height": 64, "width": 64, "batch": 2, "focal": 60.0,
                                     "pool_batches": 4, "warmup_steps": 4, "trace_steps": 2}}


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def tiny_root(tmp):
    """`tmp` holding `BENCHMARK.json` and a copy of `benchmark/` whose
    configurations and traffic are cut to CPU-test sizes and whose cells
    expect no CUDA kernel; returns (root, bench folder)."""
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (bench / "configs").glob("*.json"):
        f.write_text(json.dumps(_merge(json.loads(f.read_text()), TINY_CONFIG)))
    for name, over in TINY_TRAFFIC.items():
        f = bench / "traffic" / f"{name}.json"
        f.write_text(json.dumps(_merge(json.loads(f.read_text()), over)))
    for f in (bench / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["check"]["kernels"] = []  # the plain versions run on the CPU
        if "units" in w["check"]:  # the sub-chunks a short window runs
            w["check"].update(units=1, from_first_units=2)
        f.write_text(json.dumps(w))
    return tmp, bench


def tiny_options(entry):
    """Shrink the training options the entry takes from `cli/train.py` to
    the tiny configuration (the command line fixes ScanNet's widths)."""
    full = entry.options

    def options(run):
        c = run.cell.config
        saved = run.cell.config
        run.cell.config = json.loads(json.dumps(c))
        run.cell.config["superpoint"]["max_keypoints"] = 400
        run.cell.config["matcher"].update(gnn_layers=7, cross_attention_layers=3,
                                          sinkhorn_iterations=100)
        try:
            opt = full(run)
        finally:
            run.cell.config = saved
        opt.max_keypoints = c["superpoint"]["max_keypoints"]
        opt.gnn_layers = c["matcher"]["gnn_layers"]
        opt.cross_attention_layers = c["matcher"]["cross_attention_layers"]
        opt.sinkhorn_iterations = c["matcher"]["sinkhorn_iterations"]
        return opt

    entry.options = options
    return entry


def run_cell(root, bench, name, seed=7, seconds=0.5, trace=0, patch=None):
    """One run of cell `name` on the CPU; `patch(entry)` may break the
    program underneath first. Returns the result dict."""
    cell = registry.cell(root, name, bench=bench)
    entry = registry.entry(cell.workload["entry"], bench=bench)
    if cell.workload["entry"] == "train":
        tiny_options(entry)
    if patch is not None:
        patch(entry)
    readers = {m["name"]: registry.reader(m["name"], bench=bench) for m in cell.per_layer}
    run = session.Run(cell, seed, seconds, trace, "cpu", time.perf_counter())
    return session.execute(run, entry, readers if trace else {})
