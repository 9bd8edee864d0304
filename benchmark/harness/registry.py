"""Cells, configurations, traffic, entries and metric readers, found by name.

`BENCHMARK.json` at the checkout's root lists the cells and metrics. Each
cell `<cell>` has `workloads/<cell>.json` (its configuration, traffic,
entry, chips, why and the limits of its correctness check); its
configuration lives in the file that `BENCHMARK.json` names, its traffic in
`traffic/<traffic>.json`, its entry in `entries/<entry>.py`, and each
per-layer metric `<metric>` in `metrics/<metric>.py`, a module with
`read(run)`. Adding a cell, a configuration or a metric adds files and
entries; no file here names one.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    workload: dict  # workloads/<cell>.json
    config: dict  # the configuration file
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json metrics this cell reports
    per_layer: list


def _read(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell, reported=None):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell(root, name, bench=BENCH):
    """The `Cell` named `name` of the benchmark at `root`; raises KeyError
    for a cell `BENCHMARK.json` does not list, ValueError where its files
    disagree with it."""
    spec = _read(Path(root) / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _read(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {workload[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = _read(Path(root) / conf["file"])
    traffic = _read(bench / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name, workload, config, traffic, e2e, per_layer)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name, bench=BENCH):
    """The entry module `entries/<name>.py`."""
    return _module(bench / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def reader(name, bench=BENCH):
    """The `read(run)` of the per-layer metric `metrics/<name>.py`."""
    return _module(bench / "metrics" / f"{name}.py",
                   "benchmark_metric_" + name.replace(".", "_").replace("-", "_")).read
