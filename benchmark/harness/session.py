"""One run of one cell: set-up, the measured window, the readers, the
correctness check and the result line.

An entry module (`entries/<entry>.py`) provides:

- `setup(run) -> state`: builds the program and the inputs from the seed and
  warms up every shape the window uses; everything up to the window's first
  unit of work counts as set-up;
- `window(run, state) -> (metrics, attempted, failed)`: drives the program
  for `run.seconds` and returns the end-to-end metrics it measured, and sets
  `run.units`, `run.tuples` and `run.window_s`; in a traced run it also
  fills `run.spans` (hooks on the program's modules in the window) and,
  once the window has closed, `run.trace` (a `DeviceTrace` over a bounded
  stretch of the same work);
- `check(run, state) -> [(name, value, limit), ...]`: once the window has
  closed and the peak memory has been read, frees the program's state and
  judges what the timed path produced against the plain reference; the
  readings that no limit holds (the workload's `reported`) go to
  `run.extra["readings"]`.
"""

import math
import sys
import time

# top-level module names that no run may hold once the window has closed:
# the JAX package and JAX itself (the port's name begins with the JAX
# package's, so names are compared whole)
BANNED_MODULES = ("jax", "jaxlib", "flax", "e2e_multi_view_matching_tpu")


class BannedModules(RuntimeError):
    pass


class Run:
    """What a run knows: its arguments, its cell, and what the window left
    for the readers."""

    def __init__(self, cell, seed, seconds, traced, device, t_start):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(traced)
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.trace = None
        self.spans = {}
        self.shapes = None
        self.units = 0  # units of work (sub-chunks or steps) in the window
        self.tuples = 0  # tuples in the window
        self.window_s = None
        self.extra = {}  # entry-specific numbers for the readers


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def execute(run, entry, readers):
    """Run the cell; returns the result dict (printed by `run.py`)."""
    import torch

    state = entry.setup(run)
    run.setup_s = time.perf_counter() - run.t_start
    e2e, attempted, failed = entry.window(run, state)
    found = banned_modules()
    if found:
        raise BannedModules(f"modules loaded in the run: {', '.join(found)}")
    cuda = torch.device(run.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    breakdown = None
    if run.traced:
        for spec in run.cell.per_layer:
            value = readers[spec["name"]](run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        if run.trace is not None and run.trace.ops:
            breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    else:
        e2e = {"setup_s": run.setup_s, **e2e}
        for spec in run.cell.end_to_end:
            if spec["name"] not in e2e:
                raise KeyError(f"entry measured no {spec['name']}")
            metrics[spec["name"]] = {"value": e2e[spec["name"]], "unit": spec["unit"]}
    t_check = time.perf_counter()
    checks = entry.check(run, state)
    run.extra["check_s"] = time.perf_counter() - t_check
    found = banned_modules()
    if found:
        raise BannedModules(f"modules loaded in the run: {', '.join(found)}")
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell.workload["chips"], "memory_peak_bytes": peak}
    if run.traced and run.trace is not None and run.trace.ops:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.wall_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if run.extra.get("readings"):
        result["readings"] = run.extra["readings"]
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result
