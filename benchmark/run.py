"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and the
port (`e2e_multi_view_matching_tpu_torch`). One process is one run: it makes
its weights and inputs from `--seed`, warms up the cell's shapes (set-up),
drives the cell's entry for `--seconds`, judges what the timed path produced
against the plain reference in `reference/`, and prints as its last line of
standard output one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device` and, last, `checks` (each compared number with its
limit, also the last lines of standard error). With `--trace 1` it also
gives `breakdown`. It exits non-zero, printing no result, without a CUDA
device, without the cards the cell asks for, outside a checkout with the
port, or when JAX or the JAX package is loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def cache_dirs(root):
    """Keep every build and kernel cache inside the checkout, at fixed paths
    (the port's own nvcc builds go to `<root>/build/cuda`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "torchinductor")):
        os.environ[var] = str(root / "build" / sub)


def main(argv=None):
    args = parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import registry, session

    cell = registry.cell(ROOT, args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"a run of {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    entry = registry.entry(cell.workload["entry"])
    readers = {m["name"]: registry.reader(m["name"]) for m in cell.per_layer} if args.trace else {}
    run = session.Run(cell, args.seed, args.seconds, args.trace, "cuda", T_START)
    try:
        result = session.execute(run, entry, readers)
    except session.BannedModules as err:
        print(err, file=sys.stderr)
        return 3
    times = run.extra.get("unit_s", [])
    cpu = run.extra.get("unit_cpu_s", [])
    print(f"timing setup_s {run.setup_s:.3f} window_s {run.window_s:.3f} "
          f"check_s {run.extra.get('check_s', 0.0):.3f} units {len(times)} unit_s "
          f"{' '.join(f'{x:.3f}' for x in times)}"
          + (f" unit_cpu_s {' '.join(f'{x:.3f}' for x in cpu)}" if cpu else ""), file=sys.stderr)
    for name, value in result.get("readings", {}).items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
