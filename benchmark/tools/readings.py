"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --program_seeds 1,2,...
        [--control_seeds 7,8,9] [--faults half_batch] [--chain_seeds 5]
        [--seconds 8] [--out f.jsonl]

In one process: for each program seed, a run of the cell as `run.py` makes
it (set-up, a window of `--seconds`, the check), its readings printed
without their limits; for each control seed, the readings of the control
(the reference with TF32 on in the program's place) and of each planted
fault (`entries/<entry>.py::control`); for each chain seed, a run whose
check is replaced by the reference from the images through the pose stage
on its own outputs (`chain`, eval only). One JSON line per run, also
appended to `--out`. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program_seeds", type=_seeds, default=[])
    parser.add_argument("--control_seeds", type=_seeds, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--chain_seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmark"))
    import torch

    from benchmark.harness import registry, session
    from run import cache_dirs

    cache_dirs(ROOT)
    cell = registry.cell(ROOT, args.workload)
    entry = registry.entry(cell.workload["entry"])

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.program_seeds:
        run = session.Run(cell, seed, args.seconds, 0, "cuda", time.perf_counter())
        state = entry.setup(run)
        setup_s = time.perf_counter() - run.t_start
        e2e, attempted, failed = entry.window(run, state)
        t0 = time.perf_counter()
        checks = entry.check(run, state)
        emit({"kind": "program", "seed": seed, "setup_s": setup_s, "e2e": e2e,
              "attempted": attempted, "failed": failed, "check_s": time.perf_counter() - t0,
              "readings": {n: v for n, v, _ in checks}})
        del state
        torch.cuda.empty_cache()
    for seed in args.chain_seeds:
        run = session.Run(cell, seed, args.seconds, 0, "cuda", time.perf_counter())
        state = entry.setup(run)
        entry.window(run, state)
        t0 = time.perf_counter()
        readings = entry.chain(run, state)
        emit({"kind": "chain", "seed": seed, "seconds": time.perf_counter() - t0,
              "readings": readings})
        del state
        torch.cuda.empty_cache()
    faults = [f for f in args.faults.split(",") if f]
    for seed in args.control_seeds:
        run = session.Run(cell, seed, args.seconds, 0, "cuda", time.perf_counter())
        for fault in [None] + faults:
            t0 = time.perf_counter()
            if cell.workload["entry"] == "eval_multi_view":
                readings = entry.control(run, entry.check_units(run), fault)
            else:
                readings = entry.control(run, fault)
            emit({"kind": fault or "control", "seed": seed, "seconds": time.perf_counter() - t0,
                  "readings": readings})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
