#!/usr/bin/env python3
"""Device times of the PyTorch/CUDA port's Sinkhorn kernels in one checkout
of the repository, on one NVIDIA GPU.

    python3 tools/torch_sinkhorn_times.py --root DIR [--kernel log|scaling]
        [--cluster_counts]

Imports `e2e_multi_view_matching_tpu_torch` from DIR (so the same command
times a parent checkout and a change side by side in one call), builds its
kernels there, and times, 100 iterations, seeded scores of scale 4 (CUDA
events, one warm-up and three launches):

- `--kernel log` (the default): `sinkhorn_log` and `sinkhorn_log_stash` on
  80 pair matrices of 401 x 401 and of 1025 x 1025 (the training shapes at
  K = 400 and K = 1024);
- `--kernel scaling`: `sinkhorn_scaling` on 80 of 401 x 401 and of 1025 x
  1025 and, where DIR's plan takes them, on 8 and 80 of 2049 x 2049 (the
  eval shapes at K = 400, 1024, 2048), with the plan it launched. With
  `--cluster_counts` the streamed shapes also time the solve alone at other
  numbers of persistent clusters: as many as `L2_BUDGET_BYTES` holds
  matrices, and as many as fit on the card; each must give the planned
  launch's bits.

Prints one JSON line per shape with the card's name and power limit. Exits
non-zero without a CUDA device. Imports no JAX.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _scaling_at(sc, C, log_mu, log_nu, T, norm, plan):
    """The scaling solve launched with `plan` through the library's entry
    point (not the wrapper: no launch is counted)."""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import cuda_build

    lib = cuda_build.load("sinkhorn_cuda", sc._SIGNATURES)
    B, M, N = C.shape
    out = torch.empty_like(C)
    K = C.new_empty(plan["workspace"].get("K", (0,)))
    rc = lib.sinkhorn_scaling(*(t.data_ptr() for t in (C, log_mu, log_nu, out, K)), B, M, N,
                              T, sc.ABSORB_EVERY, float(norm), *sc._plan_args(plan),
                              torch.cuda.current_stream().cuda_stream)
    sc._raise_on(rc, "sinkhorn_scaling")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="checkout holding the port's package")
    parser.add_argument("--kernel", choices=("log", "scaling"), default="log")
    parser.add_argument("--cluster_counts", action="store_true",
                        help="scaling: also time streamed shapes at other cluster counts")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_sinkhorn_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as ts
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    T = 100
    shapes = ((80, 401), (80, 1025))
    if args.kernel == "scaling":
        shapes += ((8, 2049), (80, 2049))
    for B, n in shapes:
        if args.kernel == "scaling":
            try:
                sc.cluster_plan("scaling", B, n, n)
            except ValueError:  # wider than DIR's kernel takes
                continue
        scores = torch.randn(B, n - 1, n - 1, generator=g, device=dev) * 4.0
        C, log_mu, log_nu, norm = ts.augment_couplings(scores, torch.ones((), device=dev))
        del scores
        line = {"root": str(root), "shape": [B, n, n, T]}
        if args.kernel == "log":
            line["sinkhorn_log_ms"] = cuda_ms(
                lambda: sc.sinkhorn_log(C, log_mu, log_nu, T, norm), 3)
            line["sinkhorn_log_stash_ms"] = cuda_ms(
                lambda: sc.sinkhorn_log_stash(C, log_mu, log_nu, T, norm), 3)
        else:
            z = sc.sinkhorn_scaling(C, log_mu, log_nu, T, norm)
            line["sinkhorn_scaling_ms"] = cuda_ms(
                lambda: sc.sinkhorn_scaling(C, log_mu, log_nu, T, norm), 3)
            plan = sc.kernel_plan("scaling", B, n, n)
            line["plan"] = {k: plan[k] for k in ("cluster_size", "resident", "n_clusters",
                                                 "clusters_that_fit", "column_slots")}
            if args.cluster_counts and not plan["resident"]:
                by_count = {}
                for count in sorted({max(1, int(sc.L2_BUDGET_BYTES // (4 * n * n))),
                                     plan["n_clusters"], plan["clusters_that_fit"]}):
                    other = {**plan, "n_clusters": min(B, count)}
                    solve = lambda: _scaling_at(sc, C, log_mu, log_nu, T, norm, other)  # noqa: E731
                    if not torch.equal(solve(), z):
                        print(f"torch_sinkhorn_times: {count} clusters give other bits at "
                              f"{line['shape']}", file=sys.stderr)
                        return 1
                    by_count[str(min(B, count))] = cuda_ms(solve, 3)
                line["solve_ms_by_clusters"] = by_count
            del z
        print(json.dumps({**line, "card": card}), flush=True)
        del C, log_mu, log_nu
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
