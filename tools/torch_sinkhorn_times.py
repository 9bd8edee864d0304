#!/usr/bin/env python3
"""Device times of the PyTorch/CUDA port's log-domain Sinkhorn kernels in one
checkout of the repository, on one NVIDIA GPU.

    python3 tools/torch_sinkhorn_times.py --root DIR

Imports `e2e_multi_view_matching_tpu_torch` from DIR (so the same command
times a parent checkout and a change side by side in one call), builds its
kernels there, and times `sinkhorn_log` and `sinkhorn_log_stash` on 80 pair
matrices of 401 x 401 and of 1025 x 1025 (the training shapes at K = 400
and K = 1024), 100 iterations, seeded scores of scale 4 (CUDA events, one
warm-up and three launches). Prints one JSON line per shape with the card's
name and power limit. Exits non-zero without a CUDA device. Imports no JAX.
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="checkout holding the port's package")
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
    B, T = 80, 100
    for n in (401, 1025):
        scores = torch.randn(B, n - 1, n - 1, generator=g, device=dev) * 4.0
        C, log_mu, log_nu, norm = ts.augment_couplings(scores, torch.ones((), device=dev))
        del scores
        ms_log = cuda_ms(lambda: sc.sinkhorn_log(C, log_mu, log_nu, T, norm), 3)
        ms_st = cuda_ms(lambda: sc.sinkhorn_log_stash(C, log_mu, log_nu, T, norm), 3)
        print(json.dumps({"root": str(root), "shape": [B, n, n, T], "sinkhorn_log_ms": ms_log,
                          "sinkhorn_log_stash_ms": ms_st, "card": card}), flush=True)
        del C, log_mu, log_nu
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
