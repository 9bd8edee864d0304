#!/usr/bin/env python3
"""Device times of the PyTorch/CUDA port's bfloat16 attention kernels in one
checkout of the repository, on one NVIDIA GPU.

    python3 tools/torch_attn_bf16_times.py --root DIR [--kernels fwd|train|all]
                                           [--check] [--reps N]

Imports `e2e_multi_view_matching_tpu_torch` from DIR (so the same command times
a parent checkout and a change side by side in one call), builds its kernels
there, and times `attn_fwd_bf16` (mode full, the self layers' call) and
`cross_attn_fwd_bf16` at every shape of their paths, on seeded bfloat16 q, k,
v (CUDA events, one warm-up and `--reps` launches): bf16 eval (160 x 1024 x 64
and 32 x 5120 x 64), bf16 validation (160 x 400 x 64 and 32 x 2000 x 64), the
pair benchmark (64 x 1024 x 64, 32 x 2048 x 64; 64 x 2048 x 64, 32 x 4096 x
64) and the multi-view evaluation at K = 2048 (160 x 2048 x 64, 32 x 10240 x
64); beside each, SDPA on the same bfloat16 inputs and mask (one PyTorch call,
a yardstick). With `--check`, each output is also held to the one-ulp gate of
the plain twin (`ops/attention_cuda.py::bf16_ulp_error`) on its first slices.

`--kernels train` times the training kernels instead: `cross_attn_fwd_lse_bf16`,
`cross_attn_bwd_dq_bf16` and `cross_attn_bwd_dkv_bf16` at the bf16 training
shape (32 x 2000 x 64) and at the eval and pair shapes the kernel phase of
`chip_smoke.py` records them at (32 x 5120, 32 x 2048, 32 x 4096 x 64), on
seeded bfloat16 q, k, v, dO, the tree's own float32 LSE and dvec = rowsum(dO
O); with `--check` the output and LSE (1e-5) and the gradients (the backward's
gate, `cross_attn_bwd_bf16_slack`) against the plain twins; beside each shape
SDPA's forward and its backward through autograd (dq, dk, dv together), and a
line with dq + dk/dv (the sum of the two kernels' times) beside that backward.
`--kernels all` times both sets.

Prints one JSON line per shape and one with the card's name and power limit.
Exits non-zero without a CUDA device or on a failed check. Imports no JAX.
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

# (kernel, path, BH, n_views, K): BH = batch x 4 heads, dh = 64
SHAPES = (
    ("attn_fwd_bf16", "eval", 160, 1, 1024),
    ("cross_attn_fwd_bf16", "eval", 32, 5, 1024),
    ("attn_fwd_bf16", "validation", 160, 1, 400),
    ("cross_attn_fwd_bf16", "validation", 32, 5, 400),
    ("attn_fwd_bf16", "pairs, K = 1024", 64, 1, 1024),
    ("cross_attn_fwd_bf16", "pairs, K = 1024", 32, 2, 1024),
    ("attn_fwd_bf16", "pairs, K = 2048", 64, 1, 2048),
    ("cross_attn_fwd_bf16", "pairs, K = 2048", 32, 2, 2048),
    ("attn_fwd_bf16", "multi-view, K = 2048", 160, 1, 2048),
    ("cross_attn_fwd_bf16", "multi-view, K = 2048", 32, 5, 2048),
)
# (path, BH, n_views, K) of the training kernels
TRAIN_SHAPES = (("train", 32, 5, 400), ("eval, K = 1024", 32, 5, 1024),
                ("pairs, K = 1024", 32, 2, 1024), ("pairs, K = 2048", 32, 2, 2048))


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


def time_training_kernels(ac, root, check, reps):
    """JSON records of the three training kernels at TRAIN_SHAPES; (records,
    failed)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    dh, failed, records = 64, False, []
    for path, BH, V, K in TRAIN_SHAPES:
        S = V * K
        g = torch.Generator(device=dev).manual_seed(BH * 100003 + S + 1)
        q, k, v, do = (torch.randn(BH, S, dh, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        scale = 1.0 / math.sqrt(dh)
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        dvec = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, dvec, V, K, scale)
        runs = {"cross_attn_fwd_lse_bf16": lambda: ac.cross_attn_fwd_lse(q, k, v, V, K, scale),
                "cross_attn_bwd_dq_bf16": lambda: ac.cross_attn_bwd_dq(*args),
                "cross_attn_bwd_dkv_bf16": lambda: ac.cross_attn_bwd_dkv(*args)}
        gates = {}
        if check:
            nb = max(1, min(BH, int(2 ** 28 // (S * S))))
            sub = (q[:nb], k[:nb], v[:nb], do[:nb], lse[:nb], dvec[:nb], V, K, scale)
            o_ref, lse_ref = ac.cross_attn_fwd_lse_plain(q[:nb], k[:nb], v[:nb], V, K, scale)
            abs_scale = ac.plain_view_attention(q[:nb].float(), k[:nb].float(),
                                                v[:nb].float().abs(), 1, V, K, "cross")
            o2, lse2 = runs["cross_attn_fwd_lse_bf16"]()
            gates["cross_attn_fwd_lse_bf16"] = {
                "ulp_gate": ac.bf16_ulp_error(o[:nb], o_ref, abs_scale),
                "lse_abs_err": float((lse[:nb] - lse_ref).abs().max()),
                "same_bits": bool(torch.equal(o, o2) and torch.equal(lse, lse2))}
            del o_ref, lse_ref, abs_scale, o2, lse2
            refs, slack = ac.cross_attn_bwd_plain(*sub), ac.cross_attn_bwd_bf16_slack(*sub)
            dq, dq2 = runs["cross_attn_bwd_dq_bf16"](), runs["cross_attn_bwd_dq_bf16"]()
            gates["cross_attn_bwd_dq_bf16"] = {
                "ulp_gate": ac.bf16_ulp_error(dq[:nb], refs[0], *slack[0]),
                "same_bits": bool(torch.equal(dq, dq2))}
            (dk, dv), (dk2, dv2) = runs["cross_attn_bwd_dkv_bf16"](), runs["cross_attn_bwd_dkv_bf16"]()
            gates["cross_attn_bwd_dkv_bf16"] = {
                "ulp_gate": max(ac.bf16_ulp_error(dk[:nb], refs[1], *slack[1]),
                                ac.bf16_ulp_error(dv[:nb], refs[2], *slack[2])),
                "same_bits": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))}
            del refs, slack, dq, dq2, dk, dv, dk2, dv2
            for rec in gates.values():
                failed |= not (rec["ulp_gate"] <= 1.0 and rec["same_bits"]
                               and rec.get("lse_abs_err", 0.0) <= 1e-5)
        mask = ac.cross_view_mask(V, K, device=dev)
        q4, k4, v4 = (x[:, None].clone().requires_grad_() for x in (q, k, v))
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                           reps)
        out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do[:, None],
                                                       retain_graph=True), reps)
        del out, q4, k4, v4
        ms = {}
        for name, run in runs.items():
            ms[name] = cuda_ms(run, reps)
            rec = {"kernel": name, "path": path, "shape": [BH, S, dh], "root": str(root),
                   **gates.get(name, {}), "ms": ms[name]}
            rec["sdpa_ms" if name == "cross_attn_fwd_lse_bf16" else "sdpa_bwd_ms"] = (
                sdpa_fwd if name == "cross_attn_fwd_lse_bf16" else sdpa_bwd)
            records.append(rec)
            print(json.dumps(rec), flush=True)
        rec = {"kernel": "dq + dk/dv", "path": path, "shape": [BH, S, dh], "root": str(root),
               "ms": ms["cross_attn_bwd_dq_bf16"] + ms["cross_attn_bwd_dkv_bf16"],
               "sdpa_bwd_ms": sdpa_bwd}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, dvec, args, runs
        torch.cuda.empty_cache()
    return records, failed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="checkout whose port is timed")
    parser.add_argument("--kernels", choices=("fwd", "train", "all"), default="fwd")
    parser.add_argument("--check", action="store_true", help="hold each output to the gate")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac

    assert Path(ac.__file__).resolve().is_relative_to(root), ac.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    dh, failed = 64, False
    for name, path, BH, V, K in SHAPES if args.kernels != "train" else ():
        S = V * K
        g = torch.Generator(device=dev).manual_seed(BH * 100003 + S)
        q, k, v = (torch.randn(BH, S, dh, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        scale = 1.0 / math.sqrt(dh)
        if name == "attn_fwd_bf16":
            run = lambda: ac.attn_fwd(q, k, v, K, "full", scale)  # noqa: E731
            mask, mode = None, "full"
        else:
            run = lambda: ac.cross_attn_fwd(q, k, v, V, K, scale)  # noqa: E731
            mask, mode = ac.cross_view_mask(V, K, device=dev), "cross"
        rec = {"kernel": name, "path": path, "shape": [BH, S, dh], "root": str(root)}
        if args.check:
            nb = max(1, min(BH, int(2 ** 28 // (S * S))))
            out = run()[:nb]
            ref = ac.plain_view_attention(q[:nb], k[:nb], v[:nb], 1, V, K, mode)
            abs_scale = ac.plain_view_attention(q[:nb].float(), k[:nb].float(),
                                                v[:nb].float().abs(), 1, V, K, mode)
            rec["ulp_gate"] = ac.bf16_ulp_error(out, ref, abs_scale)
            rec["same_bits"] = bool(torch.equal(run(), run()))
            failed |= not (rec["ulp_gate"] <= 1.0 and rec["same_bits"])
            del out, ref, abs_scale
        rec["ms"] = cuda_ms(run, args.reps)
        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        rec["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                          attn_mask=mask),
                                 args.reps)
        print(json.dumps(rec), flush=True)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    if args.kernels != "fwd":
        failed |= time_training_kernels(ac, root, args.check, args.reps)[1]
    print(json.dumps({"card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
