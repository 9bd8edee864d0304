#!/usr/bin/env python3
"""What holds the Hopper bf16 forward attention kernels back: device times of
variants of `ops/csrc/attention_bf16_cuda.cu`, on one NVIDIA GPU.

    python3 tools/torch_attn_bf16_variants.py [--reps N]

Builds the source as it is (`base`) and variants made from it by text
substitution, each with the port's nvcc flags into `build/variants/`, then
times `attn_fwd_bf16` (mode full) at 160 x 1024 x 64, 160 x 2048 x 64 and
64 x 1024 x 64 and `cross_attn_fwd_bf16` at 32 x 5120 x 64 through each
library's C entry point (CUDA events, one warm-up and `--reps` launches, two
rounds), on seeded bfloat16 q, k, v:

- `grid_items`: one block a work item instead of the persistent grid;
- `stages2`, `stages6`: 2 or 6 K/V stages instead of 4;
- `no_turns`: the two consumer warpgroups without their turns;
- `no_softmax`: the softmax skipped (the products, P's split and O's update
  remain): what the tensor-core path alone takes;
- `no_pv`: P V skipped (Q K^T and the softmax remain).

The last two compute something else; the first four must give `base`'s bits
(checked). Prints one JSON line per variant and shape, then the card's name and
power limit. Exits non-zero without a CUDA device or when a variant that must
keep the bits does not. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("attn_fwd_bf16", 160, 1, 1024), ("attn_fwd_bf16", 160, 1, 2048),
          ("attn_fwd_bf16", 64, 1, 1024), ("cross_attn_fwd_bf16", 32, 5, 1024))
SAME_BITS = ("grid_items", "stages2", "stages6", "no_turns")


def _sub(text, old, new):
    if old not in text:
        raise ValueError(f"variant anchor not in the source: {old!r}")
    return text.replace(old, new)


def variants(src):
    stages = "constexpr int HW_STAGES = 4;"
    return {
        "base": src,
        "grid_items": _sub(src, "<<<min(items, sm_count()), HW_THREADS", "<<<items, HW_THREADS"),
        "stages2": _sub(src, stages, "constexpr int HW_STAGES = 2;"),
        "stages6": _sub(src, stages, "constexpr int HW_STAGES = 6;"),
        "no_turns": _sub(_sub(src, 'asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");',
                              ""),
                         'asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', ""),
        "no_softmax": _sub(src, "auto scores = [&](int t) {", "auto scores = [&](int t) {\n return;"),
        "no_pv": _sub(src, "auto issue_pv = [&]() {", "auto issue_pv = [&]() {\n return;"),
    }


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
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac
    from e2e_multi_view_matching_tpu_torch.ops import cuda_build

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "attention_bf16_cuda.cu").read_text()

    def build(item):
        name, text = item
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib_{name}.so"
        cu.write_text(text)
        r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
        return name, lib

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as ex:
        libs = dict(ex.map(build, variants(src).items()))
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    data = {shape: [torch.randn(shape[1], shape[2] * shape[3], 64, generator=g,
                                device=dev).bfloat16() for _ in range(3)] for shape in SHAPES}
    times, outs = {}, {}
    for _ in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in ac._BF16_SIGNATURES.items():
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
            for shape, (q, k, v) in data.items():
                kernel, BH, V, K = shape
                o = torch.empty_like(q)
                st = torch.cuda.current_stream().cuda_stream
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
                if kernel == "attn_fwd_bf16":
                    run = lambda: lib.attn_fwd_bf16(*ptrs, BH, V * K, 64, K, 0, 0.125, st)  # noqa: E731
                else:
                    run = lambda: lib.cross_attn_fwd_bf16(*ptrs, BH, V * K, 64, V, K, 0.125, st)  # noqa: E731
                if run() != 0:
                    raise RuntimeError(f"{name}: {kernel} launch failed")
                torch.cuda.synchronize()
                outs.setdefault((name, shape), o.clone())
                times.setdefault((name, shape), []).append(cuda_ms(run, args.reps))
    failed = False
    for (name, shape), ms in times.items():
        same = bool(torch.equal(outs[(name, shape)], outs[("base", shape)]))
        failed |= name in SAME_BITS and not same
        print(json.dumps({"variant": name, "kernel": shape[0],
                          "shape": [shape[1], shape[2] * shape[3], 64], "ms": ms,
                          "same_bits_as_base": same}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
