#!/usr/bin/env python3
"""What holds the Hopper bf16 attention kernels back: device times of variants
of `ops/csrc/attention_bf16_cuda.cu`, on one NVIDIA GPU.

    python3 tools/torch_attn_bf16_variants.py [--kernel fwd|dq|dkv] [--reps N]
                                              [--only base,name,...]

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
(checked).

`--kernel dkv` times `cross_attn_bwd_dkv_bf16` instead, at 32 x 2000 x 64 (the
bf16 training shape), 32 x 5120 x 64 and 32 x 2048 x 64, on seeded bfloat16 q,
k, v, dO with the plain forward's LSE and dvec = rowsum(dO O), through these
variants:

- `grid_items`, `stages2`, `stages6`, `no_turns`: as above (its HB_STAGES);
- `chains`: each product's k-steps as one chain after the other instead of
  interleaved with its partner's;
- `no_skip`: a consumer warpgroup whose 64 keys all lie past the view's end
  computes them as a live one does (not stored) instead of taking the turns
  only;
- `no_pds`: p and ds skipped (the products and the bf16 packing remain);
  `no_sums`, `no_sd`: the sums (dV, dK) or the scores (S^T, dP^T) not
  issued; `sd_only`: only the scores' products.

`--kernel dq` times `cross_attn_bwd_dq_bf16` at the same shapes and inputs
through these variants:

- `grid_items`, `stages2`, `stages6` (its HQ_STAGES), `no_turns`: as above;
- `regs_a`: Q and dO moved into registers once an item (ldmatrix) as the A
  operands of S and dP, as dk/dv does with K and V, instead of read from
  shared memory;
- `fresh`: each tile's dQ sum into a fresh accumulator, added to dQ in
  float32, instead of one running sum;
- `split_wait`: p and ds between a wait for the tile's S and dP and one for
  the last tile's sum (whose A operand the rounded dS overwrites), instead
  of one wait for all three;
- `sum_after`: each tile's sum issued right after its p and ds, outside the
  turn, and waited for with the next tile's S and dP (the first design);
- `no_pds`: p and ds skipped; `no_sum`: dQ's sum not issued; `sd_only`: only
  the scores' products.

The first four must give `base`'s bits; every variant that computes its
gradients (dq, or dk and dv) is held to the backward's gate
(`cross_attn_bwd_bf16_slack`) on the first slices of each shape, and its
reading is printed, with its worst reading over the ragged shapes of the card
tests (V = 2, 3, 5; K = 1 .. 400; dh = 16, 32, 64).

Prints one JSON line per variant and shape, then the card's name and power
limit. Exits non-zero without a CUDA device, when a variant that must keep
the bits does not, or when one held to the gate fails it. Imports no JAX.
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
BWD_SHAPES = ((32, 5, 400), (32, 5, 1024), (32, 2, 1024))
BWD_OFF_GATE = ("no_pds", "no_sums", "no_sum", "no_sd", "sd_only")


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


def dkv_variants(src):
    stages = "constexpr int HB_STAGES = 4;"
    turns = _sub(_sub(src, 'asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                 'asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")
    pds_at = "auto p_ds = [&]() {"
    sd_at = "    auto issue_sd = [&]() {"
    sums_at = "auto issue_sums = [&](int in) {"
    # the two products' k-steps interleaved, as built; `chains` closes the loop
    # after the first product's step and opens one for its partner's
    sd_split = "qd + 2 * kk, kk > 0);\n        wgmma_rs<0>(dpt,"
    next_kk = "\n      }\n#pragma unroll\n      for (int kk = 0; kk < DH / 16; ++kk) {\n"
    sums_split = "od + step, 1);\n        wgmma_rs(dka,"
    next_j = ("\n      }\n#pragma unroll\n      for (int j = 0; j < 4; ++j) {\n"
              "        const uint32_t step = (2 * H::group * j) >> 4;\n")

    def skip(text, *anchors):
        for a in anchors:
            text = _sub(text, a, a + "\n return;")
        return text

    return {
        "base": src,
        "grid_items": _sub(src, "<<<min(items, sm_count()), HW_THREADS, bytes, st>>>(\n"
                           "      maps[0], maps[1], maps[2], maps[3]",
                           "<<<items, HW_THREADS, bytes, st>>>(\n"
                           "      maps[0], maps[1], maps[2], maps[3]"),
        "stages2": _sub(src, stages, "constexpr int HB_STAGES = 2;"),
        "stages6": _sub(src, stages, "constexpr int HB_STAGES = 6;"),
        "no_turns": turns,
        "chains": _sub(_sub(src, sd_split, sd_split.replace("\n", next_kk, 1)),
                       sums_split, sums_split.replace("\n", next_j, 1)),
        "no_skip": _sub(src, "const bool live = 64 * c < n_live;", "const bool live = true;"),
        "no_pds": skip(src, pds_at),
        "no_sums": skip(src, sums_at),
        "no_sd": skip(src, sd_at),
        "sd_only": skip(src, sums_at, pds_at),
    }


def _sub_last(text, old, new):
    """`old` replaced where it last occurs: the dq kernel comes last in the
    source, after the forward and dk/dv, which share some of its lines."""
    if old not in text:
        raise ValueError(f"variant anchor not in the source: {old!r}")
    i = text.rindex(old)
    return text[:i] + new + text[i + len(old):]


def dq_variants(src):
    stages = "constexpr int HQ_STAGES = 4;"
    turns = _sub(_sub(src, 'asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                 'asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")
    pds_at = "auto p_ds = [&](int valid) {"
    sum_at = "auto issue_sum = [&](int in) {"
    # regs_a: the A fragments of Q's and dO's k-steps, loaded once an item
    regs = _sub_last(src, "        wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);\n"
                     "        wgmma_ss(dp, od + 2 * kk, vd + 2 * kk, kk > 0);",
                     "        wgmma_rs<0>(s, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],"
                     " kd + 2 * kk, kk > 0);\n"
                     "        wgmma_rs<0>(dp, df[kk][0], df[kk][1], df[kk][2], df[kk][3],"
                     " vd + 2 * kk, kk > 0);")
    regs = _sub_last(regs, "  uint32_t da[16];",
                     "  uint32_t da[16], qf[DH / 16][4], df[DH / 16][4];")
    regs = _sub_last(regs, "    mbar_wait(qfull0 + 8 * b, (u >> 1) & 1);\n",
                     "    mbar_wait(qfull0 + 8 * b, (u >> 1) & 1);\n"
                     "    if (live) {\n"
                     "      const uint32_t row = 16 * warp + (lane & 15);\n"
                     "#pragma unroll\n"
                     "      for (int kk = 0; kk < DH / 16; ++kk) {\n"
                     "        const uint32_t o = row * (2 * DH) + 16 * (2 * kk + (lane >> 4));\n"
                     "        const uint32_t sw = o ^ (((o >> 7) & (DH / 8 - 1)) << 4);\n"
                     "        ldsm_x4_at(qf[kk], qs + sw);\n"
                     "        ldsm_x4_at(df[kk], qs + 2 * L::TILE + sw);\n"
                     "      }\n"
                     "    }\n")
    # fresh: the tile's sum into `to` from 0, added to dQ after the next wait
    add = "#pragma unroll\n{0}for (int e = 0; e < R; ++e) dqa[e] += to[e];\n"
    fresh = _sub_last(src, "float s[32], dp[32], dqa[R];", "float s[32], dp[32], dqa[R], to[R];")
    fresh = _sub_last(fresh, "        wgmma_rs(dqa, da[4 * j], da[4 * j + 1], da[4 * j + 2], "
                      "da[4 * j + 3],\n                 kd + ((2 * H::group * j) >> 4), 1);",
                      "        wgmma_rs(to, da[4 * j], da[4 * j + 1], da[4 * j + 2], "
                      "da[4 * j + 3],\n"
                      "                 kd + ((2 * H::group * j) >> 4), j > 0);")
    fresh = _sub(fresh, "        fence_regs(dp);\n        fence_regs(dqa);\n",
                 "        fence_regs(dp);\n        fence_regs(to);\n" + add.format("        "))
    fresh = _sub(fresh, "      wgmma_wait<0>();\n      fence_regs(dqa);\n    } else {",
                 "      wgmma_wait<0>();\n      fence_regs(to);\n" + add.format("      ")
                 + "    } else {")

    # split_wait: p and ds between a wait for S and dP and one for the last
    # tile's sum, which reads the rounded dS's registers
    split = _sub(src, "        wgmma_wait<0>();  // S, dP of tile t; the sum of tile t - 1\n"
                 "        fence_regs(s);\n        fence_regs(dp);\n        fence_regs(dqa);\n"
                 "        if (lane == 0) mbar_arrive(empty0 + 8 * pstage);\n        p_ds(valid);\n",
                 "        wgmma_wait<1>();\n        fence_regs(s);\n        fence_regs(dp);\n"
                 "        p_ds(valid);\n        wgmma_wait<0>();\n        fence_regs(dqa);\n"
                 "        fence_regs(dp);\n"
                 "        if (lane == 0) mbar_arrive(empty0 + 8 * pstage);\n")
    # sum_after: each tile's sum issued after its p and ds, outside the turn
    # (queued ahead of the next tile's S and dP), one wait a tile
    live_at = src.rindex("    if (live) {\n      int x0, valid;\n")
    live_end = src.index("    if (lane == 0) {\n      mbar_arrive(empty0 + 8 * pstage);", live_at)
    after = src[:live_at] + """    if (live) {
      for (int t = 0; t < n; ++t) {
        int x0, valid;
        walk.tile(qv, t, x0, valid);
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        wgmma_fence();
        issue_sd();
        wgmma_commit();
        turn_pass(2 - c);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dqa);
        if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * pstage);
        p_ds(valid);
        pack();
        wgmma_fence();
        issue_sum(stage);
        wgmma_commit();
        next_stage();
      }
      wgmma_wait<0>();
      fence_regs(dqa);
    } else {
      for (int t = 0; t < n; ++t) {
        mbar_wait(full0 + 8 * stage, phase);
        turn_wait(1 + c);
        turn_pass(2 - c);
        if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * pstage);
        next_stage();
      }
    }
""" + src[live_end:]

    def skip(text, *anchors):
        for a in anchors:
            text = _sub_last(text, a, a + "\n return;")
        return text

    return {
        "base": src,
        "grid_items": _sub(src, "cross_attn_bwd_dq_bf16_kernel<DH><<<min(items, sm_count()), "
                           "HW_THREADS", "cross_attn_bwd_dq_bf16_kernel<DH><<<items, HW_THREADS"),
        "stages2": _sub(src, stages, "constexpr int HQ_STAGES = 2;"),
        "stages6": _sub(src, stages, "constexpr int HQ_STAGES = 6;"),
        "no_turns": turns,
        "regs_a": regs,
        "fresh": fresh,
        "split_wait": split,
        "sum_after": after,
        "no_pds": skip(src, pds_at),
        "no_sum": skip(src, sum_at),
        "sd_only": skip(src, sum_at, pds_at),
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
    parser.add_argument("--kernel", choices=("fwd", "dq", "dkv"), default="fwd")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--only", help="comma-separated variants to build (base always)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac
    from e2e_multi_view_matching_tpu_torch.ops import cuda_build

    out_dir = ROOT / "build" / "variants" / args.kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "attention_bf16_cuda.cu").read_text()
    made = {"fwd": variants, "dq": dq_variants, "dkv": dkv_variants}[args.kernel](src)
    if args.only:
        keep = {"base", *args.only.split(",")}
        made = {n: t for n, t in made.items() if n in keep}

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
        libs = dict(ex.map(build, made.items()))
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    if args.kernel != "fwd":
        failed = time_bwd(ac, libs, args.reps, args.kernel)
        print(json.dumps({"card": card_line()}), flush=True)
        return 1 if failed else 0
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
    print(json.dumps({"card": card_line()}), flush=True)
    return 1 if failed else 0


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _bwd_lib(ac, path):
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in ac._BF16_SIGNATURES.items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def _bwd_launch(lib, kernel, q, k, v, do, lse, dvec, V, K, scale):
    """Launches `kernel` ("dq" or "dkv") of a variant's library on fresh
    outputs; returns them (dq,) or (dk, dv)."""
    import torch

    BH, S, dh = q.shape
    outs = (torch.empty_like(q),) if kernel == "dq" else (torch.empty_like(k), torch.empty_like(v))
    fn = lib.cross_attn_bwd_dq_bf16 if kernel == "dq" else lib.cross_attn_bwd_dkv_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), *(x.data_ptr() for x in outs), BH, S, dh, V, K, scale,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cross_attn_bwd_{kernel}_bf16 launch failed (code {rc})")
    return outs


def _bwd_gate(ac, kernel, outs, refs, slack, nb=None):
    """The backward's gate reading of a variant's outputs (on their first nb slices)."""
    idx = (0,) if kernel == "dq" else (1, 2)
    return max(ac.bf16_ulp_error(a[:nb], refs[i], *slack[i]) for a, i in zip(outs, idx))


def ragged_gates(ac, libs, kernel):
    """{variant: (worst backward-gate reading of its gradients, (V, K, dh))}
    over the card tests' ragged shapes, on their inputs (seeded as
    tests/test_torch_kernels_cuda.py seeds them)."""
    import torch

    dev = torch.device("cuda")
    loaded = {n: _bwd_lib(ac, p) for n, p in libs.items()}
    worst = {n: (0.0, None) for n in libs}
    for K in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 400):
        for V in (2, 3, 5):
            for dh in (16, 32, 64):
                g = torch.Generator(device=dev).manual_seed(1000 * K + 10 * V + dh)
                BH = 1 if V * K < 80 else 3
                q, k, v = (2 * torch.randn(BH, V * K, dh, generator=g, device=dev)
                           for _ in range(3))
                q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
                g = torch.Generator(device=dev).manual_seed(7 + 1000 * K + 10 * V + dh)
                do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
                scale = 1.0 / dh ** 0.5
                o, lse = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
                dvec = (do.float() * o.float()).sum(-1) + torch.randn(lse.shape, generator=g,
                                                                      device=dev)
                args = (q, k, v, do, lse, dvec, V, K, scale)
                refs = ac.cross_attn_bwd_plain(*args)
                slack = ac.cross_attn_bwd_bf16_slack(*args)
                for name, lib in loaded.items():
                    e = _bwd_gate(ac, kernel, _bwd_launch(lib, kernel, *args), refs, slack)
                    if e > worst[name][0]:
                        worst[name] = (e, (V, K, dh))
    return worst


def time_bwd(ac, libs, reps, kernel):
    """Times every variant of `kernel` ("dq" or "dkv") at BWD_SHAPES, two
    rounds; True if one failed its bits or its gate."""
    import torch

    dev = torch.device("cuda")
    name_of = f"cross_attn_bwd_{kernel}_bf16"
    g = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for BH, V, K in BWD_SHAPES:
        q, k, v, do = (torch.randn(BH, V * K, 64, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        nb = max(1, min(BH, int(2 ** 28 // (V * K) ** 2)))
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, 0.125)  # the tree's own LSE forward
        dvec = (do.float() * o.float()).sum(-1)
        sub = (q[:nb], k[:nb], v[:nb], do[:nb], lse[:nb], dvec[:nb], V, K, 0.125)
        data[(BH, V, K)] = ((q, k, v, do, lse, dvec, V, K, 0.125), nb,
                            ac.cross_attn_bwd_plain(*sub), ac.cross_attn_bwd_bf16_slack(*sub))
        del o
    times, outs = {}, {}
    for _ in range(2):
        for name, path in libs.items():
            lib = _bwd_lib(ac, path)
            for shape, (args, _, _, _) in data.items():
                got = _bwd_launch(lib, kernel, *args)
                torch.cuda.synchronize()
                outs.setdefault((name, shape), got)
                times.setdefault((name, shape), []).append(
                    cuda_ms(lambda: _bwd_launch(lib, kernel, *args), reps))  # noqa: B023
    failed = False
    ragged = ragged_gates(ac, {n: p for n, p in libs.items() if n not in BWD_OFF_GATE}, kernel)
    for name, worst in ragged.items():
        failed |= not worst[0] <= 1.0
        print(json.dumps({"variant": name, "kernel": name_of, "ragged_gate_worst": worst[0],
                          "at": worst[1]}), flush=True)
    for (name, shape), ms in times.items():
        got, base = outs[(name, shape)], outs[("base", shape)]
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, base))
        rec = {"variant": name, "kernel": name_of, "shape": [shape[0], shape[1] * shape[2], 64],
               "ms": ms, "same_bits_as_base": same}
        failed |= name in SAME_BITS and not same
        if name not in BWD_OFF_GATE:
            _, nb, refs, slack = data[shape]
            rec["ulp_gate"] = _bwd_gate(ac, kernel, got, refs, slack, nb)
            failed |= not rec["ulp_gate"] <= 1.0
        print(json.dumps(rec), flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
