#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build      -- compile every hand-written kernel from `ops/csrc/` (nvcc,
                   one process per source, started together); a ptxas spill
                   in an attention kernel (float32 or bfloat16) fails it, and
                   so does a Hopper kernel (`attn_fwd_bf16`,
                   `cross_attn_fwd_bf16`, `cross_attn_fwd_lse_bf16`,
                   `cross_attn_bwd_dq_bf16`, `cross_attn_bwd_dkv_bf16`: every
                   bf16 kernel) whose SASS (cuobjdump) lacks HGMMA or
                   UTMALDG; so does a ptxas note that it
                   serialised a kernel's wgmma instructions (a wait it
                   inserted after each product). Beside the kernels, the
                   native host runtime (`data/native_loader.py`: the C++
                   library and `emvm_overlap`, host compiler, libjpeg,
                   libpng), with a probe of the compiler for `jpeglib.h` and
                   `png.h`: a failed build fails the phase when both headers
                   are found; without them the `cli` phase holds the fallback.
  2. device     -- print the card's name and power limit (nvidia-smi).
  3. kernel     -- each of the fourteen kernels against its plain PyTorch version
                   at the shapes of its main path (eval: V=5, K=1024; training:
                   V=5, K=400 and 80 pair matrices of 401 x 401, 100
                   iterations; the kernels both paths launch at both), with
                   times, bounds and the library yardstick; one JSON line per
                   kernel. The backward kernels (cross-attention dq and dk/dv,
                   the Sinkhorn reverse sweep) are also held against autograd
                   through the plain versions; the backward kernels and the
                   Sinkhorn cluster kernels against themselves for equal bits
                   (and the log kernel without the stash against itself with
                   it). The cluster kernels' records carry their launch plan,
                   the CUDA runtime's view of it, the SM clock under their
                   launches and a per-iteration split (times at 10 and 100
                   iterations: slope and intercept); the stashed log-domain
                   forward and the sweep are also held and timed at 80 x 1025
                   x 1025 (streamed), and `sinkhorn_scaling` in its wide
                   instantiation at 8 and 80 x 2049 x 2049 (K = 2048: no
                   spill). The attention forward kernels also at the pair
                   benchmark's shapes (V = 2, K = 1024 and 2048) and the
                   multi-view ones at K = 2048. The bfloat16 tensor-core
                   kernels (`attn_fwd_bf16`, `cross_attn_fwd_bf16`) at the
                   same eval, pair and K = 2048 shapes and in every mode at
                   ragged ones, held to one bfloat16 ulp of their plain twin
                   (+ 2^-18 of the output's absolute scale), beside SDPA on
                   the same bfloat16 inputs, the float32 kernel and their
                   design floor (4 products a pair). The
                   bfloat16 training kernels (`cross_attn_fwd_lse_bf16`,
                   `cross_attn_bwd_dq_bf16`, `cross_attn_bwd_dkv_bf16`) at the
                   training shape (32 x 2000 x 64) and at the eval and pair
                   shapes, held to the one-ulp gate of their bfloat16 twins
                   (the backward's widened by the bfloat16 roundings of p and
                   ds that may flip), the same bits on two runs, beside the
                   twin, SDPA on bfloat16 (forward, and its backward) and the
                   float32 kernels; dq and dk/dv with their design floors (3
                   and 4 products a pair), their launch plans and their sum
                   beside SDPA's backward. `sinkhorn_scaling` at sharp pair
                   scores (a seeded two-view matcher's final projection x 4): the
                   kernel, its twin and the float32 log domain against the
                   float64 log domain (a measurement).
                   Bounds: the largest of FP32 (bf16: tensor-core bf16)
                   operations, exponentials and bytes at the card's peak
                   rates.
  4. reference  -- the pose pipeline on the card recovers the known poses of a
                   small exact synthetic 5-tuple.
  5. main_path  -- `cli.eval_multi_view.evaluate` at full width (V=5, K=1024,
                   480x640, 7 x (self + 3 x cross), 100 Sinkhorn iterations,
                   conf MLP, w8pt_ba, eval_batch 8; 8 tuples) on seeded random
                   weights and images, once on the kernels ("auto") and once
                   on the plain versions; tuples/s, matches0 agreement, finite
                   extrinsics, the kernels' launch counts in the kernel run;
                   fails on any host sync inside one `infer_subchunk`. Then
                   the stage times of one 8-tuple sub-chunk, the
                   unrolled-Jacobi share of the pose stage, and the device's
                   busy time under torch.profiler.
  6. init_modes -- the multi-view init modes and the host-tree pipeline: the
                   4 exact synthetic 5-tuples of `reference` through
                   `multi_view_pose_pipeline_batch` in w8pt_ba, ransac,
                   ransac_ba and w8pt_ba with `ba_retriangulate`, held to the
                   JAX package's per-mode bounds, and the host-tree w8pt_ba
                   against `multi_view_pose_device`; then `evaluate` at the
                   main_path width on 8 tuples in ransac and in ransac_ba
                   (the matcher at threshold 0): finite errors, exact
                   launches 7 / 21 / 1 a sub-chunk, a RANSAC pose for half
                   the pairs, tuples/s, a sub-chunk's stage times (host
                   RANSAC, trees, device stage B), and its host syncs by the
                   port's frames: only the packed copies the modes need.
  7. bf16       -- the same evaluation in bfloat16 (`compute_dtype=
                   "bfloat16"`): on the bfloat16 kernels and on the plain
                   bfloat16 versions, tuples/s, exact launches a chunk (7
                   `attn_fwd_bf16`, 21 `cross_attn_fwd_bf16`, 1
                   `sinkhorn_scaling`, no float32 attention), finite
                   extrinsics, no host sync in a sub-chunk; on the float32
                   SuperPoint's outputs the bfloat16 kernels' matches differ
                   from the float32 kernels' on no more of the matched
                   keypoints than the plain bfloat16 run's + 1% + 3
                   standard errors of the difference (BF16_MATCH_SLACK);
                   the stage times of a sub-chunk and the matcher's device
                   time by kernel group (the bf16 self and cross kernels
                   apart) under torch.profiler.
  8. train_path -- `cli.train.train` at the full ScanNet 5-tuple training
                   width (V=5, K=400, B=8, 480x480, 7 x (self + 3 x cross), 100
                   iterations, stage 1, f32) on seeded plane scenes with exact
                   depth: 6 steps on a repeated batch plus validation, on the
                   kernels and on the plain versions from the same initial
                   state. Finite and falling loss, first-step gradients of
                   the two runs agree, launch counts per step, no host sync
                   inside a step, a checkpoint reads back; steps/s, tuples/s
                   and a per-stage breakdown of one step.
  9. pose_path  -- stage 2, `cli.train.train --pose_loss --init_exp_name` on
                   the kernel run of train_path, at the same width with the
                   conf MLP, on seeded sphere-field scenes: 6 steps plus
                   validation. Steps/s of the loop, finite match, rotation and
                   translation losses, the guard's skips, launch counts per
                   step, no host sync inside a step, first-step gradients of
                   kernels against plain at a conditioned point.
 10. train_bf16 -- bfloat16 training, `cli.train.train --compute_dtype
                   bfloat16` at the train_path width: 6 stage-1 steps on the
                   bfloat16 kernels and on the plain bfloat16 versions from
                   the same seeded state, then 3 stage-2 steps (`--pose_loss
                   --init_exp_name`) from the kernel run. Finite and falling
                   loss, exact launches a step (7 `attn_fwd_bf16`, 21 each of
                   the three bfloat16 training kernels, 1 `sinkhorn_log_stash`,
                   1 `sinkhorn_bwd`; a validation batch 7 / 21 / 1; no float32
                   attention kernel), no host sync inside a step, first-step
                   gradients no farther from the float32 kernels' than 1.5 x
                   the plain bfloat16 run's + 1e-3 (at the initial weights and
                   at the conditioned point); steps/s and a per-stage
                   breakdown.
 11. cli        -- both command lines through `python -m` from a ScanNet-format
                   tree (sphere-field scenes at 480x640 with exact depth,
                   written by `data/synthetic.write_scannet_format`): stage 1
                   of `cli.train` (V=5, K=400, B=8, jitter on, 2 steps, the
                   TensorBoard scalars, a profiler trace of step 2, whose CUDA
                   kernels must be the training kernels, as many as a step
                   launches), stage 2 (`--pose_loss --init_exp_name`), then
                   `cli.eval_multi_view` (K=1024, 100 iterations, conf MLP,
                   w8pt_ba, 8 tuples) on the stage-2 weights and SuperPoint
                   weights imported from a seeded upstream-layout state dict;
                   the eval `main()` once more in this process, for the
                   kernels' launch counts and the same metrics. Host time to
                   load a batch, steps/s of both stages, eval tuples/s. Then
                   a tree with real ScanNet's 1296x968 JPEG color: the host
                   load of a batch, and a 20-step stage-1 loop (no profiler):
                   steps/s of the loop and of its step alone, and the share
                   of the loop spent waiting on data, while the loader runs
                   (steps 6-17) and after it has finished (18-20). Last, the
                   eval command line once more with `--compute_dtype
                   bfloat16` (exit 0, finite AUCs), and both training stages
                   with `--compute_dtype bfloat16` (exit 0, finite losses).
                   Then seeded upstream-layout checkpoints (SuperPoint and
                   a 5-tuple matcher) through `tools/torch_import_weights.py`
                   and the eval command line with `--init_mode ransac_ba` on
                   them (exit 0, finite AUCs). The native runtime (the
                   `cli_native` line): the in-process eval `main()`'s test
                   set resolves `use_native="auto"` to the runtime when it
                   built and to the Python path when not. When it built:
                   `emvm_overlap` on a copy of the tree (exit 0, a JSON a
                   scene, 3-tuples from them), `overlap_matrix` within 0.03
                   of numpy, the 8 test tuples' native samples against the
                   Python path's (images 2e-2, depths 1e-3, intrinsics
                   1e-5), the rows by which the paths disagree on 1296x968
                   color (measured and predicted), and the eval `main()`'s
                   tuples/s on both paths. When it did not: the headers the
                   compiler lacks, and `use_native=True` raising with their
                   name. Both: host seconds to load 8 tuples at 480x640 and
                   1296x968 on each path there is.
 12. distributed -- the distributed modes, two gloo ranks sharing cuda:0 (the
                   card machine has one GPU; NCCL puts no two ranks on one):
                   (a) `evaluate` at the main_path width on a [cuda:0,
                   cuda:0] mesh (each sub-chunk of 8 in two slices of 4):
                   matches0 and pose errors against the one-device run at
                   the slices' batch of 4, launches 14 / 42 / 2 a sub-chunk,
                   no host sync but the chunk's `fetch_packed` copy; (b)
                   stage-1 training at the train_path width (global batch
                   8, 3 steps, kernels) as data 2 x model 1 and (c) as data
                   1 x model 2, in two spawned ranks: first-step gradients
                   within the train_path gate of a one-rank run over the
                   same batch, the ranks' gradients and parameters the same
                   bits (split leaves: half the rows each), launches per
                   rank; (d) `bundle_adjust_multi_view_sharded` on JAX's
                   at-scale problem (12 cameras, 52,800 observations, 8
                   iterations) in the same two ranks: one rank's cameras
                   (rtol 2e-3, atol 5e-5) and the error below 0.15 of the
                   initial; (e) stage 1 of `python -m ...cli.train
                   --multi_host` under `python -m torch.distributed.run
                   --standalone --nproc_per_node 1` on the `cli` tree:
                   env:// and NCCL, 2 steps.
 13. pairs      -- the two-view pair benchmark: `cli.eval_pairs` through
                   `python -m` (w8pt_ba, three AUCs) on 16 ScanNet-format pairs
                   with real ScanNet's 1296x968 color (537 x 720 frames on a
                   640 x 768 bucket, K = 1024), a seeded two-view matcher (9 x
                   (self + cross), conf MLP, 100 iterations) and an imported
                   SuperPoint; then `evaluate` in this process in all five
                   modes on the kernels and in w8pt_ba on the plain versions:
                   pairs/s, exact launch counts (9 / 9 / 1 a sub-chunk of 8
                   pairs), chunk signatures, at least half the pairs with a
                   pose; on one sub-chunk, at least 8 matches a pair, the
                   matches and probabilities of kernels and plain against a
                   float64 plain run, finite poses of the valid pairs, no
                   host sync inside a w8pt sub-chunk, the stage times. The same
                   in w8pt_ba on 16 MegaDepth-format pairs at K = 2048, long
                   side 1600 in three shapes (three bucket pairs), and the
                   multi-view `evaluate` at K = 2048 (V = 5, 8 tuples: the
                   Sinkhorn at 80 x 2049 x 2049). ScanNet and MegaDepth in
                   w8pt_ba in bfloat16 too (exact launches of the bfloat16
                   kernels: 9 / 9 / 1 a sub-chunk; no host sync in a
                   MegaDepth sub-chunk).
The third line from the end is {"kernels": [...]}, then the card's name and
power limit, and the last line is {"ok": true, "device": {...}}. Without a
CUDA device, or outside the repository, it exits non-zero and prints no
result. `--phases a,b` runs a subset while debugging (no result line).
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "e2e_multi_view_matching_tpu_torch"
PEAK_F32_OPS = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
PEAK_BF16_OPS = 989e12  # H100 SXM, dense bf16 on the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
# exponentials: 16 a clock on each SM's special-function units x 132 SMs x
# 1,980 MHz (the H100 SXM's maximum SM clock)
PEAK_EXPS = 16 * 132 * 1.98e9
ATTN_TOL = 2e-3  # online-softmax reordering drift bound (JAX test_chunked_softmax_drift_bounded)
# bfloat16 attention kernels against their plain twin: `bf16_ulp_error` <= 1,
# one bfloat16 ulp of the twin + 1e-6 + 2^-18 of the output's absolute scale
# sum p |v| / l (the tensor cores' float32 sums truncate)
BF16_ULP_TOL = 1.0
# bfloat16 eval: the bf16 kernels' matches0 against the float32 kernels' on
# the same SuperPoint outputs disagree on at most the plain bfloat16 run's
# share of the matched keypoints + this + 3 standard errors of the difference
# of the two shares. At the drawn weights bfloat16 decides most matches by
# chance (28 random layers, random images: no true correspondence, pair
# scores |s| ~ 1e2-1e3): each bf16 run keeps only ~30% of the float32
# matches, and two equally faithful runs differ by ~1.7 points a draw.
BF16_MATCH_SLACK = 0.01
CROSS_TRAIN_TOL = 2e-4  # cross-attention training kernels: max |err| / max |reference|
CROSS_LSE_TOL = 1e-5  # stashed LSE, absolute (a few float32 ulps at |lse| ~ 10)
SINKHORN_TOL = 2e-4  # transport probabilities (JAX test_pallas_scaling_kernel_matches_xla)
SINKHORN_EXTREME_TOL = 5e-4  # probabilities at extreme scores (same JAX test)
SINKHORN_DUAL_TOL = 1e-4  # stashed duals u_t, v_t (f32 reduction order over 100 iterations)
SINKHORN_GRAD_TOL = 2e-4  # dscores / max(1, max|dscores|) (JAX test_pallas_backward_kernel_matches_xla_vjp)
SINKHORN_ALPHA_TOL = 2e-3  # dalpha, relative above 1 (same JAX test)
# First-step gradients of the kernel run against the plain run, per leaf, as a
# share of the largest leaf norm. At the random (flax-style) initial weights
# the pair scores reach |s| ~ 1e3 and the assignment is nearly hard, so the
# gradient is ill-conditioned in float32: the plain float32 run itself is
# ~1.5e-2 away from the same computation in float64 on its worst leaf (the
# first layers' MLP kernels) and ~4e-5 on its median leaf. So the worst leaf
# is held to 2.5e-2 (twice the largest reading of a sound run, 1.2e-2) and the
# median leaf to 1e-3; `_grad_reference` holds the kernel run against float64
# directly, and holds every leaf to 2e-4 (six times the reading of a sound
# run) at a conditioned point: the same weights with the attention logits
# scaled down 16-fold, where the softmaxes of the 28 layers no longer
# saturate, and the pair scores 1024-fold.
TRAIN_GRAD_WORST_TOL = 2.5e-2
TRAIN_GRAD_MEDIAN_TOL = 1e-3
TRAIN_GRAD_F64_FACTOR = 3.0  # kernels' distance to float64 <= 3 x plain float32's + 1e-3
TRAIN_GRAD_CONDITIONED_TOL = 2e-4  # every leaf, kernels vs plain, at the conditioned point
CONDITIONED_RESCALE = {"q_proj": 1 / 4, "k_proj": 1 / 4, "final_proj": 1 / 32}
# bfloat16 training, first-step gradients of the bfloat16 kernel run against
# the float32 kernels' on the same weights, SuperPoint outputs and GT matches:
# two equally faithful bfloat16 runs (kernels, plain `multi_head_attention`)
# round at other places and differ a lot at random init (the saturated
# softmaxes of 28 layers), so the kernel run is held in a relative form, on
# the worst and the median leaf: no farther from float32 than BF16_GRAD_FACTOR
# x the plain bfloat16 run's distance + BF16_GRAD_SLACK of the largest leaf
# norm, at the initial weights and at the conditioned point.
BF16_GRAD_FACTOR = 1.5
BF16_GRAD_SLACK = 1e-3
# The init_modes phase's synthetic tuples: the bounds of the JAX package's
# test_ransac_modes_match_w8pt_on_high_inlier_fixture (max pairwise rotation /
# translation-direction error in degrees) and of its
# test_device_pipeline_matches_host_tree_pipeline (extrinsics)
INIT_MODE_BOUNDS = {"w8pt_ba": (1.0, 5.0), "ransac_ba": (1.5, 8.0), "ransac": (10.0, 45.0)}
HOST_TREE_TOL = 5e-4
# Held against its plain version in the kernel phase only: no entry point of
# the reference package asks for the exact log-domain iteration without grad.
OFF_PATH_KERNELS = ("sinkhorn_log",)
# Sources whose kernels must not spill registers: the build phase fails on a
# spill (the first dk/dv kernel lost 5x to one).
SPILL_FREE_SOURCES = ("attention_cuda", "attention_bf16_cuda")
# The Hopper kernels (TMA loads, wgmma products): the build phase fails unless
# their SASS holds both.
HOPPER_KERNELS = ("attn_fwd_bf16_kernel", "cross_attn_fwd_bf16_kernel",
                  "cross_attn_fwd_lse_bf16_kernel", "cross_attn_bwd_dq_bf16_kernel",
                  "cross_attn_bwd_dkv_bf16_kernel")
# The native runtime's samples against the Python path's (the JAX package's
# tests/test_data_pipeline.py::test_native_matches_python) and its overlap
# matrix against a numpy version (tests/test_native.py)
NATIVE_TOLS = {"images": 2e-2, "depths": 1e-3, "intr": 1e-5}
OVERLAP_TOL = 0.03


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of `fn` in ms over `reps` launches, after one warm-up."""
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


def bound(ops, nbytes, exps=0.0, bf16=False):
    """(least ms, "operations" or "bytes", the unit that binds) for `ops` FP32
    operations at 67 TFLOP/s (with `bf16`: bf16 tensor-core operations at 989
    TFLOP/s), `exps` exponentials at PEAK_EXPS and `nbytes` of traffic at
    3.35 TB/s: the largest of the three times."""
    t_ops = ops / (PEAK_BF16_OPS if bf16 else PEAK_F32_OPS) * 1e3
    t_exps = exps / PEAK_EXPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max((t_ops, "operations", "bf16_tensor" if bf16 else "fp32"),
               (t_exps, "operations", "exponential"), (t_bytes, "bytes", "memory"))


def build_phase():
    """Compile the kernels, and beside them the native host runtime; returns
    the native runtime's record (`_native_build`)."""
    from concurrent.futures import ThreadPoolExecutor

    from e2e_multi_view_matching_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native_build)
        logs = cuda_build.build_all(verbose=True)
        native = native.result()
    dt = time.perf_counter() - t0
    import re

    def kernel_name(mangled):
        # a mangled name is a run of <length><identifier>; take the *_kernel
        # one and the integer template arguments after it (ILi64E -> 64). The
        # length may follow other digits (the anonymous namespace's hash), so
        # of the identifiers that end in the same "_kernel" take the shortest.
        found = []
        for m in re.finditer(r"\d+", mangled):
            for k in range(len(m.group())):
                ident = mangled[m.end():m.end() + int(m.group()[k:])]
                if ident.endswith("_kernel") and "_kernel" not in ident[:-7]:
                    found.append((len(ident), m.end() + len(ident), ident))
        if not found:
            return mangled
        _, end, ident = min(found)
        args = re.findall(r"L[ib](\d+)E", mangled[end:])
        return ident + (f"<{','.join(args)}>" if args else "")

    spilled, serialised = [], []
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = kernel_name(entry.group(1))
            elif "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[ptxas {name}] {kernel}: {line.split(':', 1)[-1].strip()}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if name in SPILL_FREE_SOURCES and spill and int(spill.group(1)) + int(spill.group(2)):
                    spilled.append(f"{kernel} ({spill.group(0)})")
                serial = re.search(r"wgmma\.mma_async instructions are serialized.*function '(\w+)'",
                                   line)
                if serial:
                    serialised.append(kernel_name(serial.group(1)))
    sass = _sass_flags(cuda_build, "attention_bf16_cuda", kernel_name)
    emit({"phase": "build", "sources": sorted(logs), "seconds": round(dt, 3),
          "sass_attention_bf16": sass, "native_runtime": native})
    check(native["built"] or not all(native["headers"].values()),
          f"native runtime: its headers compile, but it did not build: {native['error']}")
    check(not spilled, f"ptxas spills: {'; '.join(spilled)}")
    check(not serialised, f"ptxas serialised the wgmma of {', '.join(serialised)}")
    for name in HOPPER_KERNELS:
        found = {k: v for k, v in sass.items() if k.startswith(name + "<")}
        check(found and all(v["HGMMA"] and v["UTMALDG"] for v in found.values()),
              f"{name}: no HGMMA or UTMALDG in its SASS ({found})")
    return native


def _native_build():
    """Build the port's native host runtime (`data/native_loader.py`: the
    library and `emvm_overlap`), and ask the host compiler whether it finds
    each header the runtime needs. Returns {"built", "seconds", "headers":
    {header: found}, "error": the build's message or None}."""
    from e2e_multi_view_matching_tpu_torch.data import native_loader

    headers = {}
    for header in ("jpeglib.h", "png.h"):
        try:
            probe = subprocess.run([native_loader._compiler(), "-x", "c++", "-fsyntax-only", "-"],
                                   input=f"#include <cstdio>\n#include <{header}>\n",
                                   capture_output=True, text=True, timeout=120)
            headers[header] = probe.returncode == 0
        except OSError:
            headers[header] = False
    t0 = time.perf_counter()
    built = native_loader.available()
    error = None if built else "\n".join(
        line for line in native_loader._error.splitlines() if "error" in line)[:2000]
    return {"built": built, "seconds": time.perf_counter() - t0, "headers": headers,
            "error": error}


def _sass_flags(cuda_build, source, kernel_name):
    """{kernel<args>: {"HGMMA": bool, "UTMALDG": bool}} of every kernel function in
    the built library of `source`, from `cuobjdump -sass`: whether its code holds
    warpgroup products (wgmma) and TMA loads."""
    import re

    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    lib = cuda_build._lib_path(source)[1]
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    flags = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(part.split(None, 1)[0])
        flags[name] = {op: op in part for op in ("HGMMA", "UTMALDG")}
    return flags


def device_phase():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def _occupancy(name, BH, S, n_views, n_kpts, dh, mode):
    """Registers, blocks per SM (at the kernel's own block size), grid and
    waves on this card of an attention kernel at one shape, from the CUDA
    runtime. The grid: row tiles of each view for the cross kernels (query
    rows; key rows for dk/dv), of all S rows for `attn_fwd`; the Hopper
    kernels' persistent grid from `hopper_fwd_plan` (`hopper_dq_plan`,
    `hopper_dkv_plan` for dq, dk/dv), whose waves are the work items a
    resident block walks."""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac

    info = ac.kernel_info(name, dh, mode)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    extra = {}
    if name in ac.HOPPER_FWD or name in (ac.HOPPER_DQ, ac.HOPPER_DKV):
        if name == ac.HOPPER_DKV:
            plan = ac.hopper_dkv_plan(BH, S, dh, n_views, n_kpts, sms=sms)
            extra = {"query_tiles_per_item": plan["query_tiles"],
                     "key_rows_computed_per_stored": plan["rows_per_stored"]}
        elif name == ac.HOPPER_DQ:
            plan = ac.hopper_dq_plan(BH, S, dh, n_views, n_kpts, sms=sms)
            extra = {"key_tiles_per_item": plan["key_tiles"],
                     "query_rows_computed_per_stored": plan["rows_per_stored"]}
        else:
            plan = ac.hopper_fwd_plan(name, BH, S, dh, n_views, n_kpts, sms=sms)
        blocks, waves = plan["grid"], plan["waves"]
        extra = {"threads": info["threads"], "persistent": info["persistent"],
                 "rows_per_item": plan["tile_rows"], "work_items": plan["items"],
                 "stages": plan["stages"], "swizzle_bytes": plan["swizzle_bytes"], **extra}
    else:
        if name.startswith("attn_fwd"):
            blocks = BH * math.ceil(S / info["tile_rows"])
        else:
            blocks = BH * n_views * math.ceil(n_kpts / info["tile_rows"])
        waves = blocks / (info["blocks_per_sm"] * sms)
        if "threads" in info:
            extra = {"threads": info["threads"], "rows_per_item": info["tile_rows"]}
    return {"registers": info["registers"], "blocks_per_sm": info["blocks_per_sm"],
            "shared_bytes": info["shared_bytes"], "spill_bytes": info["local_bytes"],
            "blocks": blocks, "waves": waves, **extra}


def _sm_clock_under(fn, reps):
    """The SM clock and its maximum (MHz), read by nvidia-smi while `reps`
    queued calls of `fn` keep the card busy."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    sm, top = (float(x) for x in out.stdout.strip().splitlines()[0].split(","))
    return {"sm_clock_mhz": sm, "max_sm_clock_mhz": top}


def _attention_records(g):
    import torch
    import torch.nn.functional as F

    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    h, dh, V = 4, 64, 5
    D = h * dh
    records = []

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # eval path (K = 1024): self layers are (B*V, K, D) tokens in mode "full" ->
    # attn_fwd at (160, 1024, 64); cross layers (B, V*K, D) -> cross_attn_fwd at
    # (32, 5120, 64). Training path (K = 400): self at (160, 400, 64) and, in
    # validation, cross at (32, 2000, 64) on per-view tiles of which the last is
    # ragged; those go into each kernel's record as `train_shapes`. The masked
    # kernel in cross mode at (32, 2000, 64), which no path runs since the
    # cross kernels take any K, is timed beside it for comparison. The pair
    # benchmark (V = 2: self at (64, K, 64), cross at (32, 2K, 64), K = 1024
    # and 2048) and the multi-view evaluation at K = 2048 ((160, 2048, 64),
    # (32, 10240, 64)) go in as `pair_shapes`.
    jax_file = "e2e_multi_view_matching_tpu/ops/attention_pallas.py"
    by_name = {}
    for name, Bt, n_views, K, mode, replaces in (
        ("attn_fwd", 8 * V, 1, 1024, "full", f"{jax_file}:51"),
        ("cross_attn_fwd", 8, V, 1024, "cross", f"{jax_file}:74"),
        ("attn_fwd", 8 * V, 1, 400, "full", "train"),
        ("cross_attn_fwd", 8, V, 400, "cross", "train"),
        ("attn_fwd", 8, V, 400, "cross", "train"),
        ("attn_fwd", 8 * 2, 1, 1024, "full", "pairs, K = 1024"),
        ("cross_attn_fwd", 8, 2, 1024, "cross", "pairs, K = 1024"),
        ("attn_fwd", 8 * 2, 1, 2048, "full", "pairs, K = 2048"),
        ("cross_attn_fwd", 8, 2, 2048, "cross", "pairs, K = 2048"),
        ("attn_fwd", 8 * V, 1, 2048, "full", "multi-view, K = 2048"),
        ("cross_attn_fwd", 8, V, 2048, "cross", "multi-view, K = 2048"),
    ):
        S = n_views * K
        # the plain version on the first nb entries of the batch: its scores
        # take at most 4 GB (all 8 at 32 x 10240 x 64 would take 13 GB a copy)
        nb = max(1, min(Bt, int(2**30 // (h * S * S))))
        q, k, v = rand(Bt, S, D), rand(Bt, S, D), rand(Bt, S, D)

        def split(x):
            return x.reshape(x.shape[0], S, h, dh).transpose(1, 2).contiguous()

        qs, ks, vs = split(q), split(k), split(v)
        q3, k3, v3 = (x.reshape(Bt * h, S, dh) for x in (qs, ks, vs))
        scale = 1.0 / math.sqrt(dh)
        mask = ac.cross_view_mask(n_views, K, device=dev) if mode == "cross" else None
        keys = (n_views - 1) * K if mode == "cross" else S  # keys a query has to see
        if name == "attn_fwd":
            run = lambda: ac.attn_fwd(q3, k3, v3, K, mode, scale)  # noqa: E731
        else:
            run = lambda: ac.cross_attn_fwd(q3, k3, v3, n_views, K, scale)  # noqa: E731
        # the public dispatch and the wrapper itself, against the plain version
        out = ac.fused_view_attention(q, k, v, h, n_views, K, mode)[:nb]
        ref = ac.plain_view_attention(q[:nb], k[:nb], v[:nb], h, n_views, K, mode)
        out3 = run()[:nb * h]
        torch.cuda.synchronize()
        err = max(float((out - ref).abs().max()),
                  float((out3 - split(ref).reshape(nb * h, S, dh)).abs().max()))
        del out, ref, out3
        ms = cuda_ms(run, 5)
        qn, kn, vn = q[:nb], k[:nb], v[:nb]
        plain_ms = cuda_ms(lambda: ac.plain_view_attention(qn, kn, vn, h, n_views, K, mode), 3)
        qsn, ksn, vsn = qs[:nb], ks[:nb], vs[:nb]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qsn, ksn, vsn, attn_mask=mask),
                         3)
        BH = Bt * h
        ops = 4.0 * BH * S * keys * dh + BH * S * keys  # FMAs x2 + one exp per score
        nbytes = 4 * BH * S * dh * 4  # q, k, v read once, o written once
        b_ms, b_by, b_unit = bound(ops, nbytes, exps=float(BH * S * keys))
        where = f"{name} {mode} V={n_views} K={K}"
        check(err <= ATTN_TOL, f"{where}: max |kernel - plain| {err} > {ATTN_TOL}")
        measured = {"max_abs_err": err, "tol": ATTN_TOL, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit, "library_ms": lib_ms,
                    "shape": [BH, S, dh], **_occupancy(name, BH, S, n_views, K, dh, mode)}
        if nb < Bt:  # plain and library timed on the batch entries compared
            measured["compared_batch"] = [nb, Bt]
        if replaces != "train":
            _bf16_attention_record(by_name, records, name, replaces, mode, n_views, K, q, k, v,
                                   nb, mask, keys, ms)
        if replaces == "train":
            by_name[name].setdefault("train_shapes", []).append({"mode": mode, **measured})
        elif replaces.startswith(("pairs", "multi-view")):
            by_name[name].setdefault("pair_shapes", []).append(
                {"path": replaces, "mode": mode, **measured})
        else:
            by_name[name] = {"name": name, "route": "cuda",
                             "source": f"{PKG}/ops/csrc/attention_cuda.cu",
                             "replaces": replaces, "launches": 0, **measured}
            records.append(by_name[name])
        del q, k, v, qs, ks, vs, q3, k3, v3, qn, kn, vn, qsn, ksn, vsn
        torch.cuda.empty_cache()

    # the masked kernel's other modes and its ragged edge, and the cross kernel
    # on ragged per-view tiles (200 = 3 x 64 + 8), at a smaller shape; float32
    # and bfloat16
    for name, mode, n_views, n_kpts in (("attn_fwd", "self", 3, 200),
                                        ("attn_fwd", "cross", 3, 200),
                                        ("attn_fwd", "full", 1, 333),
                                        ("cross_attn_fwd", "cross", 3, 200)):
        S = n_views * n_kpts
        q, k, v = rand(2, S, D), rand(2, S, D), rand(2, S, D)
        split = lambda x: x.reshape(2, S, h, dh).transpose(1, 2).reshape(2 * h, S, dh)  # noqa: E731
        for dtype in (torch.float32, torch.bfloat16):
            qs, ks, vs = (split(x).to(dtype).contiguous() for x in (q, k, v))
            if name == "attn_fwd":
                out = ac.attn_fwd(qs, ks, vs, n_kpts, mode, 1.0 / math.sqrt(dh))
            else:
                out = ac.cross_attn_fwd(qs, ks, vs, n_views, n_kpts, 1.0 / math.sqrt(dh))
            ref = ac.plain_view_attention(qs, ks, vs, 1, n_views, n_kpts, mode)
            if dtype == torch.float32:
                err = float((out - ref).abs().max())
                check(err <= ATTN_TOL, f"{name} mode {mode} K={n_kpts}: max err {err} > "
                      f"{ATTN_TOL}")
                by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
                continue
            scale = ac.plain_view_attention(qs.float(), ks.float(), vs.float().abs(), 1,
                                            n_views, n_kpts, mode)
            ulps = ac.bf16_ulp_error(out, ref, scale)
            check(ulps <= BF16_ULP_TOL, f"{name} bf16 mode {mode} K={n_kpts}: {ulps} of the "
                  f"one-ulp gate")
            rec = by_name[f"{name}_bf16"]
            rec["max_abs_err"] = max(rec["max_abs_err"], float((out.float() - ref.float())
                                                               .abs().max()))
            rec["ulp_gate"] = max(rec["ulp_gate"], ulps)
    return records


def _bf16_attention_record(by_name, records, name, replaces, mode, n_views, K, q, k, v, nb,
                           mask, keys, f32_ms):
    """The bfloat16 tensor-core kernel at the float32 record's shape and inputs
    (rounded to bfloat16): held against its plain twin (`plain_view_attention`
    on the bfloat16 tensors: float32 arithmetic, the output rounded once) by
    the one-ulp gate on the first `nb` batch entries; timed beside the twin,
    SDPA on the same bfloat16 inputs and mask, and the float32 kernel."""
    import torch
    import torch.nn.functional as F

    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac

    Bt, S, D = q.shape
    h, dh = 4, D // 4
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    q3, k3, v3 = (x.reshape(Bt, S, h, dh).transpose(1, 2).reshape(Bt * h, S, dh).contiguous()
                  for x in (qb, kb, vb))
    scale = 1.0 / math.sqrt(dh)
    if name == "attn_fwd":
        run = lambda: ac.attn_fwd(q3, k3, v3, K, mode, scale)  # noqa: E731
    else:
        run = lambda: ac.cross_attn_fwd(q3, k3, v3, n_views, K, scale)  # noqa: E731
    qn, kn, vn = qb[:nb], kb[:nb], vb[:nb]
    out = ac.fused_view_attention(qn, kn, vn, h, n_views, K, mode)
    out3 = run()[:nb * h]
    ref = ac.plain_view_attention(qn, kn, vn, h, n_views, K, mode)
    abs_scale = ac.plain_view_attention(qn.float(), kn.float(), vn.float().abs(), h, n_views,
                                        K, mode)
    split = lambda x: x.reshape(nb, S, h, dh).transpose(1, 2).reshape(nb * h, S, dh)  # noqa: E731
    ulps = max(ac.bf16_ulp_error(out, ref, abs_scale),
               ac.bf16_ulp_error(out3, split(ref), split(abs_scale)))
    err = max(float((out.float() - ref.float()).abs().max()),
              float((out3.float() - split(ref).float()).abs().max()))
    del out, out3, ref, abs_scale
    torch.cuda.synchronize()
    ms = cuda_ms(run, 5)
    plain_ms = cuda_ms(lambda: ac.plain_view_attention(qn, kn, vn, h, n_views, K, mode), 3)
    qs, ks, vs = (x[:nb * h].reshape(nb, h, S, dh) for x in (q3, k3, v3))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), 3)
    BH = Bt * h
    b_ms, b_by, b_unit = bound(4.0 * BH * S * keys * dh, 2 * 4 * BH * S * dh,
                               exps=float(BH * S * keys), bf16=True)
    # the design's tensor-core floor: 4 products a (query, key) pair (Q K^T and
    # P V with P as three bf16 terms), twice the 2 that the bound counts
    floor_ms = 8.0 * BH * S * keys * dh / PEAK_BF16_OPS * 1e3
    kname = f"{name}_bf16"
    where = f"{kname} {mode} V={n_views} K={K}"
    check(ulps <= BF16_ULP_TOL, f"{where}: {ulps} of the one-ulp gate (max |err| {err})")
    measured = {"max_abs_err": err, "ulp_gate": ulps, "tol": BF16_ULP_TOL, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
                "design_floor_ms": floor_ms, "library_ms": lib_ms, "f32_kernel_ms": f32_ms,
                "shape": [BH, S, dh],
                **_occupancy(kname, BH, S, n_views, K, dh, mode)}
    if nb < Bt:
        measured["compared_batch"] = [nb, Bt]
    if replaces.startswith(("pairs", "multi-view")):
        by_name[kname].setdefault("pair_shapes", []).append(
            {"path": replaces, "mode": mode, **measured})
    else:
        by_name[kname] = {"name": kname, "route": "cuda", "dtype": "bfloat16",
                          "source": f"{PKG}/ops/csrc/attention_bf16_cuda.cu",
                          "replaces": replaces, "launches": 0, **measured}
        records.append(by_name[kname])
    check(measured["spill_bytes"] == 0, f"{where}: {measured['spill_bytes']} spill bytes")
    del qb, kb, vb, q3, k3, v3, qn, kn, vn, qs, ks, vs
    torch.cuda.empty_cache()


def _cross_attn_train_records(g):
    """The three kernels of the cross layers under grad at the training shape
    (32, 2000, 64): V = 5, K = 400, B = 8 tuples x 4 heads; and a small ragged
    case. Each against its plain twin and against autograd of the plain masked
    attention; two runs give the same bits."""
    import torch
    import torch.nn.functional as F

    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac
    from e2e_multi_view_matching_tpu_torch.ops.attention import multi_head_attention

    dev = torch.device("cuda")
    jax_file = "e2e_multi_view_matching_tpu/ops/attention_pallas.py"

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def case(BH, V, K, dh):
        S = V * K
        q, k, v, do = rand(BH, S, dh), rand(BH, S, dh), rand(BH, S, dh), rand(BH, S, dh)
        scale = 1.0 / math.sqrt(dh)
        o, lse = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        dvec = (do * o).sum(-1)
        dq = ac.cross_attn_bwd_dq(q, k, v, do, lse, dvec, V, K, scale)
        dk, dv = ac.cross_attn_bwd_dkv(q, k, v, do, lse, dvec, V, K, scale)
        o2, lse2 = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        dq2 = ac.cross_attn_bwd_dq(q, k, v, do, lse, dvec, V, K, scale)
        dk2, dv2 = ac.cross_attn_bwd_dkv(q, k, v, do, lse, dvec, V, K, scale)
        bits = bool(torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2))
        o_p, lse_p = ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale)
        grads_p = ac.cross_attn_bwd_plain(q, k, v, do, lse, dvec, V, K, scale)
        # autograd of the plain masked attention (one head per batch entry)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o_ag = multi_head_attention(*xs, 1, mask=ac.cross_view_mask(V, K, device=dev))
        grads_ag = torch.autograd.grad(o_ag, xs, do)
        torch.cuda.synchronize()
        err = {"fwd_lse": {"o_vs_plain": rel(o, o_p), "o_vs_autograd_fwd": rel(o, o_ag.detach()),
                           "lse_abs": float((lse - lse_p).abs().max())},
               "bwd_dq": {"vs_plain": rel(dq, grads_p[0]), "vs_autograd": rel(dq, grads_ag[0])},
               "bwd_dkv": {"vs_plain": max(rel(dk, grads_p[1]), rel(dv, grads_p[2])),
                           "vs_autograd": max(rel(dk, grads_ag[1]), rel(dv, grads_ag[2]))}}
        for kname, e in err.items():
            for what, x in e.items():
                tol = CROSS_LSE_TOL if what == "lse_abs" else CROSS_TRAIN_TOL
                check(x <= tol, f"cross_attn_{kname} at {(BH, S, dh)}: {what} {x} > {tol}")
        check(bits, f"cross-attention training kernels at {(BH, S, dh)}: two runs differ")
        return (q, k, v, do, o, lse, dvec, scale), err

    small_args, small_err = case(8, 3, 100, 64)  # 100 = 80 + 20: ragged per-view tiles
    BH, V, K, dh = 32, 5, 400, 64
    S = V * K
    args, err = case(BH, V, K, dh)
    q, k, v, do, o, lse, dvec, scale = args
    bwd_args = (q, k, v, do, lse, dvec, V, K, scale)
    ms = {"fwd_lse": cuda_ms(lambda: ac.cross_attn_fwd_lse(q, k, v, V, K, scale), 5),
          "bwd_dq": cuda_ms(lambda: ac.cross_attn_bwd_dq(*bwd_args), 5),
          "bwd_dkv": cuda_ms(lambda: ac.cross_attn_bwd_dkv(*bwd_args), 5)}
    # the clock that the bounds' 67 TFLOP/s assume (1,980 MHz) against the one
    # the card holds under ~1.5 s of dk/dv launches
    clock = _sm_clock_under(lambda: ac.cross_attn_bwd_dkv(*bwd_args), int(1500 / ms["bwd_dkv"]))
    emit({"phase": "kernel", "sm_clock_under_cross_attn_bwd_dkv": clock})
    plain_fwd = cuda_ms(lambda: ac.cross_attn_fwd_lse_plain(q, k, v, V, K, scale), 3)
    plain_bwd = cuda_ms(lambda: ac.cross_attn_bwd_plain(*bwd_args), 3)
    # library yardstick: SDPA with the same boolean mask, forward, and its
    # backward (dq, dk, dv together) through autograd
    mask = ac.cross_view_mask(V, K, device=dev)
    qs, ks, vs = (x[:, None].clone().requires_grad_() for x in (q, k, v))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), 3)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do[:, None],
                                                  retain_graph=True), 3)
    del out, qs, ks, vs
    pairs = float(BH * S * (V - 1) * K)  # (query, key) pairs of other views
    rows = float(BH * S)
    records = []
    for name, line, ops, nbytes, plain_ms, lib_ms in (
        ("cross_attn_fwd_lse", 123, pairs * (4 * dh + 1), 4 * (4 * rows * dh + rows),
         plain_fwd, lib_fwd),
        ("cross_attn_bwd_dq", 163, pairs * (6 * dh + 3), 4 * (5 * rows * dh + 2 * rows),
         plain_bwd, lib_bwd),
        ("cross_attn_bwd_dkv", 190, pairs * (8 * dh + 3), 4 * (6 * rows * dh + 2 * rows),
         plain_bwd, lib_bwd),
    ):
        key = name[len("cross_attn_"):]
        b_ms, b_by, b_unit = bound(ops, nbytes, exps=pairs)  # one exp per (query, key) pair
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/attention_cuda.cu",
               "replaces": f"{jax_file}:{line}", "launches": 0,
               "max_abs_err": err[key]["o_vs_plain" if key == "fwd_lse" else "vs_plain"],
               "tol": CROSS_TRAIN_TOL, "errors": err[key], "errors_ragged_8x300x64":
               small_err[key], "bitwise_repeatable": True, "ms": ms[key],
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
               "library_ms": lib_ms,
               "shape": [BH, S, dh], **_occupancy(name, BH, S, V, K, dh, "cross")}
        if key != "fwd_lse":
            rec["plain_and_library_cover"] = "dq, dk and dv together"
        if key == "bwd_dkv":
            rec.update(clock)
        records.append(rec)
    records[0]["lse_tol"] = CROSS_LSE_TOL
    records[0]["kernels_fwd_bwd_ms"] = sum(ms.values())
    records[0]["library_fwd_bwd_ms"] = lib_fwd + lib_bwd
    return records


def _cross_attn_train_bf16_records(g, f32_records):
    """The bfloat16 tensor-core kernels of the cross layers under grad
    (`cross_attn_fwd_lse_bf16`, `cross_attn_bwd_dq_bf16`,
    `cross_attn_bwd_dkv_bf16`) at the training shape (32, 2000, 64), and at the
    eval (32, 5120, 64) and pair (V = 2, K = 1024 and 2048) shapes: each
    against its bfloat16 twin by the one-ulp gate (the backward's with the
    flips of `cross_attn_bwd_bf16_slack`), the LSE 1e-5 absolute, the same
    bits on two runs; timed beside the twin, SDPA on the same bfloat16
    inputs (forward; backward through autograd: dq, dk, dv together) and the
    float32 kernel on the float32 inputs. Twin, gate and SDPA take the first
    `nb` of the BH slices (their scores take up to 1 GB a copy)."""
    import torch
    import torch.nn.functional as F

    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    jax_file = "e2e_multi_view_matching_tpu/ops/attention_pallas.py"
    names = ("cross_attn_fwd_lse_bf16", "cross_attn_bwd_dq_bf16", "cross_attn_bwd_dkv_bf16")
    lines = {names[0]: 123, names[1]: 163, names[2]: 190}
    records = {}
    for path, BH, V, K in (("train", 32, 5, 400), ("eval, K = 1024", 32, 5, 1024),
                           ("pairs, K = 1024", 32, 2, 1024), ("pairs, K = 2048", 32, 2, 2048)):
        S, dh = V * K, 64
        nb = max(1, min(BH, int(2 ** 28 // (S * S))))
        q, k, v, do = (torch.randn(BH, S, dh, generator=g, device=dev) for _ in range(4))
        qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
        scale = 1.0 / math.sqrt(dh)
        o, lse = ac.cross_attn_fwd_lse(qb, kb, vb, V, K, scale)
        dvec = (dob.float() * o.float()).sum(-1)
        args = (qb, kb, vb, dob, lse, dvec, V, K, scale)
        dq = ac.cross_attn_bwd_dq(*args)
        dk, dv = ac.cross_attn_bwd_dkv(*args)
        o2, lse2 = ac.cross_attn_fwd_lse(qb, kb, vb, V, K, scale)
        dk2, dv2 = ac.cross_attn_bwd_dkv(*args)
        bits = bool(torch.equal(o, o2) and torch.equal(lse, lse2)
                    and torch.equal(dq, ac.cross_attn_bwd_dq(*args))
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2))
        del o2, lse2, dk2, dv2
        sub = (qb[:nb], kb[:nb], vb[:nb], dob[:nb], lse[:nb], dvec[:nb], V, K, scale)
        o_p, lse_p = ac.cross_attn_fwd_lse_plain(qb[:nb], kb[:nb], vb[:nb], V, K, scale)
        abs_scale = ac.plain_view_attention(qb[:nb].float(), kb[:nb].float(),
                                            vb[:nb].float().abs(), 1, V, K, "cross")
        gates = {names[0]: ac.bf16_ulp_error(o[:nb], o_p, abs_scale)}
        errs = {names[0]: float((o[:nb].float() - o_p.float()).abs().max())}
        lse_err = float((lse[:nb] - lse_p).abs().max())
        del o_p, lse_p, abs_scale
        refs = ac.cross_attn_bwd_plain(*sub)
        slack = ac.cross_attn_bwd_bf16_slack(*sub)
        for name, outs, idx in ((names[1], (dq,), (0,)), (names[2], (dk, dv), (1, 2))):
            gates[name] = max(ac.bf16_ulp_error(a[:nb], refs[i], *slack[i])
                              for a, i in zip(outs, idx))
            errs[name] = max(float((a[:nb].float() - refs[i].float()).abs().max())
                             for a, i in zip(outs, idx))
        del refs, slack
        torch.cuda.synchronize()
        ms = {names[0]: cuda_ms(lambda: ac.cross_attn_fwd_lse(qb, kb, vb, V, K, scale), 5),
              names[1]: cuda_ms(lambda: ac.cross_attn_bwd_dq(*args), 5),
              names[2]: cuda_ms(lambda: ac.cross_attn_bwd_dkv(*args), 5)}
        o32, lse32 = ac.cross_attn_fwd_lse(q, k, v, V, K, scale)
        args32 = (q, k, v, do, lse32, (do * o32).sum(-1), V, K, scale)
        f32_ms = {names[0]: cuda_ms(lambda: ac.cross_attn_fwd_lse(q, k, v, V, K, scale), 5),
                  names[1]: cuda_ms(lambda: ac.cross_attn_bwd_dq(*args32), 5),
                  names[2]: cuda_ms(lambda: ac.cross_attn_bwd_dkv(*args32), 5)}
        plain_fwd = cuda_ms(lambda: ac.cross_attn_fwd_lse_plain(*sub[:3], V, K, scale), 3)
        plain_bwd = cuda_ms(lambda: ac.cross_attn_bwd_plain(*sub), 3)
        mask = ac.cross_view_mask(V, K, device=dev)
        qs, ks, vs = (x[:nb, None].clone().requires_grad_() for x in (qb, kb, vb))
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), 3)
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dob[:nb, None],
                                                      retain_graph=True), 3)
        del out, qs, ks, vs
        pairs, rows = float(BH * S * (V - 1) * K), float(BH * S)
        for name, prods, n_io, plain_ms, lib_ms in (
                (names[0], 2, 4, plain_fwd, lib_fwd), (names[1], 3, 5, plain_bwd, lib_bwd),
                (names[2], 4, 6, plain_bwd, lib_bwd)):
            scalars = 1 if name == names[0] else 2  # LSE; LSE and dvec
            b_ms, b_by, b_unit = bound(2.0 * prods * pairs * dh, 2 * n_io * rows * dh
                                       + 4 * scalars * rows, exps=pairs, bf16=True)
            where = f"{name} at {(BH, S, dh)}"
            check(gates[name] <= BF16_ULP_TOL, f"{where}: {gates[name]} of the one-ulp gate "
                  f"(max |err| {errs[name]})")
            check(bits, f"bfloat16 training kernels at {(BH, S, dh)}: two runs differ")
            measured = {"max_abs_err": errs[name], "ulp_gate": gates[name], "tol": BF16_ULP_TOL,
                        "bitwise_repeatable": bits, "ms": ms[name], "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
                        "library_ms": lib_ms, "f32_kernel_ms": f32_ms[name],
                        "shape": [BH, S, dh], **_occupancy(name, BH, S, V, K, dh, "cross")}
            if name == names[0]:
                measured.update(lse_abs_err=lse_err, lse_tol=CROSS_LSE_TOL,
                                design_floor_ms=8.0 * pairs * dh / PEAK_BF16_OPS * 1e3)
                check(lse_err <= CROSS_LSE_TOL, f"{where}: LSE error {lse_err}")
            else:  # the backward's design floor: its products a pair on the tensor cores
                measured.update(plain_and_library_cover="dq, dk and dv together",
                                design_floor_ms=2.0 * prods * pairs * dh / PEAK_BF16_OPS * 1e3)
            if name == names[1]:
                measured["dq_plus_dkv_ms"] = ms[names[1]] + ms[names[2]]  # beside library_ms
            if nb < BH:
                measured["compared_batch"] = [nb, BH]
            check(measured["spill_bytes"] == 0, f"{where}: {measured['spill_bytes']} spill bytes")
            if path == "train":
                records[name] = {"name": name, "route": "cuda", "dtype": "bfloat16",
                                 "source": f"{PKG}/ops/csrc/attention_bf16_cuda.cu",
                                 "replaces": f"{jax_file}:{lines[name]}", "launches": 0,
                                 **measured}
            else:
                records[name].setdefault("other_shapes", []).append({"path": path, **measured})
        del q, k, v, do, qb, kb, vb, dob, o, lse, dvec, dq, dk, dv, o32, lse32, args, args32, sub
        torch.cuda.empty_cache()
    f32 = {r["name"]: r["ms"] for r in f32_records}
    records[names[0]]["kernels_fwd_bwd_ms"] = sum(records[n]["ms"] for n in names)
    records[names[0]]["f32_kernels_fwd_bwd_ms"] = sum(f32[n[:-len("_bf16")]] for n in names)
    return [records[n] for n in names]


def _sharp_pair_scores(K, seed, device):
    """The pair scores (2, K, K) and dustbin score of a seeded two-view matcher
    at the default widths (9 x (self + cross), flax's initializers, 256-wide
    descriptors) with its final projection scaled x 4 (the scores x 16), on
    seeded keypoints and unit descriptors of two frames, float32 plain ops
    (also the inputs of the CPU test against JAX's kernel,
    `tests/test_torch_bf16_train.py`)."""
    import torch

    from e2e_multi_view_matching_tpu_torch.models import matcher as tm
    from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as tsink

    m = tm.MultiViewMatcher(tm.MatcherConfig(gnn_layers=tm.default_gnn_layers(9, 1)))
    init_like_flax_(m, torch.Generator().manual_seed(seed))
    m = m.to(device)
    with torch.no_grad():
        m.final_proj.weight.mul_(4.0)
        m.final_proj.bias.mul_(4.0)
    seen = {}

    def capture(scores, alpha, n_iters, impl="xla"):
        seen["scores"], seen["alpha"] = scores, float(alpha)
        return tsink.log_optimal_transport(scores, alpha, n_iters, impl=impl)

    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(2, 2, K, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    kpts = rng.uniform(0, 480, (2, 2, K, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 2, K)).astype(np.float32)
    orig, tm.log_optimal_transport = tm.log_optimal_transport, capture
    try:
        with torch.no_grad():
            m(torch.from_numpy(kpts).to(device), torch.from_numpy(scores).to(device),
              torch.from_numpy(desc).to(device), torch.full((2, 2, 2), 480.0, device=device),
              full_output=False)
    finally:
        tm.log_optimal_transport = orig
    return seen["scores"], seen["alpha"]


def _sinkhorn_sharp():
    """`sinkhorn_scaling` at sharp scores (the open question of the pair
    benchmark): the kernel, its plain twin (on the CPU) and the float32 log
    domain against the float64 log-domain Sinkhorn at the same 100 iterations,
    in max |p - p64| / max(1, p64), on `_sharp_pair_scores` at the CPU test's
    draws (K = 64 and 128, seeds 0-3, K = 512, seed 0; scores made on the CPU)
    and at the pair benchmark's K = 1024 (seeds 0-1, made on the card). A
    measurement: no gate."""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as tsink
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda

    cases = []
    for K, seeds, where in ((64, range(4), "cpu"), (128, range(4), "cpu"),
                            (512, range(1), "cpu"), (1024, range(2), "cuda")):
        for seed in seeds:
            s, alpha = _sharp_pair_scores(K, seed, where)
            s = s.cuda()
            with torch.no_grad():
                p64 = tsink.log_optimal_transport(s.double(), alpha, 100, impl="xla").exp()
                runs = {"kernel": sinkhorn_cuda.log_optimal_transport_cuda(s, alpha, 100),
                        "plain_twin": sinkhorn_cuda.log_optimal_transport_cuda(
                            s.cpu(), alpha, 100).cuda(),
                        "f32_log_domain": tsink.log_optimal_transport(s, alpha, 100,
                                                                      impl="xla")}
                far = {k: float(((z.double().exp() - p64).abs() / p64.clamp(min=1.0)).max())
                       for k, z in runs.items()}
            cases.append({"K": K, "seed": seed, "max_abs_score": float(s.abs().max()), **far})
    worst = {k: max(c[k] for c in cases) for k in ("kernel", "plain_twin", "f32_log_domain")}
    return {"vs_float64_log_domain_100_iterations": cases, "worst": worst}


def _prob_err(z, z_ref):
    """Max |p - p_ref| / max(1, p_ref) over exp(log assignment): absolute on the
    match probabilities (<= 1), relative on the dustbin row and column, whose
    entries reach hundreds at K=1024 (rows are scaled by M+N)."""
    p, p_ref = z.exp(), z_ref.exp()
    return float(((p - p_ref).abs() / p_ref.clamp(min=1.0)).max())


def _cluster_info(kind, B, M, N, fn, ms):
    """The launch plan of a cluster kernel at one shape, what the CUDA
    runtime says of it (clusters that fit, registers, spills), the clusters
    that would fit at each cluster size whose resident layout fits, and the
    SM clock under ~1.5 s of launches of `fn` (`ms` each)."""
    import ctypes

    from e2e_multi_view_matching_tpu_torch.ops import cuda_build
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc

    plan = sc.kernel_plan(kind, B, M, N)
    lib = cuda_build.load("sinkhorn_cuda", sc._SIGNATURES)
    by_size = {}
    for cs in (1, 2, 4, 8, 16):  # 16: a non-portable cluster size
        band = -(-M // cs)
        smem = 4 * sc._smem_floats(kind, plan["resident"], band, N, plan["column_slots"])
        if smem <= sc.SMEM_BYTES:
            info = (ctypes.c_int * 3)()
            rc = lib.sinkhorn_cluster_info(sc.CLUSTER_KINDS.index(kind), int(plan["resident"]),
                                           plan["column_slots"], cs, smem, info)
            by_size[cs] = info[0] if rc == 0 else f"error {rc}"
    return {"cluster_size": plan["cluster_size"],
            "residency": "resident" if plan["resident"] else "streamed",
            "n_clusters": plan["n_clusters"], "clusters_that_fit": plan["clusters_that_fit"],
            "clusters_that_fit_by_size": by_size, "column_slots": plan["column_slots"],
            "registers": plan["registers"], "local_bytes": plan["local_bytes"],
            "shared_bytes": plan["smem_bytes"], **_sm_clock_under(fn, max(1, int(1500 / ms)))}


def _per_iteration(run, ms_100):
    """A solve's time split into a per-iteration slope and an intercept (the
    band's load and the output, and the launch): `run(T)` solves with T
    iterations, `ms_100` is its time at T = 100; T = 10 is timed here."""
    ms_10 = cuda_ms(lambda: run(10), 3)
    slope = (ms_100 - ms_10) / 90
    return {"ms_T10": ms_10, "ms_T100": ms_100, "us_per_iteration": slope * 1e3,
            "intercept_ms": ms_10 - 10 * slope}


def _sinkhorn_record(g):
    """`sinkhorn_scaling` at the eval shape (80 pair matrices of 1025 x 1025,
    streamed) and the validation shape (80 of 401 x 401, resident): against
    its plain version, at score scales 4 and 400, two runs giving the same
    bits."""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc
    from e2e_multi_view_matching_tpu_torch.ops.sinkhorn import log_optimal_transport

    dev = torch.device("cuda")
    B, T = 80, 100  # B*P pair matrices of an eval chunk, 100 iterations
    alpha = torch.ones((), device=dev)

    def shape(K, scales):
        errs = {}
        for scale, tol in scales:
            scores = torch.randn(B, K, K, generator=g, device=dev) * scale
            z = sc.log_optimal_transport_cuda(scores, alpha, T)
            z_again = sc.log_optimal_transport_cuda(scores, alpha, T)
            z_ref = log_optimal_transport(scores, alpha, T, impl="mxu")
            torch.cuda.synchronize()
            where = f"sinkhorn_scaling at {B} x {K + 1} x {K + 1}, scale {scale}"
            check(bool(torch.isfinite(z).all()), f"{where}: non-finite output")
            check(bool(torch.equal(z, z_again)), f"{where}: two runs give different bits")
            zmax = float(z.max())
            check(zmax < math.log(2 * K) + 1.0, f"{where}: max log_p {zmax} above log(2K)+1")
            err = _prob_err(z, z_ref)
            check(err <= tol, f"{where}: max prob err {err} > {tol}")
            errs[scale] = err
            if scale == 4.0:
                run = lambda: sc.log_optimal_transport_cuda(scores, alpha, T)  # noqa: E731
                ms = cuda_ms(run, 3)
                plain_ms = cuda_ms(lambda: log_optimal_transport(scores, alpha, T, impl="mxu"), 2)
                info = _cluster_info("scaling", B, K + 1, K + 1, run, ms)
                split = _per_iteration(
                    lambda t: sc.log_optimal_transport_cuda(scores, alpha, t), ms)
            del z, z_again, z_ref, scores
        b_ms, b_by, b_unit = _scaling_bound(B, K + 1, K + 1, T)
        return errs, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "bound_unit": b_unit, "library_ms": None, "shape": [B, K + 1, K + 1, T],
                      "bitwise_repeatable": True, **info, "per_iteration": split}

    errs, measured = shape(1024, ((4.0, SINKHORN_TOL), (400.0, SINKHORN_EXTREME_TOL)))
    errs_t, measured_t = shape(400, ((4.0, SINKHORN_TOL),))
    wide = [_sinkhorn_wide_shape(g, B_wide) for B_wide in (8, 80)]
    return {"name": "sinkhorn_scaling", "route": "cuda",
            "source": f"{PKG}/ops/csrc/sinkhorn_cuda.cu",
            "replaces": "e2e_multi_view_matching_tpu/ops/sinkhorn_pallas.py:106",
            "launches": 0, "max_abs_err": errs[4.0], "tol": SINKHORN_TOL,
            "max_abs_err_scale400": errs[400.0], "tol_scale400": SINKHORN_EXTREME_TOL,
            **measured,
            "train_shapes": [{"max_abs_err": errs_t[4.0], "tol": SINKHORN_TOL, **measured_t}],
            "wide_shapes": wide}


def _scaling_bound(B, M, N, T):
    """`bound` of a scaling-domain solve of B pair matrices of M x N, T
    iterations: 4 flops per entry per scaling iteration (two matvecs), the
    exact first iteration (2 exp + 4 add/max per entry), one exp + 2 adds per
    entry per rebuild, 3 for the output; couplings read once, log assignment
    written once; 2 + n_absorb exponentials per entry."""
    from e2e_multi_view_matching_tpu_torch.ops.sinkhorn_cuda import ABSORB_EVERY

    n_absorb = T // ABSORB_EVERY
    elems = float(B * M * N)
    return bound(elems * (4 * (T - 1) + 6 + 3 * n_absorb + 3), 2.0 * elems * 4,
                 exps=elems * (2 + n_absorb))


def _sinkhorn_wide_shape(g, B, K=2048, T=100):
    """`sinkhorn_scaling` in its wide instantiation at B pair matrices of
    (K+1) x (K+1) (the two-view pairs and the multi-view chunk at K = 2048):
    against its plain version, the same bits on two runs, no spill; its
    time, plan and per-iteration split. (`tools/torch_sinkhorn_times.py
    --kernel scaling --cluster_counts` times the solve at other cluster
    counts.)"""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc
    from e2e_multi_view_matching_tpu_torch.ops.sinkhorn import log_optimal_transport

    dev = torch.device("cuda")
    alpha = torch.ones((), device=dev)
    M = N = K + 1
    where = f"sinkhorn_scaling at {B} x {M} x {N}"
    scores = torch.randn(B, K, K, generator=g, device=dev) * 4.0
    z = sc.log_optimal_transport_cuda(scores, alpha, T)
    z_again = sc.log_optimal_transport_cuda(scores, alpha, T)
    z_ref = log_optimal_transport(scores, alpha, T, impl="mxu")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(z).all()), f"{where}: non-finite output")
    check(bool(torch.equal(z, z_again)), f"{where}: two runs give different bits")
    err = _prob_err(z, z_ref)
    check(err <= SINKHORN_TOL, f"{where}: max prob err {err} > {SINKHORN_TOL}")
    del z_again, z_ref
    run = lambda: sc.log_optimal_transport_cuda(scores, alpha, T)  # noqa: E731
    ms = cuda_ms(run, 3)
    plain_ms = cuda_ms(lambda: log_optimal_transport(scores, alpha, T, impl="mxu"), 2)
    info = _cluster_info("scaling", B, M, N, run, ms)
    check(info["local_bytes"] == 0, f"{where}: {info['local_bytes']} bytes of spills")
    split = _per_iteration(lambda t: sc.log_optimal_transport_cuda(scores, alpha, t), ms)
    del z, scores
    torch.cuda.empty_cache()
    b_ms, b_by, b_unit = _scaling_bound(B, M, N, T)
    return {"shape": [B, M, N, T], "max_abs_err": err, "tol": SINKHORN_TOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "bitwise_repeatable": True, **info, "per_iteration": split}


def _sinkhorn_train_records(g):
    """The three log-domain kernels at the training shape: 80 pair matrices
    of 401 x 401 (B=8 tuples x 10 pairs, K=400), 100 iterations; and the
    stashed forward and the reverse sweep at 80 x 1025 x 1025 (a training
    shape at K = 1024, streamed). Each also timed at 10 iterations, for the
    per-iteration split."""
    import torch

    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn as ts
    from e2e_multi_view_matching_tpu_torch.ops import sinkhorn_cuda as sc

    dev = torch.device("cuda")
    B, K, T = 80, 400, 100
    M = N = K + 1
    alpha = torch.ones((), device=dev)
    scores = torch.randn(B, K, K, generator=g, device=dev) * 4.0
    C, log_mu, log_nu, norm = ts.augment_couplings(scores, alpha)
    w = torch.randn(B, M, N, generator=g, device=dev)
    elems = float(B * M * N)
    src = f"{PKG}/ops/csrc/sinkhorn_cuda.cu"
    jax_file = "e2e_multi_view_matching_tpu/ops/sinkhorn_pallas.py"

    def forward_errs(C, log_mu, log_nu, norm, where):
        """The log kernel without and with the stash against the plain
        stashed forward; the same bits on two runs and from both."""
        z_plain, U_plain, V_plain = ts.log_sinkhorn_stash(C, log_mu, log_nu, T)
        z_plain = z_plain - norm
        z_log = sc.sinkhorn_log(C, log_mu, log_nu, T, norm)
        z_again = sc.sinkhorn_log(C, log_mu, log_nu, T, norm)
        z_st, U, V = sc.sinkhorn_log_stash(C, log_mu, log_nu, T, norm)
        z_st_again = sc.sinkhorn_log_stash(C, log_mu, log_nu, T, norm)[0]
        torch.cuda.synchronize()
        err_log, err_st = _prob_err(z_log, z_plain), _prob_err(z_st, z_plain)
        err_uv = max(float((U - U_plain).abs().max()), float((V - V_plain).abs().max()))
        check(err_log <= SINKHORN_TOL,
              f"sinkhorn_log {where}: max prob err {err_log} > {SINKHORN_TOL}")
        check(err_st <= SINKHORN_TOL,
              f"sinkhorn_log_stash {where}: max prob err {err_st} > {SINKHORN_TOL}")
        check(err_uv <= SINKHORN_DUAL_TOL,
              f"sinkhorn_log_stash {where}: max dual err {err_uv} > {SINKHORN_DUAL_TOL}")
        check(bool(torch.equal(z_log, z_again)), f"sinkhorn_log {where}: two runs differ")
        check(bool(torch.equal(z_st, z_st_again)), f"sinkhorn_log_stash {where}: two runs differ")
        check(bool(torch.equal(z_log, z_st)),
              f"sinkhorn_log and sinkhorn_log_stash {where} differ")
        return err_log, err_st, err_uv, U, V, U_plain, V_plain

    # forward: exact log domain, without and with the stash
    err_log, err_st, err_uv, U, V, U_plain, V_plain = forward_errs(
        C, log_mu, log_nu, norm, f"at {B} x {M} x {N}")

    def sweep_err(C, U, V, w, log_mu, log_nu, G, G_plain, Kk, where):
        ds, da = sc.dustbin_grads(G, Kk, Kk)
        ds_p, da_p = sc.dustbin_grads(G_plain, Kk, Kk)
        err = float((ds - ds_p).abs().max()) / max(float(ds_p.abs().max()), 1.0)
        err_a = abs(float(da) - float(da_p))
        check(err <= SINKHORN_GRAD_TOL,
              f"sinkhorn_bwd {where} vs manual sweep: scaled dscores err {err} > {SINKHORN_GRAD_TOL}")
        check(err_a <= SINKHORN_ALPHA_TOL * max(1.0, abs(float(da_p))),
              f"sinkhorn_bwd {where} vs manual sweep: dalpha {float(da)} vs {float(da_p)}")
        return err, err_a

    # backward: against the manual sweep (all pairs) and autograd (16 pairs)
    G = sc.sinkhorn_bwd(C, U, V, w, log_mu, log_nu)
    G_again = sc.sinkhorn_bwd(C, U, V, w, log_mu, log_nu)
    G_plain = ts.log_sinkhorn_bwd(C, U_plain, V_plain, w, log_mu, log_nu)
    torch.cuda.synchronize()
    check(bool(torch.equal(G, G_again)), "sinkhorn_bwd: two runs give different bits")
    err_bwd, err_da = sweep_err(C, U, V, w, log_mu, log_nu, G, G_plain, K, f"at {B} x {M} x {N}")
    nb = 16
    s_ag = scores[:nb].clone().requires_grad_()
    a_ag = alpha.clone().requires_grad_()
    z_ag = ts.log_optimal_transport(s_ag, a_ag, T, impl="xla")
    ds_ag, da_ag = torch.autograd.grad((z_ag * w[:nb]).sum(), (s_ag, a_ag))
    s_k = scores[:nb].clone().requires_grad_()
    a_k = alpha.clone().requires_grad_()
    z_k = sc.log_optimal_transport_cuda(s_k, a_k, T)
    ds_k, da_k = torch.autograd.grad((z_k * w[:nb]).sum(), (s_k, a_k))
    torch.cuda.synchronize()
    err_ag = float((ds_k - ds_ag).abs().max()) / max(float(ds_ag.abs().max()), 1.0)
    err_da_ag = abs(float(da_k) - float(da_ag))
    check(err_ag <= SINKHORN_GRAD_TOL,
          f"sinkhorn_bwd vs autograd: scaled dscores err {err_ag} > {SINKHORN_GRAD_TOL}")
    check(err_da_ag <= SINKHORN_ALPHA_TOL * max(1.0, abs(float(da_ag))),
          f"sinkhorn_bwd vs autograd: dalpha {float(da_k)} vs {float(da_ag)}")
    del z_ag, z_k, ds_ag, ds_k, G_again

    # extreme scores (random-init magnitude): everything stays finite
    s400 = (torch.randn(nb, K, K, generator=g, device=dev) * 400.0).requires_grad_()
    a400 = alpha.clone().requires_grad_()
    z400 = sc.log_optimal_transport_cuda(s400, a400, T)
    ds400, da400 = torch.autograd.grad((z400 * w[:nb]).sum(), (s400, a400))
    check(bool(torch.isfinite(z400).all() and torch.isfinite(ds400).all()
               and torch.isfinite(da400)), "sinkhorn log/bwd: non-finite at score scale 400")
    check(float(z400.detach().max()) < math.log(2 * K) + 1.0,
          "sinkhorn_log_stash: log_p above ceiling")

    def run_log(C, log_mu, log_nu, norm):
        return lambda t=T: sc.sinkhorn_log(C, log_mu, log_nu, t, norm)

    def run_stash(C, log_mu, log_nu, norm):
        return lambda t=T: sc.sinkhorn_log_stash(C, log_mu, log_nu, t, norm)

    run_l, run_s = run_log(C, log_mu, log_nu, norm), run_stash(C, log_mu, log_nu, norm)
    ms_log, ms_st = cuda_ms(run_l, 3), cuda_ms(run_s, 3)
    info_log = {**_cluster_info("log", B, M, N, run_l, ms_log),
                "per_iteration": _per_iteration(run_l, ms_log)}
    info_st = {**_cluster_info("log", B, M, N, run_s, ms_st),
               "per_iteration": _per_iteration(run_s, ms_st)}
    run_bwd = lambda: sc.sinkhorn_bwd(C, U, V, w, log_mu, log_nu)  # noqa: E731
    ms_bwd = cuda_ms(run_bwd, 3)
    info_bwd = _cluster_info("bwd", B, M, N, run_bwd, ms_bwd)
    U10, V10 = U[:, :10].contiguous(), V[:, :10].contiguous()  # a 10-iteration solve's duals
    info_bwd["per_iteration"] = _per_iteration(
        lambda t: sc.sinkhorn_bwd(C, U10, V10, w, log_mu, log_nu), ms_bwd)
    del U10, V10
    plain_fwd = cuda_ms(lambda: ts.log_sinkhorn(C, log_mu, log_nu, T), 2)
    plain_st = cuda_ms(lambda: ts.log_sinkhorn_stash(C, log_mu, log_nu, T), 2)
    plain_bwd = cuda_ms(lambda: ts.log_sinkhorn_bwd(C, U, V, w, log_mu, log_nu), 2)
    # per entry and iteration: each half-step adds the dual, takes the max,
    # subtracts it, exponentiates and sums (5), twice; 3 for the output; two
    # exponentials
    fwd_ops, fwd_exps = elems * (10 * T + 3), elems * 2 * T
    stash_bytes = 4.0 * B * T * (M + N)
    # per entry and reverse step: Q and P each two adds, one exp, one multiply
    # and one sum (10), plus the two-term update of G (2); two exponentials
    bwd_ops, bwd_exps = elems * 12 * T, elems * 2 * T
    del G, G_plain, z400, ds400

    # the stashed forward and the sweep at 80 x 1025 x 1025: streamed from
    # device memory
    Kb = 1024
    Mb = Kb + 1
    elems_b = float(B * Mb * Mb)
    scores_b = torch.randn(B, Kb, Kb, generator=g, device=dev) * 4.0
    Cb, log_mu_b, log_nu_b, norm_b = ts.augment_couplings(scores_b, alpha)
    del scores_b
    _, err_st_b, err_uv_b, _, _, Ub, Vb = forward_errs(Cb, log_mu_b, log_nu_b, norm_b,
                                                       f"at {B} x {Mb} x {Mb}")
    run_sb = run_stash(Cb, log_mu_b, log_nu_b, norm_b)
    ms_sb = cuda_ms(run_sb, 3)
    info_sb = {**_cluster_info("log", B, Mb, Mb, run_sb, ms_sb),
               "per_iteration": _per_iteration(run_sb, ms_sb)}
    plain_sb = cuda_ms(lambda: ts.log_sinkhorn_stash(Cb, log_mu_b, log_nu_b, T), 1)
    sb_ms, sb_by, sb_unit = bound(elems_b * (10 * T + 3), 2 * 4 * elems_b + 4.0 * B * T * 2 * Mb,
                                  exps=elems_b * 2 * T)
    big_stash = {"max_abs_err": err_st_b, "tol": SINKHORN_TOL, "max_abs_err_duals": err_uv_b,
                 "tol_duals": SINKHORN_DUAL_TOL, "bitwise_repeatable": True, "ms": ms_sb,
                 "plain_ms": plain_sb, "bound_ms": sb_ms, "bound_by": sb_by,
                 "bound_unit": sb_unit, "library_ms": None, "shape": [B, Mb, Mb, T], **info_sb}
    wb = torch.randn(B, Mb, Mb, generator=g, device=dev)
    Gb = sc.sinkhorn_bwd(Cb, Ub, Vb, wb, log_mu_b, log_nu_b)
    Gb_again = sc.sinkhorn_bwd(Cb, Ub, Vb, wb, log_mu_b, log_nu_b)
    Gb_plain = ts.log_sinkhorn_bwd(Cb, Ub, Vb, wb, log_mu_b, log_nu_b)
    torch.cuda.synchronize()
    check(bool(torch.equal(Gb, Gb_again)), f"sinkhorn_bwd at {B} x {Mb} x {Mb}: two runs differ")
    err_b, err_da_b = sweep_err(Cb, Ub, Vb, wb, log_mu_b, log_nu_b, Gb, Gb_plain, Kb,
                                f"at {B} x {Mb} x {Mb}")
    del Gb, Gb_again, Gb_plain
    run_b = lambda: sc.sinkhorn_bwd(Cb, Ub, Vb, wb, log_mu_b, log_nu_b)  # noqa: E731
    ms_b = cuda_ms(run_b, 2)
    info_b = _cluster_info("bwd", B, Mb, Mb, run_b, ms_b)
    plain_b = cuda_ms(lambda: ts.log_sinkhorn_bwd(Cb, Ub, Vb, wb, log_mu_b, log_nu_b), 1)
    bb_ms, bb_by, bb_unit = bound(elems_b * 12 * T, 3 * 4 * elems_b + 8.0 * B * T * Mb,
                                  exps=elems_b * 2 * T)
    big_sweep = {"max_abs_err": err_b, "tol": SINKHORN_GRAD_TOL, "dalpha_abs_err": err_da_b,
                 "bitwise_repeatable": True, "ms": ms_b, "plain_ms": plain_b,
                 "bound_ms": bb_ms, "bound_by": bb_by, "bound_unit": bb_unit,
                 "library_ms": None, "shape": [B, Mb, Mb, T], **info_b}
    del Cb, Ub, Vb, wb

    records = []
    for name, line, err, tol, ms, plain_ms, ops, exps, nbytes, extra in (
        ("sinkhorn_log", 65, err_log, SINKHORN_TOL, ms_log, plain_fwd, fwd_ops, fwd_exps,
         2 * 4 * elems, {"bitwise_repeatable": True, "same_bits_as_stash": True, **info_log}),
        ("sinkhorn_log_stash", 202, err_st, SINKHORN_TOL, ms_st, plain_st, fwd_ops, fwd_exps,
         2 * 4 * elems + stash_bytes,
         {"max_abs_err_duals": err_uv, "tol_duals": SINKHORN_DUAL_TOL,
          "bitwise_repeatable": True, "same_bits_as_log": True, **info_st,
          "other_shapes": [big_stash]}),
        ("sinkhorn_bwd", 260, err_bwd, SINKHORN_GRAD_TOL, ms_bwd, plain_bwd, bwd_ops, bwd_exps,
         3 * 4 * elems + stash_bytes,
         {"dalpha_abs_err": err_da, "tol_dalpha": SINKHORN_ALPHA_TOL,
          "max_abs_err_vs_autograd": err_ag, "dalpha_abs_err_vs_autograd": err_da_ag,
          "finite_at_scale400": True, "bitwise_repeatable": True, **info_bwd,
          "other_shapes": [big_sweep]}),
    ):
        b_ms, b_by, b_unit = bound(ops, nbytes, exps=exps)
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{jax_file}:{line}", "launches": 0,
                        "max_abs_err": err, "tol": tol, **extra, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_unit": b_unit, "library_ms": None, "shape": [B, M, N, T]})
    return records


def kernel_phase():
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    train32 = _cross_attn_train_records(g)
    records = (_attention_records(g) + train32 + _cross_attn_train_bf16_records(g, train32)
               + [_sinkhorn_record(g)] + _sinkhorn_train_records(g))
    sharp = _sinkhorn_sharp()
    next(r for r in records if r["name"] == "sinkhorn_scaling")["sharp_scores"] = sharp
    for r in records:
        emit({"phase": "kernel", **r})
    return records


def _rotation(w):
    th = float(np.linalg.norm(w))
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx


def _synthetic_tuple(rng, V=5, K=64, n_true=48, noise_px=0.1):
    """Exact matcher output for a V-tuple viewing a random point cloud: GT
    world->cam extrinsics, pixel keypoints (same slot = same point), matches
    between the first `n_true` visible slots plus 10% outliers."""
    f, W, H = 140.0, 160, 120
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    extr = np.tile(np.eye(4), (V, 1, 1))
    for v in range(1, V):
        extr[v, :3, :3] = _rotation(rng.normal(size=3) * 0.1)
        extr[v, :3, 3] = rng.normal(size=3) * 0.8 * np.array([1.0, 1.0, 0.3])
    pix = rng.uniform([15, 15], [W - 15, H - 15], size=(K, 2))
    rays = np.concatenate([pix, np.ones((K, 1))], -1) @ np.linalg.inv(intr).T
    X = rays * rng.uniform(4.0, 12.0, size=(K, 1))
    kpts = np.zeros((V, K, 2), np.float32)
    vis = np.zeros((V, K), bool)
    for v in range(V):
        Xc = X @ extr[v, :3, :3].T + extr[v, :3, 3]
        p = (Xc @ intr.T)[:, :2] / Xc[:, 2:]
        inb = (Xc[:, 2] > 0.2) & (p[:, 0] > 5) & (p[:, 0] < W - 5) & (p[:, 1] > 5) & (p[:, 1] < H - 5)
        kpts[v] = np.where(inb[:, None], p, rng.uniform(10, 100, size=(K, 2)))
        kpts[v] += rng.normal(size=(K, 2)) * noise_px
        vis[v] = inb
    pairs = [(i, j) for j in range(V) for i in range(j)]
    matches0 = np.full((len(pairs), K), -1, np.int32)
    conf = np.zeros((len(pairs), K), np.float32)
    for p_idx, (i, j) in enumerate(pairs):
        good = np.flatnonzero(vis[i] & vis[j])[:n_true]
        matches0[p_idx, good] = good
        conf[p_idx, good] = rng.uniform(0.6, 1.0, size=len(good))
        for s in np.flatnonzero(~(vis[i] & vis[j]))[:len(good) // 10]:
            matches0[p_idx, s] = rng.integers(0, K)
            conf[p_idx, s] = rng.uniform(0.1, 0.3)
    return extr, kpts, np.tile(intr, (V, 1, 1)), matches0, conf


def reference_phase():
    """The pose pipeline on the card recovers the known poses of exact
    synthetic 5-tuples (the JAX package's test_mv_pipeline bound: < 1 deg)."""
    import torch

    from e2e_multi_view_matching_tpu_torch.mvba.pipeline import multi_view_pose_device

    rng = np.random.default_rng(0)
    cases = [_synthetic_tuple(rng) for _ in range(4)]
    stack = [torch.from_numpy(np.stack([c[k] for c in cases])).cuda() for k in (1, 2, 3, 4)]
    extr = multi_view_pose_device(*stack).cpu().numpy()
    check(np.all(np.isfinite(extr)), "reference: non-finite extrinsics")
    worst = 0.0
    for (gt, *_), est in zip(cases, extr):
        for j in range(5):
            for i in range(j):
                R_gt = (gt[j] @ np.linalg.inv(gt[i]))[:3, :3]
                R = (est[j] @ np.linalg.inv(est[i]))[:3, :3]
                cos = np.clip((np.trace(R_gt.T @ R) - 1) / 2, -1, 1)
                worst = max(worst, float(np.degrees(np.arccos(cos))))
    check(worst < 1.0, f"reference: max pairwise rotation error {worst} deg >= 1")
    emit({"phase": "reference", "tuples": len(cases), "max_rot_err_deg": worst, "tol": 1.0})


def _full_width_models(seed=0, compute_dtype="float32", match_threshold=0.2):
    """SuperPoint and the 5-view matcher at the eval widths with seeded random
    weights drawn as flax draws them by default (LeCun normal, zero bias):
    after 28 GNN layers the pair scores reach |s| ~ 1e2-1e3, the regime the
    Sinkhorn kernel must survive. Returns (superpoint, kernel matcher with
    "auto" resolved on the GPU, plain matcher); the same weights in either
    `compute_dtype` and at any `match_threshold`."""
    import types

    import torch

    from e2e_multi_view_matching_tpu_torch.models.matcher import (
        MatcherConfig,
        MultiViewMatcher,
        default_gnn_layers,
    )
    from e2e_multi_view_matching_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )
    from e2e_multi_view_matching_tpu_torch.utils.config import resolve_kernel_impls

    def matcher(att, sink):
        return MultiViewMatcher(MatcherConfig(
            gnn_layers=default_gnn_layers(7, 3), sinkhorn_iterations=100, conf_mlp=True,
            multi_frame_matching=True, attention_impl=att, sinkhorn_impl=sink,
            compute_dtype=compute_dtype, match_threshold=match_threshold))

    from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_

    g = torch.Generator().manual_seed(seed)
    impls = resolve_kernel_impls(
        types.SimpleNamespace(attention_impl="auto", sinkhorn_impl="auto"), "cuda")
    sp = SuperPoint(SuperPointConfig(nms_radius=4, keypoint_threshold=0.001,
                                     max_keypoints=1024, remove_borders=12,
                                     fill_with_random_keypoints=False,
                                     compute_dtype=compute_dtype))
    kernels = matcher(impls.attention_impl, impls.sinkhorn_impl)
    init_like_flax_(sp, g)
    init_like_flax_(kernels, g)
    plain = matcher("xla", "mxu")
    plain.load_state_dict(kernels.state_dict())
    return sp, kernels, plain


def _dataset(n, V=5, H=480, W=640, seed=0):
    """`n` seeded tuples of smooth random images with ScanNet-like intrinsics."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    intr = np.tile(np.array([[580, 0, W / 2, 0], [0, 580, H / 2, 0], [0, 0, 1, 0],
                             [0, 0, 0, 1]], np.float32), (V, 1, 1))
    samples = []
    for _ in range(n):
        images = np.zeros((V, H, W, 1), np.float32)
        for v in range(V):
            img = np.zeros((H, W), np.float32)
            for _ in range(12):
                k = rng.normal(size=2) * 0.08
                img += np.sin(k[0] * xx + k[1] * yy + rng.uniform(0, 2 * np.pi))
            img += rng.normal(size=(H, W)).astype(np.float32) * 0.3
            images[v, ..., 0] = (img - img.min()) / (img.max() - img.min())
        poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(V, 3))
        samples.append({"images": images, "intr": intr, "poses": poses})
    return samples


def _reset_launches():
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda, sinkhorn_cuda

    for counts in (attention_cuda.launches, sinkhorn_cuda.launches):
        for k in counts:
            counts[k] = 0


def _launches():
    from e2e_multi_view_matching_tpu_torch.ops import attention_cuda, sinkhorn_cuda

    return {**attention_cuda.launches, **sinkhorn_cuda.launches}


def main_path_phase(n_tuples=8):
    """`evaluate` at full width on the kernels and on the plain versions."""
    import types
    import warnings

    import torch

    from e2e_multi_view_matching_tpu_torch.cli.eval_multi_view import (
        evaluate,
        infer_subchunk,
    )

    sp, kernels, plain = _full_width_models()
    data = _dataset(8)
    dataset = [data[i % len(data)] for i in range(n_tuples)]
    opt = types.SimpleNamespace(tuple_size=5, max_tuples=None, eval_batch=8, eval_scan=1,
                                no_pipeline=False, compute_dtype="float32")
    runs = {}
    for name, matcher in (("kernels", kernels), ("plain", plain)):
        evaluate(opt, sp, matcher, dataset[:8])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        if name == "kernels":
            _reset_launches()
        t0 = time.perf_counter()
        errors = evaluate(opt, sp, matcher, dataset)
        dt = time.perf_counter() - t0
        if name == "kernels":
            launches = _launches()
        check(len(errors[0]) == n_tuples * 10 and np.all(np.isfinite(errors[1])),
              f"main path ({name}): errors missing or non-finite")
        runs[name] = {"tuples_per_s": n_tuples / dt, "seconds": dt}

    # one sub-chunk through both matchers: agreement, finiteness, host syncs
    s = dataset[:8]
    images = torch.from_numpy(np.stack([x["images"] for x in s])).cuda()
    intr = torch.from_numpy(np.stack([x["intr"][:, :3, :3] for x in s])).cuda()
    size = torch.tensor([480.0, 640.0], device="cuda").expand(8, 5, 2)
    with torch.inference_mode():
        out_k = infer_subchunk(sp, kernels, images, intr, size)
        out_p = infer_subchunk(sp, plain, images, intr, size)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                infer_subchunk(sp, kernels, images, intr, size)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    agree = float((out_k[1] == out_p[1]).float().mean())
    finite = bool(torch.isfinite(out_k[3]).all() and torch.isfinite(out_p[3]).all())
    n_matches = int((out_k[1] >= 0).sum())
    # the debug mode's own notice is not a sync; every other warning names
    # the Python line that synchronised the host with the device
    syncs = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    emit({"phase": "main_path", "config": {"V": 5, "K": 1024, "image": [480, 640],
                                           "gnn": "7x(self+3xcross)", "sinkhorn_iters": 100,
                                           "eval_batch": 8, "tuples": n_tuples},
          "tuples_per_s": runs["kernels"]["tuples_per_s"],
          "plain_tuples_per_s": runs["plain"]["tuples_per_s"], "runs": runs,
          "launches": launches, "matches0_agreement": agree, "matches_kernel_run": n_matches,
          "extrinsics_finite": finite, "host_syncs_in_sub_chunk": syncs})
    check(finite, "main path: non-finite extrinsics")
    check(not syncs, f"main path: host syncs inside infer_subchunk at {syncs}")
    check(agree >= 0.99, f"main path: matches0 agreement {agree} < 0.99")
    for k in ("attn_fwd", "cross_attn_fwd", "sinkhorn_scaling"):
        check(launches.get(k, 0) >= 1, f"main path never launched {k}")
    return launches, (sp, kernels, images, intr, size)


def _pose_errors(gt, est):
    """(max rotation error, max translation-direction error) in degrees over the
    pairs of one tuple: GT world->cam extrinsics against estimated ones."""
    rot = tr = 0.0
    V = len(gt)
    for j in range(V):
        for i in range(j):
            T_gt = gt[j] @ np.linalg.inv(gt[i])
            T = est[j] @ np.linalg.inv(est[i])
            cos = np.clip((np.trace(T_gt[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
            rot = max(rot, float(np.degrees(np.arccos(cos))))
            n = np.linalg.norm(T_gt[:3, 3]) * np.linalg.norm(T[:3, 3])
            if n > 1e-9:
                c = np.clip(T_gt[:3, 3] @ T[:3, 3] / n, -1, 1)
                tr = max(tr, float(np.degrees(np.arccos(c))))
    return rot, tr


def _host_sync_sites(fn):
    """(syncs, fn's result): each host sync of `fn()` as the port's frames from
    the synchronising call outwards, innermost first, e.g.
    ("config.py:fetch_packed:134", "eval_multi_view.py:dispatch:221", ...)."""
    import traceback
    import warnings

    import torch

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1] if PKG in f.filename]
            syncs.append(tuple(f"{Path(f.filename).name}:{f.name}:{f.lineno}"
                               for f in reversed(frames)))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return syncs, out


def init_modes_phase(card, n_tuples=8):
    """The multi-view init modes (`--init_mode ransac|ransac_ba`) and the
    host-tree pipeline on the card.

    (a) The 4 exact synthetic 5-tuples of `reference_phase` through
    `multi_view_pose_pipeline_batch` in w8pt_ba, ransac and ransac_ba, and in
    w8pt_ba with `ba_retriangulate=True`: the largest pairwise rotation and
    translation-direction errors within INIT_MODE_BOUNDS; the host-tree
    w8pt_ba extrinsics within HOST_TREE_TOL of `multi_view_pose_device`'s.

    (b) `evaluate` at full width (the main path's seeded weights and images,
    V=5, K=1024, 480x640, 7 x (self + 3 x cross), 100 iterations, conf MLP,
    eval_batch 8) on `n_tuples` tuples (one sub-chunk at 8) in ransac and in
    ransac_ba, on the kernels, with the matcher at threshold 0 (at the drawn
    weights no match clears 0.2, and RANSAC needs matches; nearly all of them
    are wrong, so RANSAC runs to its iteration cap): finite errors, exact
    launches a sub-chunk (7 `attn_fwd`, 21 `cross_attn_fwd`, 1
    `sinkhorn_scaling`, nothing else), tuples/s, a RANSAC pose for at least
    half the pairs, the stage times of one sub-chunk (stage A: the host gather
    and RANSAC, in ransac_ba also the device two-view BA; the host trees; the
    device stage B with its copy back). The host syncs of the evaluate run by
    line; the only ones allowed are the copies the modes need by design, each
    through `fetch_packed`:
      - `cli/eval_multi_view.py::evaluate.dispatch`: the chunk's keypoints,
        matches and confidences to the host, for RANSAC;
      - `mvba/pipeline.py::_ransac_relative_poses` (ransac_ba): the refined
        poses and their gate to the host, for the trees;
      - `mvba/pipeline.py::multi_view_pose_from_stage_a`: the extrinsics to
        the host.
    Returns {"eval_ransac": launches, "eval_ransac_ba": launches}."""
    import dataclasses
    import types

    import torch

    from e2e_multi_view_matching_tpu_torch.cli.eval_multi_view import (
        evaluate,
        infer_subchunk,
    )
    from e2e_multi_view_matching_tpu_torch.mvba import pipeline as tpipe
    from e2e_multi_view_matching_tpu_torch.utils.config import fetch_packed

    Cfg = tpipe.MultiViewPipelineConfig
    dev = torch.device("cuda")

    # (a) exact synthetic tuples
    rng = np.random.default_rng(0)
    cases = [_synthetic_tuple(rng) for _ in range(4)]
    gt = [c[0] for c in cases]
    args = [np.stack([c[k] for c in cases]) for k in (1, 2, 3, 4)]
    synthetic = {}
    for name, cfg in (("w8pt_ba", Cfg()), ("ransac", Cfg(init_mode="ransac")),
                      ("ransac_ba", Cfg(init_mode="ransac_ba")),
                      ("w8pt_ba_retriangulate", Cfg(ba_retriangulate=True))):
        t0 = time.perf_counter()
        extr = tpipe.multi_view_pose_pipeline_batch(*args, cfg, device="cuda")
        seconds = time.perf_counter() - t0
        errs = [_pose_errors(g, e) for g, e in zip(gt, extr)]
        synthetic[name] = {"max_rot_err_deg": max(e[0] for e in errs),
                           "max_transl_err_deg": max(e[1] for e in errs),
                           "bounds_deg": INIT_MODE_BOUNDS[cfg.init_mode],
                           "finite": bool(np.all(np.isfinite(extr))), "seconds": seconds}
        if name == "w8pt_ba":
            fused = tpipe.multi_view_pose_device(
                *(torch.from_numpy(a).cuda() for a in args)).cpu().numpy()
            synthetic[name]["host_tree_vs_device_max_abs"] = float(np.abs(extr - fused).max())

    # (b) full width on the kernels, matcher at threshold 0
    sp, kernels, _ = _full_width_models(match_threshold=0.0)
    sp.cuda()  # the weights' copies are set-up, not a sub-chunk's syncs
    kernels.cuda()
    data = _dataset(8)
    dataset = [data[i % len(data)] for i in range(n_tuples)]
    opt = types.SimpleNamespace(tuple_size=5, max_tuples=None, eval_batch=8, eval_scan=1,
                                no_pipeline=False, compute_dtype="float32")
    s = dataset[:8]
    images = torch.from_numpy(np.stack([x["images"] for x in s])).cuda()
    intr_np = np.stack([x["intr"][:, :3, :3] for x in s])
    size = torch.tensor([480.0, 640.0], device="cuda").expand(8, 5, 2)
    runs, by_path = {}, {}
    for mode in ("ransac", "ransac_ba"):
        cfg = Cfg(init_mode=mode)
        # one evaluate: its time, launches and host syncs (the sync capture
        # costs a stack walk at each of the 2-3 syncs)
        _reset_launches()
        t0 = time.perf_counter()
        syncs, errors = _host_sync_sites(lambda: evaluate(opt, sp, kernels, dataset, cfg))
        dt = time.perf_counter() - t0
        launches = _launches()
        by_path[f"eval_{mode}"] = launches
        finite = len(errors[0]) == n_tuples * 10 and bool(np.all(np.isfinite(errors[1])))

        # one sub-chunk, stage by stage
        with torch.inference_mode():
            kpts, m0, conf, extr_dev = infer_subchunk(
                sp, kernels, images, torch.from_numpy(intr_np).cuda(), size, cfg)
            kpts, m0, conf = fetch_packed([kpts, m0, conf])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage_a = tpipe._ransac_stage_a(kpts, intr_np, m0, conf, cfg, dev)
            torch.cuda.synchronize()
            stage_a_s = time.perf_counter() - t0
            profile = {}
            tpipe.multi_view_pose_from_stage_a(stage_a, cfg, profile=profile)
        valid = stage_a["valid"].numpy()
        matches = (m0 >= 0).sum(-1)

        # the caller of each copy: "file:function" of the frame below fetch_packed
        callers = sorted({fr[1].rsplit(":", 1)[0] if len(fr) > 1 else " ".join(fr)
                          for fr in syncs})
        allowed = {"eval_multi_view.py:dispatch", "pipeline.py:multi_view_pose_from_stage_a"}
        if mode == "ransac_ba":
            allowed.add("pipeline.py:_ransac_relative_poses")
        runs[mode] = {
            "tuples_per_s": n_tuples / dt, "seconds": dt, "launches": launches,
            "errors_finite": finite, "pose_valid_share": float(valid.mean()),
            "matches_per_pair": {"min": int(matches.min()), "mean": float(matches.mean())},
            "sub_chunk_seconds": {"stage_a_ransac_host": stage_a_s, **profile},
            "fused_extrinsics": extr_dev is not None,
            "host_syncs_in_sub_chunk": ["  <-  ".join(fr[:2]) for fr in syncs[:20]],
            "host_sync_count": len(syncs), "sync_callers": callers,
            "only_allowed_syncs": (all(fr and fr[0].startswith("config.py:fetch_packed:")
                                       for fr in syncs) and set(callers) == allowed)}
    emit({"phase": "init_modes", "card": card,
          "config": {"V": 5, "K": 1024, "image": [480, 640], "gnn": "7x(self+3xcross)",
                     "sinkhorn_iters": 100, "eval_batch": 8, "tuples": n_tuples,
                     "match_threshold": 0.0},
          "synthetic": synthetic, "runs": runs})
    expected = {**{k: 0 for k in by_path["eval_ransac"]}, "attn_fwd": 7 * (n_tuples // 8),
                "cross_attn_fwd": 21 * (n_tuples // 8), "sinkhorn_scaling": n_tuples // 8}
    for mode, r in runs.items():
        check(r["errors_finite"], f"init_modes ({mode}): errors missing or non-finite")
        check(not r["fused_extrinsics"],
              f"init_modes ({mode}): infer_subchunk ran the fused pose stage")
        check(r["pose_valid_share"] >= 0.5, f"init_modes ({mode}): RANSAC posed "
              f"{r['pose_valid_share']:.2f} of the pairs, fewer than half")
        check(r["launches"] == expected, f"init_modes ({mode}): launched {r['launches']}, "
              f"expected {expected}")
        check(r["only_allowed_syncs"], f"init_modes ({mode}): host syncs "
              f"{r['host_syncs_in_sub_chunk']}; allowed: the packed copies of the "
              "phase's docstring")
    for name, r in synthetic.items():
        b = r["bounds_deg"]
        check(r["finite"] and r["max_rot_err_deg"] < b[0] and r["max_transl_err_deg"] < b[1],
              f"init_modes: synthetic {name} errors {r['max_rot_err_deg']:.3f} / "
              f"{r['max_transl_err_deg']:.3f} deg, bounds {b}")
    check(synthetic["w8pt_ba"]["host_tree_vs_device_max_abs"] < HOST_TREE_TOL,
          f"init_modes: host-tree w8pt_ba differs from multi_view_pose_device by "
          f"{synthetic['w8pt_ba']['host_tree_vs_device_max_abs']}")
    return by_path


def bf16_phase(n_tuples=8):
    """bfloat16 eval (`compute_dtype="bfloat16"`) at the full eval width: the
    seeded weights of `main_path`, `evaluate` on the bfloat16 kernels and on
    the plain bfloat16 versions (`multi_head_attention`), exact launches,
    finiteness and host syncs of a sub-chunk, the matches of both against the
    float32 kernels' on the same SuperPoint outputs (see BF16_MATCH_SLACK),
    and the stage times of a sub-chunk. Returns the kernel run's launches."""
    import types

    import torch

    from e2e_multi_view_matching_tpu_torch.cli.eval_multi_view import (
        evaluate,
        infer_subchunk,
    )

    sp, kernels, plain = _full_width_models(compute_dtype="bfloat16")
    sp32, kernels32, _ = _full_width_models()
    sp32, kernels32 = sp32.cuda().eval(), kernels32.cuda().eval()
    data = _dataset(8)
    dataset = [data[i % len(data)] for i in range(n_tuples)]
    opt = types.SimpleNamespace(tuple_size=5, max_tuples=None, eval_batch=8, eval_scan=1,
                                no_pipeline=False, compute_dtype="bfloat16")
    runs = {}
    for name, matcher in (("kernels", kernels), ("plain", plain)):
        evaluate(opt, sp, matcher, dataset[:8])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        errors = evaluate(opt, sp, matcher, dataset)
        dt = time.perf_counter() - t0
        if name == "kernels":
            launches = _launches()
        check(len(errors[0]) == n_tuples * 10 and np.all(np.isfinite(errors[1])),
              f"bf16 ({name}): errors missing or non-finite")
        runs[name] = {"tuples_per_s": n_tuples / dt, "seconds": dt}
    per_chunk = {**{k: 0 for k in launches}, "attn_fwd_bf16": 7, "cross_attn_fwd_bf16": 21,
                 "sinkhorn_scaling": 1}

    s = dataset[:8]
    images = torch.from_numpy(np.stack([x["images"] for x in s])).cuda()
    intr = torch.from_numpy(np.stack([x["intr"][:, :3, :3] for x in s])).cuda()
    size = torch.tensor([480.0, 640.0], device="cuda").expand(8, 5, 2)
    with torch.inference_mode():
        out = infer_subchunk(sp, kernels, images, intr, size)
        syncs = _host_syncs(lambda: infer_subchunk(sp, kernels, images, intr, size))
        # the matcher alone: the float32 SuperPoint's outputs into the float32
        # kernels, the bfloat16 kernels and the plain bfloat16 versions
        sp_out = sp32(images.reshape((40,) + images.shape[2:]))
        m_in = (sp_out["keypoints"].reshape(8, 5, -1, 2), sp_out["scores"].reshape(8, 5, -1),
                sp_out["descriptors"].reshape(8, 5, 1024, -1), size)
        m32, m_k, m_p = (m(*m_in)["matches0"] for m in (kernels32, kernels, plain))
    agree_k, n_matched = _match_agreement(m_k, m32)
    agree_p, n_p = _match_agreement(m_p, m32)
    # the standard error of the difference of two shares of ~n keypoints
    stderr = math.sqrt(2 * agree_p * (1 - agree_p) / max(1, min(n_matched, n_p)))
    limit = (1 - agree_p) + BF16_MATCH_SLACK + 3 * stderr
    agreement = {"bf16_kernels_f32_kernels": agree_k, "bf16_plain_f32_kernels": agree_p,
                 "bf16_kernels_bf16_plain": _match_agreement(m_k, m_p)[0],
                 "matched_keypoints": [n_matched, n_p], "stderr_of_difference": stderr,
                 "limit_disagreement": limit}
    finite = bool(torch.isfinite(out[3]).all())
    emit({"phase": "bf16", "config": {"V": 5, "K": 1024, "image": [480, 640],
                                      "gnn": "7x(self+3xcross)", "sinkhorn_iters": 100,
                                      "eval_batch": 8, "tuples": n_tuples,
                                      "compute_dtype": "bfloat16"},
          "tuples_per_s": runs["kernels"]["tuples_per_s"],
          "plain_tuples_per_s": runs["plain"]["tuples_per_s"], "runs": runs,
          "launches": launches, "launches_expected": per_chunk,
          "matches0_agreement_over_matched": agreement,
          "matches_kernel_run": int((out[1] >= 0).sum()), "extrinsics_finite": finite,
          "host_syncs_in_sub_chunk": syncs})
    check(launches == per_chunk, f"bf16: launched {launches}, expected {per_chunk}")
    check(finite, "bf16: non-finite extrinsics")
    check(not syncs, f"bf16: host syncs inside infer_subchunk at {syncs}")
    check(n_matched > 0, "bf16: no keypoint matched")
    check(1 - agree_k <= limit, f"bf16: the bf16 kernels' matches differ from the float32 "
          f"kernels' on {1 - agree_k} of the matched keypoints, the plain bf16 run's on "
          f"{1 - agree_p} (limit {limit})")
    # the stage times and the matcher's device time by kernel group (the bf16
    # self and cross kernels apart); one rep and the matcher alone under the
    # profiler keep the run near half its time limit
    breakdown_phase(sp, kernels, images, intr, size, reps=1, phase="breakdown_bf16",
                    profile="matcher")
    return launches


class _LossLog:
    """Collects the per-step train losses and the validation losses that
    `cli.train.train` logs (with --i_train 1 every step is logged, just after
    the read of its loss), and the host clock at each step's record."""

    def __init__(self):
        import logging

        outer = self
        self.train, self.val, self.step_end = [], [], []

        class Handler(logging.Handler):
            def emit(self, record):
                if record.msg.startswith("epoch %3d it"):
                    outer.step_end.append(time.perf_counter())
                    outer.train.append(float(record.args[-1]))
                elif record.msg.startswith("epoch %3d | val loss"):
                    outer.val.append(float(record.args[-1]))

        self.handler = Handler()
        self.logger = logging.getLogger("train")

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def train_path_phase(workdir, n_steps=6):
    """`cli.train.train` at the full ScanNet 5-tuple training width (V=5,
    K=400, B=8, 480x480, 7 x (self + 3 x cross), 100 Sinkhorn iterations, no
    conf MLP, f32) on seeded plane scenes: `n_steps` steps on one repeated
    batch and one validation batch, on the kernels and again on the plain
    versions from the same seeded initial state. Returns the kernel run's
    launch counts and its experiment name (under `workdir`), which stage 2
    starts from."""
    import warnings

    import torch

    from e2e_multi_view_matching_tpu_torch.cli import train as tcli
    from e2e_multi_view_matching_tpu_torch.data.synthetic import training_batch
    from e2e_multi_view_matching_tpu_torch.train import checkpoint as tckpt
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.train.optim import build_optimizer
    from e2e_multi_view_matching_tpu_torch.utils.config import to_device

    B, V, H, W = 8, 5, 480, 480
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    batch = training_batch(rng, B, V, H, W, f=577.0)
    val_batch = training_batch(rng, B, V, H, W, f=577.0)
    data_s = time.perf_counter() - t0

    def run(workdir, att, sink, steps, tag):
        opt = tcli.parse_args([
            "--checkpoint_dir", workdir, "--dataset", "scannet", "--tuple_size", str(V),
            "--batch_size", str(B), "--n_epochs", "1", "--max_steps", str(steps),
            "--i_train", "1", "--no_tensorboard", "--attention_impl", att,
            "--sinkhorn_impl", sink, "--dump_first_grad", f"{workdir}/{tag}"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _LossLog() as losses:
            state = tcli.train(opt, lambda epoch: iter([batch] * steps),
                               lambda epoch: iter([val_batch]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _launches()
        check(state.step == steps and len(losses.train) == steps and len(losses.val) == 1,
              f"train path ({tag}): {state.step} steps, {len(losses.train)} losses logged")
        check(all(math.isfinite(x) for x in losses.train + losses.val),
              f"train path ({tag}): non-finite loss {losses.train} {losses.val}")
        grads = dict(np.load(f"{workdir}/{tag}_p0.npz"))
        # steps 2..n of the loop itself: batch to the device, step, read of the
        # metrics, trackers and logging (step 1 carries cuDNN's plan search)
        loop_sps = (steps - 1) / (losses.step_end[-1] - losses.step_end[0])
        return opt, state, counts, {
            "steps_per_s": loop_sps, "tuples_per_s": loop_sps * B,
            "train_losses": losses.train, "val_loss": losses.val[0],
            "seconds_with_setup_and_checkpoints": dt,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}, grads

    def step_fn_steps_per_s(opt, state, reps=3):
        """Steps/s of the step function alone on a batch that already lies on
        the device (host clock, each step ended by the read of its loss): a
        per-layer figure, without the loop's host-to-device copy."""
        sp, _ = tcli.build_models(opt)
        sp.cuda().eval()
        step = tstep.make_train_step(sp, opt)
        dev = {k: to_device(v, "cuda") for k, v in batch.items()}
        gen = torch.Generator(device="cuda").manual_seed(2)
        float(step(state, dev, gen)["train_loss"])
        t0 = time.perf_counter()
        for _ in range(reps):
            float(step(state, dev, gen)["train_loss"])
        return reps / (time.perf_counter() - t0), (sp, step, dev, gen)

    opt_k, state_k, launches, run_k, grads_k = run(workdir, "cuda", "cuda", n_steps, "kernels")
    fn_sps_k, (sp, step, dev, gen) = step_fn_steps_per_s(opt_k, state_k)

    # a checkpoint that `train` wrote reads back into a fresh state
    fresh_m = tcli.build_models(opt_k, seed=1)[1].cuda()
    fresh = tstep.TrainState(fresh_m, build_optimizer(
        fresh_m.named_parameters(), opt_k.lr, opt_k.decay_rate, opt_k.start_decay,
        opt_k.end_decay))
    _, epoch, _, info = tckpt.load_checkpoint(f"{workdir}/{opt_k.exp_name}", fresh, "last")
    check(epoch == 0 and fresh.step == n_steps and not info["missing"]
          and not info["unexpected"] and int(fresh.optimizer.count) == n_steps,
          "train path: the checkpoint did not read back")

    # host syncs inside one step, before its metrics are read
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = step(state_k, dev, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    check(math.isfinite(float(metrics["train_loss"])), "train path: non-finite loss")
    breakdown = _train_breakdown(sp, opt_k, state_k, dev, gen)
    del state_k, fresh, fresh_m, step, metrics
    torch.cuda.empty_cache()
    grad_reference = _grad_reference(tcli, tstep, opt_k, sp, dev, gen)
    torch.cuda.empty_cache()

    opt_p, state_p, _, run_p, grads_p = run(workdir, "xla", "xla", n_steps, "plain")
    fn_sps_p, _ = step_fn_steps_per_s(opt_p, state_p)
    del state_p
    torch.cuda.empty_cache()

    top = max(float(np.linalg.norm(g)) for g in grads_p.values())
    diffs = sorted(float(np.linalg.norm(grads_k[k] - grads_p[k])) / top for k in grads_p)
    worst, median = diffs[-1], diffs[len(diffs) // 2]
    emit({"phase": "train_path",
          "config": {"V": V, "K": 400, "B": B, "image": [H, W], "gnn": "7x(self+3xcross)",
                     "sinkhorn_iters": 100, "conf_mlp": False, "steps": n_steps,
                     "lr": opt_k.lr},
          "steps_per_s": run_k["steps_per_s"], "tuples_per_s": run_k["tuples_per_s"],
          "plain_steps_per_s": run_p["steps_per_s"],
          "plain_tuples_per_s": run_p["tuples_per_s"],
          "step_fn_steps_per_s": fn_sps_k, "plain_step_fn_steps_per_s": fn_sps_p,
          "runs": {"kernels": run_k, "plain": run_p}, "launches": launches,
          "first_step_grad_leaf_diff_over_top_norm": {
              "worst": worst, "tol_worst": TRAIN_GRAD_WORST_TOL, "median": median,
              "tol_median": TRAIN_GRAD_MEDIAN_TOL},
          "first_step_grad_top_leaf_norm": top, "grad_reference_f64": grad_reference,
          "host_syncs_in_step": syncs,
          "data_seconds": data_s, "breakdown_one_step": breakdown})
    check(top > 0 and worst <= TRAIN_GRAD_WORST_TOL and median <= TRAIN_GRAD_MEDIAN_TOL,
          f"train path: first-step gradients of the kernel and plain runs differ by "
          f"{worst} (worst leaf) / {median} (median leaf) of the largest leaf norm")
    for name, r in (("kernels", run_k), ("plain", run_p)):
        check(r["train_losses"][-1] < r["train_losses"][0],
              f"train path ({name}): loss did not fall on the repeated batch: "
              f"{r['train_losses']}")
    check(not syncs, f"train path: host syncs inside one train step at {syncs}")
    expected = _train_launches(n_steps, val_batches=1)
    check(launches == expected, f"train path: launches {launches}, expected {expected}")
    return launches, opt_k.exp_name


def _train_launches(n_steps, val_batches):
    """Kernel launches of `n_steps` train steps and `val_batches` validation
    batches at 7 x (self + 3 x cross): per step 7 self layers on attn_fwd, 21
    cross layers on the LSE forward and the two backward kernels, one stash
    solve and one reverse sweep; per validation batch 7 attn_fwd, 21
    cross_attn_fwd and one scaling-domain solve."""
    return {"attn_fwd": 7 * (n_steps + val_batches), "cross_attn_fwd": 21 * val_batches,
            "cross_attn_fwd_lse": 21 * n_steps, "cross_attn_bwd_dq": 21 * n_steps,
            "cross_attn_bwd_dkv": 21 * n_steps, "sinkhorn_log_stash": n_steps,
            "sinkhorn_bwd": n_steps, "sinkhorn_scaling": val_batches, "sinkhorn_log": 0,
            "attn_fwd_bf16": 0, "cross_attn_fwd_bf16": 0, "cross_attn_fwd_lse_bf16": 0,
            "cross_attn_bwd_dq_bf16": 0, "cross_attn_bwd_dkv_bf16": 0}


def _train_bf16_launches(n_steps, val_batches):
    """`_train_launches` in bfloat16: the bfloat16 kernels take the float32
    attention kernels' places (per step 7 attn_fwd_bf16, 21 each of the LSE
    forward, dq and dk/dv; per validation batch 7 attn_fwd_bf16 and 21
    cross_attn_fwd_bf16), the Sinkhorn kernels stay float32."""
    f32 = _train_launches(n_steps, val_batches)
    return {**{k: 0 for k in f32}, "attn_fwd_bf16": f32["attn_fwd"],
            "cross_attn_fwd_bf16": f32["cross_attn_fwd"],
            "cross_attn_fwd_lse_bf16": f32["cross_attn_fwd_lse"],
            "cross_attn_bwd_dq_bf16": f32["cross_attn_bwd_dq"],
            "cross_attn_bwd_dkv_bf16": f32["cross_attn_bwd_dkv"],
            **{k: f32[k] for k in ("sinkhorn_log_stash", "sinkhorn_bwd", "sinkhorn_scaling")}}


def pose_path_phase(workdir, stage1_exp=None, n_steps=6):
    """Stage 2: `cli.train.train --pose_loss --init_exp_name <stage-1 run>` at
    the full ScanNet 5-tuple training width (V=5, K=400, B=8, 480x480, 7 x
    (self + 3 x cross), 100 Sinkhorn iterations, conf MLP, rot/trans weights
    726/244, value clip 0.1, non-finite guard, f32) on seeded sphere-field
    scenes: `n_steps` steps on one repeated batch, then validation on the same
    batch. Without `stage1_exp` (the phase run alone) a one-step stage-1 run
    comes first. Steps/s of the loop, finite losses, the guard's skips,
    launches per step, host syncs inside a step, and first-step gradients of
    kernels against plain at the conditioned point with the pose term at
    half of the loss."""
    import warnings

    import torch

    from e2e_multi_view_matching_tpu_torch.cli import train as tcli
    from e2e_multi_view_matching_tpu_torch.data.synthetic import (
        SphereFieldScene,
        training_batch,
    )
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.utils.config import to_device

    B, V, H, W = 8, 5, 480, 480
    t0 = time.perf_counter()
    batch = training_batch(np.random.default_rng(1), B, V, H, W, f=577.0,
                           scene_cls=SphereFieldScene)
    data_s = time.perf_counter() - t0
    common = ["--checkpoint_dir", workdir, "--dataset", "scannet", "--tuple_size", str(V),
              "--batch_size", str(B), "--i_train", "1", "--no_tensorboard",
              "--attention_impl", "cuda", "--sinkhorn_impl", "cuda"]
    if stage1_exp is None:
        opt1 = tcli.parse_args(common + ["--n_epochs", "1", "--max_steps", "1"])
        tcli.train(opt1, lambda epoch: iter([batch]), lambda epoch: iter([batch]))
        stage1_exp = opt1.exp_name
    # the stage-1 run's best checkpoint is of epoch 0: stage 2 runs epoch 1
    opt = tcli.parse_args(common + ["--pose_loss", "--init_exp_name", stage1_exp,
                                    "--n_epochs", "2"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _LossLog() as losses:
        state = tcli.train(opt, lambda epoch: iter([batch] * n_steps),
                           lambda epoch: iter([batch]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stage1_steps = state.step - n_steps
    check(len(losses.train) == n_steps and len(losses.val) == 1,
          f"pose path: {len(losses.train)} steps logged, {len(losses.val)} validations")
    check(all(math.isfinite(x) for x in losses.train + losses.val),
          f"pose path: non-finite loss {losses.train} {losses.val}")
    check(hasattr(state.matcher, "conf_mlp") and state.optimizer.skip_nonfinite
          and state.optimizer.grad_clip == 0.1 and (opt.rot_weight, opt.trans_weight)
          == (726.0, 244.0), "pose path: not the stage-2 configuration")
    check(abs(state.pose_match_ratio - n_steps * tstep.RATIO_INCREMENT) < 1e-12,
          f"pose path: pose_match_ratio {state.pose_match_ratio} after {n_steps} steps")
    loop_sps = (n_steps - 1) / (losses.step_end[-1] - losses.step_end[0])
    expected = _train_launches(n_steps, val_batches=1)
    val_only = _train_launches(0, val_batches=1)
    check(launches == expected, f"pose path: launches {launches}, expected {expected}")

    # one more step: its losses, and host syncs inside it before they are read
    sp, _ = tcli.build_models(opt)
    sp.cuda().eval()
    step = tstep.make_train_step(sp, opt)
    dev = {k: to_device(v, "cuda") for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = step(state, dev, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    step_losses = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(x) for x in step_losses.values()) and step_losses["rot_loss"] > 0
          and step_losses["transl_loss"] > 0, f"pose path: step losses {step_losses}")
    check(not syncs, f"pose path: host syncs inside one train step at {syncs}")
    skipped = int(state.optimizer.skipped)
    breakdown = _pose_breakdown(sp, opt, state, dev, gen)
    del metrics, step
    torch.cuda.empty_cache()
    grad_check = _pose_grad_check(tcli, opt, sp, dev, gen)
    emit({"phase": "pose_path",
          "config": {"V": V, "K": 400, "B": B, "image": [H, W], "gnn": "7x(self+3xcross)",
                     "sinkhorn_iters": 100, "conf_mlp": True, "steps": n_steps,
                     "rot_weight": opt.rot_weight, "trans_weight": opt.trans_weight,
                     "grad_clip": opt.grad_clip, "scene": "SphereFieldScene",
                     "init_exp_name": stage1_exp, "stage1_steps": stage1_steps},
          "steps_per_s": loop_sps, "tuples_per_s": loop_sps * B,
          "train_losses": losses.train, "val_loss": losses.val[0],
          "step_losses_after": step_losses, "pose_match_ratio": state.pose_match_ratio,
          "guard_skipped_steps": skipped, "launches": launches,
          "launches_per_step": {k: (v - val_only[k]) / n_steps for k, v in launches.items()},
          "host_syncs_in_step": syncs, "peak_memory_gib": peak,
          "seconds_with_setup_and_checkpoints": seconds, "data_seconds": data_s,
          "breakdown_one_step": breakdown, "first_step_grad_conditioned": grad_check})
    return launches


def train_bf16_phase(workdir, n_steps=6, stage2_steps=3):
    """bfloat16 training, `cli.train.train --compute_dtype bfloat16`, at the
    full ScanNet 5-tuple training width (V=5, K=400, B=8, 480x480, 7 x (self
    + 3 x cross), 100 Sinkhorn iterations) on the seeded plane scenes of
    `train_path`: `n_steps` stage-1 steps on one repeated batch and one
    validation batch, on the bfloat16 kernels and again on the plain
    bfloat16 versions from the same seeded initial state; then
    `stage2_steps` stage-2 steps (`--pose_loss --init_exp_name`, the conf MLP
    in bfloat16) from the kernel run on seeded sphere-field scenes. Finite and
    falling loss, exact launches a step (no float32 attention kernel), no
    host sync inside a step, first-step gradients in the relative form
    (`_bf16_grad_check`), steps/s and a per-stage breakdown. Returns the
    kernel runs' launch counts, both stages together."""
    import warnings

    import torch

    from e2e_multi_view_matching_tpu_torch.cli import train as tcli
    from e2e_multi_view_matching_tpu_torch.data.synthetic import (
        SphereFieldScene,
        training_batch,
    )
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.utils.config import to_device

    B, V, H, W = 8, 5, 480, 480
    rng = np.random.default_rng(0)
    batch = training_batch(rng, B, V, H, W, f=577.0)
    val_batch = training_batch(rng, B, V, H, W, f=577.0)
    common = ["--checkpoint_dir", workdir, "--dataset", "scannet", "--tuple_size", str(V),
              "--batch_size", str(B), "--i_train", "1", "--no_tensorboard",
              "--compute_dtype", "bfloat16"]

    def run(argv, steps, feed, val, tag):
        opt = tcli.parse_args(common + argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _LossLog() as losses:
            state = tcli.train(opt, lambda epoch: iter([feed] * steps),
                               lambda epoch: iter([val]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _launches()
        check(len(losses.train) == steps and len(losses.val) == 1,
              f"train bf16 ({tag}): {len(losses.train)} losses logged, {len(losses.val)} "
              f"validations")
        check(all(math.isfinite(x) for x in losses.train + losses.val),
              f"train bf16 ({tag}): non-finite loss {losses.train} {losses.val}")
        check(all(p.dtype == torch.float32 for p in state.matcher.parameters()),
              f"train bf16 ({tag}): parameters not float32")
        loop_sps = (steps - 1) / (losses.step_end[-1] - losses.step_end[0])
        return opt, state, counts, {
            "steps_per_s": loop_sps, "tuples_per_s": loop_sps * B,
            "train_losses": losses.train, "val_loss": losses.val[0],
            "seconds_with_setup_and_checkpoints": dt,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    stage1 = ["--n_epochs", "1", "--max_steps", str(n_steps)]
    opt_k, state_k, launches, run_k = run(
        stage1 + ["--attention_impl", "cuda", "--sinkhorn_impl", "cuda"], n_steps, batch,
        val_batch, "kernels")
    check(state_k.matcher.config.compute_dtype == "bfloat16", "train bf16: not a bfloat16 run")
    expected = _train_bf16_launches(n_steps, val_batches=1)
    check(launches == expected, f"train bf16: launches {launches}, expected {expected}")

    # the step function alone, host syncs inside one step, the breakdown
    sp, _ = tcli.build_models(opt_k)
    sp.cuda().eval()
    step = tstep.make_train_step(sp, opt_k)
    dev = {k: to_device(v, "cuda") for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    float(step(state_k, dev, gen)["train_loss"])
    t0 = time.perf_counter()
    for _ in range(3):
        float(step(state_k, dev, gen)["train_loss"])
    fn_sps = 3 / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metrics = step(state_k, dev, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    check(math.isfinite(float(metrics["train_loss"])), "train bf16: non-finite loss")
    breakdown = _train_breakdown(sp, opt_k, state_k, dev, gen, groups=TRAIN_BF16_GROUPS)
    del state_k, step, metrics
    torch.cuda.empty_cache()
    grad_check = _bf16_grad_check(tcli, opt_k, sp, dev, gen)
    torch.cuda.empty_cache()

    _, state_p, _, run_p = run(stage1 + ["--attention_impl", "xla", "--sinkhorn_impl", "xla"],
                               n_steps, batch, val_batch, "plain")
    del state_p
    torch.cuda.empty_cache()

    # stage 2 from the kernel run (its best checkpoint is of epoch 0)
    batch2 = training_batch(np.random.default_rng(1), B, V, H, W, f=577.0,
                            scene_cls=SphereFieldScene)
    opt2, state2, launches2, run2 = run(
        ["--pose_loss", "--init_exp_name", opt_k.exp_name, "--n_epochs", "2",
         "--attention_impl", "cuda", "--sinkhorn_impl", "cuda"], stage2_steps, batch2, batch2,
        "stage 2")
    check(hasattr(state2.matcher, "conf_mlp") and state2.optimizer.skip_nonfinite,
          "train bf16: stage 2 is not the stage-2 configuration")
    expected2 = _train_bf16_launches(stage2_steps, val_batches=1)
    check(launches2 == expected2, f"train bf16 (stage 2): launches {launches2}, "
          f"expected {expected2}")
    del state2
    torch.cuda.empty_cache()
    emit({"phase": "train_bf16",
          "config": {"V": V, "K": 400, "B": B, "image": [H, W], "gnn": "7x(self+3xcross)",
                     "sinkhorn_iters": 100, "compute_dtype": "bfloat16", "steps": n_steps,
                     "stage2_steps": stage2_steps, "lr": opt_k.lr},
          "steps_per_s": run_k["steps_per_s"], "tuples_per_s": run_k["tuples_per_s"],
          "plain_steps_per_s": run_p["steps_per_s"], "step_fn_steps_per_s": fn_sps,
          "stage2_steps_per_s": run2["steps_per_s"],
          "runs": {"kernels": run_k, "plain": run_p, "stage2_kernels": run2},
          "launches": launches, "launches_stage2": launches2,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()
                                if v and k not in ("cross_attn_fwd_bf16", "sinkhorn_scaling")},
          "host_syncs_in_step": syncs, "first_step_grads": grad_check,
          "breakdown_one_step": breakdown})
    for name, r in (("kernels", run_k), ("plain", run_p)):
        check(r["train_losses"][-1] < r["train_losses"][0],
              f"train bf16 ({name}): loss did not fall on the repeated batch: "
              f"{r['train_losses']}")
    check(not syncs, f"train bf16: host syncs inside one train step at {syncs}")
    return {k: launches[k] + launches2[k] for k in launches}


def _bf16_grad_check(tcli, opt, sp, dev, gen, n=2):
    """First-step gradients of `n` tuples from the seeded initial weights on
    the bfloat16 SuperPoint's outputs and one set of GT matches: the float32
    kernels (the reference of the relative form), the bfloat16 kernels and
    the plain bfloat16 versions, at the initial weights and at the
    conditioned point (`CONDITIONED_RESCALE`). The bfloat16 kernel run's
    distance to the float32 kernels' gradient, on the worst and the median
    leaf, is held to BF16_GRAD_FACTOR x the plain bfloat16 run's +
    BF16_GRAD_SLACK of the largest float32 leaf norm."""
    import copy

    import torch

    from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.train.losses import combine_losses, matcher_losses

    sub = {k: v[:n] for k, v in dev.items()}
    V, H, W = sub["images"].shape[1:4]
    kpts, scores, descs = tstep.superpoint_outputs(sp, sub["images"], gen)
    gi, gw = gt_matches_all_pairs(kpts, sub["intr"], sub["poses"], sub["depths"],
                                  opt.match_reproj_err, opt.unmatch_reproj_err)
    size = torch.empty((n, V, 2), device="cuda")
    size[..., 0], size[..., 1] = H, W

    def first_grads(att, dtype, rescale):
        o = copy.copy(opt)
        o.attention_impl, o.sinkhorn_impl, o.compute_dtype = att, att, dtype
        matcher = tcli.build_models(o)[1].cuda()
        with torch.no_grad():
            for name, p in matcher.named_parameters():
                for key, factor in (rescale or {}).items():
                    if key in name:
                        p.mul_(factor)
        out = matcher(kpts, scores, descs, size, train=True, full_output=False)
        losses = matcher_losses(out, gi, gw, kpts, None, None, pose_loss=False)
        total, _ = combine_losses(losses, V * (V - 1) // 2, 0.0, 0.0, 0.0)
        grads = torch.autograd.grad(total, list(matcher.parameters()))
        check(all(g.dtype == torch.float32 for g in grads), "train bf16: gradients not float32")
        return [g.double() for g in grads], float(total.detach())

    out = {"tuples": n, "factor": BF16_GRAD_FACTOR, "slack": BF16_GRAD_SLACK}
    for point, rescale in (("initial", None), ("conditioned", CONDITIONED_RESCALE)):
        f32, l32 = first_grads("cuda", "float32", rescale)
        k16, lk = first_grads("cuda", "bfloat16", rescale)
        p16, lp = first_grads("xla", "bfloat16", rescale)
        top = max(float(g.norm()) for g in f32)
        rec = {"top_leaf_norm_f32": top, "loss_f32_kernels": l32, "loss_bf16_kernels": lk,
               "loss_bf16_plain": lp, "bf16_kernels_vs_f32_kernels": _leaf_dist(k16, f32, top),
               "bf16_plain_vs_f32_kernels": _leaf_dist(p16, f32, top),
               "bf16_kernels_vs_bf16_plain": _leaf_dist(k16, p16, top)}
        out[point] = rec
        for which in ("worst", "median"):
            limit = (BF16_GRAD_FACTOR * rec["bf16_plain_vs_f32_kernels"][which]
                     + BF16_GRAD_SLACK)
            got = rec["bf16_kernels_vs_f32_kernels"][which]
            check(top > 0 and got <= limit,
                  f"train bf16 ({point} point): the bfloat16 kernel run's first-step "
                  f"gradients are {got} of the largest leaf norm from the float32 kernels' on "
                  f"the {which} leaf (limit {limit}: {BF16_GRAD_FACTOR} x the plain bfloat16 "
                  f"run's + {BF16_GRAD_SLACK})")
        del f32, k16, p16
        torch.cuda.empty_cache()
    return out


def _pose_breakdown(sp, opt, state, dev, gen, reps=2):
    """Where one stage-2 step's time goes: the forward (GT matches, matcher
    with the conf MLP, losses with the eight-point solve) and the backward on
    the host clock; the pose loss alone (the (B*P)-batched eight-point solve,
    forward and backward with respect to the confidences) with its device
    launches; device time of the whole step by kernel group."""
    import torch

    from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.train.losses import matcher_losses

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    sp_out = tstep.superpoint_outputs(sp, dev["images"], gen)
    fwd_ms, (total, _) = wall(lambda: tstep.tuple_losses(
        state.matcher, opt, state.pose_match_ratio, dev, sp_out, train=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(total, state.optimizer.params, allow_unused=True)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3

    kpts = sp_out[0]
    B, V = kpts.shape[:2]
    gi, gw = gt_matches_all_pairs(kpts, dev["intr"], dev["poses"], dev["depths"],
                                  opt.match_reproj_err, opt.unmatch_reproj_err)
    size = torch.empty((B, V, 2), device="cuda")
    size[..., 0], size[..., 1] = dev["images"].shape[2], dev["images"].shape[3]
    with torch.no_grad():
        out = state.matcher(*sp_out, size, train=False, full_output=True)
    conf = out["conf_scores"].clone().requires_grad_()
    res = {**out, "conf_scores": conf}

    def pose_terms():
        losses = matcher_losses(res, gi, gw, kpts, dev["intr"], dev["poses"], pose_loss=True)
        return losses["rot_loss"] + losses["transl_loss"]

    pose_fwd_ms, terms = wall(pose_terms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(terms, conf)
    torch.cuda.synchronize()
    pose_bwd_ms = (time.perf_counter() - t0) * 1e3
    pose = _device_busy(lambda: torch.autograd.grad(pose_terms(), conf))
    step = tstep.make_train_step(sp, opt)
    busy = _device_busy(lambda: step(state, dev, gen), groups=TRAIN_GROUPS)
    return {"forward_ms_gt_matcher_losses": fwd_ms, "backward_ms": bwd_ms,
            "pose_loss_forward_ms": pose_fwd_ms, "pose_loss_backward_ms": pose_bwd_ms,
            "pose_loss_fwd_bwd_device_launches": pose.get("device_launches"),
            "pose_loss_fwd_bwd_device_busy_ms": pose.get("profiled_device_busy_ms"),
            "pose_loss_fwd_bwd_profiled_wall_ms": pose["profiled_wall_ms"], **busy}


def _pose_grad_check(tcli, opt, sp, dev, gen, n=2):
    """First-step gradients of `n` tuples at the conditioned point (the seeded
    initial weights with `CONDITIONED_RESCALE`) with the pose term at half of
    the loss: plain float64 (the reference), plain float32 and kernels
    float32. Every mutual best match counts (threshold 0), so that the
    eight-point solves have weights at a point where the assignment is soft.
    Kernels against plain on every leaf: within 2e-4 of the largest leaf norm
    or, where float32 itself is farther from float64 (the eight-point
    gradient is ill-conditioned), within 3 x plain float32's distance to
    float64 + 2e-4."""
    import copy
    import dataclasses

    import torch

    from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
    from e2e_multi_view_matching_tpu_torch.train import step as tstep
    from e2e_multi_view_matching_tpu_torch.train.losses import combine_losses, matcher_losses

    sub = {k: v[:n] for k, v in dev.items()}
    V, H, W = sub["images"].shape[1:4]
    kpts, scores, descs = tstep.superpoint_outputs(sp, sub["images"], gen)
    gi, gw = gt_matches_all_pairs(kpts, sub["intr"], sub["poses"], sub["depths"],
                                  opt.match_reproj_err, opt.unmatch_reproj_err)
    size = torch.empty((n, V, 2), device="cuda")
    size[..., 0], size[..., 1] = H, W

    def first_grads(att, sink, dtype):
        o = copy.copy(opt)
        o.attention_impl, o.sinkhorn_impl = att, sink
        matcher = tcli.build_models(o)[1]
        matcher.config = dataclasses.replace(matcher.config, match_threshold=0.0)
        matcher = matcher.cuda().to(dtype)
        with torch.no_grad():
            for name, p in matcher.named_parameters():
                for key, factor in CONDITIONED_RESCALE.items():
                    if key in name:
                        p.mul_(factor)
        cast = [x.to(dtype) for x in (kpts, scores, descs, size)]
        out = matcher(*cast, train=True, full_output=True)
        losses = matcher_losses(out, gi, gw.to(dtype), cast[0], sub["intr"].to(dtype),
                                sub["poses"].to(dtype), pose_loss=True)
        total, _ = combine_losses(losses, V * (V - 1) // 2, 0.5, opt.rot_weight,
                                  opt.trans_weight)
        grads = torch.autograd.grad(total, list(matcher.parameters()))
        return ([g.double() for g in grads], out["matches0"],
                {k: float(v.detach()) for k, v in losses.items()})

    ref, m_ref, l_ref = first_grads("xla", "xla", torch.float64)
    plain, m_plain, l_plain = first_grads("xla", "xla", torch.float32)
    kernels, m_k, l_k = first_grads("cuda", "cuda", torch.float32)
    top = max(float(g.norm()) for g in ref)
    out = {"tuples": n, "rescale": CONDITIONED_RESCALE, "pose_match_ratio": 0.5,
           "losses_f64": l_ref, "losses_plain_f32": l_plain, "losses_kernels_f32": l_k,
           "matches_f64": int((m_ref >= 0).sum()),
           "matches0_agreement_kernels_plain": float((m_k == m_plain).float().mean()),
           "matches0_agreement_plain_f64": float((m_plain == m_ref).float().mean()),
           "top_leaf_norm_f64": top, "plain_f32_vs_f64": _leaf_dist(plain, ref, top),
           "kernels_f32_vs_f64": _leaf_dist(kernels, ref, top),
           "kernels_vs_plain_f32": _leaf_dist(kernels, plain, top)}
    limit = max(TRAIN_GRAD_CONDITIONED_TOL, TRAIN_GRAD_F64_FACTOR
                * out["plain_f32_vs_f64"]["worst"] + TRAIN_GRAD_CONDITIONED_TOL)
    out["tol"] = limit
    worst = out["kernels_vs_plain_f32"]["worst"]
    check(top > 0 and out["matches_f64"] >= 8 * n and l_ref["rot_loss"] > 0,
          f"pose path: the conditioned point has no pose term to check ({out})")
    check(worst <= limit, f"pose path: kernel and plain first-step gradients differ by {worst} "
          f"of the largest leaf norm on the worst leaf (limit {limit})")
    return out


def _leaf_dist(a, b, top):
    """Per-leaf distance ||a - b|| / top of two gradient lists: the worst and
    the median leaf."""
    d = sorted(float((x - y).norm()) / top for x, y in zip(a, b))
    return {"worst": d[-1], "median": d[len(d) // 2]}


def _grad_reference(tcli, tstep, opt, sp, dev, gen, n=2):
    """First-step gradients of `n` tuples from the same seeded initial
    weights, SuperPoint outputs and GT matches: plain ops in float64 (the
    reference), and in float32 with every combination of the attention and
    Sinkhorn implementations. The float64 run says how far float32 itself is
    from the exact gradient, which is what bounds the agreement of two float32
    runs at the initial weights, where attention logits and pair scores are
    extreme. At a conditioned point (the same weights with the parameters
    named in `CONDITIONED_RESCALE` scaled down) kernels and plain must agree
    on every leaf."""
    import copy

    import torch

    from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
    from e2e_multi_view_matching_tpu_torch.train.losses import combine_losses, matcher_losses

    sub = {k: v[:n] for k, v in dev.items()}
    V, H, W = sub["images"].shape[1:4]
    kpts, scores, descs = tstep.superpoint_outputs(sp, sub["images"], gen)
    # one set of GT matches (float32, as in training) for all runs
    gi, gw = gt_matches_all_pairs(kpts, sub["intr"], sub["poses"], sub["depths"],
                                  opt.match_reproj_err, opt.unmatch_reproj_err)
    size = torch.empty((n, V, 2), device="cuda")
    size[..., 0], size[..., 1] = H, W

    def first_grads(att, sink, dtype, rescale=None):
        o = copy.copy(opt)
        o.attention_impl, o.sinkhorn_impl = att, sink
        matcher = tcli.build_models(o)[1].cuda().to(dtype)
        with torch.no_grad():
            for name, p in matcher.named_parameters():
                for key, factor in (rescale or {}).items():
                    if key in name:
                        p.mul_(factor)
        out = matcher(kpts.to(dtype), scores.to(dtype), descs.to(dtype), size.to(dtype),
                      train=True, full_output=False)
        peak = float(out["log_assignment"].detach().abs().max())
        losses = matcher_losses(out, gi, gw.to(dtype), kpts, None, None, pose_loss=False)
        total, _ = combine_losses(losses, V * (V - 1) // 2, 0.0, 0.0, 0.0)
        grads = torch.autograd.grad(total, list(matcher.parameters()))
        return [g.double() for g in grads], peak

    ref, peak = first_grads("xla", "xla", torch.float64)
    top = max(float(g.norm()) for g in ref)
    f32 = {f"attention_{att}_sinkhorn_{sink}": first_grads(att, sink, torch.float32)[0]
           for att, sink in (("xla", "xla"), ("cuda", "cuda"), ("cuda", "xla"), ("xla", "cuda"))}
    plain, kernels = f32["attention_xla_sinkhorn_xla"], f32["attention_cuda_sinkhorn_cuda"]
    out = {"tuples": n, "top_leaf_norm_f64": top, "max_abs_log_p_f64": peak,
           "randomly_filled_slots": int((scores == 0).sum()), "slots": scores.numel(),
           "gt_matches": int((gi[:, :, 0, :-1] >= 0).sum()),
           "f32_vs_f64": {k: _leaf_dist(g, ref, top) for k, g in f32.items()},
           "kernels_vs_plain_f32": _leaf_dist(kernels, plain, top)}
    del f32, ref
    limit = TRAIN_GRAD_F64_FACTOR * out["f32_vs_f64"]["attention_xla_sinkhorn_xla"]["worst"] + 1e-3
    worst_k = out["f32_vs_f64"]["attention_cuda_sinkhorn_cuda"]["worst"]
    check(worst_k <= limit,
          f"train path: kernel-run gradients are {worst_k} of the largest leaf norm from "
          f"float64 (limit {limit}: {TRAIN_GRAD_F64_FACTOR} x the plain float32 run's + 1e-3)")

    ref_c, peak_c = first_grads("xla", "xla", torch.float64, CONDITIONED_RESCALE)
    plain_c, _ = first_grads("xla", "xla", torch.float32, CONDITIONED_RESCALE)
    kernels_c, _ = first_grads("cuda", "cuda", torch.float32, CONDITIONED_RESCALE)
    top_c = max(float(g.norm()) for g in ref_c)
    out["conditioned"] = {"rescale": CONDITIONED_RESCALE, "max_abs_log_p_f64": peak_c,
                          "top_leaf_norm_f64": top_c, "tol": TRAIN_GRAD_CONDITIONED_TOL,
                          "plain_f32_vs_f64": _leaf_dist(plain_c, ref_c, top_c),
                          "kernels_f32_vs_f64": _leaf_dist(kernels_c, ref_c, top_c),
                          "kernels_vs_plain_f32": _leaf_dist(kernels_c, plain_c, top_c)}
    worst_c = out["conditioned"]["kernels_vs_plain_f32"]["worst"]
    check(top_c > 0 and worst_c <= TRAIN_GRAD_CONDITIONED_TOL,
          f"train path: at the conditioned point the kernel and plain gradients differ by "
          f"{worst_c} of the largest leaf norm on the worst leaf (> {TRAIN_GRAD_CONDITIONED_TOL})")
    return out


def _train_breakdown(sp, opt, state, dev, gen, reps=2, groups=None):
    """Where one train step's time goes: host clock around synchronized
    stages, and device time by kernel group under torch.profiler."""
    import torch

    from e2e_multi_view_matching_tpu_torch.data.gt_matches import gt_matches_all_pairs
    from e2e_multi_view_matching_tpu_torch.train import step as tstep

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    params = state.optimizer.params
    sp_ms, sp_out = wall(lambda: tstep.superpoint_outputs(sp, dev["images"], gen))
    gt_ms, _ = wall(lambda: gt_matches_all_pairs(
        sp_out[0], dev["intr"], dev["poses"], dev["depths"], opt.match_reproj_err,
        opt.unmatch_reproj_err))
    # forward = GT matches + matcher + loss; backward timed on the last graph
    fwd_ms, (total, _) = wall(lambda: tstep.tuple_losses(
        state.matcher, opt, state.pose_match_ratio, dev, sp_out, train=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(total, params)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    opt_ms, _ = wall(lambda: state.optimizer.step(grads))
    step = tstep.make_train_step(sp, opt)
    busy = _device_busy(lambda: step(state, dev, gen), groups=groups or TRAIN_GROUPS)
    return {"superpoint_ms": sp_ms, "gt_matches_ms": gt_ms,
            "forward_ms_gt_matcher_loss": fwd_ms, "matcher_forward_ms": fwd_ms - gt_ms,
            "backward_ms": bwd_ms, "optimizer_ms": opt_ms, **busy}


# device time of an eval sub-chunk by kernel group (substrings of kernel names;
# "attn_fwd_kernel" also names cross_attn_fwd_kernel, "attn_fwd_bf16_kernel"
# cross_attn_fwd_bf16_kernel; "::attn_fwd_bf16_kernel" the self layers' only)
EVAL_GROUPS = {
    "sinkhorn_scaling": ("scaling_cluster_kernel",),
    "attention_fwd_kernels": ("attn_fwd_kernel",),
    "cross_attn_fwd": ("cross_attn_fwd_kernel",),
    "attention_bf16_kernels": ("attn_fwd_bf16_kernel",),
    "self_attn_fwd_bf16": ("::attn_fwd_bf16_kernel",),
    "cross_attn_fwd_bf16": ("cross_attn_fwd_bf16_kernel",)}
# device time of a train step by kernel group (substrings of kernel names)
TRAIN_GROUPS = {
    "sinkhorn_fwd": ("log_cluster_kernel",),
    "sinkhorn_bwd": ("bwd_cluster_kernel",),
    "attention_fwd_kernels": ("attn_fwd_kernel",),
    "attention_bwd_kernels": ("cross_attn_bwd",)}
# a bfloat16 train step ("::attn_fwd_bf16" names the self layers' kernel only)
TRAIN_BF16_GROUPS = {
    "sinkhorn_fwd": ("log_cluster_kernel",),
    "sinkhorn_bwd": ("bwd_cluster_kernel",),
    "self_attn_fwd_bf16": ("::attn_fwd_bf16_kernel",),
    "cross_attn_fwd_lse_bf16": ("cross_attn_fwd_lse_bf16_kernel",),
    "cross_attn_bwd_bf16": ("cross_attn_bwd_dq_bf16", "cross_attn_bwd_dkv_bf16"),
    "float32_attention": ("attn_fwd_kernel<", "cross_attn_bwd_dq_kernel<",
                          "cross_attn_bwd_dkv_kernel<")}


def breakdown_phase(sp, matcher, images, intr, size, reps=3, phase="breakdown",
                    profile="sub_chunk"):
    """Where one 8-tuple sub-chunk's time goes, stage by stage (host clock
    around synchronized work), and the unrolled-Jacobi share of the pose stage;
    the device's busy time under torch.profiler over the whole sub-chunk
    (`profile="sub_chunk"`) or over the matcher alone (`"matcher"`: its
    kernels, without tracing the pose stage's ~160k launches)."""
    import torch

    from e2e_multi_view_matching_tpu_torch.cli.eval_multi_view import infer_subchunk
    from e2e_multi_view_matching_tpu_torch.geom.linalg import eig_thresholded_solve
    from e2e_multi_view_matching_tpu_torch.mvba.pipeline import multi_view_pose_device

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    B = images.shape[0]
    with torch.inference_mode():
        sp_ms, sp_out = wall(lambda: sp(images.reshape((B * 5,) + images.shape[2:])))
        kpts = sp_out["keypoints"].reshape(B, 5, -1, 2)
        args = (kpts, sp_out["scores"].reshape(B, 5, -1),
                sp_out["descriptors"].reshape(B, 5, kpts.shape[2], -1), size)
        m_ms, m_out = wall(lambda: matcher(*args))
        pose_ms, _ = wall(lambda: multi_view_pose_device(kpts, intr, m_out["matches0"],
                                                         m_out["conf_scores"]))
        S24 = torch.eye(24, device="cuda").expand(B, 24, 24) + 0.1
        r24 = torch.ones(B, 24, device="cuda")
        S6 = torch.eye(6, device="cuda").expand(B * 10, 6, 6) + 0.1
        r6 = torch.ones(B * 10, 6, device="cuda")
        j24, _ = wall(lambda: eig_thresholded_solve(S24, r24, n_sweeps=8))
        j6, _ = wall(lambda: eig_thresholded_solve(S6, r6, n_sweeps=6))
        profiled = {"sub_chunk": lambda: infer_subchunk(sp, matcher, images, intr, size),
                    "matcher": lambda: matcher(*args)}[profile]
        busy = {"profiled": profile, **_device_busy(profiled, groups=EVAL_GROUPS)}
    # the multi-view BA solves 24x24 once per LM iteration (20); the two-view BA
    # solves 6x6 once per LM iteration (10)
    jacobi_ms = 20 * j24 + 10 * j6
    emit({"phase": phase, "sub_chunk_tuples": B, "superpoint_ms": sp_ms,
          "matcher_ms": m_ms, "pose_ms": pose_ms, "jacobi_ms_in_pose": jacobi_ms,
          "jacobi_share_of_pose": jacobi_ms / pose_ms, **busy})


def _device_busy(fn, groups=None):
    """Device time of one call under torch.profiler against its wall time
    (the profiler slows the host, so the idle share is an upper bound).
    `groups` = {label: (substrings of kernel names)} also sums device time by
    label. Only the device's activity is traced, and its records are read as
    the profiler returns them: host ops and their event tree cost minutes
    for a pose stage's 164,495 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    if not n_kernels:
        return {"profiled_device_busy_ms": None, "profiled_wall_ms": wall_ms}
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    grouped = {}
    for label, needles in (groups or {}).items():
        grouped[label] = sum(ms for n, ms in by_name.items() if any(x in n for x in needles))
    return {**({"device_ms_by_group": grouped} if groups else {}),
            "profiled_wall_ms": wall_ms, "profiled_device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "device_launches": n_kernels,
            "top_device_ms": [[n[:60], round(ms, 3)] for n, ms in top]}


# per-step launches of the training kernels, by the name of their CUDA symbol
TRACE_KERNELS = {"attn_fwd": r"\battn_fwd_kernel<",
                 "cross_attn_fwd_lse": r"\bcross_attn_fwd_kernel<\d+, true>",
                 "cross_attn_bwd_dq": r"\bcross_attn_bwd_dq_kernel<",
                 "cross_attn_bwd_dkv": r"\bcross_attn_bwd_dkv_kernel<",
                 "sinkhorn_log_stash": r"\blog_cluster_kernel<",
                 "sinkhorn_bwd": r"\bbwd_cluster_kernel<"}


def _upstream_matcher(rng, gnn_layers=7, cross_attention_layers=3, D=256):
    """A seeded matcher training checkpoint's state dict in the reference's
    layout (the DataParallel `module.` prefix, Conv1d (out, in, 1) weights
    drawn LeCun normal, BatchNorm1d as a fresh module leaves it, the fork's
    conf MLP) at the 5-tuple schedule: ['self'] + ['cross'] * 3, 7 times."""
    sd = {}

    def conv(name, o, i):
        sd[f"{name}.weight"] = (rng.normal(size=(o, i, 1)) * i ** -0.5).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(o, np.float32)

    def mlp(prefix, dims):
        for li in range(len(dims) - 1):
            conv(f"{prefix}.{3 * li}", dims[li + 1], dims[li])
            if li < len(dims) - 2:
                o, bn = dims[li + 1], f"{prefix}.{3 * li + 1}"
                sd[f"{bn}.weight"], sd[f"{bn}.bias"] = np.ones(o, np.float32), np.zeros(
                    o, np.float32)
                sd[f"{bn}.running_mean"] = np.zeros(o, np.float32)
                sd[f"{bn}.running_var"] = np.ones(o, np.float32)

    mlp("kenc.encoder", (3, 32, 64, 128, 256, D))
    for li in range((1 + cross_attention_layers) * gnn_layers):
        for name in ("proj.0", "proj.1", "proj.2", "merge"):
            conv(f"gnn.layers.{li}.attn.{name}", D, D)
        mlp(f"gnn.layers.{li}.mlp", (2 * D, 2 * D, D))
    conv("final_proj", D, D)
    sd["bin_score"] = np.asarray(1.0, np.float32)
    mlp("conf_mlp", (2 * D + 1, 256, 64, 1))
    return {f"module.{k}": v for k, v in sd.items()}


def _upstream_superpoint(rng):
    """A seeded SuperPoint state dict in the upstream magicleap layout, drawn
    as flax draws a convolution (LeCun normal, zero bias)."""
    shapes = {"conv1a": (64, 1, 3), "conv1b": (64, 64, 3), "conv2a": (64, 64, 3),
              "conv2b": (64, 64, 3), "conv3a": (128, 64, 3), "conv3b": (128, 128, 3),
              "conv4a": (128, 128, 3), "conv4b": (128, 128, 3), "convPa": (256, 128, 3),
              "convPb": (65, 256, 1), "convDa": (256, 128, 3), "convDb": (256, 256, 1)}
    sd = {}
    for name, (o, i, k) in shapes.items():
        sd[f"module.{name}.weight"] = (rng.normal(size=(o, i, k, k))
                                       * (i * k * k) ** -0.5).astype(np.float32)
        sd[f"module.{name}.bias"] = np.zeros(o, np.float32)
    return sd


def _run_cli(module, args, log_path):
    """`python -m <port>.cli.<module> args` from the repository root; returns
    (its log, wall seconds). Fails on a non-zero exit."""
    return _run_python(["-m", f"{PKG}.cli.{module}", *args], log_path)


def _run_python(argv, log_path):
    """`python argv` from the repository root; returns (its log, wall seconds).
    Fails on a non-zero exit."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, stdout=log,
                              stderr=subprocess.STDOUT, timeout=900)
    wall = time.perf_counter() - t0
    text = Path(log_path).read_text()
    check(proc.returncode == 0, f"cli: {' '.join(argv)} exited {proc.returncode}:\n"
          f"{text[-4000:]}")
    return text, wall


def _train_log(text, tag):
    """(experiment name, [(step, mean batch s, loss)], [val losses], trace path)
    from the log of one `cli.train` run."""
    import re

    exp = re.search(r"experiment (\S+)", text)
    steps = [(int(m.group(2)), float(m.group(3)), float(m.group(4))) for m in re.finditer(
        r"epoch +(\d+) it +(\d+) \| batch ([\d.]+)s \| loss (\S+)", text)]
    vals = [float(m.group(1)) for m in re.finditer(r"epoch +\d+ \| val loss (\S+)", text)]
    trace = re.search(r"profiler trace of steps \d+-\d+: (\S+)", text)
    check(exp is not None and steps and vals, f"cli ({tag}): no experiment, step or "
          f"validation line in the log:\n{text[-3000:]}")
    check(all(math.isfinite(x[2]) for x in steps) and all(math.isfinite(v) for v in vals),
          f"cli ({tag}): non-finite losses {steps} {vals}")
    return exp.group(1), steps, vals, trace.group(1) if trace else None


def _scannet_color(sdir):
    """The color of the ScanNet-format scene `sdir` rewritten as real
    ScanNet's: 1296x968 JPEG, the color intrinsics scaled to it."""
    import cv2

    for jpg in Path(f"{sdir}/color").glob("*.jpg"):
        img = cv2.imread(str(jpg), cv2.IMREAD_COLOR)
        scale = np.array([[1296 / img.shape[1]], [968 / img.shape[0]], [1], [1]])
        check(cv2.imwrite(str(jpg), cv2.resize(img, (1296, 968))), f"cannot write {jpg}")
    intr = f"{sdir}/intrinsic/intrinsic_color.txt"
    np.savetxt(intr, np.loadtxt(intr) * scale, delimiter=" ")


def _hd_tree(src, dst, n_train):
    """A copy of the ScanNet-format tree `src` with real ScanNet's color:
    1296x968 JPEG over the 480x640 depth, the color intrinsics scaled to it.
    Its train split repeats the train scenes of `src` as `n_train` scenes;
    val is that of `src`. Returns `dst`."""
    import shutil

    s, d = f"{src}/scannet", f"{dst}/scannet"
    os.makedirs(f"{d}/overlap/scans")
    converted = {}

    def add(name, orig):
        sdir = f"{d}/scans/{name}"
        if orig in converted:
            shutil.copytree(converted[orig], sdir)
        else:
            shutil.copytree(f"{s}/scans/{orig}", sdir)
            _scannet_color(sdir)
            converted[orig] = sdir
        shutil.copy(f"{s}/overlap/scans/{orig}.json", f"{d}/overlap/scans/{name}.json")

    splits = {sp: Path(f"{s}/scannetv2_{sp}.txt").read_text().split() for sp in ("train", "val")}
    train = [f"scene{1000 + i:04d}_00" for i in range(n_train)]
    for i, name in enumerate(train):
        add(name, splits["train"][i % len(splits["train"])])
    for name in splits["val"]:
        add(name, name)
    for sp, names in (("train", train), ("val", splits["val"])):
        Path(f"{d}/scannetv2_{sp}.txt").write_text("".join(f"{n}\n" for n in names))
    return dst


def _loop_window(text, steps, a, b):
    """(loop steps/s, step-alone steps/s, share of the loop spent waiting on
    data) over steps a+1..b of a `cli.train` run logged every step: the
    loop's rate from the timestamps of the log lines of steps a and b, the
    step's own time from `TimeTracker`'s running means (`steps` from
    `_train_log`), which start a step's clock when its batch has arrived."""
    import datetime
    import re

    stamps = [datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f") for m in
              re.finditer(r"^(\S+ \S+) INFO epoch +\d+ it +\d+ \|", text, re.M)]
    check(len(stamps) == len(steps) >= b > a >= 1,
          f"cli: {len(stamps)} timestamped steps of {len(steps)}, window {a}..{b}")
    loop_s = (stamps[b - 1] - stamps[a - 1]).total_seconds()
    step_s = steps[b - 1][1] * b - steps[a - 1][1] * a
    return {"steps": [a + 1, b], "loop_steps_per_s": (b - a) / loop_s,
            "step_alone_steps_per_s": (b - a) / step_s, "data_wait_share": 1.0 - step_s / loop_s}


def _write_cli_tree(data, H=480, W=640):
    """The `cli` phase's ScanNet-format tree under `data`: seeded sphere-field
    scenes of 8 views at H x W with exact depth, two for training, one for
    validation, one for testing."""
    from concurrent.futures import ThreadPoolExecutor

    from e2e_multi_view_matching_tpu_torch.data.synthetic import (
        SphereFieldScene,
        fourier_texture_image,
        write_scannet_format,
    )

    rng = np.random.default_rng(7)
    layout = [("train", "scene0000_00"), ("train", "scene0001_00"), ("val", "scene0100_00"),
              ("test", "scene0707_00")]
    scenes = [SphereFieldScene(rng, n_views=8, H=H, W=W, f=577.0) for _ in layout]
    with ThreadPoolExecutor(4) as pool:  # the exact depth of every pixel, cached per scene
        list(pool.map(lambda sc: [sc.grid_depth(v) for v in range(8)], scenes))
    for (split, name), scene in zip(layout, scenes):
        write_scannet_format(scene, data, scene_name=name, split=split,
                             image_fn=fourier_texture_image)


def _overlap_numpy(depths, poses, intr, stride=8):
    """The symmetric-mean overlap matrix in numpy (the JAX package's
    tests/test_native.py reference): the share of view i's valid depth
    samples that project into view j with a consistent depth."""
    n, h, w = depths.shape
    directed = np.zeros((n, n))
    for i in range(n):
        ys, xs = np.mgrid[0:h:stride, 0:w:stride]
        d = depths[i][ys, xs]
        valid = d > 1e-6
        pts = np.stack([xs[valid] * d[valid], ys[valid] * d[valid], d[valid]], -1)
        X_i = pts @ np.linalg.inv(intr[i][:3, :3]).T
        for j in range(n):
            if i == j:
                continue
            T = np.linalg.inv(poses[j]) @ poses[i]
            X_j = X_i @ T[:3, :3].T + T[:3, 3]
            z = X_j[:, 2]
            front = z > 1e-6
            p = X_j[front] @ intr[j][:3, :3].T
            u = np.round(p[:, 0] / z[front]).astype(int)
            v = np.round(p[:, 1] / z[front]).astype(int)
            inb = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            dj = depths[j][v[inb], u[inb]]
            zz = z[front][inb]
            ok = dj > 1e-6
            directed[i, j] = np.sum(np.abs(dj[ok] - zz[ok]) / dj[ok] < 0.1) / max(valid.sum(), 1)
    return 0.5 * (directed + directed.T)


def _row_shift(a, b, rows, steps=np.arange(-200, 201) / 100):
    """The shift t, to 0.01 of a row, for which a[r] best matches b[r - t]
    (b's rows interpolated linearly) over `rows`: how far a feature sits
    lower in image a than in image b."""
    def shifted(t):
        y = rows - t
        y0 = np.floor(y).astype(int)
        f = (y - y0)[:, None]
        return b[y0] * (1 - f) + b[y0 + 1] * f

    errs = [float(np.mean((a[rows] - shifted(t)) ** 2)) for t in steps]
    return float(steps[int(np.argmin(errs))])


def _native_checks(workdir, data, hd_data, native, V=5, B=8):
    """The native runtime on the `cli` trees, from the host. When it built:
    `emvm_overlap` on a copy of the 480x640 tree (exit 0, one JSON a scene,
    3-tuples the sampler can read), `overlap_matrix` against numpy, the native
    samples of the 8 test tuples against the Python path's, and on the
    1296x968 tree the rows by which the two paths disagree near the top,
    middle and bottom. When it did not: the headers it lacks, `use_native=True`
    raising with the missing header's name, and "auto" taking the Python
    path. In both cases the host seconds to load a batch of 8 tuples at
    480x640 (test split) and 1296x968 (val split), on each path there is.
    Returns the record."""
    import shutil

    from e2e_multi_view_matching_tpu_torch.data import native_loader
    from e2e_multi_view_matching_tpu_torch.data.scannet import read_depth, read_pose
    from e2e_multi_view_matching_tpu_torch.data.tuples import (
        MatchingTupleDataset,
        batch_iterator,
    )

    trees = {"480x640": (f"{data}/scannet", "test"), "1296x968": (f"{hd_data}/scannet", "val")}
    paths = (False, True) if native["built"] else (False,)
    rec = {"built": native["built"], "headers": native["headers"],
           "host_load_seconds_per_batch_of_8": {}}
    sets = {}
    for tree, (root, split) in trees.items():
        auto = MatchingTupleDataset(root, split, V, n_samples=B, shuffle_tuple=False)
        check(auto.use_native == native["built"] and len(auto) == B,
              f"native: {tree} {split} resolved use_native={auto.use_native} with "
              f"{len(auto)} tuples; the runtime built: {native['built']}")
        for use_native in paths:
            ds = MatchingTupleDataset(root, split, V, n_samples=B, shuffle_tuple=False,
                                      use_native=use_native)
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                next(batch_iterator(ds, B, shuffle=False))
                times.append(time.perf_counter() - t0)
            name = "native" if use_native else "python"
            rec["host_load_seconds_per_batch_of_8"][f"{tree}_{name}"] = times
            sets[tree, use_native] = ds

    if not native["built"]:
        missing = [h for h, found in native["headers"].items() if not found]
        forced = MatchingTupleDataset(*trees["480x640"], V, n_samples=B, use_native=True)
        try:
            forced[0]
            raised = None
        except RuntimeError as e:
            raised = str(e)
        check(raised is not None and any(h in raised for h in missing),
              f"native: without {missing}, use_native=True gave {raised!r}")
        rec.update(missing_headers=missing, auto="python",
                   use_native_true_raised=next(line for line in raised.splitlines()
                                               if any(h in line for h in missing)))
        return rec

    # emvm_overlap on a copy of the tree. The sphere-field views overlap less
    # than real ScanNet's neighbours, so the candidates' range is 0.1-1.0
    # (the default, 0.4-0.8, leaves most of the views without one)
    copy = f"{workdir}/cli_data_overlap"
    shutil.copytree(data, copy)
    shutil.rmtree(f"{copy}/scannet/overlap")
    tool_s = {}
    for split, scans in (("train", "scans"), ("test", "scans_test")):
        t0 = time.perf_counter()
        run = subprocess.run([native_loader.overlap_tool(), f"{copy}/scannet", split, "0.1", "1.0"],
                             capture_output=True, text=True, timeout=300)
        tool_s[split] = time.perf_counter() - t0
        check(run.returncode == 0, f"native: emvm_overlap {split} exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        scenes = sorted(os.listdir(f"{copy}/scannet/{scans}"))
        written = sorted(os.listdir(f"{copy}/scannet/overlap/{scans}"))
        check(written == [f"{sc}.json" for sc in scenes],
              f"native: emvm_overlap wrote {written} for the scenes {scenes}")
    n_tuples = {split: len(MatchingTupleDataset(f"{copy}/scannet", split, 3))
                for split in ("train", "test")}
    check(all(n_tuples.values()), f"native: tuples from emvm_overlap's JSONs: {n_tuples}")

    # the overlap matrix of the test scene's 8 views against numpy
    sdir = f"{data}/scannet/scans_test"
    (scene,) = os.listdir(sdir)
    depths = np.stack([read_depth(sdir, scene, i) for i in range(8)])
    poses = np.stack([read_pose(sdir, scene, i) for i in range(8)])
    intr = np.tile(np.loadtxt(f"{sdir}/{scene}/intrinsic/intrinsic_color.txt"), (8, 1, 1))
    t0 = time.perf_counter()
    ours = native_loader.overlap_matrix(depths, poses, intr, stride=8)
    overlap_s = time.perf_counter() - t0
    overlap_err = float(np.abs(ours - _overlap_numpy(depths, poses, intr, stride=8)).max())
    check(overlap_err <= OVERLAP_TOL, f"native: overlap_matrix {overlap_err} from numpy")

    # native against Python, sample by sample
    errs = {k: 0.0 for k in NATIVE_TOLS}
    for i in range(B):
        a, b = sets["480x640", False][i], sets["480x640", True][i]
        check(a["ids"] == b["ids"], f"native: tuple {i} {a['ids']} against {b['ids']}")
        for k in NATIVE_TOLS:
            errs[k] = max(errs[k], float(np.abs(a[k] - b[k]).max()))
    check(all(errs[k] <= NATIVE_TOLS[k] for k in NATIVE_TOLS),
          f"native: samples {errs} from the Python path's, limits {NATIVE_TOLS}")

    # 1296x968: the Python path pads to 972 rows, the native one does not
    # (the intrinsics of both are those of the padded frame)
    a, b = sets["1296x968", False][0], sets["1296x968", True][0]
    check(np.array_equal(a["intr"], b["intr"]), "native: 1296x968 intrinsics differ")
    h = a["images"].shape[1]
    bands = {"top": np.arange(4, 4 + h // 12), "middle": np.arange(h // 2 - h // 24, h // 2 + h // 24),
             "bottom": np.arange(h - 4 - h // 12, h - 4)}
    shifts, predicted = {}, {}
    for name, rows in bands.items():
        shifts[name] = float(np.mean([_row_shift(a["images"][v, ..., 0], b["images"][v, ..., 0], rows)
                                      for v in range(V)]))
        src = (rows.mean() + 0.5) * 968 / h - 0.5  # source row of the native path
        predicted[name] = (src + 2.5) * h / 972 - (src + 0.5) * h / 968
    rec.update(overlap_tool_seconds=tool_s, overlap_tool_tuples=n_tuples,
               overlap_matrix_seconds=overlap_s, overlap_max_err_vs_numpy=overlap_err,
               native_vs_python_max_err=errs,
               rows_python_below_native_1296x968={"measured": shifts, "predicted": predicted})
    return rec


def cli_phase(workdir, card, native, n_steps=2, hd_steps=20):
    """Both command lines at full width from a ScanNet-format tree, in
    subprocesses as a user runs them; then the eval `main()` in this process
    for the launch counts, its test set on the native runtime when that
    built (`native`, from `build_phase`), and the native runtime's own checks
    (`_native_checks`). Returns the launch counts."""
    import re
    import shutil

    import cv2
    import torch

    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev
    from e2e_multi_view_matching_tpu_torch.data.tuples import (
        MatchingTupleDataset,
        batch_iterator,
    )
    from e2e_multi_view_matching_tpu_torch.models.torch_import import import_superpoint

    V, B, H, W = 5, 8, 480, 640
    data, ckpt = f"{workdir}/cli_data", f"{workdir}/cli_runs"
    t0 = time.perf_counter()
    _write_cli_tree(data, H, W)
    write_s = time.perf_counter() - t0

    # host time to load one batch of 8 training tuples (decode, jitter, stack)
    train_set = MatchingTupleDataset(f"{data}/scannet", "train", V, n_samples=200, jitter=0.2)
    load_s = []
    for seed in (0, 1):
        t0 = time.perf_counter()
        next(batch_iterator(train_set, B, shuffle=True, seed=seed))
        load_s.append(time.perf_counter() - t0)
    check(len(train_set) == 16, f"cli: {len(train_set)} training tuples, expected 16")

    common = ["--data_dir", data, "--checkpoint_dir", ckpt, "--dataset", "scannet",
              "--tuple_size", str(V), "--batch_size", str(B), "--i_train", "1"]
    text1, wall1 = _run_cli("train", common + ["--n_epochs", "1", "--max_steps", str(n_steps),
                                               "--profile_steps", f"1,{n_steps}"],
                            f"{workdir}/cli_stage1.log")
    exp1, steps1, vals1, trace_path = _train_log(text1, "stage 1")
    text2, wall2 = _run_cli("train", common + ["--pose_loss", "--init_exp_name", exp1,
                                               "--n_epochs", "2", "--max_steps",
                                               str(2 * n_steps)], f"{workdir}/cli_stage2.log")
    exp2, steps2, vals2, _ = _train_log(text2, "stage 2")
    for exp, epoch in ((exp1, 0), (exp2, 1)):
        for name in ("cfg.json", "last_model.ckpt", "best_model.ckpt",
                     f"{epoch:06d}_model.ckpt"):
            check(os.path.exists(f"{ckpt}/{exp}/{name}"), f"cli: {exp} has no {name}")
        check(os.path.isdir(f"{ckpt}/runs/{exp}"), f"cli: no TensorBoard run of {exp}")
    check(len(steps1) == n_steps and len(steps2) == n_steps,
          f"cli: {len(steps1)} / {len(steps2)} steps logged, expected {n_steps}")

    # the profiled step: the training kernels by their CUDA symbols, each as
    # many times as one step launches it
    check(trace_path is not None and os.path.exists(trace_path), "cli: no profiler trace")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(bool(re.search(p, n)) for n in names) for k, p in TRACE_KERNELS.items()}
    expected = {k: v for k, v in _train_launches(1, 0).items() if k in TRACE_KERNELS}
    check(traced == expected, f"cli: the traced step launched {traced}, expected {expected}")

    # real ScanNet color (1296x968 JPEG: decode, pad, resize): the host's load
    # of a batch, and a stage-1 loop long enough to drain the prefetch, with
    # no profiler and no TensorBoard. The loader works up to three batches
    # ahead (two queued, one in hand), so it loads during steps up to
    # hd_steps - 3 and is done for the last three: one window of each, the
    # first after the process's first steps
    t0 = time.perf_counter()
    hd_data = _hd_tree(data, f"{workdir}/cli_data_hd", n_train=hd_steps * B // 8)
    hd_write_s = time.perf_counter() - t0
    hd_set = MatchingTupleDataset(f"{hd_data}/scannet", "train", V, n_samples=200, jitter=0.2)
    check(len(hd_set) == hd_steps * B, f"cli: {len(hd_set)} 1296x968 training tuples, "
          f"expected {hd_steps * B}")
    hd_load_s = []
    for seed in (0, 1):
        t0 = time.perf_counter()
        batch = next(batch_iterator(hd_set, B, shuffle=True, seed=seed))
        hd_load_s.append(time.perf_counter() - t0)
    check(batch["images"].shape == (B, V, H, W, 1), f"cli: 1296x968 batch of shape "
          f"{batch['images'].shape}")
    text4, wall4 = _run_cli("train", ["--data_dir", hd_data, *common[2:], "--n_epochs", "1",
                                      "--max_steps", str(hd_steps), "--no_tensorboard"],
                            f"{workdir}/cli_stage1_hd.log")
    exp4, steps4, vals4, _ = _train_log(text4, "stage 1, 1296x968 color")
    check(len(steps4) == hd_steps, f"cli: {len(steps4)} steps logged, expected {hd_steps}")
    windows = {"loading": _loop_window(text4, steps4, 5, hd_steps - 3),
               "loaded": _loop_window(text4, steps4, hd_steps - 3, hd_steps)}

    # eval: the stage-2 weights as model.ckpt, SuperPoint imported from the
    # upstream layout, 8 fixed test tuples
    exp_dir = f"{ckpt}/{exp2}"
    shutil.copy(f"{exp_dir}/best_model.ckpt", f"{exp_dir}/model.ckpt")
    torch.save(import_superpoint(_upstream_superpoint(np.random.default_rng(8))),
               f"{exp_dir}/superpoint.ckpt")
    csv_path = f"{workdir}/cli_test_tuples.csv"
    MatchingTupleDataset(f"{data}/scannet", "test", V, n_samples=8,
                         shuffle_tuple=False).write_sampled_tuples(csv_path)
    eval_args = ["--data_dir", data, "--checkpoint_dir", ckpt, "--exp_name", exp2,
                 "--test_tuple_file", csv_path, "--dataset", "scannet", "--tuple_size", str(V)]
    text3, wall3 = _run_cli("eval_multi_view", eval_args, f"{workdir}/cli_eval.log")
    with open(f"{exp_dir}/multi_view_scannet.json") as f:
        sub_metrics = json.load(f)
    n_tuples = int(re.findall(r"loaded (\d+) test tuples", text3)[-1])
    check(n_tuples == 8, f"cli: eval loaded {n_tuples} tuples, expected 8")

    # in this process: the test set resolves use_native="auto" as the
    # command line does (native when the runtime built), then on the Python
    # path for the comparison
    dataset_cls, resolved = tev.MatchingTupleDataset, []

    def recording(*args, **kwargs):
        ds = dataset_cls(*args, **kwargs)
        resolved.append(ds.use_native)
        return ds

    tev.MatchingTupleDataset = recording
    try:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        metrics = tev.main(eval_args)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = _launches()
        eval_python_s = None
        if native["built"]:
            tev.MatchingTupleDataset = lambda *a, **kw: recording(*a, **kw, use_native=False)
            t0 = time.perf_counter()
            python_metrics = tev.main(eval_args)
            torch.cuda.synchronize()
            eval_python_s = time.perf_counter() - t0
            check(python_metrics.keys() == metrics.keys(), f"cli: {python_metrics}")
    finally:
        tev.MatchingTupleDataset = dataset_cls
    check(resolved[0] == native["built"] and resolved[1:] in ([], [False]),
          f"cli: the eval main()'s test sets resolved use_native to {resolved}; the native "
          f"runtime built: {native['built']}")
    native_rec = _native_checks(workdir, data, hd_data, native)
    emit({"phase": "cli_native", "card": card, **native_rec,
          "eval_test_set_native": resolved[0],
          "eval_tuples_per_s_with_decode": {"auto": n_tuples / eval_s,
                                            "python": eval_python_s and n_tuples / eval_python_s}})
    auc_keys = [f"{m}_AUC@{t}deg" for t in (5, 10, 20) for m in ("pose", "transl", "rot")]
    emit({"phase": "cli", "codec": f"(a) OpenCV {cv2.__version__}", "card": card,
          "config": {"V": V, "B": B, "image": [H, W], "train_K": 400, "eval_K": 1024,
                     "sinkhorn_iters": 100, "jitter": 0.2, "train_tuples": len(train_set),
                     "eval_tuples": n_tuples, "steps_per_stage": n_steps},
          "tree_write_seconds": write_s, "host_load_seconds_per_batch_of_8": load_s,
          "stage1": {"exp": exp1, "wall_seconds": wall1, "steps": steps1, "val_losses": vals1,
                     "steps_per_s": 1.0 / steps1[-1][1], "profiled_step": n_steps,
                     "traced_kernel_launches": traced},
          "stage2": {"exp": exp2, "wall_seconds": wall2, "steps": steps2, "val_losses": vals2,
                     "steps_per_s": 1.0 / steps2[-1][1]},
          "stage1_1296x968": {
              "exp": exp4, "wall_seconds": wall4, "tree_write_seconds": hd_write_s,
              "host_load_seconds_per_batch_of_8": hd_load_s, "steps": steps4,
              "val_losses": vals4, "windows": windows},
          "eval": {"wall_seconds": wall3, "in_process_seconds": eval_s,
                   "tuples_per_s_with_decode": n_tuples / eval_s, "metrics": metrics},
          "launches_in_process_eval": launches})
    check(set(metrics) == set(auc_keys) and all(math.isfinite(metrics[k]) for k in auc_keys),
          f"cli: eval metrics {metrics}")
    check(set(sub_metrics) == set(auc_keys), f"cli: multi_view_scannet.json holds {sub_metrics}")
    check(metrics == sub_metrics, f"cli: in-process metrics {metrics} differ from the "
          f"subprocess's {sub_metrics}")
    expected = {**{k: 0 for k in launches}, "attn_fwd": 7, "cross_attn_fwd": 21,
                "sinkhorn_scaling": 1}
    check(launches == expected, f"cli: eval launched {launches}, expected {expected}")

    # the eval command line in bfloat16 (the bfloat16 attention kernels)
    text5, wall5 = _run_cli("eval_multi_view", eval_args + ["--compute_dtype", "bfloat16"],
                            f"{workdir}/cli_eval_bf16.log")
    with open(f"{exp_dir}/multi_view_scannet.json") as f:
        bf16_metrics = json.load(f)
    emit({"phase": "cli_bf16", "card": card, "wall_seconds": wall5, "metrics": bf16_metrics,
          "tuples": int(re.findall(r"loaded (\d+) test tuples", text5)[-1])})
    check(set(bf16_metrics) == set(auc_keys)
          and all(math.isfinite(bf16_metrics[k]) for k in auc_keys),
          f"cli: bfloat16 eval metrics {bf16_metrics}")

    # bfloat16 training through the command line: stage 1, then stage 2 from it
    common16 = common + ["--compute_dtype", "bfloat16", "--no_tensorboard"]
    text6, wall6 = _run_cli("train", common16 + ["--n_epochs", "1", "--max_steps", "1"],
                            f"{workdir}/cli_train_bf16.log")
    exp6, steps6, vals6, _ = _train_log(text6, "stage 1, bfloat16")
    text7, wall7 = _run_cli("train", common16 + ["--pose_loss", "--init_exp_name", exp6,
                                                 "--n_epochs", "2", "--max_steps", "2"],
                            f"{workdir}/cli_train2_bf16.log")
    exp7, steps7, vals7, _ = _train_log(text7, "stage 2, bfloat16")
    with open(f"{ckpt}/{exp7}/cfg.json") as f:
        cfg7 = json.load(f)
    emit({"phase": "cli_train_bf16", "card": card,
          "stage1": {"exp": exp6, "wall_seconds": wall6, "steps": steps6, "val_losses": vals6},
          "stage2": {"exp": exp7, "wall_seconds": wall7, "steps": steps7, "val_losses": vals7}})
    check(len(steps6) == 1 and len(steps7) == 1 and cfg7["compute_dtype"] == "bfloat16"
          and cfg7["pose_loss"], f"cli: bfloat16 training logged {steps6} / {steps7}")

    # upstream-layout checkpoints (SuperPoint and a 5-tuple matcher, seeded)
    # through the import tool into a run directory, then the eval command line
    # in ransac_ba on it. The directory starts with the stage-2 run's cfg.json,
    # which the tool keeps: its stub, like the JAX package's, lacks the
    # detector keys that the eval main() reads
    up, imp_dir = f"{workdir}/upstream", f"{ckpt}/imported"
    os.makedirs(up)
    os.makedirs(imp_dir)
    to_t = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}  # noqa: E731
    torch.save(to_t(_upstream_superpoint(np.random.default_rng(8))), f"{up}/superpoint_v1.pth")
    torch.save({"epoch": 0, "model": to_t(_upstream_matcher(np.random.default_rng(11)))},
               f"{up}/model.ckpt")
    shutil.copy(f"{exp_dir}/cfg.json", f"{imp_dir}/cfg.json")
    _, wall8 = _run_python(["tools/torch_import_weights.py", "--superpoint",
                            f"{up}/superpoint_v1.pth", "--matcher", f"{up}/model.ckpt",
                            "--out_dir", imp_dir, "--gnn_layers", "7",
                            "--cross_attention_layers", "3", "--tuple_size", str(V)],
                           f"{workdir}/cli_import.log")
    check(all(os.path.exists(f"{imp_dir}/{n}") for n in ("superpoint.ckpt", "model.ckpt")),
          f"cli: the import tool wrote {sorted(os.listdir(imp_dir))}")
    ransac_args = [("imported" if a == exp2 else a) for a in eval_args]
    text9, wall9 = _run_cli("eval_multi_view", ransac_args + ["--init_mode", "ransac_ba"],
                            f"{workdir}/cli_eval_ransac_ba.log")
    with open(f"{imp_dir}/multi_view_scannet.json") as f:
        ransac_metrics = json.load(f)
    emit({"phase": "cli_ransac_ba", "card": card, "import_wall_seconds": wall8,
          "eval_wall_seconds": wall9, "metrics": ransac_metrics,
          "tuples": int(re.findall(r"loaded (\d+) test tuples", text9)[-1])})
    check(set(ransac_metrics) == set(auc_keys)
          and all(math.isfinite(ransac_metrics[k]) for k in auc_keys),
          f"cli: ransac_ba eval metrics {ransac_metrics}")
    return launches


def _pair_grid(samples, eval_batch, eval_scan, bucket=128):
    """The chunks `cli.eval_pairs.evaluate` makes of `samples`: (sub-chunks,
    distinct (bucket pair, S) signatures)."""
    counts = {}
    for d in samples:
        key = tuple(tuple(-(-x // bucket) * bucket for x in d[f"image{s}"].shape[:2])
                    for s in (0, 1))
        counts[key] = counts.get(key, 0) + 1
    chunk, n_sub, sigs = eval_batch * eval_scan, 0, set()
    for key, n in counts.items():
        for lo in range(0, n, chunk):
            S = -(-min(chunk, n - lo) // eval_batch)
            n_sub += S
            sigs.add((key, S))
    return n_sub, len(sigs)


def _pair_sub_chunk(samples, bucket=128):
    """The tensors of one sub-chunk of same-bucket pairs on the card, as
    `cli.eval_pairs.evaluate` makes them: (images0, images1, sizes, valid0,
    valid1, K0, K1)."""
    import torch

    def canvas(img, shape):
        out = np.zeros(shape + (1,), np.float32)
        out[:img.shape[0], :img.shape[1]] = img
        return out

    shapes = [tuple(-(-x // bucket) * bucket for x in samples[0][f"image{s}"].shape[:2])
              for s in (0, 1)]
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    return (cuda(np.stack([canvas(d["image0"], shapes[0]) for d in samples])),
            cuda(np.stack([canvas(d["image1"], shapes[1]) for d in samples])),
            cuda([[d["image0"].shape[:2], d["image1"].shape[:2]] for d in samples]),
            cuda([d["image0"].shape[:2] for d in samples]),
            cuda([d["image1"].shape[:2] for d in samples]),
            cuda([d["intr0"][:3, :3] for d in samples]),
            cuda([d["intr1"][:3, :3] for d in samples]))


def _host_syncs(fn):
    """The Python lines at which `fn()` synchronised the host with the card."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                   if "synchronizing CUDA operation" in str(w.message)})


def _megadepth_list(root, n_pairs, rng):
    """A MegaDepth scene-info npz (LoFTR's layout) over `n_pairs` pairs of
    seeded smooth random gray JPEGs at long side 1600, landscape and portrait
    in three shapes: returns (data dir, npz path)."""
    import cv2

    shapes = [(1200, 1600), (1600, 1200), (1066, 1600)]
    n_img = 9
    paths = np.empty(n_img, dtype=object)
    intrs, poses = [], []
    for i in range(n_img):
        h, w = shapes[i % 3]
        # smooth waves at a quarter of the size, then the full size (fast)
        yy, xx = np.mgrid[0:h // 4, 0:w // 4].astype(np.float32)
        img = np.zeros((h // 4, w // 4), np.float32)
        for _ in range(12):
            k = rng.normal(size=2) * 0.12
            img += np.sin(k[0] * xx + k[1] * yy + rng.uniform(0, 2 * np.pi))
        img = (img - img.min()) / (img.max() - img.min())
        img = cv2.resize(img, (w, h)) + rng.normal(size=(h, w)).astype(np.float32) * 0.05
        paths[i] = f"Undistorted_SfM/0015/images/{i}.jpg"
        os.makedirs(f"{root}/Undistorted_SfM/0015/images", exist_ok=True)
        check(cv2.imwrite(f"{root}/{paths[i]}", np.clip(img * 255, 0, 255).astype(np.uint8)),
              f"pairs: cannot write {paths[i]}")
        f = 1.2 * max(h, w)
        intrs.append(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]]))
        pose = np.eye(4)
        pose[:3, :3] = cv2.Rodrigues(rng.normal(size=3) * 0.1)[0]
        pose[:3, 3] = rng.normal(size=3)
        poses.append(pose)
    pair_infos = np.empty(n_pairs, dtype=object)
    for i in range(n_pairs):
        pair_infos[i] = (np.array([i % n_img, (i * 4 + 1) % n_img]), 0.3, np.zeros((0, 2)))
    npz = f"{root}/0015_0.1_0.3.npz"
    np.savez(npz, image_paths=paths, intrinsics=np.stack(intrs), poses=np.stack(poses),
             pair_infos=pair_infos)
    return root, npz


# The pair phase's runs must reach these, so that the comparisons of matches
# and poses cover something: keypoints matched a pair, and the share of pairs
# with a pose, in every `evaluate` run and in a sub-chunk's w8pt modes. At
# the seeded weights the matches of two float32 runs differ on 0.5-2% of
# the keypoints either matched (ties that float32 rounding decides), so the
# kernels' matches and probabilities are held against a float64 plain run:
# no farther from it than 3 x plain float32's distance plus a slack (1% of
# the matched keypoints; SINKHORN_TOL for the probabilities).
MIN_MATCHES_A_PAIR = 8
MIN_VALID_SHARE = 0.5
MATCH_F64_FACTOR = 3.0
MATCH_F64_SLACK = 0.01


def _match_agreement(a, b):
    """matches0 of two runs: (the share of keypoints either run matched on
    which they agree, the number of such keypoints)."""
    matched = (a >= 0) | (b >= 0)
    n = int(matched.sum())
    return (float((a == b)[matched].float().mean()) if n else 0.0), n


def pairs_phase(workdir, card, n_pairs=16):
    """The two-view pair benchmark (`cli/eval_pairs.py`) at full width on the
    kernels, and the multi-view evaluation at K = 2048. Returns the launch
    counts of the kernel runs."""
    import copy
    import types

    import torch

    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev
    from e2e_multi_view_matching_tpu_torch.cli import eval_pairs as tep
    from e2e_multi_view_matching_tpu_torch.data.pairs import PairMatchingDataset
    from e2e_multi_view_matching_tpu_torch.data.synthetic import (
        SphereFieldScene,
        fourier_texture_image,
        write_scannet_format,
    )
    from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_
    from e2e_multi_view_matching_tpu_torch.models.matcher import (
        MatcherConfig,
        MultiViewMatcher,
        default_gnn_layers,
    )
    from e2e_multi_view_matching_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )
    from e2e_multi_view_matching_tpu_torch.models.torch_import import import_superpoint

    EB, SCAN = 8, 2  # eval_batch, eval_scan: the command line's defaults
    per_sub = {"attn_fwd": 9, "cross_attn_fwd": 9, "sinkhorn_scaling": 1}
    per_sub_bf16 = {"attn_fwd_bf16": 9, "cross_attn_fwd_bf16": 9, "sinkhorn_scaling": 1}
    data, assets, ckpt = f"{workdir}/pairs_data", f"{workdir}/pairs_assets", f"{workdir}/pairs_runs"
    total = {}

    def add_launches(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # 1. ScanNet: a test scene with real ScanNet's color (1296x968 JPEG, read
    # as 537 x 720 on a 640 x 768 bucket), a LoFTR-style test.npz, a seeded
    # two-view matcher and an imported SuperPoint as a run
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    scene = SphereFieldScene(rng, n_views=n_pairs + 1, H=480, W=640, f=577.0)
    write_scannet_format(scene, data, scene_name="scene0707_00", split="test",
                         image_fn=fourier_texture_image)
    _scannet_color(f"{data}/scannet/scans_test/scene0707_00")
    os.makedirs(f"{assets}/scannet_test_1500")
    np.savez(f"{assets}/scannet_test_1500/test.npz",
             name=np.asarray([(707, 0, i, i + 1) for i in range(n_pairs)]))
    write_s = time.perf_counter() - t0

    # seeded weights as flax draws them leave the two-view pair scores too flat
    # for a match to clear the 0.2 threshold (at most one a pair at K = 1024):
    # in this process the matchers take every mutual best match (threshold 0,
    # as the JAX package's tests run them), so that every pair has ~40-130
    # and the pose stages run on valid pairs; `main()` keeps 0.2
    def two_view(att, sink, dtype="float32"):
        return MultiViewMatcher(MatcherConfig(
            gnn_layers=default_gnn_layers(9, 1), sinkhorn_iterations=100, conf_mlp=True,
            multi_frame_matching=False, attention_impl=att, sinkhorn_impl=sink,
            match_threshold=0.0, compute_dtype=dtype))

    kernels, plain = two_view("cuda", "cuda"), two_view("xla", "mxu")
    init_like_flax_(kernels, torch.Generator().manual_seed(9))
    plain.load_state_dict(kernels.state_dict())
    exp_dir = f"{ckpt}/pairs"
    os.makedirs(exp_dir)
    torch.save({"epoch": 0, "model": kernels.state_dict(), "step": 0, "min_val_loss": 1.0,
                "pose_match_ratio": 0.0}, f"{exp_dir}/model.ckpt")
    sp_state = import_superpoint(_upstream_superpoint(np.random.default_rng(10)))
    torch.save(sp_state, f"{exp_dir}/superpoint.ckpt")

    text, cli_wall = _run_cli("eval_pairs", [
        "--data_dir", data, "--checkpoint_dir", ckpt, "--exp_name", "pairs", "--dataset",
        "scannet", "--assets_dir", assets, "--eval_mode", "w8pt_ba"], f"{workdir}/pairs_eval.log")
    with open(f"{exp_dir}/two_view_w8pt_ba_scannet.json") as f:
        cli_aucs = json.load(f)
    check(sorted(cli_aucs) == ["AUC@10deg", "AUC@20deg", "AUC@5deg"]
          and all(math.isfinite(v) for v in cli_aucs.values()),
          f"pairs: eval_pairs wrote {cli_aucs}")

    def superpoint(K, nms, thresh, dtype="float32"):
        sp = SuperPoint(SuperPointConfig(nms_radius=nms, keypoint_threshold=thresh,
                                         max_keypoints=K, remove_borders=0,
                                         fill_with_random_keypoints=False, compute_dtype=dtype))
        sp.load_state_dict(sp_state)
        return sp

    def run(sp, matcher, samples, mode, kernel_run, per=per_sub, dtype="float32"):
        """`evaluate` over `samples` (decoded): pairs/s, failures, signatures,
        and the kernels' launches, which must be exact on the kernels (`per`
        a sub-chunk)."""
        opt = types.SimpleNamespace(eval_mode=mode, max_pairs=None, eval_batch=EB,
                                    eval_scan=SCAN, shape_bucket=128, compute_dtype=dtype)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        errors, failures, n_sig = tep.evaluate(opt, sp, matcher, samples)
        dt = time.perf_counter() - t0
        launches = _launches()
        n_sub, want_sig = _pair_grid(samples, EB, SCAN)
        where = f"pairs ({mode}, {dtype}, {'kernels' if kernel_run else 'plain'})"
        check(len(errors) == len(samples) and int(np.isfinite(errors).sum())
              == len(samples) - failures, f"{where}: errors {errors}, {failures} failures")
        check(n_sig == want_sig, f"{where}: {n_sig} signatures, expected {want_sig}")
        check(len(samples) - failures >= MIN_VALID_SHARE * len(samples),
              f"{where}: {failures} of {len(samples)} pairs without a pose")
        if kernel_run:
            want = {**{k: 0 for k in launches}, **{k: v * n_sub for k, v in per.items()}}
            check(launches == want, f"{where}: launched {launches}, expected {want}")
            add_launches(launches)
        return {"pairs_per_s": len(samples) / dt, "seconds": dt, "failures": failures,
                "pairs": len(samples),
                "signatures": n_sig, "sub_chunks": n_sub,
                "median_error_deg": float(np.median(errors))}

    def sub_chunk_checks(sp, samples, tag):
        """One sub-chunk of 8 same-bucket pairs: the matches and log
        assignment of kernels and plain float32 against plain float64 on the
        same SuperPoint outputs, the pairs with a pose and their finiteness
        in the w8pt modes, no host sync inside a w8pt sub-chunk, and the
        stage times (w8pt_ba)."""
        args = _pair_sub_chunk(samples)
        n = len(samples)

        def wall(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3, out

        with torch.inference_mode():
            sp_ms, (sp0, sp1) = wall(lambda: (sp(args[0], args[3]), sp(args[1], args[4])))
            kpts = torch.stack([sp0["keypoints"], sp1["keypoints"]], 1)
            m_in = (kpts, torch.stack([sp0["scores"], sp1["scores"]], 1),
                    torch.stack([sp0["descriptors"], sp1["descriptors"]], 1), args[2])
            m_ms, out_k = wall(lambda: kernels(*m_in))
            out_p = plain(*m_in)
            out_r = copy.deepcopy(plain).double()(*(x.double() for x in m_in))
            m_k, m_p, m_r = (o["matches0"][:, 0] for o in (out_k, out_p, out_r))
            agree, n_matched = _match_agreement(m_k, m_p)
            agree_k, _ = _match_agreement(m_k, m_r)
            agree_p, _ = _match_agreement(m_p, m_r)
            z_r = out_r["log_assignment"].float()
            err_k = _prob_err(out_k["log_assignment"], z_r)
            err_p = _prob_err(out_p["log_assignment"], z_r)
            syncs, finite, n_valid = {}, {}, {}
            for mode in ("w8pt", "w8pt_ba", "w8pt_irls_ba"):
                run_sub = lambda: tep.infer_pose_subchunk(sp, kernels, mode, *args)  # noqa: E731
                T, valid = run_sub()
                finite[mode] = bool(torch.isfinite(T[valid]).all())
                n_valid[mode] = int(valid.sum())
                syncs[mode] = _host_syncs(run_sub)
            matches, conf = out_k["matches0"][:, 0], out_k["conf_scores"][:, 0]
            conf_w = torch.where(matches >= 0, conf, 0.0)
            mk1 = torch.gather(kpts[:, 1], 1, matches.clamp(min=0).long()[..., None].expand(
                -1, -1, 2))
            pose_ms, _ = wall(lambda: tep.pose_w8pt_batch("w8pt_ba", kpts[:, 0], mk1, args[5],
                                                          args[6], conf_w))
            busy = _device_busy(lambda: tep.infer_pose_subchunk(sp, kernels, "w8pt_ba", *args),
                                groups=EVAL_GROUPS)
        n_k, n_p = int((m_k >= 0).sum()), int((m_p >= 0).sum())
        limit = MATCH_F64_FACTOR * (1 - agree_p) + MATCH_F64_SLACK
        err_limit = MATCH_F64_FACTOR * err_p + SINKHORN_TOL
        check(min(n_k, n_p) >= MIN_MATCHES_A_PAIR * n, f"pairs ({tag}): {n_k} (kernels) and "
              f"{n_p} (plain) matches in {n} pairs, fewer than {MIN_MATCHES_A_PAIR} a pair")
        check(1 - agree_k <= limit, f"pairs ({tag}): the kernels' matches differ from float64's "
              f"on {1 - agree_k} of the matched keypoints, plain float32's on {1 - agree_p} "
              f"(limit {limit})")
        check(err_k <= err_limit, f"pairs ({tag}): the kernels' probabilities differ from "
              f"float64's by {err_k}, plain float32's by {err_p} (limit {err_limit})")
        check(float((m_k == m_p).float().mean()) >= 0.99,
              f"pairs ({tag}): matches0 agreement over all keypoints below 0.99")
        check(min(n_valid.values()) >= MIN_VALID_SHARE * n,
              f"pairs ({tag}): valid pairs {n_valid} of {n}")
        check(all(finite.values()), f"pairs ({tag}): non-finite poses of valid pairs {finite}")
        check(not any(syncs.values()), f"pairs ({tag}): host syncs in a sub-chunk {syncs}")
        return {"matches_kernels": n_k, "matches_plain": n_p, "matches_f64": int((m_r >= 0).sum()),
                "matched_keypoints": n_matched,
                "matches0_agreement_over_matched": {
                    "kernels_plain": agree, "kernels_f64": agree_k, "plain_f64": agree_p,
                    "limit_disagreement": limit},
                "matches0_agreement_all_keypoints": float((m_k == m_p).float().mean()),
                "prob_err_vs_f64": {"kernels": err_k, "plain": err_p, "limit": err_limit},
                "valid_pairs": n_valid, "poses_finite_where_valid": finite,
                "host_syncs_in_sub_chunk": syncs,
                "sub_chunk_pairs": len(samples), "superpoint_ms": sp_ms, "matcher_ms": m_ms,
                "pose_ms": pose_ms, **busy}

    dataset = PairMatchingDataset(f"{data}/scannet", [f"{assets}/scannet_test_1500/test.npz"],
                                  720, "scannet")
    t0 = time.perf_counter()
    samples = [dataset[i] for i in range(len(dataset))]
    decode_s = (time.perf_counter() - t0) / len(samples)
    check(all(s["image0"].shape == (537, 720, 1) for s in samples),
          f"pairs: ScanNet frames of shape {samples[0]['image0'].shape}")
    sp = superpoint(1024, 4, 0.001)
    run(sp, kernels, samples[:EB], "w8pt_ba", False)  # warm-up: cuDNN plans, allocator
    run(sp, plain, samples[:EB], "w8pt_ba", False)
    scannet = {mode: run(sp, kernels, samples, mode, True) for mode in tep.EVAL_MODES}
    scannet["plain_w8pt_ba"] = run(sp, plain, samples, "w8pt_ba", False)
    scannet_sub = sub_chunk_checks(sp, samples[:EB], "ScanNet")
    # bfloat16 (`--compute_dtype bfloat16`): the same weights, w8pt_ba, on the
    # bfloat16 attention kernels
    kernels16 = two_view("cuda", "cuda", "bfloat16")
    kernels16.load_state_dict(kernels.state_dict())
    sp16 = superpoint(1024, 4, 0.001, "bfloat16")
    run(sp16, kernels16, samples[:EB], "w8pt_ba", False, per_sub_bf16, "bfloat16")  # warm-up
    scannet["bf16_w8pt_ba"] = run(sp16, kernels16, samples, "w8pt_ba", True, per_sub_bf16,
                                  "bfloat16")
    del sp16

    # 2. MegaDepth format at K = 2048: three shapes at long side 1600, so that
    # chunks of different bucket pairs interleave
    t0 = time.perf_counter()
    md_dir, md_npz = _megadepth_list(f"{workdir}/pairs_megadepth", n_pairs,
                                     np.random.default_rng(11))
    md_write_s = time.perf_counter() - t0
    md_set = PairMatchingDataset(md_dir, [md_npz], 1600, "megadepth")
    t0 = time.perf_counter()
    md_samples = [md_set[i] for i in range(len(md_set))]
    md_decode_s = (time.perf_counter() - t0) / len(md_samples)
    sp2 = superpoint(2048, 3, 0.005)
    run(sp2, kernels, md_samples[:EB], "w8pt_ba", False)  # warm-up
    megadepth = {"w8pt_ba": run(sp2, kernels, md_samples, "w8pt_ba", True),
                 "plain_w8pt_ba": run(sp2, plain, md_samples, "w8pt_ba", False)}
    first = md_samples[0]["image0"].shape, md_samples[0]["image1"].shape
    same = [d for d in md_samples if (d["image0"].shape, d["image1"].shape) == first][:EB]
    sp2_16 = superpoint(2048, 3, 0.005, "bfloat16")
    run(sp2_16, kernels16, md_samples[:EB], "w8pt_ba", False, per_sub_bf16, "bfloat16")
    megadepth["bf16_w8pt_ba"] = run(sp2_16, kernels16, md_samples, "w8pt_ba", True,
                                    per_sub_bf16, "bfloat16")
    with torch.inference_mode():  # one bf16 sub-chunk at K = 2048: no host sync
        md_args = _pair_sub_chunk(same)
        megadepth["bf16_host_syncs_in_sub_chunk"] = _host_syncs(
            lambda: tep.infer_pose_subchunk(sp2_16, kernels16, "w8pt_ba", *md_args))
    del sp2_16, md_args
    check(not megadepth["bf16_host_syncs_in_sub_chunk"], f"pairs: host syncs in a bf16 "
          f"sub-chunk {megadepth['bf16_host_syncs_in_sub_chunk']}")
    check(megadepth["w8pt_ba"]["signatures"] >= 2,
          f"pairs: MegaDepth pairs on {megadepth['w8pt_ba']['signatures']} bucket pairs")
    megadepth_sub = sub_chunk_checks(sp2, same, "MegaDepth")
    del sp2, md_samples
    torch.cuda.empty_cache()

    # 3. the multi-view evaluation at MegaDepth's K = 2048: V = 5, one chunk of
    # 8 tuples, MegaDepth's schedule 9 x (self + cross) (`apply_dataset_defaults`)
    mv = MultiViewMatcher(MatcherConfig(
        gnn_layers=default_gnn_layers(9, 1), sinkhorn_iterations=100, conf_mlp=True,
        multi_frame_matching=True, attention_impl="cuda", sinkhorn_impl="cuda"))
    init_like_flax_(mv, torch.Generator().manual_seed(12))
    mv_opt = types.SimpleNamespace(tuple_size=5, max_tuples=None, eval_batch=8, eval_scan=1,
                                   no_pipeline=False, compute_dtype="float32")
    mv_data = _dataset(8, seed=12)
    sp5 = superpoint(2048, 3, 0.005)
    tev.evaluate(mv_opt, sp5, mv, mv_data)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    mv_errors = tev.evaluate(mv_opt, sp5, mv, mv_data)
    mv_s = time.perf_counter() - t0
    mv_launches = _launches()
    add_launches(mv_launches)
    check(len(mv_errors[0]) == 80 and np.all(np.isfinite(mv_errors[1])),
          "pairs: multi-view errors at K = 2048 missing or non-finite")
    want = {**{k: 0 for k in mv_launches}, **per_sub}
    check(mv_launches == want, f"pairs: multi-view at K = 2048 launched {mv_launches}, "
          f"expected {want}")

    emit({"phase": "pairs", "card": card,
          "config": {"eval_batch": EB, "eval_scan": SCAN, "shape_bucket": 128,
                     "gnn": "9x(self+cross)", "sinkhorn_iters": 100, "pairs": n_pairs},
          "cli": {"wall_seconds": cli_wall, "aucs": cli_aucs},
          "scannet": {"K": 1024, "frame": [537, 720], "bucket": [640, 768],
                      "tree_write_seconds": write_s, "host_decode_seconds_per_pair": decode_s,
                      "runs": scannet, "sub_chunk": scannet_sub},
          "megadepth": {"K": 2048, "frames": [[1200, 1600], [1600, 1200], [1066, 1600]],
                        "tree_write_seconds": md_write_s,
                        "host_decode_seconds_per_pair": md_decode_s, "runs": megadepth,
                        "sub_chunk": megadepth_sub},
          "multi_view_K2048": {"V": 5, "tuples": 8, "image": [480, 640],
                               "gnn": "9x(self+cross)", "tuples_per_s": 8 / mv_s,
                               "seconds": mv_s, "launches": mv_launches},
          "launches": total})
    return total


DIST_BA_RTOL, DIST_BA_ATOL = 2e-3, 5e-5  # tests/test_distributed_ba.py at scale
DIST_POSE_TOL = 1e-3  # deg, the pose errors of a tuple whose matches agree


def _big_ba_problem(rng, n_cams=12, pts_per_pair=800, noise=2e-4, cam_perturb=0.02):
    """JAX's at-scale multi-view BA problem (`tests/test_distributed_ba.py::
    _big_problem`) rebuilt with numpy: every pair of 12 cameras observes 800
    points, 52,800 observations; returns (GT extrinsics, the BA's inputs)."""
    Rs = []
    for _ in range(n_cams):  # tests/test_mvba.py::make_rig(rot_scale=0.3, spread=1.0)
        w = rng.normal(size=3)
        Rs.append(_rotation(w / np.linalg.norm(w) * rng.uniform(0, 0.3)).astype(np.float32))
    Rs[0] = np.eye(3, dtype=np.float32)
    centers = rng.uniform(-1.0, 1.0, size=(n_cams, 3)).astype(np.float32)
    centers[0] = 0
    extr = np.zeros((n_cams, 4, 4), np.float32)
    extr[:, 3, 3] = 1
    for i in range(n_cams):
        extr[i, :3, :3] = Rs[i]
        extr[i, :3, 3] = -Rs[i] @ centers[i]
    E = np.array([(i, j) for j in range(n_cams) for i in range(j)], np.int32)
    X = rng.uniform(-2, 2, size=(len(E), pts_per_pair, 3))
    X[..., 2] = rng.uniform(8, 16, size=(len(E), pts_per_pair))
    cam_a = np.repeat(E[:, 0], pts_per_pair).astype(np.int64)
    cam_b = np.repeat(E[:, 1], pts_per_pair).astype(np.int64)
    Xf = X.reshape(-1, 3)
    pa = np.einsum("pij,pj->pi", extr[cam_a, :3, :3], Xf) + extr[cam_a, :3, 3]
    pb = np.einsum("pij,pj->pi", extr[cam_b, :3, :3], Xf) + extr[cam_b, :3, 3]
    w = ((pa[:, 2] > 0.5) & (pb[:, 2] > 0.5)).astype(np.float32)
    xa = pa[:, :2] / pa[:, 2:3] + rng.normal(size=(len(pa), 2)) * noise
    xb = pb[:, :2] / pb[:, 2:3] + rng.normal(size=(len(pb), 2)) * noise
    extr_init = extr.copy()
    for i in range(1, n_cams):
        dw = rng.normal(size=3)
        dT = np.eye(4, dtype=np.float32)
        dT[:3, :3] = _rotation(dw / np.linalg.norm(dw) * cam_perturb)
        dT[:3, 3] = rng.normal(size=3) * cam_perturb
        extr_init[i] = dT @ extr[i]
    return extr, (extr_init.astype(np.float32), Xf.astype(np.float32), cam_a, cam_b,
                  xa.astype(np.float32), xb.astype(np.float32), w)


def _max_pose_err(extr_est, extr_gt):
    """(max rotation, max translation-direction error) in degrees of each
    camera relative to camera 0 (tests/test_mvba.py's gauge-safe measure)."""
    errs_r, errs_t = [], []
    for i in range(1, extr_gt.shape[0]):
        Tg = extr_gt[i] @ np.linalg.inv(extr_gt[0])
        Te = extr_est[i] @ np.linalg.inv(extr_est[0])
        errs_r.append(np.degrees(np.arccos(np.clip(
            (np.trace(Tg[:3, :3].T @ Te[:3, :3]) - 1) / 2, -1, 1))))
        n = np.linalg.norm(Tg[:3, 3]) * np.linalg.norm(Te[:3, 3])
        if n > 1e-9:
            errs_t.append(np.degrees(np.arccos(np.clip(Tg[:3, 3] @ Te[:3, 3] / n, -1, 1))))
    return float(max(errs_r)), float(max(errs_t)) if errs_t else 0.0


def _dist_rank(rank, world, port, workdir, n_steps):
    """One of the `distributed` phase's two gloo ranks, each a spawned process
    with its own CUDA context on cuda:0 (NCCL puts no two ranks on one GPU):
    stage-1 training as data 2 x model 1 and as data 1 x model 2 on the
    batch in `<workdir>/dist_batch.npz`, then the sharded multi-view BA on
    the problem in `<workdir>/dist_ba.npz`. Writes `<workdir>/dist_r<rank>.npz`."""
    import torch
    import torch.distributed as dist

    from e2e_multi_view_matching_tpu_torch.cli import train as tcli
    from e2e_multi_view_matching_tpu_torch.mvba.distributed import (
        bundle_adjust_multi_view_sharded,
    )
    from e2e_multi_view_matching_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(rank, world, f"tcp://127.0.0.1:{port}", backend="gloo", device="cuda:0")
    torch.cuda.set_device(0)
    data = dict(np.load(f"{workdir}/dist_batch.npz"))
    out = {}
    for tag, model_parallel in (("dp", 1), ("tp", world)):
        n_data = world // model_parallel
        b = len(data["images"]) // n_data
        lo = (rank // model_parallel) * b

        def rows(prefix):
            return {k: data[f"{prefix}{k}"][lo:lo + b] for k in ("images", "intr", "poses",
                                                                 "depths")}

        train_b, val_b = rows(""), rows("val_")
        opt = tcli.parse_args([
            "--checkpoint_dir", f"{workdir}/dist_{tag}", "--dataset", "scannet",
            "--tuple_size", "5", "--batch_size", str(b), "--n_epochs", "1",
            "--max_steps", str(n_steps), "--i_train", "1", "--no_tensorboard",
            "--attention_impl", "cuda", "--sinkhorn_impl", "cuda", "--multi_host",
            "--model_parallel", str(model_parallel),
            "--dump_first_grad", f"{workdir}/dist_{tag}_grad"])
        torch.cuda.synchronize()
        _reset_launches()
        with _LossLog() as losses:
            t0 = time.perf_counter()
            state = tcli.train(opt, lambda epoch: iter([train_b] * n_steps),
                               lambda epoch: iter([val_b]), device="cuda:0")
            torch.cuda.synchronize()
            out[f"{tag}_seconds"] = time.perf_counter() - t0
        out[f"{tag}_launches"] = json.dumps(_launches())
        out[f"{tag}_losses"] = np.asarray(losses.train + losses.val, np.float64)
        out[f"{tag}_step_end"] = np.asarray(losses.step_end, np.float64)
        out[f"{tag}_split"] = np.asarray(sorted(k for k, v in state.specs.items() if v))
        for name, p in state.matcher.named_parameters():
            out[f"{tag}:{name}"] = p.detach().cpu().numpy()
        for name, x in state.matcher.named_buffers():
            out[f"{tag}:{name}"] = x.cpu().numpy()
        del state
        torch.cuda.empty_cache()
    problem = dict(np.load(f"{workdir}/dist_ba.npz"))
    args = [torch.from_numpy(problem[k]).cuda() for k in ("extr_init", "X", "cam_a", "cam_b",
                                                        "xa", "xb", "w")]
    mesh = make_mesh()
    bundle_adjust_multi_view_sharded(*args, mesh=mesh, n_iterations=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extr, X = bundle_adjust_multi_view_sharded(*args, mesh=mesh, n_iterations=8)
    torch.cuda.synchronize()
    out["ba_seconds"] = time.perf_counter() - t0
    out["ba_extr"], out["ba_X_shape"] = extr.cpu().numpy(), np.asarray(X.shape)
    np.savez(f"{workdir}/dist_r{rank}.npz", **out)
    dist.destroy_process_group()


def distributed_phase(workdir, card, n_tuples=8, n_steps=3, world=2):
    """The distributed modes on the card: (a) `evaluate` on a [cuda:0, cuda:0]
    mesh, (b) data-parallel and (c) tensor-parallel stage-1 training on two
    gloo ranks, (d) the sharded multi-view BA on two gloo ranks, (e) the
    training command line under `torch.distributed.run` (env:// and NCCL,
    world size 1). Returns the phase's kernel launches: the eval's in this
    process and the training runs' in each rank."""
    import inspect
    import multiprocessing
    import socket
    import types

    import torch

    from e2e_multi_view_matching_tpu_torch.cli import eval_multi_view as tev
    from e2e_multi_view_matching_tpu_torch.cli import train as tcli
    from e2e_multi_view_matching_tpu_torch.data.synthetic import training_batch
    from e2e_multi_view_matching_tpu_torch.mvba.bundle_adjust import bundle_adjust_multi_view
    from e2e_multi_view_matching_tpu_torch.parallel.mesh import make_mesh
    from e2e_multi_view_matching_tpu_torch.utils import config as tconfig

    seconds = {}
    t_phase = time.perf_counter()
    # (a) eval: 8 tuples as one sub-chunk of 8, two slices of 4 on cuda:0,
    # against the one-device run at the slices' batch of 4 (one chunk of
    # two sub-chunks): the same program per tuple
    sp, kernels, _ = _full_width_models()
    samples = _dataset(n_tuples)
    base = dict(tuple_size=5, max_tuples=None, eval_scan=1, no_pipeline=False,
                compute_dtype="float32")
    ref_opt = types.SimpleNamespace(**base, eval_batch=n_tuples // world)
    dp_opt = types.SimpleNamespace(**base, eval_batch=n_tuples)
    mesh = make_mesh(devices=["cuda:0"] * world)
    captured = []
    infer = tev.infer_subchunk

    def recording(*args, **kwargs):  # keeps each slice's matches0, on the device
        out = infer(*args, **kwargs)
        captured.append(out[1])
        return out

    tev.infer_subchunk = recording
    try:
        ref_err = np.asarray(tev.evaluate(ref_opt, sp, kernels, samples))
        ref_m = torch.cat(captured)
        tev.evaluate(dp_opt, sp, kernels, samples, mesh=mesh)  # warm-up
        captured.clear()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        dp_err = np.asarray(tev.evaluate(dp_opt, sp, kernels, samples, mesh=mesh))
        eval_s = time.perf_counter() - t0
        eval_launches = _launches()
        dp_m = torch.cat(captured)
        syncs = _host_syncs(lambda: tev.evaluate(dp_opt, sp, kernels, samples, mesh=mesh))
    finally:
        tev.infer_subchunk = infer
    src, first = inspect.getsourcelines(tconfig.fetch_packed)
    copy_line = f"config.py:{first + next(i for i, ln in enumerate(src) if '.cpu()' in ln)}"
    agree = float((dp_m == ref_m).float().mean())
    same = [bool(torch.equal(dp_m[t], ref_m[t])) for t in range(n_tuples)]
    per_tuple = np.abs(dp_err - ref_err).reshape(3, n_tuples, -1).max(axis=(0, 2))
    pose_diff = max([float(d) for d, s in zip(per_tuple, same) if s], default=0.0)
    expected_eval = {**{k: 0 for k in eval_launches}, "attn_fwd": 7 * world,
                     "cross_attn_fwd": 21 * world, "sinkhorn_scaling": world}
    emit({"phase": "distributed_eval", "card": card,
          "config": {"V": 5, "K": 1024, "image": [480, 640], "gnn": "7x(self+3xcross)",
                     "sinkhorn_iters": 100, "init_mode": "w8pt_ba", "tuples": n_tuples,
                     "mesh": [str(d) for d in mesh.data_devices()], "eval_batch": n_tuples,
                     "reference_eval_batch": n_tuples // world},
          "tuples_per_s": n_tuples / eval_s, "matches0_agreement": agree,
          "tuples_with_equal_matches": sum(same), "max_pose_err_diff_deg": pose_diff,
          "launches_one_sub_chunk": eval_launches, "host_syncs": syncs,
          "allowed_sync": copy_line})
    check(np.all(np.isfinite(dp_err)) and dp_err.shape == ref_err.shape,
          "distributed (a): errors missing or non-finite")
    check(agree >= 0.99, f"distributed (a): matches0 agreement {agree} < 0.99")
    check(pose_diff <= DIST_POSE_TOL, f"distributed (a): pose errors differ by {pose_diff} "
          f"deg on a tuple with equal matches")
    check(eval_launches == expected_eval, f"distributed (a): launches {eval_launches}, "
          f"expected {expected_eval}")
    check(set(syncs) <= {copy_line}, f"distributed (a): host syncs at {syncs}, only the "
          f"chunk's copy {copy_line} is allowed")
    del sp, kernels, ref_m, dp_m, captured
    torch.cuda.empty_cache()
    seconds["eval"] = time.perf_counter() - t_phase

    # (b, c) the one-rank reference over the same global batch of 8 (the
    # train_path batch), then the two ranks
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    batch = training_batch(rng, 8, 5, 480, 480, f=577.0)
    val_batch = training_batch(rng, 8, 5, 480, 480, f=577.0)
    np.savez(f"{workdir}/dist_batch.npz", **batch, **{f"val_{k}": v for k, v in val_batch.items()})
    extr_gt, problem = _big_ba_problem(np.random.default_rng(0))
    np.savez(f"{workdir}/dist_ba.npz", **dict(zip(("extr_init", "X", "cam_a", "cam_b", "xa",
                                                   "xb", "w"), problem)))
    ref_opt = tcli.parse_args([
        "--checkpoint_dir", f"{workdir}/dist_ref", "--dataset", "scannet", "--tuple_size", "5",
        "--batch_size", "8", "--n_epochs", "1", "--max_steps", "1", "--no_tensorboard",
        "--attention_impl", "cuda", "--sinkhorn_impl", "cuda",
        "--dump_first_grad", f"{workdir}/dist_ref_grad"])
    tcli.train(ref_opt, lambda epoch: iter([batch]), lambda epoch: iter([val_batch]))
    ref_grads = dict(np.load(f"{workdir}/dist_ref_grad_p0.npz"))
    torch.cuda.empty_cache()
    seconds["reference"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, port, workdir, n_steps))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check([p.exitcode for p in procs] == [0] * world,
          f"distributed: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [dict(np.load(f"{workdir}/dist_r{r}.npz")) for r in range(world)]
    seconds["ranks"] = time.perf_counter() - t0

    top = max(float(np.linalg.norm(g)) for g in ref_grads.values())
    launches = dict(eval_launches)
    for tag, what in (("dp", "(b) data 2 x model 1"), ("tp", "(c) data 1 x model 2")):
        grads = [dict(np.load(f"{workdir}/dist_{tag}_grad_p{r}.npz")) for r in range(world)]
        diffs = sorted((float(np.linalg.norm(grads[0][k] - ref_grads[k])) / top, k)
                       for k in ref_grads)
        (worst, worst_leaf), median = diffs[-1], diffs[len(diffs) // 2][0]
        split = set(ranks[0][f"{tag}_split"].tolist())
        names = [k.split(":", 1)[1] for k in ranks[0] if k.startswith(f"{tag}:")]
        replicated_equal = all(np.array_equal(ranks[0][f"{tag}:{n}"], r[f"{tag}:{n}"])
                               for r in ranks[1:] for n in names if n not in split)
        halves = all(ranks[0][f"{tag}:{n}"].shape[0] * world == ref_grads[n].shape[0]
                     for n in split)
        grads_equal = all(np.array_equal(grads[0][k], g[k]) for g in grads[1:] for k in g)
        rank_launches = [json.loads(str(r[f"{tag}_launches"])) for r in ranks]
        expected = _train_launches(n_steps, val_batches=1)
        ends = ranks[0][f"{tag}_step_end"]
        emit({"phase": f"distributed_train_{tag}", "card": card, "mesh": what,
              "backend": "gloo, both ranks on cuda:0",
              "config": {"V": 5, "K": 400, "global_batch": 8, "image": [480, 480],
                         "gnn": "7x(self+3xcross)", "sinkhorn_iters": 100, "steps": n_steps},
              "losses_rank0": ranks[0][f"{tag}_losses"].tolist(),
              "steps_per_s_rank0": (len(ends) - 1) / (ends[-1] - ends[0]),
              "seconds_per_rank": [float(r[f"{tag}_seconds"]) for r in ranks],
              "first_step_grad_leaf_diff_over_top_norm": {
                  "worst": worst, "worst_leaf": worst_leaf, "tol_worst": TRAIN_GRAD_WORST_TOL,
                  "median": median, "tol_median": TRAIN_GRAD_MEDIAN_TOL},
              "ranks_same_first_grads": grads_equal,
              "ranks_same_params_after_last_step": replicated_equal,
              "split_leaves": len(split), "split_leaves_hold_half_rows": halves,
              "launches_per_rank": rank_launches})
        check(worst <= TRAIN_GRAD_WORST_TOL and median <= TRAIN_GRAD_MEDIAN_TOL,
              f"distributed {what}: first-step gradients differ from one rank's by {worst} "
              f"(worst leaf) / {median} (median leaf) of the largest leaf norm")
        check(grads_equal and replicated_equal, f"distributed {what}: the ranks differ")
        check((len(split) > 0) == (tag == "tp") and halves,
              f"distributed {what}: {len(split)} split leaves, halves {halves}")
        check(all(math.isfinite(x) for x in ranks[0][f"{tag}_losses"]),
              f"distributed {what}: non-finite losses")
        for rl in rank_launches:
            check(rl == expected, f"distributed {what}: launches {rl}, expected {expected}")
            for k, v in rl.items():
                launches[k] = launches.get(k, 0) + v

    # (d) the sharded BA against one rank on the card
    t0 = time.perf_counter()
    args = [torch.from_numpy(np.asarray(a)).cuda() for a in problem]
    one, _ = bundle_adjust_multi_view(args[0][None], args[1][None], args[2], args[3],
                                      args[4][None], args[5][None], args[6][None],
                                      n_iterations=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one, _ = bundle_adjust_multi_view(args[0][None], args[1][None], args[2], args[3],
                                      args[4][None], args[5][None], args[6][None],
                                      n_iterations=8)
    one = one[0].cpu().numpy()
    one_s = time.perf_counter() - t1
    sharded = ranks[0]["ba_extr"]
    err = np.abs(sharded - one) - DIST_BA_RTOL * np.abs(one)
    r, t = _max_pose_err(sharded, extr_gt)
    r0, t0_ = _max_pose_err(problem[0], extr_gt)
    emit({"phase": "distributed_ba", "card": card,
          "config": {"cameras": 12, "observations": int(len(problem[2])), "lm_iterations": 8,
                     "ranks": world, "backend": "gloo, both ranks on cuda:0"},
          "one_rank_seconds": one_s, "sharded_seconds_per_rank":
              [float(x["ba_seconds"]) for x in ranks],
          "max_abs_excess_over_rtol": float(err.max()),
          "ranks_same_cameras": all(np.array_equal(x["ba_extr"], sharded) for x in ranks),
          "rot_err_deg": [r0, r], "transl_err_deg": [t0_, t]})
    check(bool(np.all(err <= DIST_BA_ATOL)), f"distributed (d): sharded cameras off one "
          f"rank's by {float(err.max())} beyond rtol {DIST_BA_RTOL}")
    check(all(np.array_equal(x["ba_extr"], sharded) for x in ranks)
          and ranks[0]["ba_X_shape"].tolist() == [len(problem[2]), 3],
          "distributed (d): the ranks differ, or the points did not come back")
    check(r < 0.15 * r0 and t < 0.15 * t0_, f"distributed (d): rotation {r0} -> {r}, "
          f"translation {t0_} -> {t} deg: not below 0.15 of the initial error")
    seconds["ba"] = time.perf_counter() - t0

    # (e) the command line as torchrun starts it: env://, NCCL, world size 1
    t0 = time.perf_counter()
    data = f"{workdir}/cli_data"
    if not os.path.isdir(data):
        _write_cli_tree(data)
    text, wall = _run_python([
        "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
        "-m", f"{PKG}.cli.train", "--multi_host", "--data_dir", data,
        "--checkpoint_dir", f"{workdir}/dist_cli", "--dataset", "scannet", "--tuple_size", "5",
        "--batch_size", "8", "--i_train", "1", "--n_epochs", "1", "--max_steps", "2",
        "--no_tensorboard"], f"{workdir}/dist_cli.log")
    exp, steps, vals, _ = _train_log(text, "torchrun")
    emit({"phase": "distributed_cli", "card": card, "wall_seconds": wall, "steps": steps,
          "val_losses": vals, "backend_nccl": "(nccl)" in text})
    check(len(steps) == 2 and "(nccl)" in text
          and os.path.exists(f"{workdir}/dist_cli/{exp}/last_model.ckpt"),
          f"distributed (e): {len(steps)} steps, backend line {'(nccl)' in text}")
    seconds["cli"] = time.perf_counter() - t0
    emit({"phase": "distributed_seconds", "card": card, **seconds})
    return launches


PHASES = ("kernel", "reference", "main_path", "init_modes", "bf16", "train_path",
          "pose_path", "train_bf16", "cli", "distributed", "pairs")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s to run after build "
                             "and device; a subset is a debugging aid and prints no "
                             "final result line")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"--phases takes a subset of {PHASES}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tempfile

    by_path = {}
    seconds, t_last = {}, time.perf_counter()  # wall seconds of each phase

    def lap(name):
        nonlocal t_last
        seconds[name], t_last = time.perf_counter() - t_last, time.perf_counter()

    try:
        with tempfile.TemporaryDirectory() as workdir:  # checkpoints of the two stages
            native = build_phase()
            card = device_phase()
            lap("build")
            records = kernel_phase() if "kernel" in phases else []
            lap("kernel")
            if "reference" in phases:
                reference_phase()
            if "main_path" in phases:
                by_path["eval"], sub_chunk = main_path_phase()
                breakdown_phase(*sub_chunk)
                del sub_chunk
                torch.cuda.empty_cache()
            lap("main_path")
            if "init_modes" in phases:
                by_path.update(init_modes_phase(card))
                torch.cuda.empty_cache()
            lap("init_modes")
            if "bf16" in phases:
                by_path["eval_bf16"] = bf16_phase()
                torch.cuda.empty_cache()
            lap("bf16")
            stage1_exp = None
            if "train_path" in phases:
                by_path["train"], stage1_exp = train_path_phase(workdir)
                torch.cuda.empty_cache()
            lap("train_path")
            if "pose_path" in phases:
                by_path["pose"] = pose_path_phase(workdir, stage1_exp)
                torch.cuda.empty_cache()
            lap("pose_path")
            if "train_bf16" in phases:
                by_path["train_bf16"] = train_bf16_phase(workdir)
                torch.cuda.empty_cache()
            lap("train_bf16")
            if "cli" in phases:
                by_path["cli_eval"] = cli_phase(workdir, card, native)
                torch.cuda.empty_cache()
            lap("cli")
            if "distributed" in phases:
                by_path["distributed"] = distributed_phase(workdir, card)
                torch.cuda.empty_cache()
            lap("distributed")
            if "pairs" in phases:
                by_path["pairs"] = pairs_phase(workdir, card)
            lap("pairs")
            emit({"phase_seconds": seconds})
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if set(phases) != set(PHASES):
        print(f"chip_smoke: partial run ({args.phases}), no result line")
        return 0
    for r in records:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["on_main_path"] = r["name"] not in OFF_PATH_KERNELS
        if r["launches"] < 1 and r["name"] not in OFF_PATH_KERNELS:
            print(f"chip_smoke FAILED: no main path launched {r['name']}", file=sys.stderr)
            return 1
    emit({"kernels": records})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
