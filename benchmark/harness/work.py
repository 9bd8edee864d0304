"""Operations, exponentials and bytes of the port's work, from the shapes.

The yardstick of the roofline and MFU metrics. Peaks are the H100 SXM's
data-sheet figures at its 700 W limit: 67 TFLOP/s of FP32 outside the tensor
cores (the port runs float32 with TF32 off), 3.35 TB/s of HBM3, and
exponentials at 16 a clock on each of the 132 SMs' special-function units at
the 1,980 MHz maximum SM clock. A kernel's bound counts each input byte read
once and each output byte written once.

Shapes are a dict: batch (tuples a unit), views V, kpts K, height, width,
dim D, heads, layers (the GNN schedule, "self"/"cross"), sinkhorn_iters,
conf_mlp (bool), keypoint_encoder (widths), conf_mlp_hidden (widths).
"""

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXPS = 16 * 132 * 1.98e9
ABSORB_EVERY = 10  # scaling-domain Sinkhorn: an exact log-domain step every 10
F32 = 4


def bound_s(ops, nbytes, exps=0.0):
    """Least seconds of the work on one H100: the largest of operations over
    the FP32 peak, exponentials over their peak and bytes over HBM's."""
    return max(ops / PEAK_F32_OPS, exps / PEAK_EXPS, nbytes / PEAK_BYTES)


# --- attention kernels (`ops/csrc/attention_cuda.cu`); per launch ---------

def attention_shapes(s):
    """{"self": (BH, S, keys, dh), "cross": (BH, S, keys, dh)}: a self layer
    attends within each of the B V views, a cross layer from each of the
    V K tokens of a tuple to the (V - 1) K tokens of the other views."""
    B, V, K, h = s["batch"], s["views"], s["kpts"], s["heads"]
    dh = s["dim"] // h
    return {"self": (B * V * h, K, K, dh), "cross": (B * h, V * K, (V - 1) * K, dh)}


def attn_fwd(BH, S, keys, dh):
    """(ops, bytes, exps) of the forward: Q K^T and P V (two FMAs a pair and
    head dimension, 4 operations), one exponential a score; q, k, v read and
    o written once."""
    pairs = float(BH * S * keys)
    return 4.0 * pairs * dh + pairs, 4.0 * BH * S * dh * F32, pairs


def attn_fwd_lse(BH, S, keys, dh):
    """The forward that also stores the row log-sum-exp."""
    pairs = float(BH * S * keys)
    rows = float(BH * S)
    return pairs * (4 * dh + 1), F32 * (4 * rows * dh + rows), pairs


def attn_bwd_dq(BH, S, keys, dh):
    """dq from q, k, v, dO, the LSE and dvec: S and dP again, then dS K."""
    pairs = float(BH * S * keys)
    rows = float(BH * S)
    return pairs * (6 * dh + 3), F32 * (5 * rows * dh + 2 * rows), pairs


def attn_bwd_dkv(BH, S, keys, dh):
    """dk and dv: S^T, dP^T, P^T dO and dS^T q."""
    pairs = float(BH * S * keys)
    rows = float(BH * S)
    return pairs * (8 * dh + 3), F32 * (6 * rows * dh + 2 * rows), pairs


# --- Sinkhorn kernels (`ops/csrc/sinkhorn_cuda.cu`); per launch ------------

def sinkhorn_shape(s):
    """(pair matrices, rows, columns, iterations) of one solve."""
    P = s["views"] * (s["views"] - 1) // 2
    M = s["kpts"] + 1
    return s["batch"] * P, M, M, s["sinkhorn_iters"]


def sinkhorn_scaling(B, M, N, T):
    """Scaling-domain solve: 4 flops an entry a scaling iteration (two
    matvecs), the exact first iteration (2 exponentials and 4 operations an
    entry), one exponential and 2 adds an entry a rebuild, 3 for the output;
    couplings read once, log assignment written once."""
    n_absorb = T // ABSORB_EVERY
    elems = float(B * M * N)
    return (elems * (4 * (T - 1) + 6 + 3 * n_absorb + 3), 2.0 * elems * F32,
            elems * (2 + n_absorb))


def sinkhorn_log_stash(B, M, N, T):
    """Log-domain solve keeping every iteration's duals: each half-step adds
    the dual, takes the max, subtracts it, exponentiates and sums (5 an
    entry), twice an iteration, 3 for the output; two exponentials an entry
    an iteration; couplings read, output and duals written."""
    elems = float(B * M * N)
    return (elems * (10 * T + 3), 2.0 * F32 * elems + F32 * B * T * (M + N),
            elems * 2 * T)


def sinkhorn_bwd(B, M, N, T):
    """The reverse sweep over the stashed duals: Q and P each two adds, one
    exponential, one multiply and one sum (10 an entry a step), plus the
    two-term update (2); couplings and cotangent read, gradient written."""
    elems = float(B * M * N)
    return elems * 12 * T, 3.0 * F32 * elems + 2.0 * F32 * B * T * (M + N), elems * 2 * T


# --- model FLOPs (multiply-adds count 2) -----------------------------------

SUPERPOINT_CONVS = (  # (in, out, kernel, downsampling before it)
    (1, 64, 3, 1), (64, 64, 3, 1), (64, 64, 3, 2), (64, 64, 3, 2), (64, 128, 3, 4),
    (128, 128, 3, 4), (128, 128, 3, 8), (128, 128, 3, 8),
    (128, 256, 3, 8), (256, 65, 1, 8), (128, 256, 3, 8), (256, 256, 1, 8))


def superpoint_flops(H, W):
    """Convolution FLOPs of SuperPoint on one H x W frame."""
    return float(sum(2 * (H // d) * (W // d) * cin * cout * k * k
                     for cin, cout, k, d in SUPERPOINT_CONVS))


def _mlp_flops(rows, dims):
    return float(sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:])))


def matcher_flops(s):
    """Forward FLOPs of the matcher on one unit of `s["batch"]` tuples: the
    keypoint encoder, every layer's four projections and its MLP, the QK^T
    and PV of its attention, the final projection, the pair score products
    and the confidence head."""
    B, V, K, D = s["batch"], s["views"], s["kpts"], s["dim"]
    tokens = B * V * K
    P = V * (V - 1) // 2
    flops = _mlp_flops(tokens, (3,) + tuple(s["keypoint_encoder"]) + (D,))
    shapes = attention_shapes(s)
    for kind in s["layers"]:
        flops += 4 * 2.0 * tokens * D * D  # q, k, v and merge
        flops += _mlp_flops(tokens, (2 * D, 2 * D, D))
        BH, S, keys, dh = shapes[kind]
        flops += 4.0 * BH * S * keys * dh
    flops += 2.0 * tokens * D * D  # final projection
    flops += 2.0 * B * P * K * K * D  # pair scores
    if s["conf_mlp"]:
        flops += _mlp_flops(B * P * K, (2 * D + 1,) + tuple(s["conf_mlp_hidden"]) + (1,))
    return flops


def eval_unit_flops(s):
    """Model FLOPs of one eval sub-chunk: SuperPoint on its B V frames and
    the matcher's forward."""
    return s["batch"] * s["views"] * superpoint_flops(s["height"], s["width"]) + matcher_flops(s)


def train_step_flops(s):
    """Model FLOPs of one training step: the frozen SuperPoint once, the
    matcher three times (forward, and twice that for the backward)."""
    return (s["batch"] * s["views"] * superpoint_flops(s["height"], s["width"])
            + 3.0 * matcher_flops(s))
