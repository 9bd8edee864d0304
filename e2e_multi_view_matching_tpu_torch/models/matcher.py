"""Multi-view attentional GNN matcher with Sinkhorn assignment and confidence MLP (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/models/matcher.py`:
all views' keypoints form one (B, V*K, D) token tensor; self layers attend
within a view, cross layers attend every other view jointly; all C(V,2) view
pairs are scored at once and solved by Sinkhorn as one (B*P, K+1, K+1) batch.
Submodule names follow the flax names (`kenc.dense_0`, `gnn_3_cross.q_proj`,
`conf_mlp.bn_1`, ...), so `models/convert.py` maps weights mechanically.

Kernel selection: `attention_impl` "cuda" routes self and cross attention
through `ops/attention_cuda.py`, "xla" through the plain masked
`multi_head_attention`; `sinkhorn_impl` "cuda" uses `ops/sinkhorn_cuda.py`,
"xla"/"mxu" the plain log-domain/scaling-domain iterations. A "cuda" op given
a CPU tensor runs its plain version.

`forward(..., train=True)` is the training mode: BatchNorm normalises with the
batch statistics over all axes but the last and moves the running statistics,
exactly as flax does (biased variance as E[x^2] - E[x]^2, also stored;
momentum 0.9 on the old value). It is a call argument, as in the JAX package,
not `nn.Module.train()`.
"""

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e2e_multi_view_matching_tpu_torch.ops.attention import (
    cross_view_mask,
    multi_head_attention,
)
from e2e_multi_view_matching_tpu_torch.ops.attention_cuda import fused_view_attention
from e2e_multi_view_matching_tpu_torch.ops.sinkhorn import (
    extract_matches,
    log_optimal_transport,
)
from e2e_multi_view_matching_tpu_torch.ops.sinkhorn_cuda import log_optimal_transport_cuda

ATTENTION_IMPLS = ("xla", "cuda")
SINKHORN_IMPLS = ("xla", "mxu", "cuda")
BN_MOMENTUM = 0.9  # weight of the old running statistic (flax `momentum`)


def default_gnn_layers(gnn_layers: int = 9, cross_attention_layers: int = 1) -> Tuple[str, ...]:
    """Layer schedule (['self'] + ['cross'] * c) * g."""
    return tuple((["self"] + ["cross"] * cross_attention_layers) * gnn_layers)


@dataclass(frozen=True)
class MatcherConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128, 256)
    gnn_layers: Tuple[str, ...] = field(default_factory=default_gnn_layers)
    num_heads: int = 4
    sinkhorn_iterations: int = 100
    sinkhorn_impl: str = "xla"
    attention_impl: str = "xla"
    compute_dtype: str = "float32"
    match_threshold: float = 0.2
    multi_frame_matching: bool = False
    conf_mlp: bool = False
    conf_mlp_hidden: Tuple[int, ...] = (256, 64)


def batch_norm(x, bn, train):
    """BatchNorm over every axis but the last, with flax's arithmetic.

    Eval: running statistics. Train: the batch mean and the biased variance
    max(E[x^2] - E[x]^2, 0) normalise, and both move the running statistics in
    place (`torch.nn.BatchNorm1d` would store the unbiased variance)."""
    if not train:
        return F.batch_norm(x.reshape(-1, x.shape[-1]), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps).reshape(x.shape)
    rows = x.reshape(-1, x.shape[-1])
    mean = rows.mean(dim=0)
    var = torch.clamp((rows * rows).mean(dim=0) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class MLP(nn.Module):
    """Linear stack with BatchNorm (over the last axis) + ReLU between layers."""

    def __init__(self, in_dim, channels):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"dense_{i}", nn.Linear(in_dim, c))
            if i < self.n - 1:
                # holds scale, bias and the running statistics; `batch_norm`
                # does the arithmetic
                setattr(self, f"bn_{i}", nn.BatchNorm1d(c, eps=1e-5))
            in_dim = c

    def forward(self, x, train=False):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = F.relu(batch_norm(x, getattr(self, f"bn_{i}"), train))
        return x


class AttentionalLayer(nn.Module):
    """One GNN block: MHA message + residual MLP update."""

    def __init__(self, dim, num_heads, impl="xla", mode="full"):
        super().__init__()
        self.num_heads, self.impl, self.mode = num_heads, impl, mode
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)
        self.mlp = MLP(2 * dim, (2 * dim, dim))

    def forward(self, x, source, n_views, n_kpts, mask=None, train=False):
        """`n_views`, `n_kpts` describe the token structure for the kernels'
        in-kernel mask; `mask` is the plain path's (S, S) mask."""
        q, k, v = self.q_proj(x), self.k_proj(source), self.v_proj(source)
        if self.impl == "cuda":
            message = fused_view_attention(q, k, v, self.num_heads, n_views, n_kpts,
                                           self.mode)
        else:
            message = multi_head_attention(q, k, v, self.num_heads, mask=mask)
        message = self.merge(message)
        return x + self.mlp(torch.cat([x, message], dim=-1), train)


class MultiViewMatcher(nn.Module):
    """Joint matcher over V views with K keypoints each."""

    def __init__(self, config=MatcherConfig()):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "only float32 is ported (bfloat16 compute, kernels included, is "
                "its own item of the port)")
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
        if cfg.sinkhorn_impl not in SINKHORN_IMPLS:
            raise ValueError(f"sinkhorn_impl must be one of {SINKHORN_IMPLS}")
        self.config = cfg
        D = cfg.descriptor_dim
        self.kenc = MLP(3, tuple(cfg.keypoint_encoder) + (D,))
        for li, layer_type in enumerate(cfg.gnn_layers):
            if layer_type not in ("self", "cross"):
                raise ValueError(f"unknown GNN layer type {layer_type!r}")
            mode = "full" if layer_type == "self" else "cross"
            setattr(self, f"gnn_{li}_{layer_type}",
                    AttentionalLayer(D, cfg.num_heads, cfg.attention_impl, mode))
        self.final_proj = nn.Linear(D, D)
        self.bin_score = nn.Parameter(torch.ones(()))
        if cfg.conf_mlp:
            self.conf_mlp = MLP(2 * D + 1, tuple(cfg.conf_mlp_hidden) + (1,))

    def forward(self, kpts, scores, descs, image_size, train=False, full_output=True):
        """
        Args:
            kpts: (B, V, K, 2) pixel xy; scores: (B, V, K); descs: (B, V, K, D);
            image_size: (B, V, 2) as (H, W) per view.
            train: BatchNorm mode (batch statistics, running statistics moved).
            full_output: also compute matches and confidence scores.
        Returns:
            dict: "log_assignment" (B, P, K+1, K+1), "pairs" (P, 2) and, with
            full_output, "matches0"/"matches1" (B, P, K) int32 (-1 unmatched),
            "matching_scores0" (B, P, K) and "conf_scores" (B, P, K) (conf MLP).
        """
        cfg = self.config
        B, V, K, D = descs.shape
        size = image_size.to(kpts.dtype)
        center = torch.stack([size[..., 1], size[..., 0]], dim=-1)[:, :, None, :] / 2.0
        scaling = 0.7 * size.amax(dim=-1)[:, :, None, None]
        kpts_n = (kpts - center) / scaling
        x = descs + self.kenc(torch.cat([kpts_n, scores[..., None]], dim=-1), train)

        tokens = x.reshape(B, V * K, D)
        xmask = (cross_view_mask(V, K, device=descs.device)
                 if (V > 1 and cfg.attention_impl != "cuda") else None)
        for li, layer_type in enumerate(cfg.gnn_layers):
            layer = getattr(self, f"gnn_{li}_{layer_type}")
            if layer_type == "self":
                t = tokens.reshape(B * V, K, D)
                tokens = layer(t, t, 1, K, train=train).reshape(B, V * K, D)
            else:
                tokens = layer(tokens, tokens, V, K, mask=xmask, train=train)

        mdesc = self.final_proj(tokens).reshape(B, V, K, D)
        # pairs (i, j) ordered by j, then i: the lower triangle of (j, i), row-major
        idx_j, idx_i = torch.tril_indices(V, V, -1, device=descs.device)
        P = idx_i.shape[0]
        mdesc_i = mdesc[:, idx_i]  # (B, P, K, D)
        mdesc_j = mdesc[:, idx_j]
        pair_scores = torch.einsum("bpkd,bpld->bpkl", mdesc_i, mdesc_j) / (D ** 0.25)
        flat = pair_scores.reshape(B * P, K, K)
        if cfg.sinkhorn_impl == "cuda":
            log_p = log_optimal_transport_cuda(flat, self.bin_score, cfg.sinkhorn_iterations)
        else:
            log_p = log_optimal_transport(flat, self.bin_score, cfg.sinkhorn_iterations,
                                          impl=cfg.sinkhorn_impl)
        log_p = log_p.reshape(B, P, K + 1, K + 1)
        out = {"log_assignment": log_p,
               "pairs": torch.stack([idx_i, idx_j], dim=-1).to(torch.int32)}
        if not full_output:
            return out

        m0, m1, ms0 = extract_matches(log_p.reshape(B * P, K + 1, K + 1),
                                      cfg.match_threshold)
        out["matches0"] = m0.reshape(B, P, K)
        out["matches1"] = m1.reshape(B, P, K)
        out["matching_scores0"] = ms0.reshape(B, P, K)
        if cfg.conf_mlp:
            gather_idx = torch.clamp(out["matches0"], 0, K - 1).to(torch.int64)
            matched_j = torch.gather(mdesc_j, 2, gather_idx[..., None].expand(B, P, K, D))
            feats = torch.cat([mdesc_i, matched_j, out["matching_scores0"][..., None]],
                              dim=-1)
            out["conf_scores"] = torch.sigmoid(self.conf_mlp(feats, train))[..., 0]
        return out


def result_to_reference_keys(result, tuple_size):
    """Split stacked pair tensors into per-pair keys `scores_{i}_{j}`,
    `matches{i}_{i}_{j}`, `matches{j}_{i}_{j}`, `conf_scores_{i}_{j}`."""
    out = {}
    p = 0
    for j in range(tuple_size):
        for i in range(j):
            out[f"scores_{i}_{j}"] = result["log_assignment"][:, p]
            if "matches0" in result:
                out[f"matches{i}_{i}_{j}"] = result["matches0"][:, p]
                out[f"matches{j}_{i}_{j}"] = result["matches1"][:, p]
            if "conf_scores" in result:
                out[f"conf_scores_{i}_{j}"] = result["conf_scores"][:, p][..., None]
            p += 1
    return out
