"""The multi-view matcher in plain float32 PyTorch: the benchmark's reference.

A frozen copy of the float32 plain path of the port's `models/matcher.py`
(the layer names are the port's, so one state dict loads into both): the
keypoint encoder, self layers within a view and cross layers over every other
view as masked multi-head attention written out in `einsum`s, the pair scores
of all C(V, 2) view pairs, the dustbin Sinkhorn (`reference/sinkhorn.py`),
mutual-best matches and the confidence head. BatchNorm in training mode
normalises with the batch statistics (float64 sums) and moves the running
statistics, as the port's does.

The attention runs `attn_rows` batch entries at a time, so that a cross
layer's (h, V K, V K) scores fit beside the rest at the eval shapes.
"""

import math
from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import sinkhorn

BN_MOMENTUM = 0.9
_NEG_INF = -1e9


def default_gnn_layers(gnn_layers=9, cross_attention_layers=1):
    return tuple((["self"] + ["cross"] * cross_attention_layers) * gnn_layers)


@dataclass(frozen=True)
class MatcherConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128, 256)
    gnn_layers: Tuple[str, ...] = field(default_factory=default_gnn_layers)
    num_heads: int = 4
    sinkhorn_iterations: int = 100
    # "log": the log-domain iteration (training); "scaling": the stabilised
    # scaling-domain iteration (eval)
    sinkhorn: str = "log"
    match_threshold: float = 0.2
    conf_mlp: bool = False
    conf_mlp_hidden: Tuple[int, ...] = (256, 64)
    attn_rows: int = 1


def batch_norm(x, bn, train):
    if not train:
        return F.batch_norm(x.reshape(-1, x.shape[-1]), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps).reshape(x.shape)
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    mean = (rows.sum(dim=0, dtype=torch.float64) / n).to(rows.dtype)
    mean_sq = ((rows * rows).sum(dim=0, dtype=torch.float64) / n).to(rows.dtype)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class MLP(nn.Module):
    def __init__(self, in_dim, channels):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"dense_{i}", nn.Linear(in_dim, c))
            if i < self.n - 1:
                setattr(self, f"bn_{i}", nn.BatchNorm1d(c, eps=1e-5))
            in_dim = c

    def forward(self, x, train=False):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = F.relu(batch_norm(x, getattr(self, f"bn_{i}"), train))
        return x


def attention(q, k, v, num_heads, mask, rows):
    """Masked multi-head attention, heads split contiguously; -1e9 fills the
    masked logits and the denominator carries +1e-9 (the port's constants).
    q: (B, Q, D); k, v: (B, S, D); mask: (Q, S) bool or None."""
    B, Q, D = q.shape
    S = k.shape[1]
    h, dh = num_heads, D // num_heads
    outs = []
    for lo in range(0, B, rows):
        qh = q[lo:lo + rows].reshape(-1, Q, h, dh)
        kh = k[lo:lo + rows].reshape(-1, S, h, dh)
        vh = v[lo:lo + rows].reshape(-1, S, h, dh)
        logits = torch.einsum("bqhd,bshd->bhqs", qh, kh) / math.sqrt(dh)
        if mask is not None:
            logits = logits.masked_fill(~mask[None, None], _NEG_INF)
        attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-9)
        outs.append(torch.einsum("bhqs,bshd->bqhd", attn, vh).reshape(-1, Q, D))
    return torch.cat(outs)


class AttentionalLayer(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)
        self.mlp = MLP(2 * dim, (2 * dim, dim))

    def forward(self, x, mask, rows, train=False):
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if train and torch.is_grad_enabled():  # recomputed in the backward
            message = checkpoint(attention, q, k, v, self.num_heads, mask, rows,
                                 use_reentrant=False)
        else:
            message = attention(q, k, v, self.num_heads, mask, rows)
        message = self.merge(message)
        return x + self.mlp(torch.cat([x, message], dim=-1), train)


def extract_matches(log_p, match_threshold):
    """Mutual-max matches of (B, M+1, N+1) log assignments: (matches0 (B, M)
    int32, -1 unmatched; matches1 (B, N); their scores (B, M))."""
    core = log_p[:, :-1, :-1]
    M, N = core.shape[1], core.shape[2]
    idx0, max0 = core.argmax(dim=2), core.amax(dim=2)
    idx1, max1 = core.argmax(dim=1), core.amax(dim=1)
    mutual0 = torch.gather(idx1, 1, idx0) == torch.arange(M, device=core.device)[None]
    mutual1 = torch.gather(idx0, 1, idx1) == torch.arange(N, device=core.device)[None]
    scores0 = torch.exp(max0)
    valid0 = mutual0 & (scores0 > match_threshold)
    valid1 = mutual1 & (torch.exp(max1) > match_threshold)
    matches0 = torch.where(valid0, idx0, -1).to(torch.int32)
    matches1 = torch.where(valid1, idx1, -1).to(torch.int32)
    return matches0, matches1, torch.where(valid0, scores0, 0.0)


class MultiViewMatcher(nn.Module):
    """Joint matcher over V views with K keypoints each (float32)."""

    def __init__(self, config=MatcherConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        D = cfg.descriptor_dim
        self.kenc = MLP(3, tuple(cfg.keypoint_encoder) + (D,))
        for li, layer_type in enumerate(cfg.gnn_layers):
            setattr(self, f"gnn_{li}_{layer_type}", AttentionalLayer(D, cfg.num_heads))
        self.final_proj = nn.Linear(D, D)
        self.bin_score = nn.Parameter(torch.ones(()))
        if cfg.conf_mlp:
            self.conf_mlp = MLP(2 * D + 1, tuple(cfg.conf_mlp_hidden) + (1,))

    def descriptors(self, kpts, scores, descs, image_size, train=False):
        """kpts (B, V, K, 2) xy, scores (B, V, K), descs (B, V, K, D),
        image_size (H, W) -> the projected descriptors (B, V, K, D) that the
        pair scores are taken from."""
        cfg = self.config
        B, V, K, D = descs.shape
        H, W = image_size
        center = torch.tensor([W / 2.0, H / 2.0], dtype=kpts.dtype, device=kpts.device)
        kpts_n = (kpts - center) / (0.7 * max(H, W))
        x = descs + self.kenc(torch.cat([kpts_n, scores[..., None]], dim=-1), train)
        tokens = x.reshape(B, V * K, D)
        vid = torch.arange(V, device=descs.device).repeat_interleave(K)
        xmask = vid[:, None] != vid[None, :]
        rows = cfg.attn_rows
        for li, layer_type in enumerate(cfg.gnn_layers):
            layer = getattr(self, f"gnn_{li}_{layer_type}")
            if layer_type == "self":
                t = tokens.reshape(B * V, K, D)
                tokens = layer(t, None, rows * V, train).reshape(B, V * K, D)
            else:
                tokens = layer(tokens, xmask, rows, train)
        return self.final_proj(tokens).reshape(B, V, K, D)

    def assignment(self, mdesc, pair_rows=None):
        """(B, V, K, D) projected descriptors -> the (B, P, K+1, K+1) log
        assignment of every view pair: the pair scores and the dustbin
        Sinkhorn, `pair_rows` batch entries at a time (all by default)."""
        cfg = self.config
        B, V, K, D = mdesc.shape
        idx_j, idx_i = torch.tril_indices(V, V, -1, device=mdesc.device)
        P = idx_i.shape[0]
        outs = []
        for lo in range(0, B, pair_rows or B):
            m = mdesc[lo:lo + (pair_rows or B)]
            pair_scores = torch.einsum("bpkd,bpld->bpkl", m[:, idx_i], m[:, idx_j]) / (D ** 0.25)
            outs.append(sinkhorn.log_optimal_transport(
                pair_scores.reshape(-1, K, K), self.bin_score, cfg.sinkhorn_iterations,
                cfg.sinkhorn).reshape(-1, P, K + 1, K + 1))
        return torch.cat(outs)

    def confidence(self, mdesc, matches0, matching_scores0, train=False):
        """The confidence head's (B, P, K) confidences of the matches
        `matches0` (B, P, K) with their scores, from (B, V, K, D) projected
        descriptors."""
        V, K, D = mdesc.shape[1:]
        B, P = matches0.shape[:2]
        idx_j, idx_i = torch.tril_indices(V, V, -1, device=mdesc.device)
        gather_idx = torch.clamp(matches0, 0, K - 1).to(torch.int64)
        matched_j = torch.gather(mdesc[:, idx_j], 2, gather_idx[..., None].expand(B, P, K, D))
        feats = torch.cat([mdesc[:, idx_i], matched_j, matching_scores0[..., None]], dim=-1)
        return torch.sigmoid(self.conf_mlp(feats, train))[..., 0]

    def forward(self, kpts, scores, descs, image_size, train=False, full_output=True):
        """kpts (B, V, K, 2) xy, scores (B, V, K), descs (B, V, K, D),
        image_size (H, W). Returns "log_assignment" (B, P, K+1, K+1) and, with
        `full_output`, "matches0" (B, P, K), "matching_scores0" and (with the
        confidence head) "conf_scores"."""
        cfg = self.config
        mdesc = self.descriptors(kpts, scores, descs, image_size, train)
        log_p = self.assignment(mdesc)
        out = {"log_assignment": log_p}
        if not full_output:
            return out
        B, P, K = log_p.shape[0], log_p.shape[1], log_p.shape[2] - 1
        m0, _, ms0 = extract_matches(log_p.reshape(B * P, K + 1, K + 1), cfg.match_threshold)
        out["matches0"] = m0.reshape(B, P, K)
        out["matching_scores0"] = ms0.reshape(B, P, K)
        if cfg.conf_mlp:
            out["conf_scores"] = self.confidence(mdesc, out["matches0"], out["matching_scores0"],
                                                 train)
        return out
