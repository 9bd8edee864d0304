"""Upstream checkpoint import: magicleap SuperPoint and SuperGlue-style matcher
state dicts -> state dicts of the port's modules.

Counterpart of `e2e_multi_view_matching_tpu/models/torch_import.py`, whose
import it gives exactly (through `models/convert.py`), with no flax step in
between. The upstream checkpoints are PyTorch state dicts: the reference's
`model.ckpt`, whose keys carry the DataParallel `module.` prefix, and the
magicleap `superpoint_v1.pth`. Layout conversions:
- SuperPoint `conv1a..convDb` are Conv2d like the port's: `net.<same name>`;
- Conv1d weights (out, in, 1) lose their last axis and become `Linear`
  weights (out, in);
- the upstream MLP is a `Sequential` of (Conv1d, BatchNorm1d, ReLU) triples
  with a bare last Conv1d: index 3*l is the port's `dense_l`, 3*l+1 its
  `bn_l` (weight, bias and running statistics);
- matcher keys follow the upstream module tree: `kenc.encoder.*`,
  `gnn.layers.{i}.attn.proj.{0,1,2}` (q, k, v), `.attn.merge`, `.mlp.*`,
  `final_proj`, `bin_score`, and the fork's `conf_mlp` head, mapped by
  position (Conv1d layers in order, each followed by a BatchNorm1d when its
  running statistics are there).

Heads: upstream views a (B, D, N) projection as (B, dim_head, heads, N), the
head the innermost channel factor, while the port splits channels into
contiguous heads as the JAX package does. Attention is invariant under one
channel permutation applied to the q/k/v outputs and the merge input, so the
port's channel (head * dim_head + d) takes upstream channel
(d * heads + head).

Both functions take a mapping of name -> tensor or array (for example
`torch.load(path, weights_only=True)`) and return a state dict that the
port's `SuperPoint` / `MultiViewMatcher` load with `strict=True`.
"""

import re

import numpy as np
import torch

SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                    "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


def _tensor(value):
    return torch.as_tensor(np.array(value.detach().cpu() if torch.is_tensor(value) else value))


def strip_module_prefix(state_dict):
    """Drop the DataParallel 'module.' prefix."""
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


def import_superpoint(state_dict):
    """Upstream magicleap SuperPoint state dict -> the port's `SuperPoint`."""
    sd = strip_module_prefix(state_dict)
    out = {}
    for name in SUPERPOINT_CONVS:
        out[f"net.{name}.weight"] = _tensor(sd[f"{name}.weight"])
        out[f"net.{name}.bias"] = _tensor(sd[f"{name}.bias"])
    return out


def _linear(sd, src, dst, out, rows=None, cols=None):
    """Conv1d `src` (out, in, 1) -> Linear `dst` (out, in); `rows` permutes
    the output channels (and the bias), `cols` the input channels."""
    w = _tensor(sd[f"{src}.weight"])[..., 0]
    b = _tensor(sd[f"{src}.bias"])
    if rows is not None:
        w, b = w[rows], b[rows]
    if cols is not None:
        w = w[:, cols]
    out[f"{dst}.weight"] = w.contiguous()
    out[f"{dst}.bias"] = b


def _batch_norm(sd, src, dst, out):
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])
    tracked = sd.get(f"{src}.num_batches_tracked")
    out[f"{dst}.num_batches_tracked"] = (
        torch.zeros((), dtype=torch.int64) if tracked is None
        else _tensor(tracked).to(torch.int64))


def _mlp(sd, src, dst, seq_indices, out):
    """Upstream (Conv1d, BatchNorm1d, ReLU) stack at the `Sequential`
    indices `seq_indices` of its Conv1d layers -> the port's `MLP`."""
    for li, ci in enumerate(seq_indices):
        _linear(sd, f"{src}.{ci}", f"{dst}.dense_{li}", out)
        if f"{src}.{ci + 1}.running_mean" in sd:  # BN follows all but the last
            _batch_norm(sd, f"{src}.{ci + 1}", f"{dst}.bn_{li}", out)


def import_matcher(state_dict, gnn_layers, num_heads=4):
    """Upstream matcher state dict -> the port's `MultiViewMatcher`.

    Args:
        state_dict: name -> tensor or array.
        gnn_layers: the layer-type schedule (('self', 'cross', ...)).
        num_heads: attention heads of the checkpoint (upstream: 4).
    """
    sd = strip_module_prefix(state_dict)
    out = {}
    _mlp(sd, "kenc.encoder", "kenc", range(0, 15, 3), out)

    D = sd["final_proj.weight"].shape[0]
    perm = torch.from_numpy(np.arange(D).reshape(D // num_heads, num_heads).T.ravel())
    for li, layer_type in enumerate(gnn_layers):
        src, dst = f"gnn.layers.{li}", f"gnn_{li}_{layer_type}"
        for name, j in (("q_proj", 0), ("k_proj", 1), ("v_proj", 2)):
            _linear(sd, f"{src}.attn.proj.{j}", f"{dst}.{name}", out, rows=perm)
        _linear(sd, f"{src}.attn.merge", f"{dst}.merge", out, cols=perm)
        _mlp(sd, f"{src}.mlp", f"{dst}.mlp", (0, 3), out)
    _linear(sd, "final_proj", "final_proj", out)
    out["bin_score"] = _tensor(sd["bin_score"]).reshape(())

    conf_keys = [k for k in sd if k.startswith("conf_mlp.")]
    if conf_keys:
        indices = sorted({int(k.split(".")[1]) for k in conf_keys
                          if k.split(".")[1].isdigit()})
        convs = [i for i in indices if f"conf_mlp.{i}.weight" in sd
                 and len(sd[f"conf_mlp.{i}.weight"].shape) == 3]
        _mlp(sd, "conf_mlp", "conf_mlp", convs, out)
    return out
