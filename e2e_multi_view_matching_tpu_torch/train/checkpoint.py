"""Checkpoint save/load with the reference's file naming and grafting (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/train/checkpoint.py`:
- files `last_model.ckpt`, `{epoch:06d}_model.ckpt`, `best_model.ckpt`,
  pretrained `model.ckpt`; `model_id` None/'last'/'best'/int selects one;
- payload: epoch, model, optimizer, step, min_val_loss, pose_match_ratio;
- stage-1 -> stage-2 grafting: a checkpoint without `conf_mlp` weights loaded
  into a `conf_mlp` model keeps the fresh `conf_mlp` parameters and reports
  them as `missing`; an optimizer state of another parameter grouping is
  dropped and the fresh one kept.

The format is the port's own: `torch.save` of tensors and plain Python, read
back with `weights_only=True`. Checkpoints of the JAX package (flax msgpack) are
not read here; `models/convert.py` bridges the weights.
"""

import json
import os

import torch


def _ckpt_name(model_id, file_suffix="model"):
    if model_id is None:
        return f"{file_suffix}.ckpt"
    if isinstance(model_id, int):
        return f"{model_id:0>6}_{file_suffix}.ckpt"
    return f"{model_id}_{file_suffix}.ckpt"


def save_checkpoint(exp_dir, file_name, state, epoch, min_val_loss):
    """Write a TrainState (+ scalars) to `<exp_dir>/<file_name>` atomically."""
    payload = {
        "epoch": int(epoch),
        "model": state.matcher.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "min_val_loss": float(min_val_loss),
        "pose_match_ratio": float(state.pose_match_ratio),
    }
    path = os.path.join(exp_dir, file_name)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(exp_dir, state, model_id=None, file_suffix="model",
                    load_opt_state=True):
    """Load into an existing TrainState, non-strictly.

    Weights whose name and shape match are taken from the file; the others
    keep the state's values. Returns (state, epoch, min_val_loss, info) with
    info["missing"] (in the model, not in the file) and info["unexpected"].
    """
    path = os.path.join(exp_dir, _ckpt_name(model_id, file_suffix))
    device = next(state.matcher.parameters()).device
    raw = torch.load(path, map_location=device, weights_only=True)
    own = state.matcher.state_dict()
    loaded = raw.get("model", {})
    missing = [k for k in own if k not in loaded]
    unexpected = [k for k in loaded if k not in own]
    merged = {k: loaded[k] if (k in loaded and loaded[k].shape == v.shape) else v
              for k, v in own.items()}
    state.matcher.load_state_dict(merged)
    state.step = int(raw.get("step", 0))
    state.pose_match_ratio = float(raw.get("pose_match_ratio", 0.0))
    if load_opt_state:
        try:
            state.optimizer.load_state_dict(raw["optimizer"])
        except (KeyError, ValueError):
            # optimizer-group mismatch (stage-1 checkpoint into the stage-2
            # optimizer): keep the freshly initialized optimizer state
            pass
    return state, int(raw.get("epoch", 0)), float(raw.get("min_val_loss", 1e6)), {
        "missing": missing, "unexpected": unexpected}


def save_config(exp_dir, cfg_dict):
    """Persist the run config as cfg.json."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "cfg.json"), "w") as f:
        json.dump(cfg_dict, f, indent=4)


def load_config(exp_dir):
    with open(os.path.join(exp_dir, "cfg.json")) as f:
        return json.load(f)
