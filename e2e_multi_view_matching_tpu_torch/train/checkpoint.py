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
import logging
import os

import torch

log = logging.getLogger("checkpoint")


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


def load_eval_weights(exp_dir, superpoint, matcher, allow_random_superpoint=False, seed=0):
    """The weights of an evaluation run, for both eval command lines.

    The matcher reads `<exp_dir>/model.ckpt` non-strictly: weights the file
    lacks (a stage-1 run has no conf MLP) keep a seeded draw as flax draws
    them. SuperPoint reads `<exp_dir>/superpoint.ckpt`, a state dict of the
    port's `SuperPoint` (e.g. from `models/torch_import.py`); without it a
    benchmark would run a random detector, so it raises FileNotFoundError
    unless `allow_random_superpoint`, which keeps seeded random weights.
    Returns the names model.ckpt lacks.
    """
    from e2e_multi_view_matching_tpu_torch.models.convert import init_like_flax_
    from e2e_multi_view_matching_tpu_torch.train.step import TrainState

    g = torch.Generator().manual_seed(seed)
    init_like_flax_(matcher, g)
    _, _, _, info = load_checkpoint(exp_dir, TrainState(matcher, optimizer=None),
                                    model_id=None, load_opt_state=False)
    if info["missing"]:
        log.warning("model.ckpt lacks %s: seeded random values", info["missing"])
    sp_path = os.path.join(exp_dir, "superpoint.ckpt")
    if os.path.exists(sp_path):
        superpoint.load_state_dict(torch.load(sp_path, map_location="cpu", weights_only=True))
    elif not allow_random_superpoint:
        raise FileNotFoundError(
            f"SuperPoint weights not found: {sp_path}. A benchmark run with "
            "random detector weights is meaningless; import pretrained weights "
            "(models/torch_import.py) or pass --allow_random_superpoint.")
    else:
        log.warning("superpoint.ckpt absent; using RANDOM SuperPoint weights")
        init_like_flax_(superpoint, g)
    return info["missing"]


def save_config(exp_dir, cfg_dict):
    """Persist the run config as cfg.json."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "cfg.json"), "w") as f:
        json.dump(cfg_dict, f, indent=4)


def load_config(exp_dir):
    with open(os.path.join(exp_dir, "cfg.json")) as f:
        return json.load(f)
