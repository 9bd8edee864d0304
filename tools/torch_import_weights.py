"""Import upstream PyTorch checkpoints into an experiment directory of the port.

Reads the upstream checkpoint files -- `superpoint_v1.pth` (magicleap) and the
reference's matcher `model.ckpt` (from `pretrained_network_weights.zip`) --
with `torch.load(..., weights_only=True)`, maps their layouts with
`e2e_multi_view_matching_tpu_torch/models/torch_import.py`, and writes:

    <out_dir>/superpoint.ckpt   state dict of the port's `SuperPoint`
    <out_dir>/model.ckpt        matcher checkpoint (`train/checkpoint.py`)
    <out_dir>/cfg.json          config stub (kept if the directory has one)

which the port's eval command lines read:

    python tools/torch_import_weights.py --superpoint superpoint_v1.pth \\
        --matcher model.ckpt --out_dir <ckpt_dir>/<exp> \\
        [--gnn_layers 7 --cross_attention_layers 3 --tuple_size 5]
    python -m e2e_multi_view_matching_tpu_torch.cli.eval_pairs --exp_name <exp> ...

`--weights_zip pretrained_network_weights.zip` finds both members inside the
bundle (the nested checkpoint zips are read from memory). The flags are those
of `tools/import_weights.py`, the JAX package's tool, whose files these equal
after `models/convert.py`.
"""

import argparse
import io
import json
import os
import sys
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--superpoint", type=str, default=None,
                   help="torch SuperPoint state-dict file (superpoint_v1.pth)")
    p.add_argument("--matcher", type=str, default=None,
                   help="torch matcher checkpoint (model.ckpt / *_model.ckpt)")
    p.add_argument("--weights_zip", type=str, default=None,
                   help="pretrained_network_weights.zip: find both members inside "
                        "(overrides --superpoint/--matcher when they are found)")
    p.add_argument("--out_dir", type=str, required=True,
                   help="experiment directory to write "
                        "superpoint.ckpt/model.ckpt/cfg.json into")
    p.add_argument("--gnn_layers", type=int, default=9,
                   help="GNN depth of the matcher checkpoint (two-view eval "
                        "checkpoints: 9; 5-tuple scannet/matterport: 7)")
    p.add_argument("--cross_attention_layers", type=int, default=1,
                   help="cross layers per block (two-view: 1; 5-tuple: 3)")
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--tuple_size", type=int, default=2)
    return p.parse_args(argv)


def _discover_zip_members(zip_path):
    """(superpoint file, matcher file, their member names) inside a weights
    bundle zip; the files are in-memory copies of the members."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        sp, m = None, None
        for name in zf.namelist():
            base = os.path.basename(name).lower()
            if not base or name.endswith("/"):
                continue
            if "superpoint" in base:
                sp = name
            elif base.endswith((".ckpt", ".pth", ".pt")):
                m = name
        files = [io.BytesIO(zf.read(member)) if member else None for member in (sp, m)]
    return files[0], files[1], (sp, m)


def _load_state_dict(src):
    """A flat name -> tensor state dict from a bare state-dict file or from a
    training checkpoint {epoch, model, optimizer, ...}."""
    import torch

    obj = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if not isinstance(obj, dict) or not all(torch.is_tensor(v) for v in obj.values()):
        raise ValueError("checkpoint does not contain a flat tensor state dict")
    return obj


def main(argv=None):
    opt = parse_args(argv)
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
    from e2e_multi_view_matching_tpu_torch.models.torch_import import (
        import_matcher,
        import_superpoint,
    )
    from e2e_multi_view_matching_tpu_torch.train.checkpoint import save_checkpoint
    from e2e_multi_view_matching_tpu_torch.train.step import TrainState

    sp_src, m_src = opt.superpoint, opt.matcher
    if opt.weights_zip:
        sp_z, m_z, names = _discover_zip_members(opt.weights_zip)
        print(f"weights zip members: superpoint={names[0]} matcher={names[1]}")
        sp_src = sp_z or sp_src
        m_src = m_z or m_src
    if sp_src is None and m_src is None:
        raise SystemExit("nothing to import: pass --superpoint/--matcher or --weights_zip")

    os.makedirs(opt.out_dir, exist_ok=True)
    written = {}

    if sp_src is not None:
        sd = _load_state_dict(sp_src)
        superpoint = SuperPoint(SuperPointConfig())
        superpoint.load_state_dict(import_superpoint(sd))  # strict: every weight mapped
        path = os.path.join(opt.out_dir, "superpoint.ckpt")
        torch.save(superpoint.state_dict(), path)
        written["superpoint.ckpt"] = sorted(sd)[:3]
        print(f"superpoint: {len(sd)} tensors -> {path}")

    if m_src is not None:
        sd = _load_state_dict(m_src)
        schedule = default_gnn_layers(opt.gnn_layers, opt.cross_attention_layers)
        state_dict = import_matcher(sd, schedule, num_heads=opt.num_heads)
        matcher = MultiViewMatcher(MatcherConfig(
            descriptor_dim=state_dict["final_proj.weight"].shape[0], gnn_layers=schedule,
            num_heads=opt.num_heads, conf_mlp=any(k.startswith("conf_mlp.") for k in state_dict),
            multi_frame_matching=opt.tuple_size > 2))
        matcher.load_state_dict(state_dict)  # strict: every weight mapped
        path = save_checkpoint(opt.out_dir, "model.ckpt", TrainState(matcher, optimizer=None),
                               epoch=0, min_val_loss=float("inf"))
        written["model.ckpt"] = sorted(sd)[:3]
        print(f"matcher: {len(sd)} tensors -> {path}")

        cfg_path = os.path.join(opt.out_dir, "cfg.json")
        if not os.path.exists(cfg_path):
            with open(cfg_path, "w") as f:
                json.dump({
                    "gnn_layers": opt.gnn_layers,
                    "cross_attention_layers": opt.cross_attention_layers,
                    "tuple_size": opt.tuple_size,
                    "imported_from_torch": True,
                }, f, indent=2)

    return written


if __name__ == "__main__":
    main()
