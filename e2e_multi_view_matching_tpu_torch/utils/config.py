"""Argparse flags, kernel selection and the device rule of the port.

Counterpart of `e2e_multi_view_matching_tpu/utils/config.py`. Kernel switches keep the JAX semantics with "cuda" in place
of "pallas": "auto" resolves to the hand-written CUDA kernels when the run is
on a GPU, and otherwise to what JAX's CPU "auto" gives ("xla", the plain
versions).
"""

import os

import numpy as np
import torch


def add_generic_arguments(parser):
    parser.add_argument("--data_dir", type=str, default=None,
                        help="path to directory containing dataset")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="path to directory containing checkpoints")
    parser.add_argument("--dataset", type=str, default="scannet", help="dataset")
    parser.add_argument("--tuple_size", type=int, default=5,
                        help="number of images to be matched")
    parser.add_argument("--attention_impl", type=str, default="auto",
                        choices=["auto", "xla", "cuda"],
                        help="matcher attention: cuda = hand-written fused masked "
                             "kernels, xla = plain PyTorch")
    parser.add_argument("--sinkhorn_impl", type=str, default="auto",
                        choices=["auto", "xla", "mxu", "cuda"],
                        help="Sinkhorn: cuda = hand-written kernels (scaling domain "
                             "without grad, log domain with stash + reverse sweep under "
                             "grad), xla = plain log domain, mxu = plain scaling domain")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32"],
                        help="matmul compute dtype (bfloat16 compute is not ported yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU runs only when asked for")
    return parser


def resolve_device(device="cuda"):
    """torch.device for `device`; raises instead of falling back to the CPU
    when a GPU is asked for and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and none is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def resolve_kernel_impls(opt, device):
    """Resolve "auto" kernel selections: cuda on a GPU, xla elsewhere."""
    on_gpu = torch.device(device).type == "cuda"
    if getattr(opt, "attention_impl", "auto") == "auto":
        opt.attention_impl = "cuda" if on_gpu else "xla"
    if getattr(opt, "sinkhorn_impl", "auto") == "auto":
        opt.sinkhorn_impl = "cuda" if on_gpu else "xla"
    return opt


def strict_float32(opt):
    """f32 means f32: unless `opt.compute_dtype` asks for another type, turn
    off TF32, in which cuDNN runs float32 convolutions by default on Ampere
    and later (~3 decimal digits); the reference semantics are full float32
    for SuperPoint and the matcher."""
    if getattr(opt, "compute_dtype", "float32") == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def to_device(arr, device):
    """float32 numpy array -> tensor on `device`; through pinned memory on a
    GPU, so that the copy is asynchronous and waits for no queued work."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_to_grid(items, eval_batch):
    """`items` (a chunk of samples) padded with its last one up to a full grid
    of S sub-chunks of `eval_batch`, so that every sub-chunk has one shape;
    the padding is sliced off after the fetch. Returns (padded, S)."""
    S = -(-len(items) // eval_batch)
    return items + [items[-1]] * (S * eval_batch - len(items)), S


def fetch_packed(tensors):
    """Device tensors -> numpy arrays of the same shapes through ONE
    device-to-host copy (a chunk's only sync): flattened to float32 and
    concatenated on the device, copied, split on the host. Integer tensors
    must be exact in float32 (|x| < 2**24); they come back as float32."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(tuple(t.shape)))
        lo += t.numel()
    return out


def get_exp_dir(checkpoint_dir, exp_name):
    exp_dir = os.path.join(checkpoint_dir, exp_name)
    return exp_dir, os.path.join(exp_dir, "cfg.json")


def apply_dataset_defaults(opt, device):
    """Dataset-conditional hyperparameters, mutated onto opt."""
    resolve_kernel_impls(opt, device)
    ds = opt.dataset
    if "scannet" in ds:
        opt.remove_borders = 12
        opt.max_keypoints = 400
        opt.nms_radius = 4
        opt.keypoint_threshold = 0.001
        opt.n_samples = 200
        opt.match_reproj_err = 5.0
        opt.unmatch_reproj_err = 15.0
        opt.start_decay = 1e5
        opt.end_decay = 9e5
        opt.color_jitter = 0.2
    elif "matterport" in ds:
        opt.remove_borders = 4
        opt.max_keypoints = 400
        opt.nms_radius = 4
        opt.keypoint_threshold = 0.001
        opt.n_samples = None  # adapt to scene size
        opt.match_reproj_err = 5.0
        opt.unmatch_reproj_err = 15.0
        opt.start_decay = 1e5
        opt.end_decay = 9e5
        opt.color_jitter = 0.2
    elif "megadepth" in ds:
        opt.remove_borders = 0
        opt.max_keypoints = 1024
        opt.nms_radius = 3
        opt.keypoint_threshold = 0.005
        opt.n_samples = 100 if opt.tuple_size > 2 else 200
        opt.match_reproj_err = 5.0
        opt.unmatch_reproj_err = 10.0
        opt.start_decay = 5e4
        opt.end_decay = 9e5
        opt.color_jitter = None
    else:
        raise ValueError(f"Dataset {ds} is not supported.")

    # pose-loss weights per dataset + tuple size
    pose_weights = {
        ("scannet", 2): (1597.0, 270.0),
        ("scannet", 5): (726.0, 244.0),
        ("matterport", 2): (717.0, 591.0),
        ("matterport", 5): (240.0, 263.0),
        ("megadepth", 2): (710.0, 348.0),
        ("megadepth", 5): (661.0, 366.0),
    }
    if getattr(opt, "pose_loss", False):
        base = next(k for k in ("scannet", "matterport", "megadepth") if k in ds)
        key = (base, opt.tuple_size)
        if key not in pose_weights:
            raise ValueError(
                f"Specify rot/trans loss weights for tuple size {opt.tuple_size}"
            )
        opt.rot_weight, opt.trans_weight = pose_weights[key]
        opt.grad_clip = 0.1
    else:
        opt.rot_weight = 0.0
        opt.trans_weight = 0.0
        opt.grad_clip = -1.0

    # GNN depth schedule
    if opt.tuple_size > 2 and ("scannet" in ds or "matterport" in ds):
        opt.gnn_layers = 7
        opt.cross_attention_layers = 3
    else:
        opt.gnn_layers = 9
        opt.cross_attention_layers = 1
    return opt
