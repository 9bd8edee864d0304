"""The general generator of the benchmark's inputs, made on the device from
the seed. A traffic file (`traffic/<name>.json`) names its `kind` and gives
the parameters; the same seed gives the same inputs.

- `eval_tuples`: tuples of V textured images (a sum of random plane waves
  plus pixel noise, scaled to [0, 1]), pinhole intrinsics with a focal length
  drawn per view, and cam->world poses (small random rotations, random
  translations), held on the host as the eval loop reads samples.
- `plane_scenes`: training batches of tilted textured planes seen by V
  cameras, with the exact depth of every pixel (the port's
  `data/synthetic.py::PlaneScene` and `fourier_texture_image`, batched on
  the device): images (B, V, H, W, 1), intr (B, V, 3, 3), poses (B, V, 4, 4)
  cam->world and depths (B, V, H, W).
"""

import math

import torch


def _axis_angle(w):
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
    k = w / theta
    zero = torch.zeros_like(k[..., 0])
    K = torch.stack([torch.stack([zero, -k[..., 2], k[..., 1]], -1),
                     torch.stack([k[..., 2], zero, -k[..., 0]], -1),
                     torch.stack([-k[..., 1], k[..., 0], zero], -1)], -2)
    eye = torch.eye(3, device=w.device, dtype=w.dtype).expand(K.shape)
    s = torch.sin(theta)[..., None]
    c = (1 - torch.cos(theta))[..., None]
    return eye + s * K + c * (K @ K)


def _intrinsics(f, H, W):
    """(..., 3, 3) pinhole intrinsics of focal lengths `f` (...), centred."""
    intr = torch.zeros(f.shape + (3, 3), device=f.device)
    intr[..., 0, 0] = f
    intr[..., 1, 1] = f
    intr[..., 0, 2] = W / 2.0
    intr[..., 1, 2] = H / 2.0
    intr[..., 2, 2] = 1.0
    return intr


def eval_tuples(p, n, generator, device, block=8):
    """`n` samples {"images" (V, H, W, 1), "intr" (V, 3, 3), "poses"
    (V, 4, 4)} of float32 numpy arrays, made on `device` `block` tuples at
    a time; `p` holds views, height, width, waves, wave_scale, noise,
    focal (low, high), rot_sigma, trans_sigma."""
    V, H, W = p["views"], p["height"], p["width"]
    g = generator
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    samples = []
    for lo in range(0, n, block):
        b = min(block, n - lo)
        k = torch.randn((b, V, p["waves"], 2), generator=g, device=device) * p["wave_scale"]
        phase = torch.rand((b, V, p["waves"]), generator=g, device=device) * (2 * math.pi)
        img = torch.zeros((b, V, H, W), device=device)
        for i in range(p["waves"]):
            img += torch.sin(k[:, :, i, 0, None, None] * xs + k[:, :, i, 1, None, None] * ys
                             + phase[:, :, i, None, None])
        img += torch.randn((b, V, H, W), generator=g, device=device) * p["noise"]
        lo_v = img.amin(dim=(2, 3), keepdim=True)
        hi_v = img.amax(dim=(2, 3), keepdim=True)
        img = (img - lo_v) / (hi_v - lo_v)
        f_lo, f_hi = p["focal"]
        f = f_lo + (f_hi - f_lo) * torch.rand((b, V), generator=g, device=device)
        poses = torch.eye(4, device=device).repeat(b, V, 1, 1)
        poses[..., :3, :3] = _axis_angle(
            torch.randn((b, V, 3), generator=g, device=device) * p["rot_sigma"])
        poses[..., :3, 3] = torch.randn((b, V, 3), generator=g, device=device) * p["trans_sigma"]
        images = img[..., None].cpu().numpy()
        intr = _intrinsics(f, H, W).cpu().numpy()
        poses = poses.cpu().numpy()
        samples += [{"images": images[i], "intr": intr[i], "poses": poses[i]} for i in range(b)]
    return samples


def plane_scenes(p, batch, generator, device):
    """One training batch of `batch` plane scenes (dict of device tensors);
    `p` holds views, height, width, focal, plane_z, tilt, baseline,
    rot_jitter, waves, wave_freq (low, high), wave_amp (low, high)."""
    B, V, H, W = batch, p["views"], p["height"], p["width"]
    g = generator
    normal = torch.cat([p["tilt"] * torch.randn((B, 2), generator=g, device=device),
                        torch.ones((B, 1), device=device)], dim=1)
    normal = normal / torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    plane_c = normal[:, 2] * p["plane_z"]
    R = _axis_angle(torch.randn((B, V, 3), generator=g, device=device) * p["rot_jitter"])
    t = (torch.randn((B, V, 3), generator=g, device=device) * p["baseline"]
         * torch.tensor([1.0, 1.0, 0.3], device=device))
    poses = torch.eye(4, device=device).repeat(B, V, 1, 1)
    poses[..., :3, :3] = R
    poses[..., :3, 3] = t
    f = torch.full((B, V), float(p["focal"]), device=device)
    intr = _intrinsics(f, H, W)
    n_w = p["waves"]
    f_lo, f_hi = p["wave_freq"]
    a_lo, a_hi = p["wave_amp"]
    ks = (torch.randn((B, n_w, 3), generator=g, device=device)
          * (f_lo + (f_hi - f_lo) * torch.rand((B, n_w, 1), generator=g, device=device)))
    phis = torch.rand((B, n_w), generator=g, device=device) * (2 * math.pi)
    amps = a_lo + (a_hi - a_lo) * torch.rand((B, n_w), generator=g, device=device)

    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # (HW, 3)
    rays_cam = pix @ torch.linalg.inv(intr).transpose(-1, -2)  # (B, V, HW, 3)
    rays_w = rays_cam @ R.transpose(-1, -2)
    denom = rays_w @ normal[:, None, :, None]  # (B, V, HW, 1)
    num = (plane_c[:, None] - (t * normal[:, None]).sum(-1))[..., None, None]
    hit = denom.abs() > 1e-9
    depth = torch.where(hit, num / torch.where(hit, denom, torch.ones_like(denom)), 0.0)
    Xw = rays_w * depth + t[:, :, None, :]  # (B, V, HW, 3)
    images = torch.empty((B, V, H * W), device=device)
    for b in range(B):  # the waves of one scene at a time: (V, HW, waves)
        val = (torch.sin(Xw[b] @ ks[b].T + phis[b]) * amps[b]).sum(-1)
        lo_v = val.amin(dim=1, keepdim=True)
        hi_v = val.amax(dim=1, keepdim=True)
        images[b] = 0.1 + 0.8 * (val - lo_v) / (hi_v - lo_v).clamp_min(1e-6)
    return {"images": images.reshape(B, V, H, W, 1), "intr": intr, "poses": poses,
            "depths": depth.reshape(B, V, H, W).clamp_min(0.0)}
