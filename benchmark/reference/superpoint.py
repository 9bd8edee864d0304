"""SuperPoint in plain float32 PyTorch: the benchmark's reference detector.

A frozen copy of the float32, exact-size path of the port's
`models/superpoint.py` (the layer names are the port's, so one state dict
loads into both). Besides the full forward (keypoints, scores, descriptors)
it exposes `detection_map`, the score map before and after NMS (the top-K
is taken from the latter) and the descriptor maps, and
`sample_descriptors`, so that a judge can read the reference's score and
descriptor at any keypoint the program returns.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SuperPointConfig:
    nms_radius: int = 4
    keypoint_threshold: float = 0.001
    max_keypoints: int = 400
    remove_borders: int = 4
    fill_with_random_keypoints: bool = False
    descriptor_dim: int = 256


class SuperPointNet(nn.Module):
    """image (B, H, W, 1) -> (heat (B, Hc, Wc, 65), unit descriptors (B, Hc, Wc, D))."""

    def __init__(self, descriptor_dim=256):
        super().__init__()
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256

        def conv3(i, o):
            return nn.Conv2d(i, o, 3, padding=1)

        self.conv1a = conv3(1, c1)
        self.conv1b = conv3(c1, c1)
        self.conv2a = conv3(c1, c2)
        self.conv2b = conv3(c2, c2)
        self.conv3a = conv3(c2, c3)
        self.conv3b = conv3(c3, c3)
        self.conv4a = conv3(c3, c4)
        self.conv4b = conv3(c4, c4)
        self.convPa = conv3(c4, c5)
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.convDa = conv3(c4, c5)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        x = F.relu(self.conv1a(x))
        x = F.relu(self.conv1b(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv2a(x))
        x = F.relu(self.conv2b(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv3a(x))
        x = F.relu(self.conv3b(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))
        heat = self.convPb(F.relu(self.convPa(x))).permute(0, 2, 3, 1)
        desc = self.convDb(F.relu(self.convDa(x))).permute(0, 2, 3, 1)
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        return heat, desc


def _maxpool_sep(x, radius):
    size = 2 * radius + 1
    x = F.max_pool2d(x[:, None], (size, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(x, (1, size), stride=1, padding=(0, radius))[:, 0]


def simple_nms(scores, radius, n_iters=2):
    """Iterative max-pool non-maximum suppression on (B, H, W) scores."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_sep(scores, radius)
    for _ in range(n_iters):
        supp_mask = _maxpool_sep(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_sep(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def sample_descriptors(kpts, desc_map, cell=8):
    """Bilinear unit descriptors at (B, K, 2) xy pixels of (B, Hc, Wc, D) maps
    (grid_sample with align_corners=True and zero padding)."""
    B, Hc, Wc, D = desc_map.shape
    gx = (kpts[..., 0] - cell / 2 + 0.5) / (Wc * cell - cell / 2 - 0.5) * (Wc - 1)
    gy = (kpts[..., 1] - cell / 2 + 0.5) / (Hc * cell - cell / 2 - 0.5) * (Hc - 1)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    flat = desc_map.reshape(B, Hc * Wc, D)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < Hc) & (xi >= 0) & (xi < Wc)
        idx = yi.clamp(0, Hc - 1) * Wc + xi.clamp(0, Wc - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, D))
        return vals * valid[..., None]

    d = (gather(y0, x0) * (1 - wx) * (1 - wy)
         + gather(y0, x0 + 1) * wx * (1 - wy)
         + gather(y0 + 1, x0) * (1 - wx) * wy
         + gather(y0 + 1, x0 + 1) * wx * wy)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


class SuperPoint(nn.Module):
    """(B, H, W, 1) images in [0, 1] -> K keypoints, scores and descriptors."""

    def __init__(self, config=SuperPointConfig()):
        super().__init__()
        self.config = config
        self.net = SuperPointNet(config.descriptor_dim)

    @torch.no_grad()
    def detection_map(self, image, chunk=None):
        """(raw scores (B, H8, W8) after the softmax and the border mask,
        the same after NMS, descriptor maps (B, Hc, Wc, D)); `chunk` runs
        the trunk that many images at a time."""
        cfg = self.config
        B, H, W, _ = image.shape
        step = B if chunk is None else chunk
        maps = [self.net(image[i:i + step]) for i in range(0, B, step)]
        heat, desc_map = (torch.cat(m) for m in zip(*maps))
        probs = torch.softmax(heat, dim=-1)[..., :64]
        Hc, Wc = probs.shape[1], probs.shape[2]
        raw = probs.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
        b = cfg.remove_borders
        border = torch.ones((), device=image.device)
        if b > 0:
            ys = torch.arange(Hc * 8, device=image.device)
            xs = torch.arange(Wc * 8, device=image.device)
            border = ((ys[:, None] >= b) & (ys[:, None] < H - b)
                      & (xs[None, :] >= b) & (xs[None, :] < W - b))[None]
        return raw * border, simple_nms(raw, cfg.nms_radius) * border, desc_map

    @torch.no_grad()
    def forward(self, image, *, generator=None, chunk=None):
        """The top-K of `detection_map` over the full map; slots without a
        detection get score 0 and, with `fill_with_random_keypoints`, a
        uniform position drawn from `generator` (one (2, B, K) draw a call)."""
        cfg = self.config
        B, H, W, _ = image.shape
        _, scores, desc_map = self.detection_map(image, chunk)
        W8 = scores.shape[2]
        top_scores, top_idx = torch.topk(scores.reshape(B, -1), cfg.max_keypoints)
        kpts = torch.stack([(top_idx % W8).to(torch.float32),
                            (top_idx // W8).to(torch.float32)], dim=-1)
        valid = top_scores > cfg.keypoint_threshold
        if cfg.fill_with_random_keypoints:
            b = cfg.remove_borders
            r = torch.rand((2, B, cfg.max_keypoints), generator=generator, device=image.device)
            rand_kpts = torch.stack([b + r[0] * (W - 1 - 2 * b), b + r[1] * (H - 1 - 2 * b)],
                                    dim=-1)
            kpts = torch.where(valid[..., None], kpts, rand_kpts)
        top_scores = torch.where(valid, top_scores, 0.0)
        return {"keypoints": kpts, "scores": top_scores,
                "descriptors": sample_descriptors(kpts, desc_map)}
