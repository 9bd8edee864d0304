"""SuperPoint keypoint detector + descriptor (PyTorch).

Counterpart of `e2e_multi_view_matching_tpu/models/superpoint.py`, in float32
or with a bfloat16 trunk (`compute_dtype="bfloat16"`, as flax's
`nn.Conv(dtype=bfloat16)`: parameters stay float32 and are cast per call, each
convolution rounds its result to bfloat16 and then adds the bfloat16 bias;
ReLU, the extent masks and the pooling run in bfloat16; the heads are cast to
float32 before the softmax and the descriptor normalization).
Exact-size inputs, or shape-bucketed ones: images zero-padded to a common
canvas, each with its true (h, w) in `valid_size`, which gives inside each
extent what the exact-size run gives. With `fill_with_random_keypoints`
(training) slots without a detection get uniformly random positions from an
explicit `torch.Generator`; the network is frozen and runs without grad.
Public layouts stay the JAX package's: images (B, H, W, 1), keypoints (B, K, 2)
xy, descriptor maps (B, Hc, Wc, D). Inside, the trunk runs NCHW convolutions.
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
    # False is the eval contract; training fills empty slots at random
    fill_with_random_keypoints: bool = False
    descriptor_dim: int = 256
    compute_dtype: str = "float32"
    # "auto": top-K over 4x4-block maxima when NMS guarantees one survivor per
    # block; "flat": top-K over the full score map
    topk_impl: str = "auto"


class SuperPointNet(nn.Module):
    """The convolutional trunk: image (B, H, W, 1) -> (heat (B, Hc, Wc, 65),
    unit descriptors (B, Hc, Wc, D)). Submodule names follow the flax names.

    With `valid_size` (B, 2), the true (h, w) of each zero-padded image,
    activations beyond each image's extent are zeroed again after every conv
    and pool, and the extents floor-halve at each pool, as the exact-size
    run's 2x2 pooling does: a 3x3 conv at the true edge then taps zeros
    either way, so the computation inside the extent is the exact-size
    run's (without the masking the pad region grows bias-driven activations
    that bleed into the cells at the boundary)."""

    def __init__(self, descriptor_dim=256, compute_dtype="float32"):
        super().__init__()
        self.dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        conv3 = lambda i, o: nn.Conv2d(i, o, 3, padding=1)
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

    def _conv(self, layer, x):
        if self.dtype != torch.bfloat16:
            return layer(x)
        y = F.conv2d(x, layer.weight.to(self.dtype), None, layer.stride, layer.padding)
        return y + layer.bias.to(self.dtype)[None, :, None, None]

    def forward(self, image, valid_size=None):
        conv = self._conv
        ext = None if valid_size is None else [valid_size[:, 0].to(torch.int64),
                                                valid_size[:, 1].to(torch.int64)]

        def m(x):  # NCHW; zero beyond each image's extent
            if ext is None:
                return x
            ys = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
            xs = torch.arange(x.shape[3], device=x.device)[None, None, None, :]
            keep = (ys < ext[0][:, None, None, None]) & (xs < ext[1][:, None, None, None])
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))

        def pool(x):
            x = F.max_pool2d(x, 2, 2)
            if ext is not None:
                ext[0], ext[1] = ext[0] // 2, ext[1] // 2
            return m(x)

        x = image.permute(0, 3, 1, 2)
        if self.dtype == torch.bfloat16:
            x = x.to(self.dtype)
        x = m(F.relu(conv(self.conv1a, x)))
        x = m(F.relu(conv(self.conv1b, x)))
        x = pool(x)
        x = m(F.relu(conv(self.conv2a, x)))
        x = m(F.relu(conv(self.conv2b, x)))
        x = pool(x)
        x = m(F.relu(conv(self.conv3a, x)))
        x = m(F.relu(conv(self.conv3b, x)))
        x = pool(x)
        x = m(F.relu(conv(self.conv4a, x)))
        x = m(F.relu(conv(self.conv4b, x)))
        heat = conv(self.convPb, m(F.relu(conv(self.convPa, x)))).permute(0, 2, 3, 1)
        desc = conv(self.convDb, m(F.relu(conv(self.convDa, x)))).permute(0, 2, 3, 1)
        if self.dtype == torch.bfloat16:  # the heads in float32 from here on
            heat, desc = heat.float(), desc.float()
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        # whole cells beyond the extent are zero, so that bilinear taps into
        # them add nothing (the exact-size run's taps off the grid are zero)
        return heat, m(desc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _maxpool_sep(x, radius):
    # the (size, size) max filter with -inf padding is exactly separable
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


class SuperPoint(nn.Module):
    """Full detector: (B, H, W, 1) images -> fixed-K keypoints, scores, descriptors.

    Slots beyond the detected count have score 0 (and random positions with
    `fill_with_random_keypoints`).
    """

    def __init__(self, config=SuperPointConfig()):
        super().__init__()
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16")
        self.config = config
        self.net = SuperPointNet(config.descriptor_dim, config.compute_dtype)

    @torch.no_grad()
    def forward(self, image, valid_size=None, *, generator=None):
        """Detect keypoints in (B, H, W, 1) grayscale images in [0, 1].

        `valid_size`: optional (B, 2) true (h, w) of each image, zero-padded
        up to the common canvas (shape-bucketed batches): scores beyond the
        detectable extent are zeroed before NMS, so that the pad region's
        softmax plateau (~1/65 a pixel) can neither make keypoints nor
        suppress real ones at the boundary; the random fill stays inside the
        extent, and descriptors are sampled on each image's own cell grid.
        The border mask and the block top-K keep the canvas's H and W, as in
        the JAX package.
        `generator`: the keypoint-fill generator (on the images' device);
        required with `fill_with_random_keypoints`."""
        cfg = self.config
        B, H, W, _ = image.shape
        if cfg.fill_with_random_keypoints and generator is None:
            raise ValueError("fill_with_random_keypoints needs a torch.Generator")
        heat, desc_map = self.net(image, valid_size)
        probs = torch.softmax(heat, dim=-1)[..., :64]
        Hc, Wc = probs.shape[1], probs.shape[2]
        scores = probs.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4)
        scores = scores.reshape(B, Hc * 8, Wc * 8)
        valid_cells = None
        if valid_size is not None:
            # the detectable extent is the exact-size run's score grid,
            # floor(v / 8) * 8 <= v
            valid_cells = valid_size.to(torch.int64) // 2 // 2 // 2
            ys_g = torch.arange(Hc * 8, device=image.device)[None, :, None]
            xs_g = torch.arange(Wc * 8, device=image.device)[None, None, :]
            inside = ((ys_g < 8 * valid_cells[:, 0, None, None])
                      & (xs_g < 8 * valid_cells[:, 1, None, None]))
            scores = torch.where(inside, scores, 0.0)
        scores = simple_nms(scores, cfg.nms_radius)

        b = cfg.remove_borders
        H8, W8 = Hc * 8, Wc * 8
        if b > 0:
            ys = torch.arange(H8, device=image.device)
            xs = torch.arange(W8, device=image.device)
            border = ((ys[:, None] >= b) & (ys[:, None] < H - b)
                      & (xs[None, :] >= b) & (xs[None, :] < W - b))
            scores = scores * border[None]

        K = cfg.max_keypoints
        use_block_topk = (cfg.topk_impl == "auto" and cfg.nms_radius >= 3
                          and H8 % 4 == 0 and W8 % 4 == 0
                          and (H8 // 4) * (W8 // 4) >= K)
        if use_block_topk:
            # NMS radius >= 3 leaves at most one survivor per 4x4 block, so the
            # block maxima give the same selection for distinct scores
            blocks = scores.reshape(B, H8 // 4, 4, W8 // 4, 4).permute(0, 1, 3, 2, 4)
            blocks = blocks.reshape(B, H8 // 4, W8 // 4, 16)
            bmax = blocks.amax(dim=-1)
            barg = blocks.argmax(dim=-1)
            top_scores, cand_idx = torch.topk(bmax.reshape(B, -1), K)
            sub = torch.gather(barg.reshape(B, -1), 1, cand_idx)
            by = cand_idx // (W8 // 4)
            bx = cand_idx % (W8 // 4)
            ys = (by * 4 + sub // 4).to(torch.float32)
            xs = (bx * 4 + sub % 4).to(torch.float32)
        else:
            top_scores, top_idx = torch.topk(scores.reshape(B, -1), K)
            ys = (top_idx // W8).to(torch.float32)
            xs = (top_idx % W8).to(torch.float32)
        kpts = torch.stack([xs, ys], dim=-1)
        valid = top_scores > cfg.keypoint_threshold
        if cfg.fill_with_random_keypoints:
            # uniform in [b, W-1-b) x [b, H-1-b) (each image's true extent
            # with valid_size), like the JAX fill; drawn for every slot so
            # that the draw does not depend on the detections
            if valid_size is None:
                vw, vh = float(W), float(H)
            else:
                vw = valid_size[:, 1].to(torch.float32)[:, None]
                vh = valid_size[:, 0].to(torch.float32)[:, None]
            r = torch.rand((2, B, K), generator=generator, device=image.device)
            rand_kpts = torch.stack([b + r[0] * (vw - 1 - 2 * b),
                                     b + r[1] * (vh - 1 - 2 * b)], dim=-1)
            kpts = torch.where(valid[..., None], kpts, rand_kpts)
        top_scores = torch.where(valid, top_scores, 0.0)
        descs = sample_descriptors(kpts, desc_map, valid_cells=valid_cells)
        return {"keypoints": kpts, "scores": top_scores, "descriptors": descs}


def sample_descriptors(kpts, desc_map, cell=8, valid_cells=None):
    """Bilinearly sample unit descriptors at keypoint pixel locations.

    The upstream grid_sample(align_corners=True) convention with zero padding
    for out-of-range taps (see the JAX counterpart).

    Args:
        kpts: (B, K, 2) xy pixels; desc_map: (B, Hc, Wc, D).
        valid_cells: optional (B, 2) true (Hc, Wc) of shape-bucketed inputs:
            the upstream mapping normalizes by the image's own grid, so the
            exact-size run's descriptors need the true cell counts.
    Returns:
        (B, K, D) unit descriptors.
    """
    B, Hc, Wc, D = desc_map.shape
    if valid_cells is None:
        hc, wc = float(Hc), float(Wc)
    else:
        hc = valid_cells[:, 0].to(torch.float32)[:, None]
        wc = valid_cells[:, 1].to(torch.float32)[:, None]
    gx = (kpts[..., 0] - cell / 2 + 0.5) / (wc * cell - cell / 2 - 0.5) * (wc - 1)
    gy = (kpts[..., 1] - cell / 2 + 0.5) / (hc * cell - cell / 2 - 0.5) * (hc - 1)
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
