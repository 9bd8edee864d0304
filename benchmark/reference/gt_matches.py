"""Ground-truth correspondences from depth and pose, on the device (PyTorch).

Frozen copy of the port's `data/gt_matches.py`, kept as the benchmark's
plain reference of the training step's supervision.

Counterpart of `e2e_multi_view_matching_tpu/data/gt_matches.py`: keypoints are
floored to integer pixels, lifted with their depth, projected into the other
view, and matched by mutual nearest neighbour on the symmetric reprojection
error; class-balancing weights drop the uncertain non-matches. All pairs of a
tuple run as one (B*P) batch. Nothing here synchronises with the host:
inverses go through `torch.linalg.inv_ex`, which does not read its error flag
back.

Output contract: per pair `gt_indices` (B, 2, K+1) int32 with -1 = dustbin and
`gt_weights` (B, 2, K+1) float32 (0 = dropped).
"""

import torch

_EPS = 1e-12


def _inv(x):
    return torch.linalg.inv_ex(x).inverse


def _pairwise_dist(a, b):
    """(..., K, 2), (..., K, 2) -> (..., K, K) distances by the Gram expansion
    ||a||^2 + ||b||^2 - 2ab with a 1e-12 floor: the JAX formula, not
    `torch.cdist`, so that the f32 cancellation (~0.02 px at coordinates of
    hundreds of pixels) is the same on both sides."""
    aa = (a * a).sum(dim=-1)
    bb = (b * b).sum(dim=-1)
    ab = torch.einsum("...kc,...lc->...kl", a, b)
    d2 = aa[..., :, None] + bb[..., None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(d2, min=_EPS))


def _lookup_depth(depth, kpts):
    """depth (B, H, W), kpts (B, K, 2) xy -> (B, K) nearest-pixel depth."""
    H, W = depth.shape[-2:]
    x = kpts[..., 0].to(torch.int64).clamp(0, W - 1)
    y = kpts[..., 1].to(torch.int64).clamp(0, H - 1)
    return torch.gather(depth.reshape(depth.shape[0], H * W), 1, y * W + x)


def _transform_kpts(kpts, d, K_src, K_dst, T):
    """Pixels + depth of the source view into the destination view.

    Returns (depths_dst (B, K), kpts_dst (B, K, 2))."""
    pix_h = torch.stack([kpts[..., 0] * d, kpts[..., 1] * d, d], dim=-1)
    X_src = torch.einsum("bij,bkj->bki", _inv(K_src), pix_h)
    X_dst = torch.einsum("bij,bkj->bki", T[:, :3, :3], X_src) + T[:, None, :3, 3]
    p_dst = torch.einsum("bij,bkj->bki", K_dst, X_dst)
    z = p_dst[..., 2]
    sign = torch.where(z >= 0, 1.0, -1.0)
    z_safe = sign * torch.clamp(z.abs(), min=1e-9)
    return z, p_dst[..., :2] / z_safe[..., None]


def gt_matches_of_pair(kpts0, kpts1, K0, K1, T021, depth0, depth1,
                       max_matched_reproj_err=5.0, min_unmatched_reproj_err=15.0):
    """GT match indices + class-balanced weights for one view pair.

    Args:
        kpts0, kpts1: (B, K, 2) pixel xy; K0, K1: (B, 3, 3) or (B, 4, 4);
        T021: (B, 4, 4) view0 -> view1; depth0, depth1: (B, H, W) meters.
    Returns:
        gt_indices (B, 2, K+1) int32, gt_weights (B, 2, K+1) float32.
    """
    K0 = K0[..., :3, :3]
    K1 = K1[..., :3, :3]
    kpts0 = torch.floor(kpts0)  # integer-pixel semantics
    kpts1 = torch.floor(kpts1)
    B, K, _ = kpts0.shape
    dev = kpts0.device
    d0 = _lookup_depth(depth0, kpts0)
    d1 = _lookup_depth(depth1, kpts1)
    depths0to1, kpts0to1 = _transform_kpts(kpts0, d0, K0, K1, T021)
    depths1to0, kpts1to0 = _transform_kpts(kpts1, d1, K1, K0, _inv(T021))

    # symmetric mean reprojection error: rows = kpts0, columns = kpts1
    errors = 0.5 * (_pairwise_dist(kpts0, kpts1to0) + _pairwise_dist(kpts0to1, kpts1))
    row_mins = errors.argmin(dim=2)  # first minimum, like jnp.argmin
    col_mins = errors.argmin(dim=1)

    i0s = torch.arange(K, device=dev).expand(B, K)
    i1s = row_mins
    mutual = torch.gather(col_mins, 1, i1s) == i0s
    err_at_min = torch.gather(errors, 2, i1s[..., None])[..., 0]
    valid_d0 = d0 > 1e-6
    match_d1 = torch.gather(d1, 1, i1s)
    valid_d1 = match_d1 > 1e-6
    match_mask = mutual & (err_at_min <= max_matched_reproj_err) & valid_d0 & valid_d1
    # relative depth consistency in both directions
    rel0 = (depths0to1 - match_d1).abs() / torch.clamp(match_d1, min=1e-6)
    rel1 = (torch.gather(depths1to0, 1, i1s) - d0).abs() / torch.clamp(d0, min=1e-6)
    match_mask = match_mask & (rel0 < 0.1) & (rel1 < 0.1)
    match_count = match_mask.sum(dim=1)

    minus = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
    match_indices0 = torch.cat([torch.where(match_mask, i1s, -1), minus], dim=1)
    # view-1 side: write i0 at position i1 where matched; every other write
    # goes to the discard slot K+1 (mutual argmin makes the real writes injective)
    scatter_idx = torch.where(match_mask, i1s, K + 1)
    mi1_ext = torch.full((B, K + 2), -1, dtype=torch.int64, device=dev)
    mi1_ext.scatter_(1, scatter_idx, i0s)
    match_indices1 = mi1_ext[:, :K + 1]
    matched1 = match_indices1[:, :K] >= 0

    # uncertain non-matches on the kpts0 side
    drop0 = ~match_mask & (~valid_d0 | ~valid_d1 | (err_at_min <= min_unmatched_reproj_err))
    # ... and on the kpts1 side
    j0s = col_mins
    invalid_depth1 = ~(torch.gather(d0, 1, j0s) > 1e-6) | ~(d1 > 1e-6)
    err_at_min1 = torch.gather(errors, 1, j0s[:, None, :])[:, 0, :]
    drop1 = ~matched1 & (invalid_depth1 | (err_at_min1 <= min_unmatched_reproj_err))
    drop_count = drop0.sum(dim=1) + drop1.sum(dim=1)

    # class-balancing weights
    match_frac = 2.0 * match_count / torch.clamp(2.0 * K - drop_count, min=1.0)
    unmatch_weight = 0.5 / torch.clamp(1.0 - match_frac, min=1e-6)
    match_weight = 0.5 / torch.clamp(match_frac, min=1e-6)
    invalid_w = (match_frac <= 1e-6) | (match_frac >= 1.0 - 1e-6)
    match_weight = torch.where(invalid_w, 0.0, match_weight)
    unmatch_weight = torch.where(invalid_w, 0.0, unmatch_weight)

    def weights_for(drop, matched):
        # the dustbin entry is never dropped and never matched
        no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        w = torch.where(torch.cat([matched, no], dim=1), match_weight[:, None],
                        unmatch_weight[:, None])
        return torch.where(torch.cat([drop, no], dim=1), 0.0, w)

    gt_indices = torch.stack([match_indices0, match_indices1], dim=1).to(torch.int32)
    gt_weights = torch.stack([weights_for(drop0, match_mask),
                              weights_for(drop1, matched1)], dim=1).to(torch.float32)
    return gt_indices, gt_weights


def gt_matches_all_pairs(kpts, intr, poses, depths, max_matched_reproj_err=5.0,
                         min_unmatched_reproj_err=15.0):
    """GT matches for all C(V,2) pairs of a tuple, stacked on a pair axis.

    For each pair (k, m), T_k2m = inv(pose_m) @ pose_k.

    Args:
        kpts: (B, V, K, 2); intr: (B, V, 3, 3) or (B, V, 4, 4);
        poses: (B, V, 4, 4) cam->world; depths: (B, V, H, W).
    Returns:
        gt_indices (B, P, 2, K+1), gt_weights (B, P, 2, K+1) with pairs ordered
        [(k, m) for m in range(V) for k in range(m)].
    """
    B, V = kpts.shape[:2]
    idx_m, idx_k = torch.tril_indices(V, V, -1, device=kpts.device)
    P = idx_k.shape[0]

    def flat(x, idx):
        return x[:, idx].reshape((B * P,) + x.shape[2:])

    T = _inv(flat(poses, idx_m)) @ flat(poses, idx_k)
    gi, gw = gt_matches_of_pair(
        flat(kpts, idx_k), flat(kpts, idx_m), flat(intr, idx_k), flat(intr, idx_m), T,
        flat(depths, idx_k), flat(depths, idx_m),
        max_matched_reproj_err, min_unmatched_reproj_err)
    return gi.reshape((B, P) + gi.shape[1:]), gw.reshape((B, P) + gw.shape[1:])
