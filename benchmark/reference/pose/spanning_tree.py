"""Maximum-spanning-tree absolute-pose initialization (PyTorch and numpy).

Frozen copy of the port's `mvba/spanning_tree.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/mvba/spanning_tree.py`: a match
graph weighted by pairwise inlier counts, its maximum spanning tree, and the
relative poses chained along it into absolute extrinsics (camera 0 = identity).
Two implementations:

- `spanning_tree_poses`: numpy on the host, one tuple (dict in, list out), for
  the host-tree pipeline of the RANSAC init modes;
- `spanning_tree_poses_device`: Prim's algorithm over the C(V,2) pair slots of
  every tuple at once, the V-1 growth steps unrolled, with the host scan's
  tie-breaks.
"""

import numpy as np
import torch

from .lie import invert_transform


def maximum_spanning_tree(weights):
    """Prim's maximum spanning tree on a dense symmetric weight matrix.

    Args:
        weights: (N, N) nonnegative; 0 = no edge. Only i<j entries are read.
    Returns:
        list of (i, j) tree edges (i < j), in insertion order from node 0.
    """
    N = weights.shape[0]
    W = np.maximum(weights, weights.T).astype(np.float64)
    in_tree = np.zeros(N, bool)
    in_tree[0] = True
    edges = []
    for _ in range(N - 1):
        best = (-1.0, None)
        for a in np.where(in_tree)[0]:
            for b in np.where(~in_tree)[0]:
                if W[a, b] > best[0]:
                    best = (W[a, b], (a, b))
        if best[1] is None or best[0] <= 0:
            break
        a, b = best[1]
        in_tree[b] = True
        edges.append((min(a, b), max(a, b)))
    return edges


def spanning_tree_poses(n_images, rel_poses, inlier_counts):
    """Chain relative poses along the maximum spanning tree into extrinsics.

    `rel_poses[(i, j)]` is T_i2j (points in cam_i -> cam_j); the chain builds
    cam_i -> world poses and inverts them into world->cam extrinsics with
    camera 0 as the world frame.

    Args:
        n_images: N.
        rel_poses: dict {(i, j): (4, 4) ndarray} for i < j.
        inlier_counts: dict {(i, j): int}.
    Returns:
        (extr (N, 4, 4) float32, unreachable cameras = identity; tree_edges
         list of (i, j)).
    """
    W = np.zeros((n_images, n_images))
    for (i, j), c in inlier_counts.items():
        if (i, j) in rel_poses:
            W[i, j] = max(c, 0)
    tree = maximum_spanning_tree(W)

    abs_pose = {0: np.eye(4)}
    for _ in range(n_images):
        for i, j in tree:
            if j not in abs_pose and i in abs_pose:
                abs_pose[j] = abs_pose[i] @ np.linalg.inv(rel_poses[(i, j)])
            elif i not in abs_pose and j in abs_pose:
                abs_pose[i] = abs_pose[j] @ rel_poses[(i, j)]
        if len(abs_pose) == n_images:
            break

    extr = np.stack([np.linalg.inv(abs_pose[i]) if i in abs_pose else np.eye(4)
                     for i in range(n_images)]).astype(np.float32)
    return extr, tree


def spanning_tree_poses_device(T_rel, counts, valid, idx_i, idx_j, n_views):
    """Prim's maximum spanning tree + pose chaining for a batch of tuples.

    Tie-breaking follows the host scan order (tree node a ascending, new node b
    ascending, first strict maximum): inlier counts are integers, so
    subtracting rank/(V^2+1) < 1 orders equal weights by (a, b) without
    reordering unequal ones, and `argmax` returns the first maximum.

    Args:
        T_rel: (B, P, 4, 4) relative poses T_i2j per pair.
        counts: (B, P) inlier counts; valid: (B, P) bool pose validity.
        idx_i, idx_j: (P,) int64 tensors, pair order [(i, j) for j < V, i < j].
        n_views: V.
    Returns:
        (extr (B, V, 4, 4) world->cam with camera 0 = identity and unreachable
         cameras = identity, on_tree (B, P) bool tree membership).
    """
    B = T_rel.shape[0]
    V = n_views
    dev = T_rel.device
    W = torch.where(valid, torch.clamp(counts.to(torch.float32), min=0.0), 0.0)
    ar = torch.arange(B, device=dev)
    in_tree = torch.zeros((B, V), dtype=torch.bool, device=dev)
    in_tree[:, 0] = True
    eye = torch.eye(4, dtype=T_rel.dtype, device=dev)
    abs_pose = eye.expand(B, V, 4, 4).clone()
    on_tree = torch.zeros_like(valid)
    T_inv = invert_transform(T_rel)

    def at(x, p):
        return torch.gather(x, 1, p[:, None])[:, 0]

    for _ in range(V - 1):
        ti = in_tree[:, idx_i]
        tj = in_tree[:, idx_j]
        elig = (ti ^ tj) & (W > 0)
        a = torch.where(ti, idx_i, idx_j)  # in-tree endpoint
        b = torch.where(ti, idx_j, idx_i)  # endpoint being added
        w_eff = torch.where(elig, W - (a * V + b).to(torch.float32) / (V * V + 1.0), -1.0)
        p = torch.argmax(w_eff, dim=-1)
        take = at(w_eff, p) > 0.0
        new_node = at(b, p)
        # abs_pose maps cam -> world: anchor i => abs[j] = abs[i] @ inv(T),
        # anchor j => abs[i] = abs[j] @ T
        T_step = torch.where(at(ti, p)[:, None, None], T_inv[ar, p], T_rel[ar, p])
        new_pose = abs_pose[ar, at(a, p)] @ T_step
        abs_pose[ar, new_node] = torch.where(take[:, None, None], new_pose,
                                             abs_pose[ar, new_node])
        in_tree[ar, new_node] = in_tree[ar, new_node] | take
        on_tree[ar, p] = on_tree[ar, p] | take

    extr = torch.where(in_tree[..., None, None], invert_transform(abs_pose), eye)
    return extr, on_tree
