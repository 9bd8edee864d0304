"""Pose error metrics and AUC (PyTorch tensors; `pose_auc` is host numpy).

Frozen copy of the port's `geom/metrics.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/geom/metrics.py`.
"""

import numpy as np
import torch


def safe_arccos(x, eps=1e-6):
    """arccos with inputs clamped strictly inside (-1, 1)."""
    return torch.arccos(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def rotation_angle_error(T0, T1, reduce=True, degrees=False):
    """Geodesic angle between the rotation parts of T0 and T1."""
    trace = torch.einsum("...ji,...ji->...", T0[..., :3, :3], T1[..., :3, :3])
    err = safe_arccos((trace - 1.0) * 0.5).abs()
    if degrees:
        err = torch.rad2deg(err)
    return err.mean() if reduce else err


def translation_angle_error(T0, T1, reduce=True, degrees=False):
    """Angle between the translations of T0 and T1; near-zero-norm entries
    contribute 0 and drop out of the mean."""
    t0 = T0[..., :3, 3]
    t1 = T1[..., :3, 3]
    n = torch.linalg.vector_norm(t0, dim=-1) * torch.linalg.vector_norm(t1, dim=-1)
    valid = n > 1e-6
    cos_a = torch.sum(t0 * t1, dim=-1) / torch.clamp(n, min=1e-6)
    err = torch.where(valid, safe_arccos(cos_a).abs(), 0.0)
    if degrees:
        err = torch.rad2deg(err)
    if reduce:
        return err.sum() / torch.clamp(valid.to(err.dtype).sum(), min=1.0)
    return err


def pose_error_max(T_gt, T_pred, degrees=True):
    """max(rotation error, translation angle error), the benchmark pose error."""
    r = rotation_angle_error(T_gt, T_pred, reduce=False, degrees=degrees)
    t = translation_angle_error(T_gt, T_pred, reduce=False, degrees=degrees)
    return torch.maximum(r, t)


def pose_auc(errors, thresholds=(5, 10, 20)):
    """Trapezoidal AUC of the cumulative error-recall curve (host numpy)."""
    errors = np.asarray([np.inf if not np.isfinite(e) else float(e)
                         for e in np.ravel(errors)])
    errors = np.concatenate([[0.0], np.sort(errors)])
    recall = np.arange(len(errors)) / (len(errors) - 1)
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last_index], [recall[last_index - 1]]])
        e = np.concatenate([errors[:last_index], [t]])
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs
