"""SO(3)/SE(3) Lie group operations (PyTorch).

Frozen copy of the port's `geom/lie.py`, kept as the benchmark's plain
reference of the pose stage: it imports nothing of the port.

Counterpart of `e2e_multi_view_matching_tpu/geom/lie.py`. Transforms act on
column vectors, X' = R @ X + t; a 4x4 transform is [[R, t], [0, 1]]; the se(3)
tangent is [omega(3), nu(3)] (rotation first). Everything broadcasts over
leading batch dimensions.
"""

import math

import torch

_EPS = 1e-8


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta_sq):
    """Taylor-stable a=sin(t)/t, b=(1-cos t)/t^2, c=(t - sin t)/t^3."""
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / (theta_sq + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta + _EPS))
    return a, b, c


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    return _eye(3, w) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), with the
    diagonal-based fallback near theta = pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(theta) + _EPS))
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None])
                          / (1.0 - cos_theta[..., None] + _EPS), min=0.0)
    sign = torch.sign(v + _EPS)
    w_pi = theta[..., None] * torch.sqrt(axis_sq) * sign
    return torch.where(near_pi[..., None], w_pi, scale[..., None] * v)


def make_transform(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    """se(3) tangent [omega, nu] (..., 6) -> (..., 4, 4) transform."""
    w, nu = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_coeffs(theta_sq)
    K = hat(w)
    KK = K @ K
    eye = _eye(3, xi)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    t = (V @ nu[..., None])[..., 0]
    return make_transform(R, t)


def se3_log(T):
    """(..., 4, 4) transform -> se(3) tangent [omega, nu] (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta_sq)
    K = hat(w)
    coef = torch.where(theta_sq < 1e-8, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - a / (2.0 * b + _EPS)) / (theta_sq + _EPS))
    V_inv = _eye(3, T) - 0.5 * K + coef[..., None, None] * (K @ K)
    nu = (V_inv @ t[..., None])[..., 0]
    return torch.cat([w, nu], dim=-1)


def invert_transform(T):
    """Closed-form SE(3) inverse (no linear solve)."""
    R_inv = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(R_inv @ T[..., :3, 3:])[..., 0]
    return make_transform(R_inv, t_inv)
