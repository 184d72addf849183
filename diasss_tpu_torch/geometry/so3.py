"""SO(3) operations with GTSAM-compatible conventions, on torch tensors.

Counterpart of :mod:`diasss_tpu.geometry.so3`: :func:`exp` is the Rodrigues
exponential of an axis-angle vector (``gtsam::Rot3::Rodrigues``), :func:`log`
its inverse, :func:`rpy` the xyz-Euler extraction of ``gtsam::Rot3::rpy()``.
Every function is shape-polymorphic over leading batch dimensions and free of
data-dependent Python control flow, so ``torch.func.vmap``/``jacfwd`` apply.
"""

from __future__ import annotations

import math

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w``: last dim 3 -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_coeffs(theta2: torch.Tensor):
    """Stable ``A = sin t / t`` and ``B = (1 - cos t) / t^2`` (Taylor near 0)."""
    eps = 1e-8
    safe = torch.clamp(theta2, min=eps)
    theta = torch.sqrt(safe)
    small = theta2 < eps
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    return a, b


def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map (Rodrigues): axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map: rotation (..., 3, 3) -> axis-angle (..., 3).

    Stable for small angles and near pi (axis from the largest diagonal of
    ``(R + R^T)/2 + I`` there).  The arccos argument is clamped strictly inside
    (-1, 1) so forward-mode Jacobians at the identity stay finite.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    eps_c = 1e-7
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps_c, 1.0 - eps_c)
    theta = torch.arccos(cos_t)
    antisym = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    near_pi = theta > (math.pi - 1e-3)
    scale_generic = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * sin_t, min=1e-12),
    )
    w_generic = scale_generic[..., None] * antisym
    S = 0.5 * (R + R.transpose(-1, -2)) + _eye_like(R)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(S, -1, idx)[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-12)
    sign = torch.where(torch.sum(axis * antisym, dim=-1) < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * sign[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian ``I + B hat(w) + C hat(w)^2``."""
    theta2 = torch.sum(w * w, dim=-1)
    eps = 1e-8
    safe = torch.clamp(theta2, min=eps)
    theta = torch.sqrt(safe)
    small = theta2 < eps
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (safe * theta))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian (used by the SE(3) log map)."""
    theta2 = torch.sum(w * w, dim=-1)
    eps = 1e-8
    safe = torch.clamp(theta2, min=eps)
    theta = torch.sqrt(safe)
    small = theta2 < eps
    half = theta * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-12)) / safe,
    )
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def rpy(R: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) with ``R = Rz(y) @ Ry(p) @ Rx(r)``."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def yaw(R: torch.Tensor) -> torch.Tensor:
    """Yaw angle, ``gtsam::Rot3::yaw()``."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> quaternion (w, x, y, z) by branch-free Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=0.0)) * 0.5

    qw0 = root(1.0 + tr)
    d0 = 4.0 * torch.clamp(qw0, min=1e-12)
    c0 = torch.stack([qw0, (m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    d1 = 4.0 * torch.clamp(qx1, min=1e-12)
    c1 = torch.stack([(m21 - m12) / d1, qx1, (m01 + m10) / d1, (m02 + m20) / d1], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    d2 = 4.0 * torch.clamp(qy2, min=1e-12)
    c2 = torch.stack([(m02 - m20) / d2, (m01 + m10) / d2, qy2, (m12 + m21) / d2], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    d3 = 4.0 * torch.clamp(qz3, min=1e-12)
    c3 = torch.stack([(m10 - m01) / d3, (m02 + m20) / d3, (m12 + m21) / d3, qz3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)
