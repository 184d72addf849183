"""SE(3) poses as batched (R, t) tensors with GTSAM-compatible semantics.

Counterpart of :mod:`diasss_tpu.geometry.se3`.  A pose batch is the pair
``R: (..., 3, 3)``, ``t: (..., 3)``; tangent vectors are ordered
``(omega, v)``; ``expmap``/``logmap`` are the full SE(3) exponential;
``between(a, b) = a^-1 * b``; DR rows ``(r, p, y, x, y, z)`` build poses with
``Rot3::Rodrigues`` on the first three entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class Pose3(NamedTuple):
    """Batched rigid transform; fields broadcast over leading dims."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @property
    def shape(self):
        return self.t.shape[:-1]

    def __getitem__(self, idx):
        return Pose3(self.R[idx], self.t[idx])


def identity(shape=(), dtype=torch.float32, device=None) -> Pose3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*shape, 3, 3)
    t = torch.zeros((*shape, 3), dtype=dtype, device=device)
    return Pose3(R, t)


def from_rodrigues_xyz(rpyxyz: torch.Tensor) -> Pose3:
    """Poses from DR rows ``(r, p, y, x, y, z)`` (axis-angle, not Euler)."""
    return Pose3(so3.exp(rpyxyz[..., :3]), rpyxyz[..., 3:6])


def _apply(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., None])[..., 0]


def compose(a: Pose3, b: Pose3) -> Pose3:
    return Pose3(a.R @ b.R, _apply(a.R, b.t) + a.t)


def inverse(a: Pose3) -> Pose3:
    Rt = a.R.transpose(-1, -2)
    return Pose3(Rt, -_apply(Rt, a.t))


def between(a: Pose3, b: Pose3) -> Pose3:
    """``a^-1 * b`` (gtsam::Pose3::between)."""
    return compose(inverse(a), b)


def transform_to(a: Pose3, p: torch.Tensor) -> torch.Tensor:
    """World point -> body frame: ``R^T (p - t)``."""
    return _apply(a.R.transpose(-1, -2), p - a.t)


def transform_from(a: Pose3, p: torch.Tensor) -> torch.Tensor:
    """Body point -> world frame: ``R p + t``."""
    return _apply(a.R, p) + a.t


def expmap(xi: torch.Tensor) -> Pose3:
    """SE(3) exponential of ``xi = (omega, v)`` (..., 6)."""
    w = xi[..., :3]
    return Pose3(so3.exp(w), _apply(so3.left_jacobian(w), xi[..., 3:]))


def logmap(a: Pose3) -> torch.Tensor:
    """SE(3) logarithm -> ``(omega, v)`` (..., 6)."""
    w = so3.log(a.R)
    return torch.cat([w, _apply(so3.left_jacobian_inv(w), a.t)], dim=-1)


def retract(a: Pose3, xi: torch.Tensor) -> Pose3:
    """Right-retraction ``a * Expmap(xi)`` (the GTSAM 4.x Pose3 default)."""
    return compose(a, expmap(xi))


def local(a: Pose3, b: Pose3) -> torch.Tensor:
    """``Logmap(a^-1 b)``."""
    return logmap(between(a, b))


def to_rpyxyz(a: Pose3) -> torch.Tensor:
    """Pose -> ``(roll, pitch, yaw, x, y, z)`` (the ``*_all`` dump format)."""
    return torch.cat([so3.rpy(a.R), a.t], dim=-1)


def to_quat_xyzw_t(a: Pose3) -> torch.Tensor:
    """Pose -> ``(qx, qy, qz, qw, x, y, z)`` (the pairwise dump format)."""
    q = so3.to_quaternion(a.R)
    return torch.cat([q[..., 1:], q[..., :1], a.t], dim=-1)


def adjoint(a: Pose3) -> torch.Tensor:
    """Adjoint map (..., 6, 6) in the (omega, v) order: ``[[R, 0], [hat(t) R, R]]``."""
    top = torch.cat([a.R, torch.zeros_like(a.R)], dim=-1)
    bottom = torch.cat([so3.hat(a.t) @ a.R, a.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def where(mask: torch.Tensor, a: Pose3, b: Pose3) -> Pose3:
    """Per-pose select: ``mask`` broadcasts over the pose batch dims."""
    return Pose3(
        torch.where(mask[..., None, None], a.R, b.R),
        torch.where(mask[..., None], a.t, b.t),
    )


def cat(poses, dim: int = 0) -> Pose3:
    return Pose3(torch.cat([p.R for p in poses], dim=dim), torch.cat([p.t for p in poses], dim=dim))
