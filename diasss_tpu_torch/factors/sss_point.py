"""Sonar slant-range / zero-plane measurement factor (SSSpointfactor.cpp:11-80).

Counterpart of :mod:`diasss_tpu.factors.sss_point`: with ``p_s`` the landmark
in the sensor frame, the residual is ``[|p_s| - slant_range, p_s.x - 0]`` and
the noise sigmas are ``(sigma_r, slant_range * alpha_bw)``.
"""

from __future__ import annotations

import math

import torch

from ..geometry import se3


def sss_point_residual(point: torch.Tensor, pose: se3.Pose3, sensor: se3.Pose3,
                       measured: torch.Tensor) -> torch.Tensor:
    """(..., 2) residual ``[|p_s| - m0, p_s.x - m1]``."""
    p_s = se3.transform_to(sensor, se3.transform_to(pose, point))
    rng = torch.linalg.norm(p_s, dim=-1)
    return torch.stack([rng - measured[..., 0], p_s[..., 0] - measured[..., 1]], dim=-1)


def sss_point_whitened(point, pose, sensor, measured, sigmas):
    """Noise-whitened residual: ``r / sigmas``."""
    return sss_point_residual(point, pose, sensor, measured) / sigmas


def kp_noise_sigmas(slant_range: torch.Tensor, sigma_r: float = 0.1, alpha_bw_deg: float = 0.1) -> torch.Tensor:
    """Diagonal sigmas ``(sigma_r, slant_range * alpha_bw)`` (optimizer.cpp:706-707)."""
    alpha = alpha_bw_deg * math.pi / 180.0
    return torch.stack([torch.full_like(slant_range, sigma_r), slant_range * alpha], dim=-1)
