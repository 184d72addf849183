"""Pose-graph factors with GTSAM residual conventions.

Counterpart of :mod:`diasss_tpu.factors.between`: ``BetweenFactor<Pose3>``
is ``Logmap(measured^-1 * (x1^-1 * x2))`` with tangent order (omega, v);
``PriorFactor<Pose3>`` is ``Logmap(prior^-1 * x)`` (optimizer.cpp:166-168)
and ``PriorFactor<Point3>`` is ``x - prior`` (optimizer.cpp:1006-1008).
The solvers hold the gauge pose fixed instead of calling the pose prior.
"""

from __future__ import annotations

import torch

from ..geometry import se3


def between_residual(x1: se3.Pose3, x2: se3.Pose3, measured: se3.Pose3) -> torch.Tensor:
    """(..., 6) tangent residual of a BetweenFactor<Pose3>."""
    return se3.local(measured, se3.between(x1, x2))



def prior_residual(x: se3.Pose3, prior: se3.Pose3) -> torch.Tensor:
    """(..., 6) tangent residual of a PriorFactor<Pose3>."""
    return se3.local(prior, x)


def point_prior_residual(p: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """(..., 3) residual of a PriorFactor<Point3>."""
    return p - prior
