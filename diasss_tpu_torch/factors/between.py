"""Pose-graph factors with GTSAM residual conventions.

Counterpart of the between factor of :mod:`diasss_tpu.factors.between`:
``BetweenFactor<Pose3>`` is ``Logmap(measured^-1 * (x1^-1 * x2))`` with
tangent order (omega, v).  (The prior factors have no caller in the port:
the gauge pose is held fixed instead.)
"""

from __future__ import annotations

import torch

from ..geometry import se3


def between_residual(x1: se3.Pose3, x2: se3.Pose3, measured: se3.Pose3) -> torch.Tensor:
    """(..., 6) tangent residual of a BetweenFactor<Pose3>."""
    return se3.local(measured, se3.between(x1, x2))

