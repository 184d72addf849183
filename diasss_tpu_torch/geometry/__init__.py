"""Geometry core: SO(3)/SE(3) ops and side-scan sonar imaging geometry."""

from . import se3, so3, sonar
from .se3 import Pose3

__all__ = ["Pose3", "se3", "so3", "sonar"]
