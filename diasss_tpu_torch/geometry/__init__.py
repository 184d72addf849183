"""Geometry core: SO(3)/SE(3) ops and side-scan sonar imaging geometry."""

from . import se3, so3, sonar
from .se3 import (
    Pose3,
    between,
    compose,
    expmap,
    from_rodrigues_xyz,
    identity,
    inverse,
    local,
    logmap,
    retract,
    to_quat_xyzw_t,
    to_rpyxyz,
    transform_from,
    transform_to,
)

__all__ = [
    "se3",
    "so3",
    "sonar",
    "Pose3",
    "between",
    "compose",
    "expmap",
    "from_rodrigues_xyz",
    "identity",
    "inverse",
    "local",
    "logmap",
    "retract",
    "to_quat_xyzw_t",
    "to_rpyxyz",
    "transform_from",
    "transform_to",
]
