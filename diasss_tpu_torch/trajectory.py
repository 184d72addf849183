"""Trajectory writers matching the reference dump formats.

* :func:`save_poses_rpy` — ``r p y x y z`` rows (optimizer.cpp:1181-1182).
* :func:`save_poses_quat` — ``qx qy qz qw x y z`` rows (optimizer.cpp:1119-1121).
* :func:`load_poses_rpy` — the rows of a :func:`save_poses_rpy` file.
"""

from __future__ import annotations

import os

import numpy as np

from .geometry import se3


def _write(path: str, rows: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")


def save_poses_rpy(path: str, poses: se3.Pose3):
    _write(path, se3.to_rpyxyz(poses).cpu().numpy())


def save_poses_quat(path: str, poses: se3.Pose3):
    _write(path, se3.to_quat_xyzw_t(poses).cpu().numpy())


def load_poses_rpy(path: str) -> np.ndarray:
    """(P, 6) ``r p y x y z`` rows of a :func:`save_poses_rpy` file."""
    return np.loadtxt(path).reshape(-1, 6)
