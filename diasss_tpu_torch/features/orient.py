"""Intensity-centroid keypoint orientation (IC_Angle, ORBextractor.cpp:77-104).

Counterpart of :mod:`diasss_tpu.features.orient`: ``atan2(m01, m10)`` over the
radius-15 disk around each keypoint, from edge-clamped 31x31 patches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15


def _disk_masks(device=None):
    ys, xs = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    inside = (xs**2 + ys**2) <= HALF_PATCH**2 + HALF_PATCH // 2
    return (
        torch.as_tensor(xs * inside, dtype=torch.float32, device=device),
        torch.as_tensor(ys * inside, dtype=torch.float32, device=device),
    )


def extract_patches(img: torch.Tensor, kps: torch.Tensor, half: int) -> torch.Tensor:
    """(K, 2) integer keypoints (x, y) -> (K, 2h+1, 2h+1) edge-clamped patches.
    Keypoints outside the image are clamped to it, as ``lax.dynamic_slice``
    clamps its start."""
    n, m = img.shape
    pad = F.pad(img[None, None], (half, half, half, half), mode="replicate")[0, 0]
    off = torch.arange(2 * half + 1, device=img.device)
    x = torch.clamp(kps[:, 0].to(torch.int64), 0, m - 1)
    y = torch.clamp(kps[:, 1].to(torch.int64), 0, n - 1)
    return pad[y[:, None, None] + off[None, :, None], x[:, None, None] + off[None, None, :]]


def ic_angles(img: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """Orientation in radians for each keypoint (level coordinates)."""
    xs, ys = _disk_masks(img.device)
    patches = extract_patches(img.to(torch.float32), kps, HALF_PATCH)
    m10 = torch.sum(patches * xs, dim=(-2, -1))
    m01 = torch.sum(patches * ys, dim=(-2, -1))
    return torch.atan2(m01, m10)
