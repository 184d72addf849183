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


def gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``img[yi, xi]`` for an (h, w) image; for a batch of images (L, h, w)
    the index tensors lead with L and image l is read at index row l."""
    if img.dim() == 2:
        return img[yi, xi]
    L, h, w = img.shape
    idx = yi * w + xi
    return torch.gather(img.reshape(L, h * w), 1, idx.reshape(L, -1)).reshape(idx.shape)


def extract_patches(img: torch.Tensor, kps: torch.Tensor, half: int) -> torch.Tensor:
    """(K, 2) integer keypoints (x, y) -> (K, 2h+1, 2h+1) edge-clamped patches.
    Keypoints outside the image are clamped to it, as ``lax.dynamic_slice``
    clamps its start.  A batch of images (L, n, m) takes (L, K, 2)
    keypoints and gives (L, K, 2h+1, 2h+1)."""
    n, m = img.shape[-2:]
    pad = F.pad(img.reshape(-1, 1, n, m), (half, half, half, half), mode="replicate")
    pad = pad.reshape(*img.shape[:-2], n + 2 * half, m + 2 * half)
    off = torch.arange(2 * half + 1, device=img.device)
    x = torch.clamp(kps[..., 0].to(torch.int64), 0, m - 1)
    y = torch.clamp(kps[..., 1].to(torch.int64), 0, n - 1)
    return gather2d(pad, y[..., None, None] + off[:, None], x[..., None, None] + off[None, :])


def ic_angles(img: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """Orientation in radians for each keypoint (level coordinates); a batch
    of images (L, n, m) takes (L, K, 2) keypoints."""
    xs, ys = _disk_masks(img.device)
    patches = extract_patches(img.to(torch.float32), kps, HALF_PATCH)
    m10 = _tree_sum(_tree_sum(patches * xs))
    m01 = _tree_sum(_tree_sum(patches * ys))
    # in float64, rounded once: the CPU's float32 atan2 can differ by an ulp
    # between its vector lanes and its scalar tail, i.e. with the batch size
    return torch.atan2(m01.double(), m10.double()).to(torch.float32)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by pairwise halving (zero-padded to a power of
    two): elementwise adds in one fixed order, so each sum has the same bits
    whatever the batch around it and on either device (a library reduction
    picks its order by shape), and the stacked detector's angles equal the
    per-level ones bit for bit."""
    n = x.shape[-1]
    x = F.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]
