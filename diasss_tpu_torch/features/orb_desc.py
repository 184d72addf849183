"""Steered binary (ORB-style) descriptors and their Hamming distances.

Counterpart of :mod:`diasss_tpu.features.orb_desc`: 256 point pairs drawn
from a seeded Gaussian (sigma = patch/5 x 2, clipped to the 31x31 ORB patch;
the same numpy draw, so the pattern is bit-identical), rotated by the
keypoint angle and scaled by its size; bits are stored as +-1 float32 so the
Hamming distance is one matmul, ``(256 - b1 . b2) / 2``.  The matmul of +-1
values is exact in float32; callers on the card keep TF32 off all the same
(ROADMAP C3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .sift import bilinear_sample

N_BITS = 256
PATCH_HALF = 15  # sample within the 31x31 ORB patch


@functools.lru_cache(maxsize=1)
def _pattern():
    """(N_BITS, 2, 2) point-pair offsets, deterministic."""
    rng = np.random.default_rng(19)
    pts = rng.normal(0.0, PATCH_HALF / 5.0 * 2.0, (N_BITS, 2, 2))
    pts = np.clip(pts, -PATCH_HALF, PATCH_HALF)
    return pts.astype(np.float32)


def orb_descriptors(img: torch.Tensor, kps: torch.Tensor, angles: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(K, 256) float32 in {-1, +1} of keypoints ``kps`` (K, 2) (x, y) with
    steering ``angles`` (K,) radians and sizes (K,) (pattern scaled by
    size/31); a batch of images (L, h, w) takes (L, K, 2) keypoints."""
    img = img.to(torch.float32)
    pat = torch.as_tensor(_pattern(), device=img.device)  # (256, 2, 2)
    c = torch.cos(angles)[..., None, None]
    s = torch.sin(angles)[..., None, None]
    sc = (sizes / (2.0 * PATCH_HALF + 1.0))[..., None, None]
    px = (c * pat[..., 0] - s * pat[..., 1]) * sc + kps[..., 0, None, None]  # (..., K, 256, 2)
    py = (s * pat[..., 0] + c * pat[..., 1]) * sc + kps[..., 1, None, None]
    v = bilinear_sample(img, px, py)
    return torch.where(v[..., 0] < v[..., 1], 1.0, -1.0)


def hamming_matrix(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(..., K1, K2) Hamming distances of +-1 encodings (..., K, D)."""
    return 0.5 * (b1.shape[-1] - b1 @ b2.transpose(-1, -2))
