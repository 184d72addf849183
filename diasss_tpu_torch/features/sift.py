"""SIFT descriptors as a batched dense-patch computation.

Counterpart of :mod:`diasss_tpu.features.sift`: a rotated, scaled
``PATCH x PATCH`` sample grid per keypoint (bilinear gather), gradients on the
sampled patch, soft orientation binning, trilinear spatial pooling with a
Gaussian window as one batched matrix product, then normalise -> clip 0.2 ->
renormalise -> x512 (OpenCV convention).  The constant tables are rebuilt here
in numpy with the same formulas.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .orient import gather2d

D_SPATIAL = 4
N_ORI = 8
SCL_FCTR = 3.0
PATCH = 32
MAG_THRESH = 0.2
INT_FCTR = 512.0


def sample_grid_np():
    """Sample offsets in descriptor-bin units, (PATCH, PATCH) each."""
    step = D_SPATIAL / PATCH
    coords = (np.arange(PATCH) + 0.5) * step - D_SPATIAL / 2
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    return gx.astype(np.float32), gy.astype(np.float32)


def soft_assign_matrix_np() -> np.ndarray:
    """(PATCH*PATCH, D*D) trilinear spatial pooling weights x Gaussian window."""
    gx, gy = sample_grid_np()
    centers = np.arange(D_SPATIAL) - (D_SPATIAL - 1) / 2
    wx = np.maximum(0.0, 1.0 - np.abs(gx.reshape(-1, 1) - centers[None, :]))
    wy = np.maximum(0.0, 1.0 - np.abs(gy.reshape(-1, 1) - centers[None, :]))
    w_spatial = wy[:, :, None] * wx[:, None, :]
    r2 = gx.reshape(-1) ** 2 + gy.reshape(-1) ** 2
    gauss = np.exp(-r2 / (2 * (0.5 * D_SPATIAL) ** 2))
    w = w_spatial * gauss[:, None, None]
    return w.reshape(PATCH * PATCH, D_SPATIAL * D_SPATIAL).astype(np.float32)


_GX, _GY = sample_grid_np()
_W_SPATIAL = soft_assign_matrix_np()


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``img`` (h, w) at the points ``(xs, ys)``, clamped to its extent; a
    batch of images (L, h, w) takes points that lead with L."""
    h, w = img.shape[-2:]
    x0 = torch.clamp(torch.floor(xs), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    v00, v01 = gather2d(img, yi, xi), gather2d(img, yi, xi + 1)
    v10, v11 = gather2d(img, yi + 1, xi), gather2d(img, yi + 1, xi + 1)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def sift_descriptors(img: torch.Tensor, kps: torch.Tensor, angles: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
    """(K, 128) float32 descriptors of keypoints ``kps`` (K, 2) (x, y); a
    batch of images (L, h, w) takes (L, K, 2) keypoints and gives (L, K, 128)."""
    img = img.to(torch.float32)
    dev = img.device
    gx = torch.as_tensor(_GX, device=dev)
    gy = torch.as_tensor(_GY, device=dev)
    w_spatial = torch.as_tensor(_W_SPATIAL, device=dev)

    hw = (SCL_FCTR * (sizes * 0.5))[..., None, None]  # pixels per spatial bin
    c = torch.cos(angles)[..., None, None]
    s = torch.sin(angles)[..., None, None]
    ox = (c * gx - s * gy) * hw + kps[..., 0, None, None]
    oy = (s * gx + c * gy) * hw + kps[..., 1, None, None]
    patches = bilinear_sample(img, ox, oy)  # (..., K, P, P)

    dx = torch.gradient(patches, dim=-1)[0]
    dy = torch.gradient(patches, dim=-2)[0]
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)

    obin = torch.remainder(ori / (2 * math.pi) * N_ORI, N_ORI)
    o0 = torch.floor(obin)
    fo = obin - o0
    o0 = torch.remainder(o0.to(torch.int64), N_ORI)
    o1 = torch.remainder(o0 + 1, N_ORI)
    ow = (torch.nn.functional.one_hot(o0, N_ORI) * (1.0 - fo)[..., None]
          + torch.nn.functional.one_hot(o1, N_ORI) * fo[..., None]) * mag[..., None]

    lead = kps.shape[:-1]
    hist = torch.einsum("kso,sb->kbo", ow.reshape(-1, PATCH * PATCH, N_ORI), w_spatial)
    desc = hist.reshape(*lead, D_SPATIAL * D_SPATIAL * N_ORI)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6)
    desc = torch.clamp(desc, max=MAG_THRESH)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-6) * INT_FCTR
