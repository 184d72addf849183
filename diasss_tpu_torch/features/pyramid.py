"""Image pyramid and Gaussian blur (ORBextractor.cpp:1115-1140, 1092).

Counterpart of :mod:`diasss_tpu.features.pyramid`.  The bilinear resize
rebuilds the separable weight matrices of ``jax.image.resize(method="linear",
antialias=False)`` (half-pixel centres, triangle kernel, per-output
normalisation) with the same float32 operations, so the weights are
bit-identical, and applies them as two matrix products in the order JAX's
einsum path takes.  The blur is a separable reflect-101 convolution.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(shape, n_levels: int, scale_factor: float) -> List[tuple]:
    """cvRound-compatible level sizes (ORBextractor.cpp:1120)."""
    h, w = shape
    out = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor**lvl)
        out.append((int(np.rint(h * s)), int(np.rint(w * s))))
    return out


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 linear-resize weights, computed exactly as
    ``jax._src.image.scale.compute_weight_mat`` does with antialias off."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * float(inv_scale) - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of a 2-D float32 image to ``shape`` (no antialiasing)."""
    n, m = img.shape
    h, w = shape
    if (h, w) == (n, m):
        return img
    w_rows = resize_weights(n, h, img.device) if h != n else None
    w_cols = resize_weights(m, w, img.device) if w != m else None
    if w_rows is None:
        return img @ w_cols
    if w_cols is None:
        return w_rows.T @ img
    # contraction order of the cheaper einsum path: rows first costs
    # M*h*(N + w), columns first N*w*(M + h)
    if m * h * (n + w) <= n * w * (m + h):
        return (w_rows.T @ img) @ w_cols
    return w_rows.T @ (img @ w_cols)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> List[torch.Tensor]:
    """Successive bilinear resizes, each level from the previous one."""
    img = img.to(torch.float32)
    shapes = pyramid_shapes(tuple(img.shape), n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[lvl]))
    return levels


def gaussian_kernel1d(ksize: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ksize: int = 13, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 padding (cv BORDER_REFLECT_101).

    A convolution: on a CUDA tensor it runs through cuDNN, so callers that
    want float32 results turn ``torch.backends.cudnn.allow_tf32`` off."""
    k = gaussian_kernel1d(ksize, sigma, img.device)
    pad = ksize // 2
    x = img.to(torch.float32)[None, None]
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="reflect"), k.reshape(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="reflect"), k.reshape(1, 1, 1, -1))
    return x[0, 0]
