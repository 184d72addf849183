"""Geo-referenced mosaic of the waterfall images.

Counterpart of :mod:`diasss_tpu.mosaic`: every waterfall pixel has a world
(x, y) from its geo image; intensities are normalized per column
(:func:`.frame.normalize_columns`), bucketed into a world grid and averaged
where frames overlap — a scatter-mean by ``index_add_`` into shared (sum,
count) planes on the frames' device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .frame import Keyframe, normalize_columns


def build_mosaic(frames: List[Keyframe], resolution: float = 0.25, margin: float = 5.0, geo_list=None):
    """Average-intensity world mosaic of all frames.

    ``geo_list`` optionally overrides each frame's geo image: the geo of
    the estimated poses (``pipeline._estimated_geo``) gives the
    drift-corrected map instead of the DR-referenced one.

    Returns (mosaic (H, W) float32 numpy with NaN where no data, x0, y0,
    resolution)."""
    geos = geo_list if geo_list is not None else [f.geo for f in frames]
    ext = torch.stack([torch.stack([g[..., 0].amin(), g[..., 0].amax(), g[..., 1].amin(), g[..., 1].amax()])
                       for g in geos]).cpu().numpy()
    x0 = float(ext[:, 0].min() - margin)
    y0 = float(ext[:, 2].min() - margin)
    width = int((ext[:, 1].max() + margin - x0) / resolution) + 1
    height = int((ext[:, 3].max() + margin - y0) / resolution) + 1

    dev = geos[0].device
    total = torch.zeros(height * width, dtype=torch.float32, device=dev)
    count = torch.zeros(height * width, dtype=torch.float32, device=dev)
    for f, g in zip(frames, geos):
        xi = torch.clamp(((g[..., 0] - x0) / resolution).to(torch.int32), 0, width - 1)
        yi = torch.clamp(((g[..., 1] - y0) / resolution).to(torch.int32), 0, height - 1)
        flat = (yi * width + xi).reshape(-1).to(torch.int64)
        v = normalize_columns(f.raw.to(dev)).to(torch.float32).reshape(-1)
        total.index_add_(0, flat, v)
        count.index_add_(0, flat, torch.ones_like(v))
    mosaic = torch.where(count > 0, total / torch.clamp(count, min=1.0), float("nan"))
    return mosaic.reshape(height, width).cpu().numpy(), x0, y0, resolution


def save_mosaic_png(path: str, mosaic: np.ndarray) -> None:
    """Render the mosaic to a grayscale PNG (NaN = black)."""
    from .viz import write_png

    img = np.nan_to_num(mosaic, nan=0.0)
    mx = img.max() if img.max() > 0 else 1.0
    gray = (img / mx * 255).astype(np.uint8)
    write_png(path, np.repeat(gray[..., None], 3, axis=-1))
