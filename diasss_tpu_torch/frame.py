"""Keyframe data model and waterfall preprocessing on torch tensors.

Counterpart of :mod:`diasss_tpu.frame` (device path only):

* :func:`normalize_sss` — frame.cpp:57-81
* :func:`filtered_mask` — frame.cpp:83-124 (the box-OR dilation is a
  ``max_pool2d`` of the bright map as float)
* geo-referencing via :func:`.geometry.sonar.geo_image`
* :func:`normalize_columns` — the column-wise normalizer of the mosaic
* :func:`_normalize_sss_np` — :func:`normalize_sss` in numpy, for the
  bench's CPU proxy of the reference (:mod:`.bench`)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import trace
from .config import MaskConfig, NormalizeConfig

from .geometry import sonar


class Keyframe(NamedTuple):
    """One survey line: device tensors + host-side metadata (field names and
    layouts as :class:`diasss_tpu.frame.Keyframe`)."""

    img_id: int
    raw: torch.Tensor  # (N, M) raw intensities (float32 unless built in another dtype)
    norm: torch.Tensor  # (N, M) uint8 normalized image
    mask: torch.Tensor  # (N, M) bool keypoint-validity mask
    geo: torch.Tensor  # (N, M, 2) world (x, y) per pixel
    dr_poses: torch.Tensor  # (N, 6) dead-reckoning rows (r, p, y, x, y, z)
    altitudes: torch.Tensor  # (N,)
    ground_ranges: torch.Tensor  # (M//2,)
    annos: np.ndarray  # (Ka, 7) int annotation rows, host-side


def normalize_sss(raw: torch.Tensor, cfg: NormalizeConfig = NormalizeConfig()) -> torch.Tensor:
    """``(x - min) / (mean*2.5 - min) * 255`` clipped to [0, 255], rounded
    half-to-even to uint8; ``raw`` is (..., N, M), reduced per image."""
    raw = raw.to(torch.float32)
    flat = raw.flatten(-2)
    mn = flat.amin(-1)[..., None, None]
    max_used = flat.mean(-1)[..., None, None] * cfg.mean_factor
    out = torch.clamp((raw - mn) / (max_used - mn) * 255.0, 0.0, 255.0)
    return torch.round(out).to(torch.uint8)


def _normalize_sss_np(raws: np.ndarray, cfg: NormalizeConfig) -> np.ndarray:
    """Host (numpy) mirror of :func:`normalize_sss` over a stacked (F, N, M)
    batch, the bench's reference proxy's normalization: the JAX package's
    ``_normalize_sss_np`` operation for operation (float32, ``np.round``
    half-to-even), so equal to it bit for bit."""
    raws = raws.astype(np.float32)
    flat = raws.reshape(raws.shape[0], -1)
    mn = flat.min(axis=1)[:, None, None]
    max_used = flat.mean(axis=1, dtype=np.float32)[:, None, None] * cfg.mean_factor
    out = (raws - mn) / (max_used - mn) * 255.0
    np.clip(out, 0.0, 255.0, out=out)
    return np.round(out).astype(np.uint8)


def normalize_columns(raw: torch.Tensor) -> torch.Tensor:
    """Column-wise mean normalization + clip [0, 3] + rescale to [0, 255],
    rounded half-to-even to uint8: the reference's ``Util::NormalizeConvertSSS``
    (util.cpp:339-417, rs_by_column with clip)."""
    raw = raw.to(torch.float32)
    col_mean = raw.sum(0, keepdim=True) * (1.0 / raw.shape[0])  # as XLA's mean: times the reciprocal
    x = raw / torch.clamp(col_mean, min=1e-12)
    x = torch.clamp(x, 0.0, 3.0)
    mn, mx = x.amin(), x.amax()
    x = (x - mn) * (255.0 / torch.clamp(mx - mn, min=1e-12))
    return torch.round(x).to(torch.uint8)


def _clamped_margin(ref_margin: int, dim: int) -> int:
    return ref_margin if dim - 2 * ref_margin >= dim // 4 else dim // 4


def filtered_mask(raw: torch.Tensor, cfg: MaskConfig = MaskConfig()) -> torch.Tensor:
    """Binary keypoint-validity mask of (..., N, M) images: bright-pixel box
    dilation, nadir stripe, first/last pings and side columns are masked out
    (same rules and short-line margin clamp as the JAX package)."""
    raw = raw.to(torch.float32)
    n, m = raw.shape[-2:]
    lead = raw.shape[:-2]
    mean = raw.flatten(-2).mean(-1)[..., None, None]
    bright = (raw > mean * cfg.bright_factor).to(torch.float32)
    r = cfg.bright_radius
    dilated = F.max_pool2d(bright.reshape(-1, 1, n, m), 2 * r + 1, stride=1, padding=r)
    dilated = dilated.reshape(*lead, n, m) > 0
    rows = torch.arange(n, device=raw.device)[:, None]
    cols = torch.arange(m, device=raw.device)[None, :]
    center = (cols > m // 2 - cfg.center_width) & (cols < m // 2 + cfg.center_width)
    side_p = _clamped_margin(cfg.side_pings, n)
    turn = (rows < side_p) | (rows > n - side_p)
    side_c = _clamped_margin(int(cfg.side_pings * cfg.side_cols_frac), m)
    sides = (cols < side_c) | (cols > m - side_c)
    return ~(dilated | center | turn | sides)


def build_keyframes_batch(
    items,
    norm_cfg: NormalizeConfig = NormalizeConfig(),
    mask_cfg: MaskConfig = MaskConfig(),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
):
    """Keyframes for ``items`` = ``(img_id, raw, dr_poses, altitudes,
    ground_ranges[, annos])`` tuples, on the card unless ``device`` says
    otherwise.  Equal-shape lines are stacked and preprocessed as one batch;
    mixed shapes fall back to per-frame builds.  The raw image, poses,
    altitudes, ground ranges and geo are in ``dtype``; normalization and
    the mask work in float32 whatever it is, as the JAX package's do."""
    with trace.span("frame.build_keyframes"):
        shapes = {(np.shape(it[1]), np.shape(it[2]), np.shape(it[3])) for it in items}
        if len(shapes) != 1:
            return [build_keyframe(*it, norm_cfg=norm_cfg, mask_cfg=mask_cfg, dtype=dtype, device=device)
                    for it in items]

        def up(k):
            return torch.as_tensor(np.stack([it[k] for it in items]), dtype=dtype, device=device)

        raws, poses, alts, grs = up(1), up(2), up(3), up(4)
        norms = normalize_sss(raws, norm_cfg)
        masks = filtered_mask(raws, mask_cfg)
        geos = sonar.geo_image(poses[..., 3:5], poses[..., 2], grs, raws.shape[-1])
        out = []
        for k, it in enumerate(items):
            annos = it[5] if len(it) > 5 else None
            out.append(Keyframe(
                img_id=it[0], raw=raws[k], norm=norms[k], mask=masks[k], geo=geos[k],
                dr_poses=poses[k], altitudes=alts[k], ground_ranges=grs[k],
                annos=np.zeros((0, 7), np.int64) if annos is None else np.asarray(annos),
            ))
        return out


def build_keyframe(
    img_id: int,
    raw: np.ndarray,
    dr_poses: np.ndarray,
    altitudes: np.ndarray,
    ground_ranges: np.ndarray,
    annos: Optional[np.ndarray] = None,
    norm_cfg: NormalizeConfig = NormalizeConfig(),
    mask_cfg: MaskConfig = MaskConfig(),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Keyframe:
    """One keyframe: upload the line and run normalize + mask + geo."""
    return build_keyframes_batch(
        [(img_id, raw, dr_poses, altitudes, ground_ranges, annos)],
        norm_cfg=norm_cfg, mask_cfg=mask_cfg, dtype=dtype, device=device,
    )[0]
