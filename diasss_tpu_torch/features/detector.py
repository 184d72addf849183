"""Feature detector orchestration — the ORBextractor::operator() equivalent.

Counterpart of :mod:`diasss_tpu.features.detector`, per-level layout only.
FAST-9 at two thresholds with the 3-px frame zeroed and 3x3 NMS for every
pyramid level of the frame in one :func:`.fast.fast_two_threshold` call (one
kernel launch on the card); then per level: cells with no corner at the
initial threshold fall back to the minimum threshold, cell-tiled top-K
selection with a per-cell cap, intensity-centroid orientation, and SIFT or
steered binary (ORB) descriptors on the blurred level.  Keypoint capacity
is static (``n_features``) with a validity mask.

``jax.lax.top_k`` puts the lower index first among equal values and the
selection depends on that; ``torch.topk`` promises no tie order, so selection
uses a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DetectorConfig

from .fast import fast_two_threshold
from .orb_desc import orb_descriptors
from .orient import ic_angles
from .pyramid import build_pyramid, gaussian_blur
from .sift import sift_descriptors

PATCH_SIZE = 31  # ORBextractor.cpp PATCH_SIZE


class DetectedFeatures(NamedTuple):
    xy: torch.Tensor  # (K, 2) float32 (x, y) in level-0 coordinates
    response: torch.Tensor  # (K,)
    angle: torch.Tensor  # (K,) radians
    size: torch.Tensor  # (K,) keypoint size (px, level-0 scale convention)
    level: torch.Tensor  # (K,) int32 pyramid level
    desc: torch.Tensor  # (K, D) float32: 128-d SIFT, 256-d +-1 ORB, or geo patches
    valid: torch.Tensor  # (K,) bool


def features_per_level(n_features: int, n_levels: int, scale_factor: float):
    """ORBextractor ctor distribution (ORBextractor.cpp:418-430)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor**n_levels)
    out = []
    acc = 0
    for lvl in range(n_levels - 1):
        k = int(round(n_first * factor**lvl))
        out.append(k)
        acc += k
    out.append(max(n_features - acc, 0))
    return out


def _cell_cap(h: int, w: int, k_level: int, cell_size: int) -> int:
    n_cells = (h // cell_size + 1) * (w // cell_size + 1)
    return max(1, int(np.ceil(3 * k_level / max(n_cells, 1))))


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: largest first, lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_keypoints(score: torch.Tensor, k_level: int, cell_size: int, cell_cap: int,
                      edge: int):
    """Top-``k_level`` responses with a per-cell cap: per-cell top-``cap``
    over (cell_size x cell_size) tiles, then a global top-k over the
    cell-major, rank-major candidates.  Returns (xy, resp, valid)."""
    n, m = score.shape
    dev = score.device
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(m, device=dev)[None, :]
    border = (rows < edge) | (rows >= n - edge) | (cols < edge) | (cols >= m - edge)
    score = torch.where(border, torch.zeros_like(score), score)

    cs = cell_size
    n_cy, n_cx = -(-n // cs), -(-m // cs)
    sc = F.pad(score, (0, n_cx * cs - m, 0, n_cy * cs - n))
    tiles = sc.reshape(n_cy, cs, n_cx, cs).permute(0, 2, 1, 3).reshape(-1, cs * cs)

    cell_vals, cell_pos = top_k(tiles, cell_cap)  # (C, cap)
    keep = cell_vals > 0.0
    cand = torch.where(keep, cell_vals, torch.zeros_like(cell_vals)).reshape(-1)
    if cand.shape[0] < k_level:  # tiny images: fewer candidate slots than k
        cand = F.pad(cand, (0, k_level - cand.shape[0]))

    top_vals, top_idx = top_k(cand, k_level)
    cell = top_idx // cell_cap
    # padded slots index past the last cell: the gather clamps, as JAX's does
    within = cell_pos[torch.clamp(cell, max=cell_pos.shape[0] - 1), top_idx % cell_cap]
    ys = (cell // n_cx) * cs + within // cs
    xs = (cell % n_cx) * cs + within % cs
    return torch.stack([xs, ys], -1).to(torch.float32), top_vals, top_vals > 0.0


def _combine_two_threshold(s_hi: torch.Tensor, s_lo: torch.Tensor, cell_size: int) -> torch.Tensor:
    """The initial-threshold map, falling back to the minimum-threshold map in
    cells with no initial-threshold corner (ORBextractor.cpp:806-816).  Cells
    are anchored at (0, 0)."""
    n, m = s_hi.shape
    pad_r = -(-n // cell_size) * cell_size - n
    pad_c = -(-m // cell_size) * cell_size - m
    has_hi = F.max_pool2d(F.pad(s_hi, (0, pad_c, 0, pad_r))[None, None], cell_size)[0, 0] > 0
    full = has_hi.repeat_interleave(cell_size, 0).repeat_interleave(cell_size, 1)[:n, :m]
    return torch.where(full, s_hi, s_lo)


def _detect_level(limg: torch.Tensor, scores, lvl: int, k_level: int, cfg: DetectorConfig) -> DetectedFeatures:
    """Keypoints of one level from its ``(s_hi, s_lo)`` FAST maps."""
    scale = cfg.scale_factor**lvl
    n, m = limg.shape
    score = _combine_two_threshold(*scores, cfg.cell_size)
    cap = _cell_cap(n, m, k_level, cfg.cell_size)
    xy, resp, valid = _select_keypoints(score, k_level, cfg.cell_size, cap, cfg.edge_threshold)
    ang = ic_angles(limg, xy)
    size_lvl = PATCH_SIZE * scale
    dev = limg.device
    if cfg.descriptor == "geo_patch":
        # the dense matcher reads world patches from the raster, not from here
        desc = torch.zeros((k_level, 1), dtype=torch.float32, device=dev)
    else:
        blurred = gaussian_blur(limg, cfg.blur_ksize, cfg.blur_sigma)
        sizes = torch.full((k_level,), size_lvl * cfg.desc_size_scale, dtype=torch.float32, device=dev)
        describe = orb_descriptors if cfg.descriptor == "orb" else sift_descriptors
        desc = describe(blurred, xy, ang, sizes)
    return DetectedFeatures(
        xy=xy * scale,
        response=resp,
        angle=ang,
        size=torch.full((k_level,), size_lvl, dtype=torch.float32, device=dev),
        level=torch.full((k_level,), lvl, dtype=torch.int32, device=dev),
        desc=desc,
        valid=valid,
    )


def detect_features(
    norm_img: torch.Tensor,
    mask: torch.Tensor | None = None,
    cfg: DetectorConfig = DetectorConfig(),
    stacked: bool = False,
) -> DetectedFeatures:
    """Detect keypoints + descriptors on a normalized waterfall image;
    keypoints outside ``mask`` are invalidated (frame.cpp:184-195).
    ``descriptor="sift"`` computes SIFT descriptors, ``"orb"`` steered
    binary ones; ``"geo_patch"`` returns the (K, 1) zero descriptor, as the
    JAX package does (its world patches are read by the dense matcher or
    attached by the pipeline)."""
    if stacked:
        raise NotImplementedError(
            "detect_features(stacked=True) is not ported: the single-program "
            "layout is on ROADMAP's not-to-port list (measured slower than per-level)"
        )
    img = norm_img.to(torch.float32)
    per_level = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    used = [lvl for lvl, k_level in enumerate(per_level) if k_level > 0]
    scores = fast_two_threshold([levels[lvl].contiguous() for lvl in used], float(cfg.ini_fast_threshold),
                                float(cfg.min_fast_threshold))
    parts = [_detect_level(levels[lvl], s, lvl, per_level[lvl], cfg) for lvl, s in zip(used, scores)]
    feats = DetectedFeatures(*[torch.cat([getattr(p, f) for p in parts]) for f in DetectedFeatures._fields])
    if mask is not None:
        xi = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, mask.shape[1] - 1)
        yi = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, mask.shape[0] - 1)
        feats = feats._replace(valid=feats.valid & mask[yi, xi])
    return feats
