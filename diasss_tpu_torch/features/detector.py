"""Feature detector orchestration — the ORBextractor::operator() equivalent.

Counterpart of :mod:`diasss_tpu.features.detector`.  FAST-9 at two
thresholds with the 3-px frame zeroed and 3x3 NMS for every pyramid level of
the frame in one :func:`.fast.fast_two_threshold` call (one kernel launch on
the card); then per level: cells with no corner at the initial threshold
fall back to the minimum threshold, cell-tiled top-K selection with a
per-cell cap, intensity-centroid orientation, and SIFT or steered binary
(ORB) descriptors on the blurred level.  Keypoint capacity is static
(``n_features``) with a validity mask.

Two layouts give bit-identical valid keypoints: per level (the default),
and ``stacked``, the counterpart of the JAX package's single-program
layout: the levels replicate-padded to one shape (the JAX package's, its
64-row rounding included) and each step after the FAST kernel run once for
all levels as one batch, so the torch stage's launches do not grow with the
level count.  Its descriptors read the padded images and match the
per-level ones to float tolerance.

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
    """Top-``k_level`` responses of one level's ``score`` (n, m) with a
    per-cell cap (:func:`_select_batched`).  Returns (xy, resp, valid)."""
    n, m = score.shape
    dims = torch.tensor([[cell_cap, n, m]], device=score.device)
    return tuple(x[0] for x in _select_batched(score[None], k_level, cell_size, cell_cap, edge, dims))


def _select_batched(score: torch.Tensor, k: int, cell_size: int, cap_max: int, edge: int,
                    dims: torch.Tensor):
    """Top-``k`` responses of each map of ``score`` (L, n, m), level l with
    at most ``dims[l, 0]`` keypoints per (cell_size x cell_size) cell and
    its true extent ``dims[l, 1:]`` (the map is zero past it): per-cell
    top-``cap_max`` over the tiles (ranks past the level's cap dropped),
    then a global top-k over the cell-major, rank-major candidates.
    Returns (xy (L, k, 2), resp (L, k), valid (L, k))."""
    L, n, m = score.shape
    dev = score.device
    cap, h, w = (dims[:, i, None, None] for i in range(3))
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(m, device=dev)[None, :]
    border = (rows < edge) | (rows >= h - edge) | (cols < edge) | (cols >= w - edge)
    score = torch.where(border, torch.zeros_like(score), score)

    cs = cell_size
    n_cy, n_cx = -(-n // cs), -(-m // cs)
    sc = F.pad(score, (0, n_cx * cs - m, 0, n_cy * cs - n))
    tiles = sc.reshape(L, n_cy, cs, n_cx, cs).permute(0, 1, 3, 2, 4).reshape(L, -1, cs * cs)

    cell_vals, cell_pos = top_k(tiles, cap_max)  # (L, C, cap_max)
    keep = (torch.arange(cap_max, device=dev) < cap) & (cell_vals > 0.0)
    cand = torch.where(keep, cell_vals, torch.zeros_like(cell_vals)).reshape(L, -1)
    if cand.shape[1] < k:  # tiny images: fewer candidate slots than k
        cand = F.pad(cand, (0, k - cand.shape[1]))

    top_vals, top_idx = top_k(cand, k)
    cell = top_idx // cap_max
    # padded slots index past the last cell: the gather clamps, as JAX's does
    slot = torch.clamp(cell, max=cell_pos.shape[1] - 1) * cap_max + top_idx % cap_max
    within = torch.gather(cell_pos.reshape(L, -1), 1, slot)
    ys = (cell // n_cx) * cs + within // cs
    xs = (cell % n_cx) * cs + within % cs
    return torch.stack([xs, ys], -1).to(torch.float32), top_vals, top_vals > 0.0


def _combine_two_threshold(s_hi: torch.Tensor, s_lo: torch.Tensor, cell_size: int) -> torch.Tensor:
    """The initial-threshold map, falling back to the minimum-threshold map in
    cells with no initial-threshold corner (ORBextractor.cpp:806-816).  Cells
    are anchored at (0, 0).  Maps (n, m), or a batch (L, n, m)."""
    n, m = s_hi.shape[-2:]
    pad_r = -(-n // cell_size) * cell_size - n
    pad_c = -(-m // cell_size) * cell_size - m
    padded = F.pad(s_hi, (0, pad_c, 0, pad_r)).reshape(-1, 1, n + pad_r, m + pad_c)
    has_hi = (F.max_pool2d(padded, cell_size) > 0).reshape(*s_hi.shape[:-2], -1, (m + pad_c) // cell_size)
    full = has_hi.repeat_interleave(cell_size, -2).repeat_interleave(cell_size, -1)[..., :n, :m]
    return torch.where(full, s_hi, s_lo)


def _descriptors(blurred: torch.Tensor, xy: torch.Tensor, ang: torch.Tensor, sizes: torch.Tensor,
                 cfg: DetectorConfig) -> torch.Tensor:
    """SIFT, ORB or (for ``"geo_patch"``) (..., K, 1) zero descriptors;
    ``blurred`` (n, m) or a batch (L, n, m)."""
    if cfg.descriptor == "geo_patch":
        # the dense matcher reads world patches from the raster, not from here
        return torch.zeros((*xy.shape[:-1], 1), dtype=torch.float32, device=xy.device)
    describe = orb_descriptors if cfg.descriptor == "orb" else sift_descriptors
    return describe(blurred, xy, ang, sizes)


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
    blurred = None if cfg.descriptor == "geo_patch" else gaussian_blur(limg, cfg.blur_ksize, cfg.blur_sigma)
    sizes = torch.full((k_level,), size_lvl * cfg.desc_size_scale, dtype=torch.float32, device=dev)
    desc = _descriptors(blurred, xy, ang, sizes, cfg)
    return DetectedFeatures(
        xy=xy * scale,
        response=resp,
        angle=ang,
        size=torch.full((k_level,), size_lvl, dtype=torch.float32, device=dev),
        level=torch.full((k_level,), lvl, dtype=torch.int32, device=dev),
        desc=desc,
        valid=valid,
    )


def _pad_replicate(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``img`` padded to (H, W) by repeating its last row and column: what
    the edge-clamped reads of the patch extractors see past its extent."""
    h, w = img.shape
    yi = torch.clamp(torch.arange(H, device=img.device), max=h - 1)
    xi = torch.clamp(torch.arange(W, device=img.device), max=w - 1)
    return img[yi[:, None], xi[None, :]]


def _detect_stacked(levels, scores, used, per_level, cfg: DetectorConfig) -> DetectedFeatures:
    """Keypoints of the ``used`` levels from their FAST maps, every step run
    once over the levels padded to the JAX package's common shape: height
    the largest level height rounded up to 64 rows, width level 0's.  The
    FAST maps are zero past each level's FAST frame, so zero padding gives
    the JAX layout's maps; the images are replicate-padded, the blurred
    ones blurred at their true shape first.  Each level selects the
    largest level budget ``k_max``; its first ``k_level`` rows are its own
    top-k (the selection's sort is stable)."""
    dev = levels[0].device
    shapes = [tuple(l.shape) for l in levels]
    caps = [_cell_cap(h, w, k, cfg.cell_size) for (h, w), k in zip(shapes, per_level)]
    Hp = max(-(-h // 64) * 64 for h, _ in shapes)
    Wp = shapes[0][1]
    k_max = max(per_level)

    def stack(maps):
        return torch.stack([F.pad(x, (0, Wp - x.shape[1], 0, Hp - x.shape[0])) for x in maps])

    score = _combine_two_threshold(stack([s[0] for s in scores]), stack([s[1] for s in scores]), cfg.cell_size)
    dims = torch.tensor([[caps[l], *shapes[l]] for l in used], device=dev)
    xy, resp, valid = _select_batched(score, k_max, cfg.cell_size, max(caps), cfg.edge_threshold, dims)
    raw = torch.stack([_pad_replicate(levels[l], Hp, Wp) for l in used])
    ang = ic_angles(raw, xy)
    scales = [cfg.scale_factor**l for l in used]
    blurred = None
    if cfg.descriptor != "geo_patch":
        blurred = torch.stack([_pad_replicate(gaussian_blur(levels[l], cfg.blur_ksize, cfg.blur_sigma), Hp, Wp)
                               for l in used])
    sizes = torch.tensor([[PATCH_SIZE * sc * cfg.desc_size_scale] for sc in scales], dtype=torch.float32,
                         device=dev).expand(len(used), k_max)
    desc = _descriptors(blurred, xy, ang, sizes, cfg)
    parts = []
    for i, (l, sc) in enumerate(zip(used, scales)):
        k = per_level[l]
        parts.append(DetectedFeatures(
            xy=xy[i, :k] * sc, response=resp[i, :k], angle=ang[i, :k],
            size=torch.full((k,), PATCH_SIZE * sc, dtype=torch.float32, device=dev),
            level=torch.full((k,), l, dtype=torch.int32, device=dev), desc=desc[i, :k], valid=valid[i, :k]))
    return DetectedFeatures(*[torch.cat([getattr(p, f) for p in parts]) for f in DetectedFeatures._fields])


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
    attached by the pipeline).  ``stacked`` runs the steps after the FAST
    kernel once over all levels padded to one shape (:func:`_detect_stacked`)
    instead of once per level."""
    img = norm_img.to(torch.float32)
    per_level = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    used = [lvl for lvl, k_level in enumerate(per_level) if k_level > 0]
    scores = fast_two_threshold([levels[lvl].contiguous() for lvl in used], float(cfg.ini_fast_threshold),
                                float(cfg.min_fast_threshold))
    if stacked:
        feats = _detect_stacked(levels, scores, used, per_level, cfg)
    else:
        parts = [_detect_level(levels[lvl], s, lvl, per_level[lvl], cfg) for lvl, s in zip(used, scores)]
        feats = DetectedFeatures(*[torch.cat([getattr(p, f) for p in parts]) for f in DetectedFeatures._fields])
    if mask is not None:
        xi = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, mask.shape[1] - 1)
        yi = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, mask.shape[0] - 1)
        feats = feats._replace(valid=feats.valid & mask[yi, xi])
    return feats
