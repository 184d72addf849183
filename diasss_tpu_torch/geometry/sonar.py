"""Side-scan sonar imaging geometry on torch tensors.

Counterpart of :mod:`diasss_tpu.geometry.sonar`.  A waterfall has M columns;
columns ``[M/2, M)`` are starboard.  The ground-range index of column ``j`` is
``|j - M/2|`` clamped to ``[0, M/2 - 1]`` (the reference reads one past the
table at port column 0; this clamps).
"""

from __future__ import annotations

import math

import torch


def ground_range_index(col: torch.Tensor, n_bins) -> torch.Tensor:
    """``n_bins``: an int, or a tensor of bin counts that broadcasts against
    ``col`` (one per entry, on a survey whose lines differ in bin count)."""
    half = n_bins // 2
    # two clamps, no host-made tensor: a CUDA graph can capture it
    return torch.clamp(torch.clamp(torch.abs(col - half), max=half - 1), min=0)


def is_starboard(col: torch.Tensor, n_bins: int) -> torch.Tensor:
    return col >= (n_bins // 2)


def slant_range(alt: torch.Tensor, ground_range: torch.Tensor) -> torch.Tensor:
    """``sqrt(altitude^2 + ground_range^2)``."""
    return torch.sqrt(alt * alt + ground_range * ground_range)


def slant_range_at(ping, col, altitudes, ground_ranges, n_bins: int) -> torch.Tensor:
    """Slant range of keypoints at integer (ping, col)."""
    return slant_range(altitudes[ping], ground_ranges[ground_range_index(col, n_bins)])


def nadir_mask(col_s, col_t, n_gr_s: int, n_gr_t: int, nd_thres: int = 20):
    """Keep pairs whose columns are >= ``nd_thres`` bins from the nadir line."""
    return (torch.abs(col_s - n_gr_s) >= nd_thres) & (torch.abs(col_t - n_gr_t) >= nd_thres)


def geo_image(
    pose_xy: torch.Tensor,
    pose_yaw: torch.Tensor,
    ground_ranges: torch.Tensor,
    n_bins: int,
    tf_stb=None,
    tf_port=None,
) -> torch.Tensor:
    """Flat-seafloor geo-referencing of a waterfall: (..., N, M, 2) world (x, y).

    ``pose_xy`` (..., N, 2), ``pose_yaw`` (..., N), ``ground_ranges`` (..., G);
    leading dims batch frames.  Starboard columns look along ``yaw + pi/2``,
    port columns along ``yaw - pi/2``.  ``tf_stb`` / ``tf_port``: optional
    (3,) sensor lever arms (tensors or array-likes, zero where not given),
    whose x, y are subtracted from the pose on their side as
    frame.cpp:141-149 does (the reference sets them to zero,
    frame.cpp:38-39).
    """
    dtype, dev = pose_xy.dtype, pose_xy.device
    cols = torch.arange(n_bins, device=dev)
    stb = is_starboard(cols, n_bins)
    gr = ground_ranges[..., ground_range_index(cols, n_bins)].to(dtype)  # (..., M)
    quarter = torch.tensor(math.pi / 2, dtype=dtype, device=dev)  # pi/2 in dtype, not through float32
    side = torch.where(stb, quarter, -quarter)
    ang = pose_yaw[..., :, None] + side

    def lever(tf):
        return torch.zeros(2, dtype=dtype, device=dev) if tf is None else torch.as_tensor(tf, device=dev).to(dtype)[:2]

    lever_xy = torch.where(stb[:, None], lever(tf_stb), lever(tf_port))  # (M, 2)
    x = pose_xy[..., :, None, 0] - lever_xy[:, 0] + gr[..., None, :] * torch.cos(ang)
    y = pose_xy[..., :, None, 1] - lever_xy[:, 1] + gr[..., None, :] * torch.sin(ang)
    return torch.stack([x, y], dim=-1)


def geo_bbox(geo: torch.Tensor) -> torch.Tensor:
    """Axis-aligned extent of geo images: (..., N, M, 2) -> (..., 4)
    ``[x_min, x_max, y_min, y_max]``."""
    x = geo[..., 0].flatten(-2)
    y = geo[..., 1].flatten(-2)
    return torch.stack([x.amin(-1), x.amax(-1), y.amin(-1), y.amax(-1)], dim=-1)


def bbox_iou_overlap(geo_a: torch.Tensor, geo_b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bbox IoU of two frames' geo extents (util.cpp:13-43);
    0 where the boxes do not overlap."""
    ax_min, ax_max, ay_min, ay_max = geo_bbox(geo_a).unbind(-1)
    bx_min, bx_max, by_min, by_max = geo_bbox(geo_b).unbind(-1)
    x_ol = torch.minimum(ax_max, bx_max) - torch.maximum(ax_min, bx_min)
    y_ol = torch.minimum(ay_max, by_max) - torch.maximum(ay_min, by_min)
    area_ol = x_ol * y_ol
    area_a = torch.abs(ax_max - ax_min) * torch.abs(ay_max - ay_min)
    area_b = torch.abs(bx_max - bx_min) * torch.abs(by_max - by_min)
    iou = area_ol / (area_a + area_b - area_ol)
    return torch.where((x_ol > 0) & (y_ol > 0), iou, torch.zeros_like(iou))


def project_landmark_geo(pose_xy, pose_yaw, col, ground_ranges, n_bins):
    """Geo (x, y) of the pixel at column ``col`` under pose (xy, yaw) — the
    evaluator's re-projection, with the reference's extra ``-pi`` side flip.
    ``ground_ranges`` is one (G,) table or one table per column entry
    (..., G); ``n_bins`` an int or one bin count per column entry."""
    half = n_bins // 2
    # a table shorter than the bin count's half (another line's) is read
    # clamped to its last entry, as the JAX package's gather reads it
    idx = torch.clamp(ground_range_index(col, n_bins), max=ground_ranges.shape[-1] - 1)
    if ground_ranges.dim() == 1:
        gr = ground_ranges[idx]
    else:
        gr = torch.gather(ground_ranges, -1, idx[..., None])[..., 0]
    ang = torch.where(col < half, pose_yaw + math.pi / 2 - math.pi, pose_yaw - math.pi / 2 - math.pi)
    return torch.stack([pose_xy[..., 0] + gr * torch.cos(ang), pose_xy[..., 1] + gr * torch.sin(ang)], dim=-1)
