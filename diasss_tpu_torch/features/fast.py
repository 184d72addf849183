"""FAST-9 corner score: the plain torch version and the device dispatch.

:func:`fast_score_plain` is the torch port of
:func:`diasss_tpu.features.fast.fast_score`: the 16 Bresenham-circle shifts
are ``torch.roll`` (so they wrap at the borders, like the JAX version), and the
segment test takes the min/max over every circular 9-of-16 arc.

:func:`fast_score` is what the detector calls: for a CPU tensor it runs the
plain version; for a CUDA tensor it launches the hand-written kernel of
:mod:`.fast_cuda` (which raises on anything it does not take).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 as (dx, dy), clockwise from 12 o'clock
# (OpenCV order; the same table as diasss_tpu.features.fast.CIRCLE)
CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
N_CONTIG = 9


def fast_score_plain(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score map (OpenCV's "largest threshold that keeps it a corner");
    0 where the segment test fails.  Borders wrap; callers mask a 3-px frame."""
    img = img.to(torch.float32)
    circ = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for (dx, dy) in CIRCLE], dim=-1)
    diff = circ - img[..., None]  # (N, M, 16)
    d2 = torch.cat([diff, diff], dim=-1)
    arc_min = torch.stack([d2[..., s : s + N_CONTIG].amin(-1) for s in range(16)], dim=-1)
    arc_max = torch.stack([d2[..., s : s + N_CONTIG].amax(-1) for s in range(16)], dim=-1)
    score = torch.maximum(arc_min.amax(-1), -arc_max.amin(-1))
    return torch.where(score > threshold, score, torch.zeros_like(score))


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score map: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if img.device.type == "cpu":
        return fast_score_plain(img, threshold)
    from .fast_cuda import fast9_score

    return fast9_score(img, threshold)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (max-pool with -inf padding)."""
    local_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= local_max, score, torch.zeros_like(score))
