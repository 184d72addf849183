"""FAST-9 corner scores: the plain torch version and the device dispatch.

:func:`fast_score_plain` is the torch port of
:func:`diasss_tpu.features.fast.fast_score`: the 16 Bresenham-circle shifts
are ``torch.roll`` (so they wrap at the borders, like the JAX version), and the
segment test takes the min/max over every circular 9-of-16 arc.

:func:`fast_two_threshold` is what the detector calls: for every pyramid level
of one frame, the score at both FAST thresholds with the 3-px frame zeroed
and 3x3 non-maximum suppression applied.  For CPU tensors it runs
:func:`fast_two_threshold_plain`; for CUDA tensors it launches the
hand-written kernel of :mod:`.fast_cuda` once for all levels (which raises on
anything it does not take).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 as (dx, dy), clockwise from 12 o'clock
# (OpenCV order; the same table as diasss_tpu.features.fast.CIRCLE)
CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
N_CONTIG = 9
FAST_FRAME = 3  # FAST circle radius: scores this close to the border are junk
MAX_LEVELS = 16  # the CUDA kernel's by-value level table (csrc/fast9.cu: MAX_LEVELS)


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


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (max-pool with -inf padding)."""
    local_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= local_max, score, torch.zeros_like(score))


def frame_mask(score: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero scores inside the 3-px FAST frame of the (h, w) extent."""
    n, m = score.shape
    rows = torch.arange(n, device=score.device)[:, None]
    cols = torch.arange(m, device=score.device)[None, :]
    ok = (rows >= FAST_FRAME) & (rows < h - FAST_FRAME) & (cols >= FAST_FRAME) & (cols < w - FAST_FRAME)
    return torch.where(ok, score, torch.zeros_like(score))


def check_levels(levels: Sequence[torch.Tensor]) -> None:
    """Raise on anything :func:`fast_two_threshold` does not take on either
    device: a list or tuple of 1 to ``MAX_LEVELS`` non-empty contiguous 2-D
    float32 tensors of one device."""
    if not isinstance(levels, (list, tuple)):
        raise TypeError(f"fast_two_threshold takes a list of pyramid levels, got {type(levels).__name__}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_two_threshold takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    for i, img in enumerate(levels):
        if not isinstance(img, torch.Tensor):
            raise TypeError(f"fast_two_threshold takes tensors, got level {i} of type {type(img).__name__}")
        if img.dtype != torch.float32:
            raise TypeError(f"fast_two_threshold takes float32, got level {i} of {img.dtype}")
        if img.dim() != 2 or img.numel() == 0:
            raise ValueError(f"fast_two_threshold takes non-empty 2-D levels, got level {i} of shape "
                             f"{tuple(img.shape)}")
        if not img.is_contiguous():
            raise ValueError(f"fast_two_threshold takes contiguous levels, level {i} is not")
        if img.device != levels[0].device:
            raise ValueError(f"fast_two_threshold takes levels of one device, got {img.device} and "
                             f"{levels[0].device}")


def fast_two_threshold_plain(levels: Sequence[torch.Tensor], ini_t: float,
                             min_t: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per level ``(nms3(frame_mask(fast_score_plain(img, ini_t))),
    nms3(frame_mask(fast_score_plain(img, min_t))))``, the frame of each
    level's own shape.  The segment test runs once per level: thresholding
    the unthresholded score is the same as thresholding inside it."""
    out = []
    for img in levels:
        n, m = img.shape
        raw = fast_score_plain(img, float("-inf"))
        out.append(tuple(nms3(frame_mask(torch.where(raw > t, raw, torch.zeros_like(raw)), n, m))
                         for t in (ini_t, min_t)))
    return out


def fast_two_threshold(levels: Sequence[torch.Tensor], ini_t: float,
                       min_t: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`fast_two_threshold_plain` for CPU tensors; one launch of the
    CUDA kernel for all levels for CUDA tensors."""
    if all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in levels):
        check_levels(levels)
        return fast_two_threshold_plain(levels, ini_t, min_t)
    from .fast_cuda import fast9_two_threshold

    return fast9_two_threshold(levels, ini_t, min_t)
