"""Sliding Compatibility Check — vectorized multi-hypothesis RANSAC
(FEAmatcher.cpp:185-317).

Counterpart of :mod:`diasss_tpu.matching.scc`.  The model is the along-track
(ping) offset between matched keypoints, parity-flipped for opposite-heading
lines; with ``scc_mode="xy"`` also the bin offset (3 samples per hypothesis).
The ``(H, S)`` hypothesis sample indices come from the ``rng`` object
(:mod:`..rng`), drawn uniformly over the matched keypoints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatcherConfig


class SCCResult(NamedTuple):
    corres: torch.Tensor  # (..., K), filtered to the consensus inliers
    inlier_count: torch.Tensor  # (...) int
    model_x: torch.Tensor  # (...) float32


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[..., idx]`` along the last dim with ``idx`` (..., *rest) batched
    like ``v``'s leading dims."""
    flat = idx.reshape(*idx.shape[: v.dim() - 1], -1)
    return torch.gather(v, -1, flat).reshape(idx.shape)


def scc_filter(
    kp_y_q: torch.Tensor,  # (..., K) query keypoint ping coords
    kp_y_r: torch.Tensor,  # (..., Kr) reference keypoint ping coords
    corres: torch.Tensor,  # (..., K) from the NN search, -1 = unmatched
    parity_flip: torch.Tensor,  # (...) bool
    ref_rows: torch.Tensor,  # (...) float reference image row count
    rng,
    cfg: MatcherConfig = MatcherConfig(),
    kp_x_q: torch.Tensor | None = None,
    kp_x_r: torch.Tensor | None = None,
) -> SCCResult:
    matched = corres >= 0
    cc = torch.clamp(corres, min=0)
    y_r = _take(kp_y_r, cc)
    y_ref = torch.where(parity_flip[..., None], ref_rows[..., None] - y_r + 1.0, y_r)
    x_val = torch.abs(kp_y_q - y_ref)  # (..., K)

    use_xy = cfg.scc_mode == "xy" and kp_x_q is not None and kp_x_r is not None
    n_samples = 3 if use_xy else cfg.scc_samples
    samples = rng.categorical_matched(matched, cfg.scc_max_iters, n_samples)  # (..., H, S)
    model_x = _take(x_val, samples).sum(-1) / n_samples  # (..., H)

    inl = (torch.abs(model_x[..., :, None] - x_val[..., None, :]) <= cfg.scc_pix_error) & matched[..., None, :]
    if use_xy:
        y_val = torch.abs(kp_x_q - _take(kp_x_r, cc))
        model_y = _take(y_val, samples).sum(-1) / n_samples
        inl = inl & (torch.abs(model_y[..., :, None] - y_val[..., None, :]) <= cfg.scc_pix_error_y)
    any_match = matched.any(-1)
    counts = torch.where(any_match[..., None], inl.sum(-1), torch.zeros_like(inl.sum(-1)))

    best_h = torch.argmax(counts, dim=-1)  # first max wins, like the strict '<' update
    best_inl = torch.gather(inl, -2, best_h[..., None, None].expand(*best_h.shape, 1, inl.shape[-1]))[..., 0, :]
    best_inl = best_inl & matched
    best_model = torch.gather(model_x, -1, best_h[..., None])[..., 0]
    return SCCResult(
        corres=torch.where(best_inl, corres, torch.full_like(corres, -1)),
        inlier_count=torch.gather(counts, -1, best_h[..., None])[..., 0],
        model_x=torch.where(any_match, best_model, torch.zeros_like(best_model)),
    )
