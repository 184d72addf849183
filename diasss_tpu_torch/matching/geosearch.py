"""Geo-gated nearest-neighbour descriptor search (FEAmatcher.cpp:52-138).

Counterpart of :mod:`diasss_tpu.matching.geosearch` for the ``"l2"`` (SIFT)
metric: candidates are reference keypoints within the geo radius; the best
L2 match wins if it passes the distance bound and the first/second ratio test,
with the single-candidate escape hatch.  Batched over any leading pair dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diasss_tpu.config import MatcherConfig

_BIG = 1e9


class NNResult(NamedTuple):
    corres: torch.Tensor  # (..., K) int64 index into ref kps, -1 if none
    n_candidates: torch.Tensor  # (..., K) geo-gated candidate counts
    best_dist: torch.Tensor  # (..., K) float32


def check_metric(cfg: MatcherConfig) -> None:
    if cfg.desc_metric != "l2":
        raise NotImplementedError(
            f"desc_metric={cfg.desc_metric!r} is not ported yet (ROADMAP A11: the "
            "hamming/orb and ncc/geo_patch descriptor families); only 'l2' (SIFT) is"
        )


def nn_core(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox, bound, cfg: MatcherConfig) -> NNResult:
    """NN search of query keypoints (..., K) against reference keypoints
    (..., Kr); ``ref_bbox`` (..., 4) and ``bound`` (...) batch with them.

    The best candidate is the first index among equal distances and the
    second-best is the minimum over the rest — the values ``lax.top_k(-d, 2)``
    returns (``torch.argmin`` returns the first minimal index)."""
    check_metric(cfg)
    d2 = torch.sum((geo_q[..., :, None, :] - geo_r[..., None, :, :]) ** 2, dim=-1)
    gate = (d2 < cfg.geo_radius**2) & valid_q[..., :, None] & valid_r[..., None, :]
    bb = ref_bbox[..., None, :]
    in_bbox = (
        (geo_q[..., 0] >= bb[..., 0]) & (geo_q[..., 0] <= bb[..., 1])
        & (geo_q[..., 1] >= bb[..., 2]) & (geo_q[..., 1] <= bb[..., 3])
    )
    gate = gate & in_bbox[..., :, None]

    q2 = torch.sum(desc_q * desc_q, dim=-1)
    r2 = torch.sum(desc_r * desc_r, dim=-1)
    cross = desc_q @ desc_r.transpose(-1, -2)
    dist = torch.sqrt(torch.clamp(q2[..., :, None] + r2[..., None, :] - 2.0 * cross, min=0.0))
    big = torch.full_like(dist, _BIG)
    masked = torch.where(gate, dist, big)

    best_id = torch.argmin(masked, dim=-1)
    best = torch.gather(masked, -1, best_id[..., None])[..., 0]
    if cfg.ratio_excl_radius > 0.0:
        # second-best excludes the best's spatial neighbourhood
        best_geo = torch.gather(geo_r, -2, best_id[..., None].expand(*best_id.shape, 2))
        near_best = (
            torch.sum((geo_r[..., None, :, :] - best_geo[..., :, None, :]) ** 2, dim=-1)
            < cfg.ratio_excl_radius**2
        )
        second = torch.where(near_best, big, masked).amin(-1)
    elif masked.shape[-1] >= 2:
        second = masked.scatter(-1, best_id[..., None], _BIG).amin(-1)
    else:
        second = torch.full_like(best, _BIG)
    n_cand = gate.sum(-1)

    ratio_ok = best / torch.clamp(second, min=1e-9) <= cfg.ratio_test
    bound = torch.as_tensor(bound, dtype=dist.dtype, device=dist.device)[..., None]
    ok = ((best < bound) & ratio_ok & (n_cand >= 1)) | ((n_cand == 1) & (best < bound))
    return NNResult(
        corres=torch.where(ok, best_id, torch.full_like(best_id, -1)),
        n_candidates=n_cand,
        best_dist=best,
    )


def geo_nn_search(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox,
                  cfg: MatcherConfig = MatcherConfig()) -> NNResult:
    """Single-pair search with the SIFT distance bound."""
    return nn_core(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox, cfg.sift_dist_bound, cfg)
