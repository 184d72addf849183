"""Geo-gated nearest-neighbour descriptor search (FEAmatcher.cpp:52-176).

Counterpart of :mod:`diasss_tpu.matching.geosearch`: candidates are
reference keypoints within the geo radius; the best match wins if it passes
the distance bound and the first/second ratio test, with the
single-candidate escape hatch.  Three metrics: ``"l2"`` (SIFT), ``"hamming"``
(ORB +-1 bits; the bound depends on the two images' id parity and a real
second-best must exist) and ``"ncc"`` (geo patches, distance 1 - NCC).
Batched over any leading pair dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatcherConfig
from ..features.orb_desc import hamming_matrix

_BIG = 1e9


class NNResult(NamedTuple):
    corres: torch.Tensor  # (..., K) int64 index into ref kps, -1 if none
    n_candidates: torch.Tensor  # (..., K) geo-gated candidate counts
    best_dist: torch.Tensor  # (..., K) float32


def accept_bound(cfg: MatcherConfig, parity_flip: torch.Tensor) -> torch.Tensor:
    """The distance bound of ``cfg.desc_metric`` per pair, float32 of
    ``parity_flip``'s shape: for ``"hamming"`` the cross-parity bound where
    ``parity_flip`` (opposite-parity images, FEAmatcher.cpp:143-145)."""
    if cfg.desc_metric == "hamming":
        return torch.where(parity_flip, cfg.orb_dist_bound_cross, cfg.orb_dist_bound).to(torch.float32)
    bound = 1.0 - cfg.ncc_min if cfg.desc_metric == "ncc" else cfg.sift_dist_bound
    return torch.full(parity_flip.shape, bound, dtype=torch.float32, device=parity_flip.device)


def descriptor_distance(desc_q, desc_r, cfg: MatcherConfig) -> torch.Tensor:
    """(..., K, Kr) descriptor distances of ``cfg.desc_metric``."""
    if cfg.desc_metric == "hamming":
        return hamming_matrix(desc_q, desc_r)
    if cfg.desc_metric == "ncc":
        # unit mean-free descriptors: the dot product is the NCC
        return 1.0 - desc_q @ desc_r.transpose(-1, -2)
    q2 = torch.sum(desc_q * desc_q, dim=-1)
    r2 = torch.sum(desc_r * desc_r, dim=-1)
    cross = desc_q @ desc_r.transpose(-1, -2)
    return torch.sqrt(torch.clamp(q2[..., :, None] + r2[..., None, :] - 2.0 * cross, min=0.0))


def accept(best, second, n_cand, bound, cfg: MatcherConfig) -> torch.Tensor:
    """The accept rule of a query's best candidate: within the bound and the
    first/second ratio test, or the single candidate within the bound; for
    ``"hamming"`` a real second-best must exist too (FEAmatcher.cpp:166-175)."""
    ratio_thr = cfg.ncc_ratio if cfg.desc_metric == "ncc" else cfg.ratio_test
    ratio_ok = best / torch.clamp(second, min=1e-9) <= ratio_thr
    if cfg.desc_metric == "hamming":
        return (((best <= bound) & ratio_ok & (second < _BIG) & (n_cand >= 1))
                | ((n_cand == 1) & (best <= bound)))
    return ((best < bound) & ratio_ok & (n_cand >= 1)) | ((n_cand == 1) & (best < bound))


def nn_core(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox, bound, cfg: MatcherConfig) -> NNResult:
    """NN search of query keypoints (..., K) against reference keypoints
    (..., Kr); ``ref_bbox`` (..., 4) and ``bound`` (...) batch with them.

    The best candidate is the first index among equal distances and the
    second-best is the minimum over the rest — the values ``lax.top_k(-d, 2)``
    returns (``torch.argmin`` returns the first minimal index)."""
    d2 = torch.sum((geo_q[..., :, None, :] - geo_r[..., None, :, :]) ** 2, dim=-1)
    gate = (d2 < cfg.geo_radius**2) & valid_q[..., :, None] & valid_r[..., None, :]
    bb = ref_bbox[..., None, :]
    in_bbox = (
        (geo_q[..., 0] >= bb[..., 0]) & (geo_q[..., 0] <= bb[..., 1])
        & (geo_q[..., 1] >= bb[..., 2]) & (geo_q[..., 1] <= bb[..., 3])
    )
    gate = gate & in_bbox[..., :, None]

    dist = descriptor_distance(desc_q, desc_r, cfg)
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

    ok = accept(best, second, n_cand, torch.as_tensor(bound, dtype=dist.dtype, device=dist.device)[..., None], cfg)
    return NNResult(
        corres=torch.where(ok, best_id, torch.full_like(best_id, -1)),
        n_candidates=n_cand,
        best_dist=best,
    )


def geo_nn_search(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox,
                  cfg: MatcherConfig = MatcherConfig(), parity_flip: bool = False) -> NNResult:
    """Single-pair search with the metric's bound (``parity_flip``:
    opposite-parity images, the ORB cross bound)."""
    bound = accept_bound(cfg, torch.as_tensor(parity_flip, device=geo_q.device))
    return nn_core(geo_q, desc_q, valid_q, geo_r, desc_r, valid_r, ref_bbox, bound, cfg)
