"""Bidirectional robust matching with the cross-direction consistency merge
(FEAmatcher.cpp:13-50, 323-439).

Counterpart of :mod:`diasss_tpu.matching.robust` without the ring/mesh paths:
geo-gated NN search + optional mutual cross-check + SCC in both directions,
then the host-side merge.  Output rows follow the ``corres_kps`` layout
``(img_id, ref_img_id, ping, bin, ref_ping, ref_bin)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MatcherConfig

from ..features.detector import DetectedFeatures
from ..geometry.sonar import geo_bbox
from .geosearch import check_metric, nn_core
from .scc import scc_filter


class MatchResult(NamedTuple):
    rows_s: np.ndarray  # (M, 6) corres_kps rows for the source frame
    rows_t: np.ndarray  # (M, 6) mirrored rows for the target frame
    n_matches: int
    inliers_1: int
    inliers_2: int
    consistent: bool


def kp_geo(feats: DetectedFeatures, geo_img: torch.Tensor) -> torch.Tensor:
    """Geo position of each keypoint, gathered at truncated integer coords."""
    xi = torch.clamp(feats.xy[:, 0].to(torch.int64), 0, geo_img.shape[1] - 1)
    yi = torch.clamp(feats.xy[:, 1].to(torch.int64), 0, geo_img.shape[0] - 1)
    return geo_img[yi, xi]


def _cross_check(c1: torch.Tensor, c2: torch.Tensor):
    """Mutual-NN filter (FEAmatcher.cpp:407-422) on (..., K) corres pairs."""
    ar = torch.arange(c1.shape[-1], device=c1.device)
    m1 = (c1 >= 0) & (torch.gather(c2, -1, torch.clamp(c1, min=0)) == ar)
    m2 = (c2 >= 0) & (torch.gather(c1, -1, torch.clamp(c2, min=0)) == ar)
    return torch.where(m1, c1, torch.full_like(c1, -1)), torch.where(m2, c2, torch.full_like(c2, -1))


def _merge_directions(img_id_s, img_id_t, xy_s, xy_t, c1, c2, inl1, inl2, m1, m2,
                      rows_s, rows_t, cfg) -> MatchResult:
    """Host-side consistency merge of the two directions' SCC outcomes
    (ConsistentCheck, FEAmatcher.cpp:323-405); all arrays are numpy."""
    img_diff = abs(rows_s - rows_t) if (img_id_s % 2 != img_id_t % 2) else 0.0
    consistent = abs(abs(m1 - m2) - img_diff) <= cfg.consistency_thres
    if consistent:
        i1 = np.nonzero(c1 >= 0)[0]
        i1 = i1[c2[c1[i1]] != i1]  # skip direction-1 matches whose reverse points back
        j2 = np.nonzero(c2 >= 0)[0]
        src_idx = np.concatenate([i1, c2[j2]])
        tgt_idx = np.concatenate([c1[i1], j2])
    elif inl1 > inl2:
        src_idx = np.nonzero(c1 >= 0)[0]
        tgt_idx = c1[src_idx]
    else:
        tgt_idx = np.nonzero(c2 >= 0)[0]
        src_idx = c2[tgt_idx]
    n = len(src_idx)
    rows_src = np.empty((n, 6), np.float64)
    rows_tgt = np.empty((n, 6), np.float64)
    rows_src[:, 0] = img_id_s
    rows_src[:, 1] = img_id_t
    rows_src[:, 2] = xy_s[src_idx, 1]
    rows_src[:, 3] = xy_s[src_idx, 0]
    rows_src[:, 4] = xy_t[tgt_idx, 1]
    rows_src[:, 5] = xy_t[tgt_idx, 0]
    rows_tgt[:, 0] = img_id_t
    rows_tgt[:, 1] = img_id_s
    rows_tgt[:, 2:4] = rows_src[:, 4:6]
    rows_tgt[:, 4:6] = rows_src[:, 2:4]
    return MatchResult(rows_src, rows_tgt, n, inl1, inl2, bool(consistent))


def _nn_scc_both(g_s, f_s, bb_s, g_t, f_t, bb_t, parity, rows_s, rows_t, rng, cfg):
    """Both directions of NN search + SCC.  Every argument may carry the same
    leading pair dims (stacked path) or none (one pair)."""
    bound = torch.full(parity.shape, cfg.sift_dist_bound, dtype=torch.float32, device=parity.device)
    nn1 = nn_core(g_s, f_s.desc, f_s.valid, g_t, f_t.desc, f_t.valid, bb_t, bound, cfg)
    nn2 = nn_core(g_t, f_t.desc, f_t.valid, g_s, f_s.desc, f_s.valid, bb_s, bound, cfg)
    c1, c2 = nn1.corres, nn2.corres
    if cfg.cross_check:
        c1, c2 = _cross_check(c1, c2)
    xs, xt = f_s.xy, f_t.xy
    scc1 = scc_filter(xs[..., 1], xt[..., 1], c1, parity, rows_t, rng, cfg,
                      kp_x_q=xs[..., 0], kp_x_r=xt[..., 0])
    scc2 = scc_filter(xt[..., 1], xs[..., 1], c2, parity, rows_s, rng, cfg,
                      kp_x_q=xt[..., 0], kp_x_r=xs[..., 0])
    return scc1, scc2


def _host(scc1, scc2, xy_s, xy_t):
    """One device->host transfer of everything the merges read."""
    return [t.cpu().numpy() for t in (scc1.corres, scc2.corres, scc1.inlier_count,
                                       scc2.inlier_count, scc1.model_x, scc2.model_x, xy_s, xy_t)]


def robust_matching_stacked(pair_ids, img_ids, feats_list, geo_list, rows_list, rng,
                            cfg: MatcherConfig = MatcherConfig()):
    """Whole-survey robust matching: every pair's bidirectional NN + SCC in
    one batch over the pair axis, one device->host transfer, then the merges
    on the host.  Requires equal keypoint capacity across frames.  Returns
    ``{(i, j): MatchResult}``."""
    if not pair_ids:
        return {}
    check_metric(cfg)
    dev = feats_list[0].xy.device
    feats = DetectedFeatures(*[torch.stack(f) for f in zip(*feats_list)])
    geo_kp = torch.stack([kp_geo(f, g) for f, g in zip(feats_list, geo_list)])
    bboxes = torch.stack([geo_bbox(g) for g in geo_list])
    src = torch.as_tensor([i for (i, j) in pair_ids], dtype=torch.int64, device=dev)
    tgt = torch.as_tensor([j for (i, j) in pair_ids], dtype=torch.int64, device=dev)
    parity = torch.as_tensor([(img_ids[i] % 2) != (img_ids[j] % 2) for (i, j) in pair_ids], device=dev)
    n_rows = torch.as_tensor([float(r) for r in rows_list], dtype=torch.float32, device=dev)
    f_s = DetectedFeatures(*[a[src] for a in feats])
    f_t = DetectedFeatures(*[a[tgt] for a in feats])
    scc1, scc2 = _nn_scc_both(geo_kp[src], f_s, bboxes[src], geo_kp[tgt], f_t, bboxes[tgt],
                              parity, n_rows[src], n_rows[tgt], rng, cfg)
    c1, c2, inl1, inl2, m1, m2, xy_s, xy_t = _host(scc1, scc2, f_s.xy, f_t.xy)
    return {
        (i, j): _merge_directions(
            img_ids[i], img_ids[j], xy_s[p], xy_t[p], c1[p], c2[p], int(inl1[p]), int(inl2[p]),
            float(m1[p]), float(m2[p]), rows_list[i], rows_list[j], cfg,
        )
        for p, (i, j) in enumerate(pair_ids)
    }


def robust_matching(img_id_s, img_id_t, feats_s, feats_t, geo_s, geo_t, rows_s: int, rows_t: int,
                    rng, cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """One pair's robust matching; the two frames may hold different
    keypoint capacities."""
    check_metric(cfg)
    dev = feats_s.xy.device
    parity = torch.as_tensor(img_id_s % 2 != img_id_t % 2, device=dev)
    scc1, scc2 = _nn_scc_both(
        kp_geo(feats_s, geo_s), feats_s, geo_bbox(geo_s), kp_geo(feats_t, geo_t), feats_t, geo_bbox(geo_t),
        parity, torch.as_tensor(float(rows_s), device=dev), torch.as_tensor(float(rows_t), device=dev), rng, cfg,
    )
    c1, c2, inl1, inl2, m1, m2, xy_s, xy_t = _host(scc1, scc2, feats_s.xy, feats_t.xy)
    return _merge_directions(img_id_s, img_id_t, xy_s, xy_t, c1, c2, int(inl1), int(inl2),
                             float(m1), float(m2), rows_s, rows_t, cfg)
