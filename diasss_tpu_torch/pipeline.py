"""End-to-end SLAM pipeline.

Counterpart of :func:`diasss_tpu.pipeline.run_slam`:

  frames -> overlap gate (bbox IoU) -> [detect -> match] or annotations ->
  keypoint pairs -> estimator -> evaluation + trajectory dumps,

with the estimator either ``"two_stage"`` (batched loop-closure mini-solves
-> quality gate -> chain pose-graph LM) or ``"full_ba"`` (joint pose +
landmark bundle adjustment), each with the direct step or the PCG family,
and optionally the exact pose marginals of the solution
(``pose_graph.marginals`` / ``full_ba.marginals``).  Matching is
the keypoint matcher (``matcher.mode="kp"``) or the dense world-correlation
matcher (``"dense"``).  On the detected path, ``rematch_iters > 0`` iterates
match -> assemble -> solve: geo is recomputed from the estimated poses, the
search extent shrinks to the measured residual, and the solve is
warm-started.  The automatic profile (``config.automatic_config()``) runs
detection, dense matching, full BA and two re-match rounds.

Not ported yet, and raising with its ROADMAP item: ``mesh_devices`` (A14).
A survey whose lines differ in ping or bin count runs the same stacked
stages, its per-frame arrays padded to the longest axes
(:func:`_stack_padded`).  The per-pair matchers (``stacked=False``) serve
the online stream (:mod:`.online`).

Stage times go to ``SlamResult.timings`` (seconds, each stage ended by a
device synchronise) and path counters to ``SlamResult.counters``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .config import PipelineConfig
from .pairs import KpsPairs, get_kps_pairs

from .evaluate import Eval1Result, Eval2Result
from .frame import Keyframe
from .geometry import se3
from .geometry.sonar import geo_bbox
from .padding import pad_rows_tree
from .rng import TorchRng
from .solvers.lc import LCResult


@dataclasses.dataclass
class SlamResult:
    poses: se3.Pose3  # (P,) estimated poses, global concatenated order
    frame_slices: List[slice]
    pair_ids: List[Tuple[int, int]]
    lc_results: Dict[Tuple[int, int], LCResult]  # host (CPU) tensors
    n_lc_accepted: int
    eval1: Dict[Tuple[int, int], Eval1Result]
    eval2: Dict[Tuple[int, int], Eval2Result]
    ate_dr: Optional[float]
    ate_est: Optional[float]
    solve_error0: float
    solve_error: float
    timings: Dict[str, float]  # stage wall times, seconds
    counters: Dict[str, int]  # path counters (match_stacked_pairs, solver_direct_solves, ...)
    solve_capped: bool = False  # the LM hit max_gn_iters while still improving
    # (P, 6) marginal standard deviations of the estimate (rpy then xyz
    # tangent order; pose 0 is the gauge, zero) when the estimator's
    # ``marginals`` is set, else None
    pose_sigmas: Optional[np.ndarray] = None

    def summary(self) -> Dict[str, float]:
        total_pings = int(self.poses.t.shape[0])
        wall = sum(self.timings.values())
        return {
            "total_pings": total_pings,
            "wall_seconds": round(wall, 3),
            "pings_per_sec": round(total_pings / wall, 1) if wall > 0 else float("nan"),
            "solve_seconds": round(self.timings.get("pose_graph", 0.0) + self.timings.get("full_ba", 0.0), 3),
            "n_loop_closures": self.n_lc_accepted,
            "solve_capped": self.solve_capped,
        }


def _check_supported(frames, cfg: PipelineConfig) -> None:
    def todo(what, item):
        raise NotImplementedError(f"{what} is not ported to diasss_tpu_torch yet (ROADMAP {item})")

    if cfg.estimator not in ("two_stage", "full_ba"):
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if cfg.mesh_devices:
        todo("mesh_devices (multi-device solves and matching)", "A14: multi-device")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack_padded(tensors: List[torch.Tensor]) -> torch.Tensor:
    """Stack per-frame tensors, zero-padding every axis (pings, bins) to the
    longest frame's; every consumer gathers by in-range (ping, bin) only."""
    shape = [max(int(t.shape[d]) for t in tensors) for d in range(tensors[0].dim())]
    pads = [sum(((0, shape[d] - int(t.shape[d])) for d in reversed(range(t.dim()))), ()) for t in tensors]
    return torch.stack([torch.nn.functional.pad(t, p) for t, p in zip(tensors, pads)])


def _stack_tables(frames: List[Keyframe]):
    """Every frame's ground-range table, each padded with its last entry to
    the longest (the value the JAX package's clamped read of a shorter table
    returns), and every frame's bin count, on the frames' device."""
    tables = [f.ground_ranges for f in frames]
    g = max(int(t.shape[0]) for t in tables)
    gras = torch.stack([torch.cat([t, t[-1:].expand(g - t.shape[0])]) for t in tables])
    return gras, torch.as_tensor([int(f.raw.shape[1]) for f in frames], device=gras.device)


def _overlap_pairs(frames: List[Keyframe], min_overlap: float,
                   cache: Optional[dict] = None) -> List[Tuple[int, int]]:
    """Pair gating by geo bbox IoU (diasss2.cpp:88-97): one batched bbox
    reduction per frame shape, the IoU arithmetic on the host.  ``cache``:
    an ``{id(frame): bbox}`` dict of a streaming caller (the online stream),
    so each arrival reduces only the new frame's geo; the caller keeps the
    frames alive while the cache is used."""
    bb = np.zeros((len(frames), 4), np.float64)
    by_shape: dict = {}
    for k, f in enumerate(frames):
        if cache is not None and id(f) in cache:
            bb[k] = cache[id(f)]
        else:
            by_shape.setdefault(tuple(f.geo.shape), []).append(k)
    for idxs in by_shape.values():
        bb[np.asarray(idxs)] = geo_bbox(torch.stack([frames[k].geo for k in idxs])).cpu().numpy()
        if cache is not None:
            for k in idxs:
                cache[id(frames[k])] = bb[k]
    out = []
    for i in range(len(frames)):
        for j in range(i + 1, len(frames)):
            ax0, ax1, ay0, ay1 = bb[i]
            bx0, bx1, by0, by1 = bb[j]
            x_ol = min(ax1, bx1) - max(ax0, bx0)
            y_ol = min(ay1, by1) - max(ay0, by0)
            if x_ol > 0 and y_ol > 0:
                a_ol = x_ol * y_ol
                a_a = abs(ax1 - ax0) * abs(ay1 - ay0)
                a_b = abs(bx1 - bx0) * abs(by1 - by0)
                if a_ol / (a_a + a_b - a_ol) > min_overlap:
                    out.append((i, j))
    return out


def _pad_feats_common(feats):
    """Pad every frame's features to the survey-max keypoint capacity with
    ``valid=False`` rows, so mixed-capacity surveys take the stacked path."""
    cap = max(int(f.xy.shape[0]) for f in feats)
    return [pad_rows_tree(f, cap) for f in feats]


def _count(counters, key, n):
    counters[key] = counters.get(key, 0) + n


def _match_pairs_dense(frames, feats, geo_list, pair_ids, cfg: PipelineConfig, matcher_cfg, counters,
                       stacked: bool = True):
    """Dense world-correlation matching (matching/dense.py).  Stacked: every
    frame rasterized once at the survey-common shape, all pairs correlated
    in one batch (features padded to a common capacity first).  Per pair
    (the online stream): each frame in a pair rasterized once at its own
    fitted shape, one correlation per pair."""
    from .matching.dense import dense_matching, dense_matching_stacked, world_raster

    corres_rows: Dict[int, list] = {i: [] for i in range(len(frames))}
    if not pair_ids:
        return corres_rows
    if stacked:
        results = dense_matching_stacked(pair_ids, [f.img_id for f in frames], feats, [f.norm for f in frames],
                                         geo_list, cfg.detector, matcher_cfg.dense)
        _count(counters, "match_stacked_pairs", len(pair_ids))
    else:
        res = cfg.detector.geopatch_res
        rasters = {k: world_raster(frames[k].norm, geo_list[k], res) for k in sorted({k for p in pair_ids for k in p})}
        results = {
            (i, j): dense_matching(frames[i].img_id, frames[j].img_id, feats[i], frames[i].norm, geo_list[i],
                                   frames[j].norm, geo_list[j], cfg.detector, matcher_cfg.dense,
                                   raster_s=rasters[i], raster_t=rasters[j])
            for (i, j) in pair_ids
        }
        _count(counters, "match_perpair_pairs", len(pair_ids))
    for (i, j), (rows_s, rows_t, n) in results.items():
        if n:
            corres_rows[i].append((frames[j].img_id, rows_s))
            corres_rows[j].append((frames[i].img_id, rows_t))
    return corres_rows


def _match_pairs(frames, feats, geo_list, pair_ids, cfg: PipelineConfig, matcher_cfg, rng, counters,
                 stacked: bool = True):
    """Detected-correspondence matching over the gated pairs (geo gating
    against ``geo_list``: DR geo, or drift-compensated geo on re-match
    rounds).  Dense mode goes to :func:`_match_pairs_dense`.

    ``stacked=True`` (batch pipeline): features padded to a common capacity,
    geo-patch descriptors attached to every frame in one batch, and every
    pair in one batch when there are several (one pair takes the per-pair
    matcher).  ``stacked=False`` (online stream): geo patches attached frame
    by frame to the frames in a pair, and one pair at a time.  The path taken
    is counted in ``counters['match_stacked_pairs' / 'match_perpair_pairs']``."""
    from .features import attach_geo_patch_descriptors, attach_geo_patch_descriptors_batch
    from .matching.robust import robust_matching, robust_matching_stacked

    if stacked:
        feats = _pad_feats_common(feats)
    if matcher_cfg.mode == "dense":
        return _match_pairs_dense(frames, feats, geo_list, pair_ids, cfg, matcher_cfg, counters, stacked)
    if cfg.detector.descriptor == "geo_patch":
        if stacked:
            feats = attach_geo_patch_descriptors_batch(feats, [f.norm for f in frames], geo_list, cfg.detector)
        else:
            involved = {k for p in pair_ids for k in p}
            feats = [attach_geo_patch_descriptors(f, frames[k].norm, geo_list[k], cfg.detector) if k in involved
                     else f for k, f in enumerate(feats)]
    corres_rows: Dict[int, list] = {i: [] for i in range(len(frames))}
    if stacked and len(pair_ids) > 1:
        results = robust_matching_stacked(
            pair_ids, [f.img_id for f in frames], feats, geo_list,
            [int(f.raw.shape[0]) for f in frames], rng, cfg=matcher_cfg,
        )
        _count(counters, "match_stacked_pairs", len(pair_ids))
    else:
        results = {
            (i, j): robust_matching(
                frames[i].img_id, frames[j].img_id, feats[i], feats[j], geo_list[i], geo_list[j],
                int(frames[i].raw.shape[0]), int(frames[j].raw.shape[0]), rng, cfg=matcher_cfg,
            )
            for (i, j) in pair_ids
        }
        _count(counters, "match_perpair_pairs", len(pair_ids))
    for (i, j) in pair_ids:
        m = results[(i, j)]
        if m.n_matches:
            corres_rows[i].append((frames[j].img_id, m.rows_s))
            corres_rows[j].append((frames[i].img_id, m.rows_t))
    return corres_rows


def _assemble_pairs(frames, corres_rows, pair_ids, cfg: PipelineConfig, use_anno: bool):
    """Keypoint-pair assembly (``pairs.get_kps_pairs`` on host copies) at one
    power-of-two capacity."""
    involved = sorted({k for ij in pair_ids for k in ij})
    alts_h = {k: frames[k].altitudes.cpu().numpy() for k in involved}
    grs_h = {k: frames[k].ground_ranges.cpu().numpy() for k in involved}
    raw_pairs: Dict[Tuple[int, int], KpsPairs] = {}
    for (i, j) in pair_ids:
        if use_anno:
            rows = frames[i].annos
        else:
            mine = [r for (ref_id, r) in corres_rows[i] if ref_id == frames[j].img_id]
            rows = np.concatenate(mine, axis=0) if mine else np.zeros((0, 6))
        raw_pairs[(i, j)] = get_kps_pairs(
            rows, frames[j].img_id, alts_h[i], grs_h[i], alts_h[j], grs_h[j],
            use_anno=use_anno, nadir_threshold=cfg.loop_closure.nadir_threshold, capacity=None,
        )
    cap = max([1] + [kp.pairs.shape[0] for kp in raw_pairs.values()])
    cap = int(2 ** np.ceil(np.log2(cap))) if cap > 1 else 1
    kps_pairs: Dict[Tuple[int, int], KpsPairs] = {}
    for key, kp in raw_pairs.items():
        padded = np.zeros((cap, 7), np.float32)
        padded[: kp.pairs.shape[0]] = kp.pairs
        valid = np.zeros(cap, bool)
        valid[: kp.valid.shape[0]] = kp.valid
        kps_pairs[key] = KpsPairs(padded, valid)
    return kps_pairs, cap


def _solve_two_stage(frames, geo_list, kps_pairs, pair_ids, cap, cfg: PipelineConfig, rng,
                     timings, counters):
    """Batched LC mini-solves -> quality gate -> global pose-graph LM."""
    from .solvers.lc import loop_closing_tfs_stacked
    from .solvers import pose_graph

    dev = frames[0].geo.device
    t0 = time.perf_counter()
    lc_results: Dict[Tuple[int, int], LCResult] = {}
    if pair_ids:
        rows_cat = np.concatenate([kps_pairs[k].pairs for k in pair_ids])
        valid_cat = np.concatenate([kps_pairs[k].valid for k in pair_ids])
        src_cat = np.concatenate([np.full(cap, i) for (i, j) in pair_ids])
        tgt_cat = np.concatenate([np.full(cap, j) for (i, j) in pair_ids])

        def up(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        gras, n_bins = _stack_tables(frames)
        stacked = loop_closing_tfs_stacked(
            up(rows_cat), up(valid_cat), up(src_cat, torch.int64), up(tgt_cat, torch.int64),
            _stack_padded([f.dr_poses for f in frames]), _stack_padded(list(geo_list)),
            _stack_padded([f.altitudes for f in frames]), gras, n_bins=n_bins, kp_cfg=cfg.kp_noise,
            cfg=cfg.loop_closure,
        )
        host = pytree.tree_map(lambda a: a.cpu(), stacked)
        for k, key in enumerate(pair_ids):
            lc_results[key] = pytree.tree_map(lambda a: a[k * cap:(k + 1) * cap], host)
    timings["loop_closures"] = timings.get("loop_closures", 0.0) + time.perf_counter() - t0

    # --- accepted LC factors (quality > 0; at most one per target ping) ---
    t0 = time.perf_counter()
    offsets = np.cumsum([0] + [int(f.dr_poses.shape[0]) for f in frames])
    lc_i, lc_j, lc_R, lc_t, lc_sig = [], [], [], [], []
    seen_targets = set()
    for (i, j) in pair_ids:
        res = lc_results[(i, j)]
        kp = kps_pairs[(i, j)]
        q = res.quality.numpy()
        var = res.variance6.numpy()
        Rm, tm = res.rel_pose.R.numpy(), res.rel_pose.t.numpy()
        for k in range(len(q)):
            if not kp.valid[k] or not (q[k] > 0) or not np.all(np.isfinite(var[k])):
                continue
            gid_s = int(offsets[i] + kp.pairs[k, 0])
            gid_t = int(offsets[j] + kp.pairs[k, 3])
            if gid_t in seen_targets:
                continue  # first-found wins (optimizer.cpp:218-231)
            seen_targets.add(gid_t)
            lc_i.append(gid_s)
            lc_j.append(gid_t)
            lc_R.append(Rm[k])
            lc_t.append(tm[k])
            lc_sig.append(np.sqrt(np.maximum(var[k], 1e-12)))
    n_acc = len(lc_i)
    if n_acc == 0:
        lc_i, lc_j = [0], [min(1, int(offsets[-1]) - 1)]
        lc_meas = se3.identity((1,), torch.float32, dev)
        lc_sigmas = np.ones((1, 6), np.float32)
        lc_valid = np.zeros(1, bool)
    else:
        lc_meas = se3.Pose3(torch.as_tensor(np.stack(lc_R), device=dev), torch.as_tensor(np.stack(lc_t), device=dev))
        lc_sigmas = np.stack(lc_sig).astype(np.float32)
        lc_valid = np.ones(n_acc, bool)
    timings["lc_gate"] = timings.get("lc_gate", 0.0) + time.perf_counter() - t0

    # --- global pose-graph solve ---
    t0 = time.perf_counter()
    graph = pose_graph.build_chain_graph(
        [f.dr_poses for f in frames], lc_i=lc_i, lc_j=lc_j, lc_meas=lc_meas, lc_sigmas=lc_sigmas,
        lc_valid=lc_valid, cfg=cfg.pose_graph,
        rng=rng if cfg.pose_graph.init_noise_xyz > 0 else None, device=dev,
    )
    poses, info = pose_graph.solve_pose_graph(graph, cfg.pose_graph)
    _count(counters, f"solver_{info.solver_kind}_solves", 1)
    _sync(dev)
    timings["pose_graph"] = timings.get("pose_graph", 0.0) + time.perf_counter() - t0
    return poses, info, lc_results, n_acc, graph


def _evaluate_pairs(frames, kps_pairs, pair_ids, poses, offsets, cfg, run_eval2, counters):
    """eval_1 (and eval_2) for every gated pair in one stacked batch, also on
    a survey whose lines differ in shape (the JAX package evaluates those
    pair by pair), counted in ``counters['eval_stacked_pairs']``; the port
    has no per-pair evaluation, so its ``eval_perpair_pairs`` stays 0 and,
    as in the JAX package, is not recorded."""
    from .evaluate import eval_landmark_consistency_stacked, eval_triangulated_consistency_stacked

    if not pair_ids:
        return {}, {}
    _count(counters, "eval_stacked_pairs", len(pair_ids))
    rows_list, sf_list, tf_list, blocks = [], [], [], []
    start = 0
    for (i, j) in pair_ids:
        kp = kps_pairs[(i, j)]
        rows = kp.pairs[kp.valid]
        rows_list.append(rows)
        sf_list.append(np.full(len(rows), i, np.int64))
        tf_list.append(np.full(len(rows), j, np.int64))
        blocks.append(((i, j), start, start + len(rows)))
        start += len(rows)
    rows_cat, sf_cat, tf_cat = np.concatenate(rows_list), np.concatenate(sf_list), np.concatenate(tf_list)
    geo_all = _stack_padded([f.geo for f in frames])
    gras, n_bins = _stack_tables(frames)
    eval1 = eval_landmark_consistency_stacked(rows_cat, sf_cat, tf_cat, blocks, geo_all, gras, poses, offsets[:-1],
                                              n_bins)
    eval2 = {}
    if run_eval2:
        eval2 = eval_triangulated_consistency_stacked(
            rows_cat, sf_cat, tf_cat, blocks, _stack_padded([f.dr_poses for f in frames]), geo_all,
            _stack_padded([f.altitudes for f in frames]), poses, offsets[:-1], cfg.kp_noise, cfg.loop_closure,
        )
    return eval1, eval2


def _match_residual_q95(rows_cat, valid_cat, src_cat, tgt_cat, geo_st):
    """95th percentile of the post-solve geo discrepancy of the current
    matches, ``||geo_s[ping_s, bin_s] - geo_t[ping_t, bin_t]||`` per valid
    row with geo from the estimated poses, and the valid-row count, as two
    device scalars.  ``rows_cat`` (K, 7) keypoint-pair rows concatenated over
    pairs; ``src_cat``/``tgt_cat`` (K,) frame indices; ``geo_st`` (F, N, M, 2)."""
    N, M = geo_st.shape[1], geo_st.shape[2]

    def take(fidx, ping, binc):
        return geo_st[fidx, torch.clamp(ping.to(torch.int32), 0, N - 1).to(torch.int64),
                      torch.clamp(binc.to(torch.int32), 0, M - 1).to(torch.int64)]

    d = torch.linalg.vector_norm(take(src_cat, rows_cat[:, 0], rows_cat[:, 1])
                                 - take(tgt_cat, rows_cat[:, 3], rows_cat[:, 4]), dim=1)
    n = valid_cat.sum()
    K = d.shape[0]
    # masked quantile: invalid rows sort to the front as -1
    s = torch.sort(torch.where(valid_cat, d, -1.0)).values
    rank = torch.minimum(torch.clamp((0.95 * n.to(torch.float32)).to(torch.int32), min=0),
                         torch.clamp(n - 1, min=0))
    pos = torch.clamp((K - n) + rank, 0, K - 1)
    return s[pos], n


# Bucketed search extents (raster cells) of adaptive re-matching: the
# measured residual rounds up to one of these.
_REMATCH_RING_BUCKETS = (4, 8, 12, 16, 20, 28, 40)


def _rematch_plan(poses, prev_t, kps_pairs, pair_ids, geo_new, cfg: PipelineConfig):
    """Decide the next re-match round: ``(stop, radius_m, ring_cells, t,
    budget_saturated)``.

    * stop: the last solve moved every pose by less than half a raster cell
      (the matches cannot change), or the residual q95 of the current
      matches at the drift-compensated geo is already at the matcher's
      quantization floor (``rematch_stop_resid_cells`` cells);
    * radius: the measured residual q95 times ``rematch_margin`` plus two
      cells, rounded up to a bucket of :data:`_REMATCH_RING_BUCKETS` and
      capped at ``rematch_geo_radius``; saturated when the residual wants
      more than the cap.

    The pose shift, the q95 and the valid count reach the host in one read."""
    res = cfg.detector.geopatch_res
    t = poses.t
    radius = cfg.rematch_geo_radius
    cells = int(np.ceil(radius / res))
    parts = [torch.linalg.vector_norm(t - prev_t, dim=1).amax() if prev_t is not None
             else torch.zeros((), dtype=t.dtype, device=t.device)]
    use_q95 = cfg.rematch_adaptive and bool(kps_pairs) and len({tuple(g.shape) for g in geo_new}) == 1
    if use_q95:
        dev = t.device
        rows_cat = np.concatenate([kps_pairs[k].pairs for k in pair_ids])
        valid_cat = np.concatenate([kps_pairs[k].valid for k in pair_ids])
        src_cat = np.concatenate([np.full(kps_pairs[(i, j)].pairs.shape[0], i) for (i, j) in pair_ids])
        tgt_cat = np.concatenate([np.full(kps_pairs[(i, j)].pairs.shape[0], j) for (i, j) in pair_ids])
        q95, n = _match_residual_q95(
            torch.as_tensor(rows_cat, device=dev), torch.as_tensor(valid_cat, device=dev),
            torch.as_tensor(src_cat, dtype=torch.int64, device=dev),
            torch.as_tensor(tgt_cat, dtype=torch.int64, device=dev), torch.stack(list(geo_new)))
        parts += [q95.to(t.dtype), n.to(t.dtype)]
    host = torch.stack(parts).cpu().tolist()
    if prev_t is not None and host[0] < 0.5 * res:
        return True, None, None, t, False
    if use_q95 and int(host[2]) >= 8:  # enough support for the quantile to mean anything
        q95 = host[1]
        if q95 <= cfg.rematch_stop_resid_cells * res:
            return True, None, None, t, False
        need_cells = int(np.ceil((q95 * cfg.rematch_margin + 2.0 * res) / res))
        for b in _REMATCH_RING_BUCKETS:
            if b >= need_cells:
                need_cells = b
                break
        saturated = need_cells > cells
        cells = min(cells, max(need_cells, _REMATCH_RING_BUCKETS[0]))
        return False, cells * res, cells, t, saturated
    return False, radius, cells, t, False


def _estimated_geo(frames, poses: se3.Pose3) -> List[torch.Tensor]:
    """Every frame's geo image recomputed from the estimated poses (same
    flat-floor projection as frame.cpp:126-165), on the device."""
    from .geometry import sonar

    rows = se3.to_rpyxyz(poses)
    out, off = [], 0
    for f in frames:
        n = int(f.dr_poses.shape[0])
        seg = rows[off:off + n]
        off += n
        out.append(sonar.geo_image(seg[:, 3:5].contiguous(), seg[:, 2].contiguous(), f.ground_ranges,
                                   int(f.raw.shape[1])))
    return out


def _solve_full_ba(frames, geo_list, kps_pairs, pair_ids, cfg: PipelineConfig, init_poses, it, rng,
                   timings, counters):
    """Joint bundle adjustment, warm-started from the previous solve on
    re-match rounds."""
    from .solvers import full_ba

    t0 = time.perf_counter()
    ba_cfg = cfg.full_ba
    if not cfg.pose_graph.use_anno and ba_cfg.max_geo_discrepancy == 0:
        # detected matches carry outliers the joint solve would trust
        ba_cfg = dataclasses.replace(ba_cfg, max_geo_discrepancy=4.0)
    if it > 0:
        # drift-compensated geo: true matches agree to within the residual
        ba_cfg = dataclasses.replace(ba_cfg, max_geo_discrepancy=cfg.rematch_geo_discrepancy)
    noise = rng if cfg.pose_graph.init_noise_xyz > 0 and init_poses is None else None
    frames_geo = [f._replace(geo=g) for f, g in zip(frames, geo_list)]
    prob = full_ba.build_ba_problem(frames_geo, kps_pairs, pair_ids, ba_cfg, cfg.pose_graph, rng=noise)
    if init_poses is not None:
        prob = prob._replace(poses0=init_poses)
    n_valid = int(prob.kp_valid.sum())
    poses, lms, info = full_ba.solve_full_ba(prob, ba_cfg, cfg.kp_noise,
                                             k_direct_cols=_woodbury_width(prob, n_valid))
    _count(counters, f"solver_{info.solver_kind}_solves", 1)
    _sync(poses.t.device)
    timings["full_ba"] = timings.get("full_ba", 0.0) + time.perf_counter() - t0
    return poses, info, n_valid, prob, lms


def _woodbury_width(prob, n_valid: int) -> int:
    """Leading factor slots that carry Woodbury columns: the valid count
    rounded up to 128 (the padding tail is invalid)."""
    return min(int(prob.kp_i.shape[0]), max(128, -(-n_valid // 128) * 128))


def _pose_sigmas(cfg: PipelineConfig, solved, poses, timings) -> Optional[np.ndarray]:
    """(P, 6) marginal standard deviations at the solution when the
    estimator's ``marginals`` is set: ``sqrt`` of the diagonals of the exact
    marginal covariance blocks, one host copy.  ``solved`` is the solved
    pose graph, or (BAProblem, landmarks, valid count)."""
    from .solvers import full_ba, pose_graph

    if not (cfg.full_ba.marginals if cfg.estimator == "full_ba" else cfg.pose_graph.marginals):
        return None
    t0 = time.perf_counter()
    if cfg.estimator == "full_ba":
        prob, lms, n_valid = solved
        cov = full_ba.ba_pose_marginals(prob, poses, lms, cfg.full_ba, cfg.kp_noise,
                                        k_cols=_woodbury_width(prob, n_valid))
    else:
        cov = pose_graph.pg_pose_marginals(solved, poses)
    sigmas = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0)).to(torch.float32).cpu().numpy()
    timings["pose_marginals"] = time.perf_counter() - t0
    return sigmas


def run_slam(
    frames: List[Keyframe],
    cfg: PipelineConfig = PipelineConfig(),
    gt_rows_list: Optional[List[np.ndarray]] = None,
    out_dir: Optional[str] = None,
    run_eval2: bool = True,
    feats: Optional[list] = None,
    rng=None,
) -> SlamResult:
    """Run the SLAM pipeline on keyframes built on one device.

    ``feats``: precomputed per-frame :class:`.features.DetectedFeatures`
    (detected mode); ``rng``: an :class:`.rng.Rng` (default: a
    :class:`.rng.TorchRng` seeded from ``cfg`` on the frames' device)."""
    _check_supported(frames, cfg)
    dev = frames[0].geo.device
    rng = rng if rng is not None else TorchRng.from_config(cfg, dev)
    timings: Dict[str, float] = {}
    counters: Dict[str, int] = {}

    t0 = time.perf_counter()
    pair_ids = _overlap_pairs(frames, cfg.min_overlap)
    timings["overlap_gate"] = time.perf_counter() - t0

    use_anno = cfg.pose_graph.use_anno
    if not use_anno and feats is None:
        from .features import detect_features

        t0 = time.perf_counter()
        feats = [detect_features(f.norm, f.mask, cfg.detector) for f in frames]
        _sync(dev)
        timings["detect"] = time.perf_counter() - t0

    # iterated match -> assemble -> solve (re-matching only when detected)
    geo_list = [f.geo for f in frames]
    n_iters = 1 + (cfg.rematch_iters if not use_anno else 0)
    init_poses = poses = info = prev_t = solved = None
    lc_results: Dict[Tuple[int, int], LCResult] = {}
    n_acc = 0
    kps_pairs: Dict[Tuple[int, int], KpsPairs] = {}
    for it in range(n_iters):
        corres_rows = None
        if not use_anno:
            t0 = time.perf_counter()
            matcher_cfg = cfg.matcher
            if it > 0:
                geo_new = _estimated_geo(frames, poses)
                stop, radius, cells, prev_t, saturated = _rematch_plan(poses, prev_t, kps_pairs, pair_ids,
                                                                       geo_new, cfg)
                if saturated:
                    _count(counters, "rematch_saturated_rounds", 1)
                if stop:
                    _count(counters, "rematch_converged_rounds", n_iters - it)
                    timings["matching"] = timings.get("matching", 0.0) + time.perf_counter() - t0
                    break
                geo_list = geo_new
                counters[f"rematch_r{it}_ring_cells"] = cells
                matcher_cfg = dataclasses.replace(
                    matcher_cfg, geo_radius=radius,
                    dense=dataclasses.replace(matcher_cfg.dense, search_radius=radius))
            corres_rows = _match_pairs(frames, feats, geo_list, pair_ids, cfg, matcher_cfg, rng, counters)
            _sync(dev)
            timings["matching"] = timings.get("matching", 0.0) + time.perf_counter() - t0

        t0 = time.perf_counter()
        kps_pairs, cap = _assemble_pairs(frames, corres_rows, pair_ids, cfg, use_anno)
        timings["kps_assembly"] = timings.get("kps_assembly", 0.0) + time.perf_counter() - t0

        if cfg.estimator == "full_ba":
            poses, info, n_acc, prob, lms = _solve_full_ba(frames, geo_list, kps_pairs, pair_ids, cfg, init_poses,
                                                           it, rng, timings, counters)
            init_poses = poses
            solved = (prob, lms, n_acc)
        else:
            poses, info, lc_results, n_acc, solved = _solve_two_stage(frames, geo_list, kps_pairs, pair_ids, cap,
                                                                      cfg, rng, timings, counters)

    pose_sigmas = _pose_sigmas(cfg, solved, poses, timings)

    t0 = time.perf_counter()
    offsets = np.cumsum([0] + [int(f.dr_poses.shape[0]) for f in frames])
    frame_slices = [slice(int(offsets[k]), int(offsets[k + 1])) for k in range(len(frames))]
    eval1, eval2 = _evaluate_pairs(frames, kps_pairs, pair_ids, poses, offsets, cfg, run_eval2, counters)
    ate_dr = ate_est = None
    if gt_rows_list is not None:
        from .evaluate import trajectory_ate_pair

        dr_t = torch.cat([f.dr_poses[:, 3:6] for f in frames])
        ate_dr, ate_est = trajectory_ate_pair(dr_t, poses, np.concatenate(gt_rows_list, axis=0))
    timings["evaluation"] = time.perf_counter() - t0

    if out_dir is not None:
        from .trajectory import save_poses_quat, save_poses_rpy

        dr_all = se3.from_rodrigues_xyz(torch.cat([f.dr_poses for f in frames]))
        save_poses_rpy(f"{out_dir}/dr_poses_all.txt", dr_all)
        save_poses_rpy(f"{out_dir}/est_poses_all.txt", poses)
        if len(frames) == 2:
            save_poses_quat(f"{out_dir}/dr_poses.txt", dr_all)
            save_poses_quat(f"{out_dir}/est_poses.txt", poses)

    t0 = time.perf_counter()
    err0, err = torch.stack([info.error0, info.error]).cpu().tolist()
    timings["result_fetch"] = time.perf_counter() - t0
    max_it = cfg.full_ba.max_iters if cfg.estimator == "full_ba" else cfg.pose_graph.max_gn_iters
    result = SlamResult(
        poses=poses,
        frame_slices=frame_slices,
        pair_ids=pair_ids,
        lc_results=lc_results,
        n_lc_accepted=n_acc,
        eval1=eval1,
        eval2=eval2,
        ate_dr=ate_dr,
        ate_est=ate_est,
        solve_error0=float(err0),
        solve_error=float(err),
        timings=timings,
        counters=counters,
        solve_capped=info.iterations >= max_it and info.stall == 0,
        pose_sigmas=pose_sigmas,
    )
    if out_dir is not None:
        from .dumps import write_reference_dumps

        write_reference_dumps(out_dir, result, kps_pairs)
    return result
