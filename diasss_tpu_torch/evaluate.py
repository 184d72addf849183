"""Annotation-based evaluation (optimizer.cpp:1216-1886) and ground-truth ATE.

Counterpart of :mod:`diasss_tpu.evaluate`:

* eval_1 (landmark geo-consistency): the geo distance between the two
  projections of each keypoint pair under DR poses vs estimated poses;
* eval_2 (triangulated consistency): range/plane residuals of the landmark
  triangulated under DR and under estimated poses;
* the translation RMSE of DR and estimate against ground truth.

The pipeline evaluates every frame pair at once (the ``*_stacked``
functions); the per-pair forms are the same computation for one pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import KeypointNoiseConfig, LoopClosureConfig

from .geometry import se3, so3, sonar


class Eval1Result(NamedTuple):
    improved_pct: float
    n_pairs: int
    avg_x_dr: float
    avg_x_est: float
    avg_y_dr: float
    avg_y_est: float
    avg_norm_dr: float
    avg_norm_est: float
    ini_dists: np.ndarray
    fnl_dists: np.ndarray


_E0 = np.zeros(0)


class Eval2Result(NamedTuple):
    range_improved_pct: float
    plane_improved_pct: float
    n_pairs: int
    avg_range_dr: float
    avg_range_est: float
    avg_plane_dr: float
    avg_plane_est: float
    range_dr_e: np.ndarray = _E0
    range_est_e: np.ndarray = _E0
    plane_dr_e: np.ndarray = _E0
    plane_est_e: np.ndarray = _E0


_NAN = float("nan")
EMPTY_EVAL1 = Eval1Result(_NAN, 0, _NAN, _NAN, _NAN, _NAN, _NAN, _NAN, _E0, _E0)
EMPTY_EVAL2 = Eval2Result(_NAN, _NAN, 0, _NAN, _NAN, _NAN, _NAN)


def _rows(pairs_cat, src_frame, tgt_frame, device):
    p = torch.as_tensor(np.asarray(pairs_cat, np.float32), device=device)
    sf = torch.as_tensor(np.asarray(src_frame), dtype=torch.int64, device=device)
    tf = torch.as_tensor(np.asarray(tgt_frame), dtype=torch.int64, device=device)
    ids = [p[:, c].to(torch.int64) for c in (0, 1, 3, 4)]
    return p, sf, tf, ids


def eval_landmark_consistency_stacked(
    pairs_cat: np.ndarray,  # (K, 7) concatenated valid rows of all frame pairs
    src_frame: np.ndarray,  # (K,) source frame index per row
    tgt_frame: np.ndarray,  # (K,) target frame index per row
    blocks: list,  # [(key, start, stop)] row slices per frame pair
    geo_all: torch.Tensor,  # (F, N, M, 2)
    gras_all: torch.Tensor,  # (F, G)
    est_poses: se3.Pose3,  # (P,) global solved poses
    frame_offsets: np.ndarray,  # (F,) global pose offset of each frame
    n_bins,  # int, or (F,) one bin count per frame
):
    """eval_1 for every frame pair in one batch and one host transfer.  Both
    projections of a row take its source frame's bin count, as the JAX
    package's per-pair ``eval_landmark_consistency`` does (padded tables as
    :func:`.solvers.lc.loop_closing_tfs_stacked` takes them)."""
    if len(pairs_cat) == 0:
        return {key: EMPTY_EVAL1 for key, _, _ in blocks}
    dev = geo_all.device
    p, sf, tf, (id_s, bin_s, id_t, bin_t) = _rows(pairs_cat, src_frame, tgt_frame, dev)
    ini_xy = geo_all[sf, id_s, bin_s] - geo_all[tf, id_t, bin_t]
    off = torch.as_tensor(np.asarray(frame_offsets), dtype=torch.int64, device=dev)
    pose_s = est_poses[off[sf] + id_s]
    pose_t = est_poses[off[tf] + id_t]
    if isinstance(n_bins, torch.Tensor):
        n_bins = n_bins[sf]
    proj_s = sonar.project_landmark_geo(pose_s.t[:, :2], so3.yaw(pose_s.R), bin_s, gras_all[sf], n_bins)
    proj_t = sonar.project_landmark_geo(pose_t.t[:, :2], so3.yaw(pose_t.R), bin_t, gras_all[tf], n_bins)
    host = _eval1_host(ini_xy, proj_s - proj_t)
    return {key: _eval1_result(host, a, b) for key, a, b in blocks}


def _eval1_host(ini_xy: torch.Tensor, fnl_xy: torch.Tensor) -> np.ndarray:
    """The DR and estimated distances and offsets, in one host transfer."""
    return torch.stack([torch.linalg.norm(ini_xy, dim=-1), torch.linalg.norm(fnl_xy, dim=-1),
                        ini_xy[:, 0], ini_xy[:, 1], fnl_xy[:, 0], fnl_xy[:, 1]]).cpu().numpy()


def _eval1_result(host: np.ndarray, a: int, b: int) -> Eval1Result:
    if b <= a:
        return EMPTY_EVAL1
    ini, fnl = host[0, a:b], host[1, a:b]
    return Eval1Result(
        improved_pct=float((ini > fnl).mean() * 100.0),
        n_pairs=int(b - a),
        avg_x_dr=float(np.abs(host[2, a:b]).mean()),
        avg_x_est=float(np.abs(host[4, a:b]).mean()),
        avg_y_dr=float(np.abs(host[3, a:b]).mean()),
        avg_y_est=float(np.abs(host[5, a:b]).mean()),
        avg_norm_dr=float(ini.mean()),
        avg_norm_est=float(fnl.mean()),
        ini_dists=ini,
        fnl_dists=fnl,
    )


def eval_landmark_consistency(
    pairs: np.ndarray,  # (K, 7) valid kps-pair rows of one frame pair
    geo_s: torch.Tensor,
    geo_t: torch.Tensor,
    gras_s: torch.Tensor,
    gras_t: torch.Tensor,
    est_s: se3.Pose3,  # (Ns,) estimated poses of the source frame
    est_t: se3.Pose3,  # (Nt,)
    n_bins: int,
) -> Eval1Result:
    """eval_1 of one frame pair: DR geo-projection distance vs estimated-pose
    projection distance (both projections with ``n_bins``)."""
    if len(pairs) == 0:
        return EMPTY_EVAL1
    p = torch.as_tensor(np.asarray(pairs, np.float32), device=geo_s.device)
    id_s, bin_s, id_t, bin_t = (p[:, c].to(torch.int64) for c in (0, 1, 3, 4))
    pose_s, pose_t = est_s[id_s], est_t[id_t]
    proj_s = sonar.project_landmark_geo(pose_s.t[:, :2], so3.yaw(pose_s.R), bin_s, gras_s, n_bins)
    proj_t = sonar.project_landmark_geo(pose_t.t[:, :2], so3.yaw(pose_t.R), bin_t, gras_t, n_bins)
    host = _eval1_host(geo_s[id_s, bin_s] - geo_t[id_t, bin_t], proj_s - proj_t)
    return _eval1_result(host, 0, int(p.shape[0]))


def eval_triangulated_consistency_stacked(
    pairs_cat: np.ndarray,
    src_frame: np.ndarray,
    tgt_frame: np.ndarray,
    blocks: list,
    dr_all: torch.Tensor,  # (F, N, 6)
    geo_all: torch.Tensor,  # (F, N, M, 2)
    alts_all: torch.Tensor,  # (F, N)
    est_poses: se3.Pose3,  # (P,)
    frame_offsets: np.ndarray,
    kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
    lc_cfg: LoopClosureConfig = LoopClosureConfig(),
):
    """eval_2 for every frame pair in one batched triangulation run."""
    if len(pairs_cat) == 0:
        return {key: EMPTY_EVAL2 for key, _, _ in blocks}
    dev = geo_all.device
    p, sf, tf, (id_s, bin_s, id_t, bin_t) = _rows(pairs_cat, src_frame, tgt_frame, dev)
    sr_s, sr_t = p[:, 2], p[:, 5]
    row_s, row_t = dr_all[sf, id_s], dr_all[tf, id_t]
    z_bar = 0.5 * ((row_s[:, 5] - alts_all[sf, id_s]) + (row_t[:, 5] - alts_all[tf, id_t]))
    L0 = torch.cat([0.5 * (geo_all[sf, id_s, bin_s] + geo_all[tf, id_t, bin_t]), z_bar[:, None]], dim=1)
    off = torch.as_tensor(np.asarray(frame_offsets), dtype=torch.int64, device=dev)

    host = _eval2_host(se3.from_rodrigues_xyz(row_s), se3.from_rodrigues_xyz(row_t), est_poses[off[sf] + id_s],
                       est_poses[off[tf] + id_t], sr_s, sr_t, L0, kp_cfg, lc_cfg)
    return {key: _eval2_result(host, a, b) for key, a, b in blocks}


def _eval2_host(dr_s: se3.Pose3, dr_t: se3.Pose3, est_s: se3.Pose3, est_t: se3.Pose3, sr_s, sr_t, L0, kp_cfg,
                lc_cfg) -> np.ndarray:
    """Range and plane errors of the landmarks triangulated under the DR and
    the estimated poses of each row's two pings: (4, K) rows range DR,
    plane DR, range estimated, plane estimated, in one host transfer."""
    from .solvers.triangulate import triangulate_batch

    Ts = se3.identity((int(sr_s.shape[0]),), sr_s.dtype, sr_s.device)

    def errors(Tp_s, Tp_t):
        lm = triangulate_batch(Tp_s, Tp_t, Ts, Ts, sr_s, sr_t, L0, kp_cfg, lc_cfg, True)
        l_s, l_t = se3.transform_to(Tp_s, lm), se3.transform_to(Tp_t, lm)
        range_e = 0.5 * (torch.abs(torch.linalg.norm(l_s, dim=-1) - sr_s) + torch.abs(torch.linalg.norm(l_t, dim=-1) - sr_t))
        return range_e, 0.5 * (torch.abs(l_s[:, 0]) + torch.abs(l_t[:, 0]))

    return torch.stack([*errors(dr_s, dr_t), *errors(est_s, est_t)]).cpu().numpy()


def _eval2_result(host: np.ndarray, a: int, b: int) -> Eval2Result:
    if b <= a:
        return EMPTY_EVAL2
    r_dr, p_dr, r_est, p_est = host[:, a:b]
    return Eval2Result(
        range_improved_pct=float((r_dr > r_est).mean() * 100.0),
        plane_improved_pct=float((p_dr > p_est).mean() * 100.0),
        n_pairs=int(b - a),
        avg_range_dr=float(r_dr.mean()),
        avg_range_est=float(r_est.mean()),
        avg_plane_dr=float(p_dr.mean()),
        avg_plane_est=float(p_est.mean()),
        range_dr_e=r_dr,
        range_est_e=r_est,
        plane_dr_e=p_dr,
        plane_est_e=p_est,
    )


def eval_triangulated_consistency(
    pairs: np.ndarray,
    dr_s: torch.Tensor,
    dr_t: torch.Tensor,
    geo_s: torch.Tensor,
    geo_t: torch.Tensor,
    alts_s: torch.Tensor,
    alts_t: torch.Tensor,
    est_s: se3.Pose3,
    est_t: se3.Pose3,
    kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
    lc_cfg: LoopClosureConfig = LoopClosureConfig(),
) -> Eval2Result:
    """eval_2 of one frame pair: triangulated landmark range/plane residuals,
    DR vs estimated."""
    if len(pairs) == 0:
        return EMPTY_EVAL2
    p = torch.as_tensor(np.asarray(pairs, np.float32), device=geo_s.device)
    id_s, bin_s, id_t, bin_t = (p[:, c].to(torch.int64) for c in (0, 1, 3, 4))
    z_bar = 0.5 * ((dr_s[id_s, 5] - alts_s[id_s]) + (dr_t[id_t, 5] - alts_t[id_t]))
    L0 = torch.cat([0.5 * (geo_s[id_s, bin_s] + geo_t[id_t, bin_t]), z_bar[:, None]], dim=1)
    host = _eval2_host(se3.from_rodrigues_xyz(dr_s[id_s]), se3.from_rodrigues_xyz(dr_t[id_t]), est_s[id_s],
                       est_t[id_t], p[:, 2], p[:, 5], L0, kp_cfg, lc_cfg)
    return _eval2_result(host, 0, int(p.shape[0]))


def _rmse(ts, gt_rows: np.ndarray) -> list:
    """Translation RMSE of each (P, 3) tensor of ``ts`` against ground-truth
    DR-format rows, in one host transfer."""
    gt = se3.from_rodrigues_xyz(torch.as_tensor(np.asarray(gt_rows), dtype=torch.float32, device=ts[0].device))

    def rmse(t):
        d = t - gt.t
        return torch.sqrt(torch.mean(torch.sum(d * d, dim=1)))

    return torch.stack([rmse(t) for t in ts]).cpu().tolist()


def trajectory_ate(est: se3.Pose3, gt_rows: np.ndarray) -> float:
    """Translation RMSE of the estimate against ground-truth DR-format rows
    (no alignment; the gauge is the first pose)."""
    return float(_rmse([est.t], gt_rows)[0])


def trajectory_ate_pair(dr_t: torch.Tensor, est: se3.Pose3, gt_rows: np.ndarray) -> tuple:
    """``(ate_dr, ate_est)``: translation RMSE of the DR (P, 3) and estimated
    positions against ground-truth DR-format rows (no alignment; the gauge is
    the first pose), with one host transfer."""
    a, b = _rmse([dr_t, est.t], gt_rows)
    return float(a), float(b)
