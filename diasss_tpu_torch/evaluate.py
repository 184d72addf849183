"""Annotation-based evaluation (optimizer.cpp:1216-1886) and ground-truth ATE.

Counterpart of the stacked evaluators of :mod:`diasss_tpu.evaluate`:

* eval_1 (landmark geo-consistency): the geo distance between the two
  projections of each keypoint pair under DR poses vs estimated poses;
* eval_2 (triangulated consistency): range/plane residuals of the landmark
  triangulated under DR and under estimated poses;
* the translation RMSE of DR and estimate against ground truth.
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
    fnl_xy = proj_s - proj_t
    host = torch.stack([torch.linalg.norm(ini_xy, dim=-1), torch.linalg.norm(fnl_xy, dim=-1),
                        ini_xy[:, 0], ini_xy[:, 1], fnl_xy[:, 0], fnl_xy[:, 1]]).cpu().numpy()
    ini, fnl = host[0], host[1]
    out = {}
    for key, a, b in blocks:
        if b <= a:
            out[key] = EMPTY_EVAL1
            continue
        out[key] = Eval1Result(
            improved_pct=float((ini[a:b] > fnl[a:b]).mean() * 100.0),
            n_pairs=int(b - a),
            avg_x_dr=float(np.abs(host[2, a:b]).mean()),
            avg_x_est=float(np.abs(host[4, a:b]).mean()),
            avg_y_dr=float(np.abs(host[3, a:b]).mean()),
            avg_y_est=float(np.abs(host[5, a:b]).mean()),
            avg_norm_dr=float(ini[a:b].mean()),
            avg_norm_est=float(fnl[a:b].mean()),
            ini_dists=ini[a:b],
            fnl_dists=fnl[a:b],
        )
    return out


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
    from .solvers.triangulate import triangulate_batch

    if len(pairs_cat) == 0:
        return {key: EMPTY_EVAL2 for key, _, _ in blocks}
    dev = geo_all.device
    p, sf, tf, (id_s, bin_s, id_t, bin_t) = _rows(pairs_cat, src_frame, tgt_frame, dev)
    sr_s, sr_t = p[:, 2], p[:, 5]
    K = p.shape[0]
    row_s, row_t = dr_all[sf, id_s], dr_all[tf, id_t]
    Ts = se3.identity((K,), p.dtype, dev)
    z_bar = 0.5 * ((row_s[:, 5] - alts_all[sf, id_s]) + (row_t[:, 5] - alts_all[tf, id_t]))
    L0 = torch.cat([0.5 * (geo_all[sf, id_s, bin_s] + geo_all[tf, id_t, bin_t]), z_bar[:, None]], dim=1)
    off = torch.as_tensor(np.asarray(frame_offsets), dtype=torch.int64, device=dev)

    def errors(Tp_s, Tp_t):
        lm = triangulate_batch(Tp_s, Tp_t, Ts, Ts, sr_s, sr_t, L0, kp_cfg, lc_cfg, True)
        l_s, l_t = se3.transform_to(Tp_s, lm), se3.transform_to(Tp_t, lm)
        range_e = 0.5 * (torch.abs(torch.linalg.norm(l_s, dim=-1) - sr_s) + torch.abs(torch.linalg.norm(l_t, dim=-1) - sr_t))
        return range_e, 0.5 * (torch.abs(l_s[:, 0]) + torch.abs(l_t[:, 0]))

    r_dr, p_dr = errors(se3.from_rodrigues_xyz(row_s), se3.from_rodrigues_xyz(row_t))
    r_est, p_est = errors(est_poses[off[sf] + id_s], est_poses[off[tf] + id_t])
    r_dr, p_dr, r_est, p_est = torch.stack([r_dr, p_dr, r_est, p_est]).cpu().numpy()
    out = {}
    for key, a, b in blocks:
        if b <= a:
            out[key] = EMPTY_EVAL2
            continue
        out[key] = Eval2Result(
            range_improved_pct=float((r_dr[a:b] > r_est[a:b]).mean() * 100.0),
            plane_improved_pct=float((p_dr[a:b] > p_est[a:b]).mean() * 100.0),
            n_pairs=int(b - a),
            avg_range_dr=float(r_dr[a:b].mean()),
            avg_range_est=float(r_est[a:b].mean()),
            avg_plane_dr=float(p_dr[a:b].mean()),
            avg_plane_est=float(p_est[a:b].mean()),
            range_dr_e=r_dr[a:b],
            range_est_e=r_est[a:b],
            plane_dr_e=p_dr[a:b],
            plane_est_e=p_est[a:b],
        )
    return out


def trajectory_ate_pair(dr_t: torch.Tensor, est: se3.Pose3, gt_rows: np.ndarray) -> tuple:
    """``(ate_dr, ate_est)``: translation RMSE of the DR (P, 3) and estimated
    positions against ground-truth DR-format rows (no alignment; the gauge is
    the first pose), with one host transfer."""
    gt = se3.from_rodrigues_xyz(torch.as_tensor(np.asarray(gt_rows), dtype=torch.float32, device=dr_t.device))

    def rmse(t):
        d = t - gt.t
        return torch.sqrt(torch.mean(torch.sum(d * d, dim=1)))

    a, b = torch.stack([rmse(dr_t), rmse(est.t)]).cpu().tolist()
    return float(a), float(b)
