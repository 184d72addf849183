"""Batched loop-closure transform estimation (optimizer.cpp:641-982).

Counterpart of :mod:`diasss_tpu.solvers.lc`: one 9-dof LM mini-problem per
keypoint correspondence (target pose + landmark; the source pose is held at
its DR value), all correspondences in one batch.  Per correspondence the
outputs are the relative pose, the marginal variances of the target pose, the
quality score ``ini_dist / fnl_dist - 2`` (accept if > 0) and the eval_2 /
depth dump columns.  The compass-flip guard pre-composes a yaw-pi rotation
when ``|yaw| > 2*pi/3``, strictly per correspondence.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import KeypointNoiseConfig, LoopClosureConfig

from ..factors.between import between_residual
from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
from ..geometry import se3, sonar
from .lm import levenberg_marquardt, marginal_covariance
from .triangulate import triangulate_batch

_DEG = math.pi / 180.0


class LCState(NamedTuple):
    """Variables of one mini problem: the target pose and the landmark."""

    X2: se3.Pose3
    L: torch.Tensor


class LCResult(NamedTuple):
    rel_pose: se3.Pose3  # (K,) relative transform source ping -> target ping
    variance6: torch.Tensor  # (K, 6) marginal variances of the target pose
    quality: torch.Tensor  # (K,) ini/fnl geo-dist ratio - 2 (accept if > 0)
    valid: torch.Tensor  # (K,) input validity mask
    ini_dist: torch.Tensor
    fnl_dist: torch.Tensor
    dr_range_e: torch.Tensor
    dr_plane_e: torch.Tensor
    est_range_e: torch.Tensor
    est_plane_e: torch.Tensor
    depth_est: torch.Tensor
    depth_drape: torch.Tensor
    lm_iters: torch.Tensor


def _retract(state: LCState, delta: torch.Tensor) -> LCState:
    return LCState(X2=se3.retract(state.X2, delta[..., 0:6]), L=state.L + delta[..., 6:9])


def _compass_flip(yaw: torch.Tensor, threshold: float) -> se3.Pose3:
    """yaw-pi pre-composition pose where ``|yaw|`` exceeds the threshold."""
    ang = torch.where(torch.abs(yaw) > threshold, math.pi, 0.0).to(yaw.dtype)
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(ang), torch.ones_like(ang)
    R = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)], -2)
    return se3.Pose3(R=R, t=torch.zeros((*ang.shape, 3), dtype=yaw.dtype, device=yaw.device))


def _lc_residual(state: LCState, Tp_s, Ts, Tp_st, sig_odo, sig_kp1, sig_kp2, m1, m2):
    r_odo = between_residual(Tp_s, state.X2, Tp_st) / sig_odo
    r_kp1 = sss_point_residual(state.L, Tp_s, Ts, m1) / sig_kp1
    r_kp2 = sss_point_residual(state.L, state.X2, Ts, m2) / sig_kp2
    return torch.cat([r_odo, r_kp1, r_kp2], dim=-1)


def _solve_batch(pair, row_s, row_t, g_s, g_t, alt_s, alt_t, gras_t, n_bins,
                kp_cfg: KeypointNoiseConfig, cfg: LoopClosureConfig):
    """The JAX package's per-correspondence ``_solve_one``, over a batch of K
    correspondences: pair (K, 7), DR rows (K, 6), geo (K, 2), altitudes (K,),
    target ground-range tables (K, G), the source frame's bin count (an int
    or (K,))."""
    dtype, dev = row_s.dtype, row_s.device
    K = pair.shape[0]
    bin_t = pair[:, 4].to(torch.int64)
    sr_s, sr_t = pair[:, 2], pair[:, 5]

    cps_s = _compass_flip(row_s[:, 2], cfg.compass_flip_yaw)
    cps_t = _compass_flip(row_t[:, 2], cfg.compass_flip_yaw)
    Tp_s = se3.compose(se3.from_rodrigues_xyz(row_s), cps_s)
    Tp_t = se3.compose(se3.from_rodrigues_xyz(row_t), cps_t)
    Tp_st = se3.between(Tp_s, Tp_t)
    Ts = se3.identity((K,), dtype, dev)  # zero lever arms (frame.cpp:38-39)

    sig_kp1 = kp_noise_sigmas(sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_kp2 = kp_noise_sigmas(sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)

    def const(v):
        return torch.full((K,), v, dtype=dtype, device=dev)

    sig_odo = torch.stack([
        const(cfg.odo_sigma_ro_deg * _DEG),
        const(cfg.odo_sigma_pi_deg * _DEG),
        const(cfg.odo_sigma_ya_deg * _DEG),
        torch.clamp(torch.abs(Tp_st.t[:, 0]) * cfg.odo_x_scale, min=1e-3),
        torch.clamp(torch.abs(Tp_st.t[:, 1]) * cfg.odo_y_scale, min=1e-3),
        const(cfg.odo_sigma_z),
    ], dim=-1)
    m1 = torch.stack([sr_s, torch.zeros_like(sr_s)], dim=-1)
    m2 = torch.stack([sr_t, torch.zeros_like(sr_t)], dim=-1)

    # landmark init: midpoint of geo projections, z = mean(pose_z - altitude)
    z_bar = 0.5 * ((row_s[:, 5] - alt_s) + (row_t[:, 5] - alt_t))
    L0 = torch.stack([0.5 * (g_s[:, 0] + g_t[:, 0]), 0.5 * (g_s[:, 1] + g_t[:, 1]), z_bar], dim=-1)

    res = levenberg_marquardt(
        _lc_residual, _retract, LCState(X2=Tp_t, L=L0),
        (Tp_s, Ts, Tp_st, sig_odo, sig_kp1, sig_kp2, m1, m2), 9, max_iters=cfg.max_lm_iters,
    )
    X2_est, L_est = res.x.X2, res.x.L
    var6 = torch.diagonal(marginal_covariance(res.hessian, slice(0, 6)), dim1=-2, dim2=-1)

    src = se3.compose(Tp_s, se3.inverse(cps_s))
    dst = se3.compose(X2_est, se3.inverse(cps_t))
    rel = se3.between(src, dst)

    ini_dist = torch.linalg.norm(g_s - g_t, dim=-1)
    lm_geo_t = sonar.project_landmark_geo(dst.t[:, :2], torch.atan2(dst.R[:, 1, 0], dst.R[:, 0, 0]),
                                          bin_t, gras_t, n_bins)
    fnl_dist = torch.linalg.norm(g_s - lm_geo_t, dim=-1)
    quality = ini_dist / torch.clamp(fnl_dist, min=1e-9) - cfg.quality_threshold

    lm_dr = triangulate_batch(Tp_s, Tp_t, Ts, Ts, sr_s, sr_t, L0, kp_cfg, cfg, True)

    def range_plane(Ta, Tb, lm):
        la = se3.transform_to(Ts, se3.transform_to(Ta, lm))
        lb = se3.transform_to(Ts, se3.transform_to(Tb, lm))
        rng = 0.5 * (torch.abs(torch.linalg.norm(la, dim=-1) - sr_s) + torch.abs(torch.linalg.norm(lb, dim=-1) - sr_t))
        return rng, 0.5 * (torch.abs(la[:, 0]) + torch.abs(lb[:, 0]))

    dr_range_e, dr_plane_e = range_plane(Tp_s, Tp_t, lm_dr)
    est_range_e, est_plane_e = range_plane(Tp_s, X2_est, L_est)
    return (rel, var6, quality, ini_dist, fnl_dist, dr_range_e, dr_plane_e,
            est_range_e, est_plane_e, L_est[:, 2], pair[:, 6], res.iterations)


def _result(out, valid: torch.Tensor) -> LCResult:
    rel, var6, quality, *rest = out
    # padded slots never become loop closures
    quality = torch.where(valid, quality, torch.full_like(quality, -math.inf))
    return LCResult(rel, var6, quality, valid, *rest)


def _gather_inputs(pairs, dr_s, dr_t, geo_s, geo_t, alts_s, alts_t):
    """Per-correspondence gathers from one frame pair's arrays."""
    id_s, id_t = pairs[:, 0].to(torch.int64), pairs[:, 3].to(torch.int64)
    bin_s, bin_t = pairs[:, 1].to(torch.int64), pairs[:, 4].to(torch.int64)
    return dr_s[id_s], dr_t[id_t], geo_s[id_s, bin_s], geo_t[id_t, bin_t], alts_s[id_s], alts_t[id_t]


def loop_closing_tfs_stacked(
    pairs: torch.Tensor,  # (K, 7) correspondences of ALL frame pairs
    valid: torch.Tensor,  # (K,)
    src_frame: torch.Tensor,  # (K,) source frame index
    tgt_frame: torch.Tensor,  # (K,) target frame index
    dr_all: torch.Tensor,  # (F, N, 6)
    geo_all: torch.Tensor,  # (F, N, M, 2)
    alts_all: torch.Tensor,  # (F, N)
    gras_all: torch.Tensor,  # (F, G)
    n_bins,  # int, or (F,) one bin count per frame
    kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
    cfg: LoopClosureConfig = LoopClosureConfig(),
) -> LCResult:
    """Whole-survey loop-closure solve: every correspondence of every frame
    pair in one batch (per-frame inputs gathered on the device).

    On a survey whose lines differ in bin count, ``n_bins`` holds each
    frame's count, and ``dr_all`` / ``geo_all`` / ``alts_all`` are padded to
    the longest ping and bin axes.  Each correspondence takes its source
    frame's bin count and its target frame's ground-range table, as the JAX
    package's per-pair solve does; a table shorter than ``G`` is padded with
    its last entry, which is what the JAX package's clamped read of a short
    table returns."""
    id_s, id_t = pairs[:, 0].to(torch.int64), pairs[:, 3].to(torch.int64)
    bin_s, bin_t = pairs[:, 1].to(torch.int64), pairs[:, 4].to(torch.int64)
    sf, tf = src_frame.to(torch.int64), tgt_frame.to(torch.int64)
    out = _solve_batch(
        pairs, dr_all[sf, id_s], dr_all[tf, id_t], geo_all[sf, id_s, bin_s], geo_all[tf, id_t, bin_t],
        alts_all[sf, id_s], alts_all[tf, id_t], gras_all[tf],
        n_bins[sf] if isinstance(n_bins, torch.Tensor) else n_bins, kp_cfg, cfg,
    )
    return _result(out, valid)


def loop_closing_tfs(
    pairs: torch.Tensor,  # (K, 7) padded keypoint pairs of one frame pair
    valid: torch.Tensor,
    dr_s, dr_t, geo_s, geo_t, alts_s, alts_t, gras_t,
    n_bins: int,
    kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
    cfg: LoopClosureConfig = LoopClosureConfig(),
) -> LCResult:
    """All K loop-closure mini problems of one frame pair in one batch."""
    gathered = _gather_inputs(pairs, dr_s, dr_t, geo_s, geo_t, alts_s, alts_t)
    out = _solve_batch(pairs, *gathered, gras_t.expand(pairs.shape[0], -1), n_bins, kp_cfg, cfg)
    return _result(out, valid)
