"""Batched landmark triangulation from two sonar observations
(optimizer.cpp:984-1021).

Counterpart of :mod:`diasss_tpu.solvers.triangulate`: one 3-dof LM per
landmark, all landmarks in one batch, with the xy-loose / z-tight point prior
``(10, 10, baseline/100)`` when ``with_prior``.
"""

from __future__ import annotations

import torch

from ..config import KeypointNoiseConfig, LoopClosureConfig

from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
from ..geometry import se3


def _tria_residual(L, Tp_s, Tp_t, Ts_s, Ts_t, sig_s, sig_t, m_s, m_t, lm_prior, prior_sigmas):
    r1 = sss_point_residual(L, Tp_s, Ts_s, m_s) / sig_s
    r2 = sss_point_residual(L, Tp_t, Ts_t, m_t) / sig_t
    return torch.cat([r1, r2, (L - lm_prior) / prior_sigmas], dim=-1)


def _tria_residual_no_prior(L, Tp_s, Tp_t, Ts_s, Ts_t, sig_s, sig_t, m_s, m_t):
    r1 = sss_point_residual(L, Tp_s, Ts_s, m_s) / sig_s
    r2 = sss_point_residual(L, Tp_t, Ts_t, m_t) / sig_t
    return torch.cat([r1, r2], dim=-1)


def _add(L, delta):
    return L + delta


def triangulate_batch(
    Tp_s: se3.Pose3,
    Tp_t: se3.Pose3,
    Ts_s: se3.Pose3,
    Ts_t: se3.Pose3,
    sr_s: torch.Tensor,
    sr_t: torch.Tensor,
    lm_init: torch.Tensor,
    kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
    lc_cfg: LoopClosureConfig = LoopClosureConfig(),
    with_prior: bool = True,
) -> torch.Tensor:
    """Triangulate K landmarks at once; every argument batched on dim 0."""
    from .lm import levenberg_marquardt

    sig_s = kp_noise_sigmas(sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_t = kp_noise_sigmas(sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    m_s = torch.stack([sr_s, torch.zeros_like(sr_s)], dim=-1)
    m_t = torch.stack([sr_t, torch.zeros_like(sr_t)], dim=-1)
    args = (Tp_s, Tp_t, Ts_s, Ts_t, sig_s, sig_t, m_s, m_t)
    if with_prior:
        baseline = torch.linalg.norm(Tp_s.t[..., :2] - Tp_t.t[..., :2], dim=-1)
        xy = torch.full_like(baseline, lc_cfg.tria_xy_sigma)
        prior_sigmas = torch.stack([xy, xy, torch.clamp(baseline / lc_cfg.tria_z_baseline_div, min=1e-6)], dim=-1)
        res = levenberg_marquardt(_tria_residual, _add, lm_init, args + (lm_init, prior_sigmas), 3,
                                  max_iters=lc_cfg.max_lm_iters)
    else:
        res = levenberg_marquardt(_tria_residual_no_prior, _add, lm_init, args, 3,
                                  max_iters=lc_cfg.max_lm_iters)
    return res.x
