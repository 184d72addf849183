"""Full bundle adjustment: joint poses + landmarks with Schur elimination.

Counterpart of :mod:`diasss_tpu.solvers.full_ba`: one nonlinear
least-squares problem over all ping poses and all correspondence landmarks,

    min  sum ||odo residuals||^2 + sum_k ( rho(||sss(L_k, X_{s_k})||^2) +
         rho(||sss(L_k, X_{t_k})||^2) + ||L_k prior||^2 ),

solved by Levenberg-Marquardt (Huber ``rho`` by IRLS).  Each trial
eliminates the landmarks (3x3 blocks) and solves the Schur-reduced pose
system: exactly (``"direct"``: the odometry chain by multi-RHS cyclic
reduction, the landmark couplings, 3 columns per correspondence, by
Woodbury with one dense Cholesky) or by preconditioned conjugate gradients
with the Schur-reduced product (``"jacobi"``, ``"tridiag"``,
``"dense_seg"``).  ``"auto"`` is the direct step under the JAX package's
size guard and ``"dense_seg"`` above it; ``"chain"`` is on ROADMAP's
not-to-port list.  :func:`ba_pose_marginals` gives the exact per-pose
marginal covariances at the solution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..config import FullBAConfig
from ..factors.between import between_residual
from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
from ..geometry import se3
from ..segments import Segments, chain_sum, segments
from .lm import cholesky_solve_or_nan

MAX_DIRECT_KPAD = 2048


class BAProblem(NamedTuple):
    poses0: se3.Pose3  # (P,)
    odo_meas: se3.Pose3  # (P-1,)
    odo_sigmas: torch.Tensor  # (6,)
    kp_i: torch.Tensor  # (K,) int64 global source ping index
    kp_j: torch.Tensor  # (K,) int64 global target ping index
    kp_sr_s: torch.Tensor  # (K,) source slant ranges
    kp_sr_t: torch.Tensor  # (K,)
    kp_valid: torch.Tensor  # (K,) bool
    lm0: torch.Tensor  # (K, 3) landmark initializations
    lm_prior: torch.Tensor  # (K, 3) prior centers (= lm0)
    lm_prior_sigmas: torch.Tensor  # (3,)
    # optional constant-pose endpoints: where kp_{i,j}_fix[k] the factor is
    # evaluated at kp_pose_{s,t}[k] and its pose Jacobian block is zero
    kp_i_fix: Optional[torch.Tensor] = None  # (K,) bool
    kp_j_fix: Optional[torch.Tensor] = None
    kp_pose_s: Optional[se3.Pose3] = None  # (K,)
    kp_pose_t: Optional[se3.Pose3] = None


class BAInfo(NamedTuple):
    error0: torch.Tensor
    error: torch.Tensor
    iterations: int  # LM trials run
    stall: int  # consecutive no-improvement trials at exit
    cg_iters_total: int  # CG iterations over all trials (0 for the direct step)
    solver_kind: str
    lam: Optional[torch.Tensor] = None  # () final LM damping (the resume state, with ``stall``)


def resolve_ba_solver_kind(preconditioner: str, P: int, K_pad: int) -> str:
    """The linear solve a full-BA run takes: ``"auto"`` is the direct
    Woodbury chain step while ``K_pad <= 2048`` and its ``(P, 6, 3K+1)``
    multi-RHS buffers (three of them) stay under 4 GB (the JAX package's
    guard), else ``"dense_seg"`` PCG; ``"direct"``, ``"jacobi"``,
    ``"tridiag"`` and ``"dense_seg"`` are taken as given."""
    kind = preconditioner
    if kind == "chain":
        raise NotImplementedError(
            "the 'chain' preconditioner (tridiag.ChainFactor) is an opt-in negative result on ROADMAP's "
            "not-to-port list; dense_seg is the PCG fallback"
        )
    if kind == "auto":
        mem_ok = P * 6 * (3 * K_pad + 1) * 4 * 3 < 4e9
        kind = "direct" if (K_pad <= MAX_DIRECT_KPAD and mem_ok) else "dense_seg"
    if kind not in ("direct", "jacobi", "tridiag", "dense_seg"):
        raise ValueError(f"unknown full-BA preconditioner {preconditioner!r}")
    return kind


def _sss_factor_terms(pose: se3.Pose3, lm: torch.Tensor, sr: torch.Tensor, sigmas: torch.Tensor):
    """Whitened residuals (K, 2) and Jacobians (K, 2, 6) pose, (K, 2, 3)
    landmark of a batch of sonar factors: forward-mode derivatives over the
    9 tangent directions on batched residuals."""
    Ts = se3.identity((), lm.dtype, lm.device)
    m = torch.stack([sr, torch.zeros_like(sr)], dim=-1)

    def f(d):
        return sss_point_residual(lm + d[:, 6:], se3.retract(pose, d[:, :6]), Ts, m) / sigmas

    K = lm.shape[0]
    zero = torch.zeros((K, 9), dtype=lm.dtype, device=lm.device)
    basis = torch.eye(9, dtype=lm.dtype, device=lm.device)[:, None, :].expand(9, K, 9)
    r = f(zero)
    J = vmap(lambda t: jvp(f, (zero,), (t,))[1])(basis).permute(1, 2, 0)  # (K, 2, 9)
    return r, J[..., :6], J[..., 6:]


def _endpoint_poses(poses: se3.Pose3, prob: BAProblem):
    """Per-factor endpoint poses: the optimized pose, or the constant pose
    where a fix mask is set."""
    pi = poses[prob.kp_i]
    pj = poses[prob.kp_j]
    if prob.kp_i_fix is not None:
        pi = se3.where(prob.kp_i_fix, prob.kp_pose_s, pi)
    if prob.kp_j_fix is not None:
        pj = se3.where(prob.kp_j_fix, prob.kp_pose_t, pj)
    return pi, pj


def _huber_rho(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber cost of a residual block given its squared norm (0.5*||r||^2 core)."""
    if delta <= 0:
        return 0.5 * sq_norm
    nr = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
    return torch.where(nr <= delta, 0.5 * sq_norm, delta * (nr - 0.5 * delta))


def _huber_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight sqrt(rho'(r)/r): multiply residual and Jacobian rows."""
    if delta <= 0:
        return torch.ones_like(sq_norm)
    nr = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
    return torch.sqrt(torch.clamp(delta / nr, max=1.0))


def _ba_error(poses: se3.Pose3, lms: torch.Tensor, prob: BAProblem, kp_cfg, huber_delta: float = 0.0):
    r_odo = between_residual(poses[:-1], poses[1:], prob.odo_meas) / prob.odo_sigmas
    Ts = se3.identity((), lms.dtype, lms.device)

    def kp_res(pose, sr):
        m = torch.stack([sr, torch.zeros_like(sr)], dim=-1)
        sig = kp_noise_sigmas(sr, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
        return sss_point_residual(lms, pose, Ts, m) / sig

    pose_i, pose_j = _endpoint_poses(poses, prob)
    v = prob.kp_valid[:, None]
    # where-mask (not multiply): padded slots can hold inf/nan residuals
    r_s = torch.where(v, kp_res(pose_i, prob.kp_sr_s), 0.0)
    r_t = torch.where(v, kp_res(pose_j, prob.kp_sr_t), 0.0)
    r_pr = torch.where(v, (lms - prob.lm_prior) / prob.lm_prior_sigmas, 0.0)
    return _ba_error_from_residuals(r_odo, r_s, r_t, r_pr, huber_delta)


def _ba_error_from_residuals(r_odo, r_s, r_t, r_pr, huber_delta: float) -> torch.Tensor:
    rob = torch.sum(_huber_rho(torch.sum(r_s ** 2, -1), huber_delta)) + torch.sum(
        _huber_rho(torch.sum(r_t ** 2, -1), huber_delta))
    return 0.5 * (torch.sum(r_odo ** 2) + torch.sum(r_pr ** 2)) + rob


def kp_segments(prob: BAProblem) -> Tuple[Segments, Segments]:
    """The segment plans of the sonar factors' source and target poses
    (``kp_i``, ``kp_j``); one pair per solve."""
    P = int(prob.poses0.t.shape[0])
    return segments(prob.kp_i, P), segments(prob.kp_j, P)


def _kp_sum(segs, xs: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """(P, ...) sums of per-correspondence terms, ``xs`` at ``kp_i`` and
    ``xt`` at ``kp_j``."""
    return segs[0].sum(xs) + segs[1].sum(xt)


def _schur_columns(prob, L_ll, Hpl_s, Hpl_t, P: int, K: int, k_cols):
    """The Schur coupling columns of the leading ``k_cols`` factor slots:
    ``Vhat = Hpl L_ll^-T`` (k, 6, 3) at each endpoint, pose-0 couplings
    zeroed (the gauge), their endpoint indices and the scattered ``V`` (P, 6,
    3k).  Slots past ``k_cols`` must be invalid padding."""
    from .pose_graph import woodbury_columns

    if k_cols is None or k_cols > K:
        k_cols = K
    Hpl_s, Hpl_t, L_ll = Hpl_s[:k_cols], Hpl_t[:k_cols], L_ll[:k_cols]
    kp_i, kp_j = prob.kp_i[:k_cols], prob.kp_j[:k_cols]
    Hpl_s0 = torch.where((kp_i == 0)[:, None, None], 0.0, Hpl_s)
    Hpl_t0 = torch.where((kp_j == 0)[:, None, None], 0.0, Hpl_t)
    Vhat_s = torch.linalg.solve_triangular(L_ll, Hpl_s0.transpose(-1, -2), upper=False).transpose(-1, -2)
    Vhat_t = torch.linalg.solve_triangular(L_ll, Hpl_t0.transpose(-1, -2), upper=False).transpose(-1, -2)
    return Vhat_s, Vhat_t, kp_i, kp_j, woodbury_columns(Vhat_s, Vhat_t, kp_i, kp_j, P)


def _direct_ba_step(prob, g_red, U_chain, D_p, L_ll, Hpl_s, Hpl_t, lam, P: int, K: int, k_cols=None):
    """Exact damped step of the Schur-reduced pose system, ``S = T' - V V^T``:

    * ``T'`` = odometry chain + per-pose sonar diagonal + damping, i.e.
      tridiag(diag = (1+lam) D_p, offdiag = U_chain), solved by multi-RHS
      cyclic reduction;
    * ``V`` = the Schur coupling columns ``Hpl L_ll^-T`` (3 per
      correspondence, two nonzero 6-row blocks each at ``kp_i``/``kp_j``,
      :func:`_schur_columns`).

    Woodbury with the subtracted sign: ``S^-1 b = w0 + Wv (I - V^T T'^-1
    V)^-1 V^T w0`` with ``[w0 | Wv] = T'^-1 [b | V]``.  A failed capacitance
    Cholesky gives NaN, so LM rejects the step.  ``k_cols``: leading factor
    slots that carry columns (slots past it must be invalid padding)."""
    from .pose_graph import columns_t
    from .tridiag import solve_block_tridiag_multi

    dtype, dev = D_p.dtype, D_p.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Vhat_s, Vhat_t, kp_i, kp_j, V = _schur_columns(prob, L_ll, Hpl_s, Hpl_t, P, K, k_cols)
    T_diag = (1.0 + lam) * D_p + 1e-6 * eye6
    T_diag[0] = eye6
    U = U_chain.clone()
    U[0] = 0.0

    W = solve_block_tridiag_multi(T_diag, U, torch.cat([(-g_red)[:, :, None], V], dim=2))
    del V
    w0, Wv = W[:, :, 0], W[:, :, 1:]
    C = torch.eye(Wv.shape[2], dtype=dtype, device=dev) - columns_t(Vhat_s, Vhat_t, kp_i, kp_j, Wv)
    c0 = columns_t(Vhat_s, Vhat_t, kp_i, kp_j, w0[..., None])[:, 0]
    y = cholesky_solve_or_nan(0.5 * (C + C.T), c0)
    delta = w0 + Wv @ y
    delta[0] = 0.0
    return delta


def _finish_trial(poses, lms, err, lam, delta_p, Jp_s, Jp_t, Jl_s, Jl_t, g_l, ll_solve, prob, kp_cfg, cfg, P):
    """Landmark back-substitution, retract, LM accept gate."""
    delta_p = delta_p.clone()
    delta_p[0] = 0.0
    hv = (Jp_s @ delta_p[prob.kp_i][..., None])[..., 0]
    ht = (Jp_t @ delta_p[prob.kp_j][..., None])[..., 0]
    w2 = (Jl_s.transpose(-1, -2) @ hv[..., None])[..., 0] + (Jl_t.transpose(-1, -2) @ ht[..., None])[..., 0]
    delta_l = ll_solve(-g_l - w2)

    not_gauge = torch.arange(P, device=delta_p.device) != 0
    new_poses = se3.where(not_gauge, se3.retract(poses, delta_p), poses)
    new_lms = lms + delta_l
    new_err = _ba_error(new_poses, new_lms, prob, kp_cfg, cfg.huber_delta)
    good = torch.isfinite(new_err) & (new_err < err)
    poses = se3.where(good.expand(P), new_poses, poses)
    lms = torch.where(good, new_lms, lms)
    err = torch.where(good, new_err, err)
    lam = torch.where(good, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 10.0, max=1e6))
    return poses, lms, err, lam


class _Normal(NamedTuple):
    """The Gauss-Newton blocks of one linearization (Huber IRLS weights
    applied, invalid slots zeroed; no damping, no gauge)."""

    Ja: torch.Tensor  # (P-1, 6, 6) odometry Jacobians, pose i and i+1
    Jb: torch.Tensor
    Jp_s: torch.Tensor  # (K, 2, 6) sonar factor pose Jacobians
    Jp_t: torch.Tensor
    Jl_s: torch.Tensor  # (K, 2, 3) landmark Jacobians
    Jl_t: torch.Tensor
    g_p: torch.Tensor  # (P, 6) pose gradient
    g_l: torch.Tensor  # (K, 3) landmark gradient
    D_p: torch.Tensor  # (P, 6, 6) pose diagonal blocks
    H_ll: torch.Tensor  # (K, 3, 3) landmark blocks
    Hpl_s: torch.Tensor  # (K, 6, 3) pose-landmark blocks
    Hpl_t: torch.Tensor
    U_chain: torch.Tensor  # (P-1, 6, 6) odometry couplings (i, i+1)


def _normal_blocks(poses, lms, prob: BAProblem, sig_s, sig_t, huber_delta: float, segs) -> _Normal:
    from .pose_graph import _linearize_between

    dtype, dev = lms.dtype, lms.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    r_o, Ja, Jb = _linearize_between(poses[:-1], poses[1:], prob.odo_meas, prob.odo_sigmas)

    pose_i, pose_j = _endpoint_poses(poses, prob)
    r_s, Jp_s, Jl_s = _sss_factor_terms(pose_i, lms, prob.kp_sr_s, sig_s)
    r_t, Jp_t, Jl_t = _sss_factor_terms(pose_j, lms, prob.kp_sr_t, sig_t)
    if prob.kp_i_fix is not None:
        Jp_s = torch.where(prob.kp_i_fix[:, None, None], 0.0, Jp_s)
    if prob.kp_j_fix is not None:
        Jp_t = torch.where(prob.kp_j_fix[:, None, None], 0.0, Jp_t)
    v1, v2 = prob.kp_valid[:, None], prob.kp_valid[:, None, None]
    r_s = torch.where(v1, r_s, 0.0)
    r_t = torch.where(v1, r_t, 0.0)
    # IRLS robustification: downweight gross sonar residuals (Huber)
    w_s = _huber_weight(torch.sum(r_s ** 2, -1), huber_delta)
    w_t = _huber_weight(torch.sum(r_t ** 2, -1), huber_delta)
    r_s, r_t = r_s * w_s[:, None], r_t * w_t[:, None]
    Jp_s = torch.where(v2, Jp_s * w_s[:, None, None], 0.0)
    Jp_t = torch.where(v2, Jp_t * w_t[:, None, None], 0.0)
    Jl_s = torch.where(v2, Jl_s * w_s[:, None, None], 0.0)
    Jl_t = torch.where(v2, Jl_t * w_t[:, None, None], 0.0)
    r_pr = torch.where(v1, (lms - prob.lm_prior) / prob.lm_prior_sigmas, 0.0)
    Jl_pr = (eye3 / prob.lm_prior_sigmas[:, None]).expand(lms.shape[0], 3, 3) * prob.kp_valid.to(dtype)[:, None, None]

    def tmv(J, r):  # J^T r per factor
        return (J.transpose(-1, -2) @ r[..., None])[..., 0]

    def tmm(A, B):  # A^T B per factor
        return A.transpose(-1, -2) @ B

    seg_i, seg_j = segs
    g_p = chain_sum(tmv(Ja, r_o), tmv(Jb, r_o)) + seg_i.sum(tmv(Jp_s, r_s)) + seg_j.sum(tmv(Jp_t, r_t))
    g_l = tmv(Jl_s, r_s) + tmv(Jl_t, r_t) + tmv(Jl_pr, r_pr)
    D_p = chain_sum(tmm(Ja, Ja), tmm(Jb, Jb)) + seg_i.sum(tmm(Jp_s, Jp_s)) + seg_j.sum(tmm(Jp_t, Jp_t))
    H_ll = tmm(Jl_s, Jl_s) + tmm(Jl_t, Jl_t) + tmm(Jl_pr, Jl_pr)
    return _Normal(Ja, Jb, Jp_s, Jp_t, Jl_s, Jl_t, g_p, g_l, D_p, H_ll, tmm(Jp_s, Jl_s), tmm(Jp_t, Jl_t),
                   tmm(Ja, Jb))


def _pcg_ba_step(kind: str, prob, segs, nb: _Normal, g_red, D_p, ll_solve, L_ll, lam, P: int,
                 cfg: FullBAConfig):
    """Damped step of the Schur-reduced pose system by PCG; returns (delta,
    CG iterations).  The product is applied factor-wise (odometry chain,
    sonar pose diagonal, damping, minus ``Hpl H_ll^-1 H_lp``).  The
    preconditioner works on the reduced system's block diagonal (damped
    ``D_p`` minus each factor's ``Hpl H_ll^-1 Hpl^T``, plus 1e-5 I), or on
    the block where its Cholesky fails, the damped ``D_p`` plus 1e-5 I
    instead: its blocks (``"jacobi"``; there one failed block switches them
    all), or the chain on it cut into segments, by cyclic reduction per
    application (``"tridiag"``) or inverted densely per trial
    (``"dense_seg"``)."""
    from .pose_graph import _cholesky_or_nan, _pcg
    from .tridiag import (apply_dense_segment_inverses, auto_dense_segment, dense_segment_inverses,
                          solve_block_tridiag_segmented)

    dev = D_p.device
    eye6 = torch.eye(6, dtype=D_p.dtype, device=dev)
    kp_i, kp_j = prob.kp_i, prob.kp_j
    Ja_t, Jb_t = nb.Ja.transpose(-1, -2), nb.Jb.transpose(-1, -2)
    Jps_t, Jpt_t = nb.Jp_s.transpose(-1, -2), nb.Jp_t.transpose(-1, -2)
    Jls_t, Jlt_t = nb.Jl_s.transpose(-1, -2), nb.Jl_t.transpose(-1, -2)

    def mv(J, v):
        return (J @ v[..., None])[..., 0]

    def matvec(v):
        v = torch.cat([torch.zeros_like(v[:1]), v[1:]])
        a = mv(nb.Ja, v[:-1]) + mv(nb.Jb, v[1:])
        out = chain_sum(mv(Ja_t, a), mv(Jb_t, a))
        b_s, b_t = mv(nb.Jp_s, v[kp_i]), mv(nb.Jp_t, v[kp_j])
        out = out + segs[0].sum(mv(Jps_t, b_s)) + segs[1].sum(mv(Jpt_t, b_t))
        out = out + lam * mv(D_p, v)
        yv = ll_solve(mv(Jls_t, b_s) + mv(Jlt_t, b_t))  # H_ll^-1 H_lp v
        out = out - _kp_sum(segs, mv(nb.Hpl_s, yv), mv(nb.Hpl_t, yv))
        out[0] = 0.0
        return out

    corr = _kp_sum(segs, nb.Hpl_s @ torch.cholesky_solve(nb.Hpl_s.transpose(-1, -2), L_ll),
                   nb.Hpl_t @ torch.cholesky_solve(nb.Hpl_t.transpose(-1, -2), L_ll))
    Dp_damped = D_p * (1.0 + lam) - corr
    Dp_damped[0] = eye6
    Dp_damped = Dp_damped + 1e-5 * eye6
    fallback = D_p * (1.0 + lam) + 1e-5 * eye6
    L_d = _cholesky_or_nan(Dp_damped)
    if kind == "jacobi":
        Lp = torch.where(torch.isfinite(L_d).all(), L_d, _cholesky_or_nan(fallback))

        def precond(v):
            return torch.cholesky_solve(v[..., None], Lp)[..., 0]
    else:
        D_pc = torch.where(torch.isfinite(L_d).all(-1, keepdim=True).all(-2, keepdim=True), Dp_damped, fallback)
        U = nb.U_chain.clone()
        U[0] = 0.0
        if kind == "dense_seg":
            Minv = dense_segment_inverses(D_pc, U, auto_dense_segment(P, cfg.tridiag_segment))

            def precond(v):
                return apply_dense_segment_inverses(Minv, v)
        else:
            def precond(v):
                return solve_block_tridiag_segmented(D_pc, U, v, cfg.tridiag_segment)

    return _pcg(matvec, -g_red, precond, cfg.cg_tol, cfg.cg_max_iters)


def _trial(poses, lms, err, lam, prob: BAProblem, segs, sig_s, sig_t, cfg: FullBAConfig, kp_cfg, kind: str,
           k_cols):
    """One LM trial; returns (poses, lms, err, lam, CG iterations)."""
    from .pose_graph import _cholesky_or_nan

    P = poses.t.shape[0]
    dtype, dev = lms.dtype, lms.device
    nb = _normal_blocks(poses, lms, prob, sig_s, sig_t, cfg.huber_delta, segs)
    L_ll = _cholesky_or_nan(nb.H_ll * (1.0 + lam) + 1e-6 * torch.eye(3, dtype=dtype, device=dev))

    def ll_solve(x):  # (K, 3)
        return torch.cholesky_solve(x[..., None], L_ll)[..., 0]

    g_p = nb.g_p.clone()
    g_p[0] = 0.0
    D_p = nb.D_p.clone()
    D_p[0] = torch.eye(6, dtype=dtype, device=dev)
    y = ll_solve(nb.g_l)
    g_red = g_p - _kp_sum(segs, (nb.Hpl_s @ y[..., None])[..., 0], (nb.Hpl_t @ y[..., None])[..., 0])
    g_red[0] = 0.0
    if kind == "direct":
        delta_p = _direct_ba_step(prob, g_red, nb.U_chain, D_p, L_ll, nb.Hpl_s, nb.Hpl_t, lam, P,
                                  int(prob.kp_i.shape[0]), k_cols=k_cols)
        cg_k = 0
    else:
        delta_p, cg_k = _pcg_ba_step(kind, prob, segs, nb, g_red, D_p, ll_solve, L_ll, lam, P, cfg)
    return _finish_trial(poses, lms, err, lam, delta_p, nb.Jp_s, nb.Jp_t, nb.Jl_s, nb.Jl_t, nb.g_l, ll_solve,
                         prob, kp_cfg, cfg, P) + (cg_k,)


def solve_full_ba(prob: BAProblem, cfg: FullBAConfig, kp_cfg, lam0=None, stall0=None,
                  k_direct_cols: int | None = None):
    """LM with per-trial Schur-eliminated solves; returns (poses, landmarks,
    BAInfo).  A Python loop of trials: the accept/reject and damping update
    stay on the device; the stall flag (two consecutive trials improving the
    error by < 1e-6 relative end the solve) costs one host read per trial,
    and a PCG step one per ``pose_graph.CG_CHUNK`` CG iterations.
    ``lam0`` / ``stall0`` resume the damping (else 1e-4) and the stall
    counter (else 0) of a checkpoint (:mod:`..checkpoint`); ``BAInfo.lam``
    is the damping at exit.  ``k_direct_cols``: leading factor slots that
    carry Woodbury columns in the direct step (the padding tail is
    invalid); None = all K slots."""
    P = prob.poses0.t.shape[0]
    dtype, dev = prob.poses0.t.dtype, prob.poses0.t.device
    kind = resolve_ba_solver_kind(cfg.preconditioner, P, int(prob.kp_i.shape[0]))
    sig_s = kp_noise_sigmas(prob.kp_sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_t = kp_noise_sigmas(prob.kp_sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    err0 = _ba_error(prob.poses0, prob.lm0, prob, kp_cfg, cfg.huber_delta)
    poses, lms, err = prob.poses0, prob.lm0, err0
    segs = kp_segments(prob)
    lam = torch.tensor(1e-4 if lam0 is None else float(lam0), dtype=dtype, device=dev)
    stall = 0 if stall0 is None else int(stall0)
    k = cg_total = 0
    while k < cfg.max_iters and stall < 2:
        poses, lms, err2, lam, cg_k = _trial(poses, lms, err, lam, prob, segs, sig_s, sig_t, cfg, kp_cfg, kind,
                                             k_direct_cols)
        improved = bool((err - err2) > 1e-6 * torch.clamp(err, min=1e-30))
        err = err2
        k += 1
        cg_total += cg_k
        stall = 0 if improved else stall + 1
    return poses, lms, BAInfo(error0=err0, error=err, iterations=k, stall=stall, cg_iters_total=cg_total,
                              solver_kind=kind, lam=lam)


def ba_pose_marginals(prob: BAProblem, poses: se3.Pose3, lms: torch.Tensor, cfg: FullBAConfig, kp_cfg,
                      k_cols: int | None = None) -> torch.Tensor:
    """(P, 6, 6) exact marginal covariance blocks of the BA pose estimate:
    the block diagonal of the inverse Schur complement ``S^-1 = (T - V
    V^T)^-1`` at the solution,

        diag(S^-1)_p = diag(T^-1)_p + Wv_p (I - V^T T^-1 V)^-1 Wv_p^T,

    ``T`` the gauge-fixed chain (selected inversion along the
    cyclic-reduction levels), ``V`` the Schur coupling columns of the direct
    step trimmed to ``k_cols`` (slots past it must be invalid), ``Wv = T^-1
    V`` from one multi-RHS cyclic reduction.  The linearization is the
    solver's at the solution (Huber IRLS weights, constant-pose endpoints),
    undamped, in float32; the rest runs in float64, as
    :func:`.pose_graph.pg_pose_marginals` explains, and the result is
    float64.  Pose 0 is the gauge (zero covariance)."""
    from .pose_graph import _cholesky_or_nan, columns_t, lowrank_diag_blocks
    from .tridiag import block_tridiag_selected_inverse, solve_block_tridiag_multi

    P = prob.poses0.t.shape[0]
    dtype, dev = torch.float64, prob.poses0.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    sig_s = kp_noise_sigmas(prob.kp_sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_t = kp_noise_sigmas(prob.kp_sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    nb = _Normal(*[x.to(dtype) for x in _normal_blocks(poses, lms, prob, sig_s, sig_t, cfg.huber_delta,
                                                       kp_segments(prob))])
    L_ll = _cholesky_or_nan(nb.H_ll + 1e-6 * torch.eye(3, dtype=dtype, device=dev))
    T_diag = nb.D_p + 1e-6 * eye6
    T_diag[0] = eye6
    U = nb.U_chain.clone()
    U[0] = 0.0
    Vhat_s, Vhat_t, kp_i, kp_j, V = _schur_columns(prob, L_ll, nb.Hpl_s, nb.Hpl_t, P, int(prob.kp_i.shape[0]),
                                                   k_cols)
    Wv = solve_block_tridiag_multi(T_diag, U, V)
    del V
    C = torch.eye(Wv.shape[2], dtype=dtype, device=dev) - columns_t(Vhat_s, Vhat_t, kp_i, kp_j, Wv)
    cov = block_tridiag_selected_inverse(T_diag, U) + lowrank_diag_blocks(Wv, _cholesky_or_nan(0.5 * (C + C.T)))
    cov[0] = 0.0
    return cov


def _gather_geo_endpoints(frames, fs, ping_s, bin_s, ft, ping_t, bin_t):
    """(K, 2) world-xy geo endpoints of each correspondence, source and
    target: one device gather over all frames' geo, one transfer."""
    geos = [f.geo for f in frames]
    dev = geos[0].device
    sizes = np.array([g.shape[0] * g.shape[1] for g in geos], np.int64)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ncols = np.array([g.shape[1] for g in geos], np.int64)
    idx = np.concatenate([base[fs] + ping_s * ncols[fs] + bin_s, base[ft] + ping_t * ncols[ft] + bin_t])
    flat = torch.cat([g.reshape(-1, 2) for g in geos])
    g = flat[torch.as_tensor(idx, device=dev)].cpu().numpy()
    K = len(fs)
    return g[:K], g[K:]


def build_ba_problem(frames, kps_pairs: dict, pair_ids, ba_cfg: FullBAConfig, pose_cfg, rng=None) -> BAProblem:
    """Assemble a BAProblem from keyframes + per-pair keypoint batches.

    Every nadir-passing correspondence becomes a landmark (no quality gate).
    DR rows and altitudes are read with one host copy each; the initial-value
    noise of the chain comes from ``rng`` (``rng.normal``), as
    :func:`.pose_graph.build_chain_graph` takes it."""
    from .pose_graph import build_chain_graph

    dev = frames[0].geo.device
    dr_all = torch.cat([f.dr_poses for f in frames]).cpu().numpy()
    alt_all = torch.cat([f.altitudes for f in frames]).cpu().numpy()
    offsets = np.cumsum([0] + [int(f.dr_poses.shape[0]) for f in frames])

    fs_l, ft_l, cols_l = [], [], []
    for (i, j) in pair_ids:
        kp = kps_pairs[(i, j)]
        rows = kp.pairs[kp.valid]
        if not len(rows):
            continue
        fs_l.append(np.full(len(rows), i, np.int64))
        ft_l.append(np.full(len(rows), j, np.int64))
        cols_l.append(rows)

    if fs_l:
        fs, ft, rows = np.concatenate(fs_l), np.concatenate(ft_l), np.concatenate(cols_l)
        ping_s, bin_s = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
        ping_t, bin_t = rows[:, 3].astype(np.int64), rows[:, 4].astype(np.int64)
        sr_s, sr_t = rows[:, 2], rows[:, 5]
        g1, g2 = _gather_geo_endpoints(frames, fs, ping_s, bin_s, ft, ping_t, bin_t)
        kp_i = offsets[fs] + ping_s
        kp_j = offsets[ft] + ping_t
        if ba_cfg.max_geo_discrepancy > 0:
            keep = np.linalg.norm(g1 - g2, axis=1) <= ba_cfg.max_geo_discrepancy
            kp_i, kp_j = kp_i[keep], kp_j[keep]
            sr_s, sr_t = sr_s[keep], sr_t[keep]
            g1, g2 = g1[keep], g2[keep]
        z = 0.5 * ((dr_all[kp_i, 5] - alt_all[kp_i]) + (dr_all[kp_j, 5] - alt_all[kp_j]))
        lm0 = np.concatenate([0.5 * (g1 + g2), z[:, None]], axis=1)
        valid = np.ones(len(kp_i), bool)
    else:
        kp_i = np.zeros(1, np.int64)
        kp_j = np.zeros(1, np.int64)
        sr_s = np.ones(1)
        sr_t = np.ones(1)
        lm0 = np.zeros((1, 3))
        valid = np.zeros(1, bool)

    # pad the correspondence batch to a power of two
    K = len(kp_i)
    cap = max(1, int(2 ** np.ceil(np.log2(K)))) if K else 1
    pad = cap - K

    def up(a, dtype, fill=0):
        a = np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)]) if pad else a
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    chain = build_chain_graph(
        [f.dr_poses for f in frames], lc_i=np.zeros(1, np.int64), lc_j=np.ones(1, np.int64),
        lc_meas=se3.identity((1,), torch.float32, dev), lc_sigmas=np.ones((1, 6), np.float32),
        lc_valid=np.zeros(1, bool), cfg=pose_cfg, rng=rng, device=dev,
    )
    return BAProblem(
        poses0=chain.poses0,
        odo_meas=chain.odo_meas,
        odo_sigmas=chain.odo_sigmas,
        kp_i=up(kp_i, torch.int64),
        kp_j=up(kp_j, torch.int64),
        kp_sr_s=up(sr_s, torch.float32, 1.0),
        kp_sr_t=up(sr_t, torch.float32, 1.0),
        kp_valid=up(valid, torch.bool),
        lm0=up(lm0, torch.float32),
        lm_prior=up(lm0, torch.float32),
        lm_prior_sigmas=torch.tensor(
            [ba_cfg.lm_prior_xy_sigma, ba_cfg.lm_prior_xy_sigma, ba_cfg.lm_prior_z_sigma],
            dtype=torch.float32, device=dev),
    )
