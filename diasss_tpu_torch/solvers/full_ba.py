"""Full bundle adjustment: joint poses + landmarks with Schur elimination.

Counterpart of the direct path of :mod:`diasss_tpu.solvers.full_ba`: one
nonlinear least-squares problem over all ping poses and all correspondence
landmarks,

    min  sum ||odo residuals||^2 + sum_k ( rho(||sss(L_k, X_{s_k})||^2) +
         rho(||sss(L_k, X_{t_k})||^2) + ||L_k prior||^2 ),

solved by Levenberg-Marquardt (Huber ``rho`` by IRLS).  Each trial eliminates
the landmarks (3x3 blocks) and solves the Schur-reduced pose system exactly:
the odometry chain by multi-RHS cyclic reduction, the landmark couplings (3
columns per correspondence) by Woodbury with one dense Cholesky.

``"auto"`` resolves to that direct step on every device, under the JAX
package's size guard; above it, and for the PCG family, the port raises
(ROADMAP A7).  ``ba_pose_marginals`` is not ported (ROADMAP A9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp, vmap

from ..config import FullBAConfig
from ..factors.between import between_residual
from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
from ..geometry import se3
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
    solver_kind: str


def resolve_ba_solver_kind(preconditioner: str, P: int, K_pad: int) -> str:
    """The linear solve a full-BA run takes: ``"auto"`` and ``"direct"`` are
    the direct Woodbury chain step on every device while ``K_pad <= 2048``
    and its ``(P, 6, 3K+1)`` multi-RHS buffers stay under 4 GB (the JAX
    package's guard).  Above the guard, or for any PCG kind, not ported."""
    if preconditioner not in ("auto", "direct"):
        raise NotImplementedError(
            f"full-BA preconditioner {preconditioner!r} is not ported; only the direct step is "
            "(ROADMAP A7: dense_seg and the PCG family)"
        )
    mem_ok = P * 6 * (3 * K_pad + 1) * 4 * 3 < 4e9
    if not (K_pad <= MAX_DIRECT_KPAD and mem_ok):
        raise NotImplementedError(
            f"{K_pad} padded correspondences over {P} poses exceed the direct step's guard "
            f"(K_pad <= {MAX_DIRECT_KPAD}, (P, 6, 3K+1) buffers < 4 GB); the dense_seg fallback is "
            "not ported (ROADMAP A7)"
        )
    return "direct"


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


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, P: int) -> torch.Tensor:
    return torch.zeros((P,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _direct_ba_step(prob, g_red, U_chain, D_p, L_ll, Hpl_s, Hpl_t, lam, P: int, K: int, k_cols=None):
    """Exact damped step of the Schur-reduced pose system, ``S = T' - V V^T``:

    * ``T'`` = odometry chain + per-pose sonar diagonal + damping, i.e.
      tridiag(diag = (1+lam) D_p, offdiag = U_chain), solved by multi-RHS
      cyclic reduction;
    * ``V`` = the Schur coupling columns ``Hpl L_ll^-T`` (3 per
      correspondence, two nonzero 6-row blocks each at ``kp_i``/``kp_j``),
      built by a scatter into zeros (``index_put_`` with accumulation; the
      JAX package's one-hot product gives the same values).

    Woodbury with the subtracted sign: ``S^-1 b = w0 + Wv (I - V^T T'^-1
    V)^-1 V^T w0`` with ``[w0 | Wv] = T'^-1 [b | V]``.  A failed capacitance
    Cholesky gives NaN, so LM rejects the step.  ``k_cols``: leading factor
    slots that carry columns (slots past it must be invalid padding)."""
    from .tridiag import solve_block_tridiag_multi

    dtype, dev = D_p.dtype, D_p.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    if k_cols is None or k_cols > K:
        k_cols = K
    K = k_cols
    Hpl_s, Hpl_t, L_ll = Hpl_s[:K], Hpl_t[:K], L_ll[:K]
    kp_i, kp_j = prob.kp_i[:K], prob.kp_j[:K]

    # gauge: pose-0-touching Schur couplings vanish
    Hpl_s0 = torch.where((kp_i == 0)[:, None, None], 0.0, Hpl_s)
    Hpl_t0 = torch.where((kp_j == 0)[:, None, None], 0.0, Hpl_t)
    Vhat_s = torch.linalg.solve_triangular(L_ll, Hpl_s0.transpose(-1, -2), upper=False).transpose(-1, -2)
    Vhat_t = torch.linalg.solve_triangular(L_ll, Hpl_t0.transpose(-1, -2), upper=False).transpose(-1, -2)

    ar = torch.arange(K, device=dev)
    V = torch.zeros((P, K, 6, 3), dtype=dtype, device=dev)
    V.index_put_((kp_i, ar), Vhat_s, accumulate=True)
    V.index_put_((kp_j, ar), Vhat_t, accumulate=True)
    V = V.permute(0, 2, 1, 3).reshape(P, 6, 3 * K)

    T_diag = (1.0 + lam) * D_p + 1e-6 * eye6
    T_diag[0] = eye6
    U = U_chain.clone()
    U[0] = 0.0

    W = solve_block_tridiag_multi(T_diag, U, torch.cat([(-g_red)[:, :, None], V], dim=2))
    del V
    w0, Wv = W[:, :, 0], W[:, :, 1:]
    AW = Vhat_s.transpose(-1, -2) @ Wv[kp_i] + Vhat_t.transpose(-1, -2) @ Wv[kp_j]  # (K, 3, 3K)
    C = torch.eye(3 * K, dtype=dtype, device=dev) - AW.reshape(3 * K, 3 * K)
    del AW
    c0 = (Vhat_s.transpose(-1, -2) @ w0[kp_i][..., None] + Vhat_t.transpose(-1, -2) @ w0[kp_j][..., None]).reshape(-1)
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


def _trial(poses, lms, err, lam, prob: BAProblem, sig_s, sig_t, cfg: FullBAConfig, kp_cfg, k_cols):
    from .pose_graph import _linearize_between

    P = poses.t.shape[0]
    dtype, dev = lms.dtype, lms.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    idx_a = torch.arange(P - 1, device=dev)
    idx_b = idx_a + 1
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
    w_s = _huber_weight(torch.sum(r_s ** 2, -1), cfg.huber_delta)
    w_t = _huber_weight(torch.sum(r_t ** 2, -1), cfg.huber_delta)
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

    g_p = (_segment_sum(tmv(Ja, r_o), idx_a, P) + _segment_sum(tmv(Jb, r_o), idx_b, P)
           + _segment_sum(tmv(Jp_s, r_s), prob.kp_i, P) + _segment_sum(tmv(Jp_t, r_t), prob.kp_j, P))
    g_l = tmv(Jl_s, r_s) + tmv(Jl_t, r_t) + tmv(Jl_pr, r_pr)
    D_p = (_segment_sum(tmm(Ja, Ja), idx_a, P) + _segment_sum(tmm(Jb, Jb), idx_b, P)
           + _segment_sum(tmm(Jp_s, Jp_s), prob.kp_i, P) + _segment_sum(tmm(Jp_t, Jp_t), prob.kp_j, P))
    H_ll = (tmm(Jl_s, Jl_s) + tmm(Jl_t, Jl_t) + tmm(Jl_pr, Jl_pr)) * (1.0 + lam) + 1e-6 * eye3
    L_ll, info = torch.linalg.cholesky_ex(H_ll)
    L_ll = torch.where((info != 0)[:, None, None], float("nan"), L_ll)  # as jnp.linalg.cholesky

    def ll_solve(x):  # (K, 3)
        return torch.cholesky_solve(x[..., None], L_ll)[..., 0]

    Hpl_s = tmm(Jp_s, Jl_s)  # (K, 6, 3)
    Hpl_t = tmm(Jp_t, Jl_t)
    g_p[0] = 0.0
    D_p[0] = torch.eye(6, dtype=dtype, device=dev)
    y = ll_solve(g_l)
    g_red = g_p - (_segment_sum((Hpl_s @ y[..., None])[..., 0], prob.kp_i, P)
                   + _segment_sum((Hpl_t @ y[..., None])[..., 0], prob.kp_j, P))
    g_red[0] = 0.0
    U_chain = tmm(Ja, Jb)  # (P-1, 6, 6)
    delta_p = _direct_ba_step(prob, g_red, U_chain, D_p, L_ll, Hpl_s, Hpl_t, lam, P, int(prob.kp_i.shape[0]),
                              k_cols=k_cols)
    return _finish_trial(poses, lms, err, lam, delta_p, Jp_s, Jp_t, Jl_s, Jl_t, g_l, ll_solve, prob, kp_cfg,
                         cfg, P)


def solve_full_ba(prob: BAProblem, cfg: FullBAConfig, kp_cfg, k_direct_cols: int | None = None):
    """LM with per-trial Schur-eliminated direct solves; returns (poses,
    landmarks, BAInfo).  A Python loop of trials: the accept/reject and
    damping update stay on the device; the stall flag (two consecutive
    trials improving the error by < 1e-6 relative end the solve) costs one
    host read per trial.  ``k_direct_cols``: leading factor slots that carry
    Woodbury columns (the padding tail is invalid); None = all K slots."""
    P = prob.poses0.t.shape[0]
    dtype, dev = prob.poses0.t.dtype, prob.poses0.t.device
    kind = resolve_ba_solver_kind(cfg.preconditioner, P, int(prob.kp_i.shape[0]))
    sig_s = kp_noise_sigmas(prob.kp_sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_t = kp_noise_sigmas(prob.kp_sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    err0 = _ba_error(prob.poses0, prob.lm0, prob, kp_cfg, cfg.huber_delta)
    poses, lms, err = prob.poses0, prob.lm0, err0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    k = stall = 0
    while k < cfg.max_iters and stall < 2:
        poses, lms, err2, lam = _trial(poses, lms, err, lam, prob, sig_s, sig_t, cfg, kp_cfg, k_direct_cols)
        improved = bool((err - err2) > 1e-6 * torch.clamp(err, min=1e-30))
        err = err2
        k += 1
        stall = 0 if improved else stall + 1
    return poses, lms, BAInfo(error0=err0, error=err, iterations=k, stall=stall, solver_kind=kind)


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
