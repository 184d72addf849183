"""Global pose-graph optimization — batched LM with the exact direct step.

Counterpart of the direct path of :mod:`diasss_tpu.solvers.pose_graph`.  All
poses of all frames form one chain (odometry factors ``(i, i+1)``); loop
closures are sparse extra between factors with per-factor diagonal sigmas;
pose 0 is held fixed (the gauge).  Each LM trial solves the damped normal
equations exactly: the odometry chain (block-tridiagonal, plus the damping)
by multi-RHS cyclic reduction, the loop-closure columns by the Woodbury
identity with one dense Cholesky.

The JAX package's ``"auto"`` picks a solver by backend; here ``"auto"``
resolves to ``"direct"`` on every device, and the PCG family (``jacobi``,
``tridiag``, ``dense_seg``, ``chain``) and more than 1024 loop-closure
factors raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..config import PoseGraphConfig

from ..factors.between import between_residual
from ..geometry import se3

MAX_DIRECT_LC = 1024


class PoseGraph(NamedTuple):
    """Static-shape pose-graph problem (fields as the JAX package's)."""

    poses0: se3.Pose3  # (P,) initial values
    odo_meas: se3.Pose3  # (P-1,) odometry measurements between(i, i+1)
    odo_sigmas: torch.Tensor  # (6,) shared odometry noise sigmas
    lc_i: torch.Tensor  # (Fl,) int64 source pose index
    lc_j: torch.Tensor  # (Fl,) int64 target pose index
    lc_meas: se3.Pose3  # (Fl,) loop-closure measurements
    lc_sigmas: torch.Tensor  # (Fl, 6)
    lc_valid: torch.Tensor  # (Fl,) bool


class SolveInfo(NamedTuple):
    error0: torch.Tensor  # () graph error at the initial values
    error: torch.Tensor  # () graph error at the solution
    iterations: int  # LM trials run
    stall: int  # consecutive trials without relative improvement at exit


def resolve_pg_solver_kind(preconditioner: str, P: int, L_lc: int) -> str:
    """``"auto"`` and ``"direct"`` resolve to ``"direct"``; anything else, or
    more than :data:`MAX_DIRECT_LC` loop-closure factors, is not ported."""
    if preconditioner not in ("auto", "direct"):
        raise NotImplementedError(
            f"pose-graph preconditioner {preconditioner!r} is not ported; only the direct "
            "step is (ROADMAP A7: the dense_seg/tridiag PCG family)"
        )
    if L_lc > MAX_DIRECT_LC:
        raise NotImplementedError(
            f"{L_lc} loop-closure factors exceed the direct step's {MAX_DIRECT_LC}; the "
            "PCG fallback is not ported (ROADMAP A7)"
        )
    return "direct"


def _whitened_residuals(poses: se3.Pose3, graph: PoseGraph):
    r_odo = between_residual(poses[:-1], poses[1:], graph.odo_meas) / graph.odo_sigmas
    r_lc = between_residual(poses[graph.lc_i], poses[graph.lc_j], graph.lc_meas) / graph.lc_sigmas
    return r_odo, torch.where(graph.lc_valid[:, None], r_lc, torch.zeros_like(r_lc))


def graph_error(poses: se3.Pose3, graph: PoseGraph) -> torch.Tensor:
    r_odo, r_lc = _whitened_residuals(poses, graph)
    return 0.5 * (torch.sum(r_odo * r_odo) + torch.sum(r_lc * r_lc))


def _linearize_between(xi: se3.Pose3, xj: se3.Pose3, meas: se3.Pose3, sigmas: torch.Tensor):
    """Whitened residuals (F, 6) and 6x6 Jacobians wrt right-perturbations of
    both poses, (F, 6, 6) each, by forward-mode AD over the 12 directions."""

    def f(d):
        return between_residual(se3.retract(xi, d[:, :6]), se3.retract(xj, d[:, 6:]), meas) / sigmas

    F_ = xi.t.shape[0]
    zero = torch.zeros((F_, 12), dtype=xi.t.dtype, device=xi.t.device)
    basis = torch.eye(12, dtype=zero.dtype, device=zero.device)[:, None, :].expand(12, F_, 12)
    r = f(zero)
    J = vmap(lambda t: jvp(f, (zero,), (t,))[1])(basis).permute(1, 2, 0)  # (F, 6, 12)
    return r, J[..., :6], J[..., 6:]


def _build_normal_terms(poses: se3.Pose3, graph: PoseGraph):
    """Per-factor whitened Jacobians, residuals and index arrays (odometry
    factors first, then loop closures; invalid LC slots zeroed)."""
    P = poses.t.shape[0]
    dev = poses.t.device
    ar = torch.arange(P, device=dev)
    idx_i = torch.cat([ar[:-1], graph.lc_i])
    idx_j = torch.cat([ar[1:], graph.lc_j])
    meas = se3.cat([graph.odo_meas, graph.lc_meas])
    sig = torch.cat([graph.odo_sigmas.expand(P - 1, 6), graph.lc_sigmas])
    valid = torch.cat([torch.ones(P - 1, dtype=torch.bool, device=dev), graph.lc_valid])
    r, Ji, Jj = _linearize_between(poses[idx_i], poses[idx_j], meas, sig)
    w = valid[:, None].to(r.dtype)
    return idx_i, idx_j, r * w, Ji * w[..., None], Jj * w[..., None]


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, P: int) -> torch.Tensor:
    return torch.zeros((P,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _gradient_and_diag(idx_i, idx_j, r, Ji, Jj, P: int):
    """g = J^T r and the block diagonal of H = J^T J, with pose 0 fixed."""
    gi = (Ji.transpose(-1, -2) @ r[..., None])[..., 0]
    gj = (Jj.transpose(-1, -2) @ r[..., None])[..., 0]
    g = _segment_sum(gi, idx_i, P) + _segment_sum(gj, idx_j, P)
    D = _segment_sum(Ji.transpose(-1, -2) @ Ji, idx_i, P) + _segment_sum(Jj.transpose(-1, -2) @ Jj, idx_j, P)
    g[0] = 0.0
    D[0] = torch.eye(6, dtype=D.dtype, device=D.device)
    return g, D


def _direct_lm_step(graph, idx_i, idx_j, Ji, Jj, g, D, lam, P: int, L_lc: int):
    """Exact damped-LM step (P, 6) for damping ``lam`` — the JAX package's
    ``_direct_lm_step_multi`` for one damping value (its damping sweep is on
    ROADMAP's not-to-port list).

    ``H + lam*blockdiag(H) = T' + V V^T``: ``T'`` (odometry chain + damping)
    is solved by multi-RHS cyclic reduction, the loop-closure columns ``V``
    (6 per factor) are folded in by Woodbury with one (6L, 6L) Cholesky.
    Couplings to pose 0 are zeroed so ``delta[0] == 0`` exactly."""
    from .lm import cholesky_solve_or_nan
    from .tridiag import solve_block_tridiag_multi

    dtype, dev = D.dtype, D.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Ji_o, Jj_o = Ji[: P - 1], Jj[: P - 1]
    U = Ji_o.transpose(-1, -2) @ Jj_o
    U[0] = 0.0
    D_odo = _segment_sum(Ji_o.transpose(-1, -2) @ Ji_o, idx_i[: P - 1], P) + _segment_sum(
        Jj_o.transpose(-1, -2) @ Jj_o, idx_j[: P - 1], P)
    D_odo[0] = eye6
    T_diag = D_odo + lam * D + 1e-6 * eye6
    if L_lc == 0:
        delta = solve_block_tridiag_multi(T_diag, U, -g[..., None])[..., 0]
        delta[0] = 0.0
        return delta

    Ji_l = torch.where((graph.lc_i == 0)[:, None, None], 0.0, Ji[P - 1:])
    Jj_l = torch.where((graph.lc_j == 0)[:, None, None], 0.0, Jj[P - 1:])
    # V[p, b, l, a] = A_l[a, b] for p the pose A_l's block touches
    ar = torch.arange(L_lc, device=dev)
    V = torch.zeros((P, L_lc, 6, 6), dtype=dtype, device=dev)
    V.index_put_((graph.lc_i, ar), Ji_l.transpose(-1, -2), accumulate=True)
    V.index_put_((graph.lc_j, ar), Jj_l.transpose(-1, -2), accumulate=True)
    V = V.permute(0, 2, 1, 3).reshape(P, 6, 6 * L_lc)

    W = solve_block_tridiag_multi(T_diag, U, torch.cat([(-g)[:, :, None], V], dim=2))
    w0, Wv = W[:, :, 0], W[:, :, 1:]
    AW = Ji_l @ Wv[graph.lc_i] + Jj_l @ Wv[graph.lc_j]  # (L, 6, 6L)
    C = AW.reshape(6 * L_lc, 6 * L_lc) + torch.eye(6 * L_lc, dtype=dtype, device=dev)
    c0 = ((Ji_l @ w0[graph.lc_i][..., None]) + (Jj_l @ w0[graph.lc_j][..., None])).reshape(-1)
    y = cholesky_solve_or_nan(0.5 * (C + C.T), c0)
    delta = w0 - Wv @ y
    delta[0] = 0.0
    return delta


def solve_pose_graph(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()):
    """Batched LM on the full pose graph; returns (poses, SolveInfo).

    One Python iteration per LM trial (damping *0.3 on accept, *10 on
    reject): the accept/reject and damping update stay on the device; the
    stall counter (two consecutive trials improving the error by < 1e-6
    relative end the solve) costs one host read per trial."""
    P = graph.poses0.t.shape[0]
    L_lc = graph.lc_i.shape[0]
    resolve_pg_solver_kind(cfg.preconditioner, P, L_lc)
    if tuple(cfg.lam_sweep_factors) != (1.0,):
        raise NotImplementedError(
            "lam_sweep_factors (the damping sweep) is an opt-in negative result on ROADMAP's "
            "not-to-port list; the port runs the single-damping schedule"
        )
    dtype, dev = graph.poses0.t.dtype, graph.poses0.t.device
    rel_exit_tol = 1e-6
    not_gauge = torch.arange(P, device=dev) != 0

    poses = graph.poses0
    err0 = graph_error(poses, graph)
    err = err0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    k = stall = 0
    while k < cfg.max_gn_iters and stall < 2:
        idx_i, idx_j, r, Ji, Jj = _build_normal_terms(poses, graph)
        g, D = _gradient_and_diag(idx_i, idx_j, r, Ji, Jj, P)
        lam = torch.clamp(lam, 1e-9, 1e6)
        delta = _direct_lm_step(graph, idx_i, idx_j, Ji, Jj, g, D, lam, P, L_lc)
        cand = se3.where(not_gauge, se3.retract(poses, delta), poses)
        new_err = graph_error(cand, graph)
        good = torch.isfinite(new_err) & (new_err < err)
        poses = se3.where(good.expand(P), cand, poses)
        improved = (err - torch.where(good, new_err, err)) > rel_exit_tol * torch.clamp(err, min=1e-30)
        err = torch.where(good, new_err, err)
        lam = torch.where(good, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 10.0, max=1e6))
        k += 1
        stall = 0 if bool(improved) else stall + 1
    return poses, SolveInfo(error0=err0, error=err, iterations=k, stall=stall)


def build_chain_graph(dr_rows_list, lc_i, lc_j, lc_meas: se3.Pose3, lc_sigmas, lc_valid,
                      cfg: PoseGraphConfig = PoseGraphConfig(), rng=None, device="cuda") -> PoseGraph:
    """The global PoseGraph from per-frame DR rows + LC factors.  Odometry
    measurements are the exact DR relative poses; initial values get the
    reference's injected Gaussian noise (first pose exact) when ``rng`` is
    given, drawn with ``rng.normal((P, 6))``.  ``dr_rows_list`` holds (N_f, 6)
    arrays or tensors."""
    rows = torch.cat([torch.as_tensor(r, dtype=torch.float32, device=device) for r in dr_rows_list])
    deg = math.pi / 180.0
    odo_sigmas = torch.tensor(
        [cfg.odo_sigma_ro_deg * deg, cfg.odo_sigma_pi_deg * deg, cfg.odo_sigma_ya_deg * deg,
         cfg.odo_sigma_x, cfg.odo_sigma_y, cfg.odo_sigma_z], dtype=torch.float32, device=device)
    dr_poses = se3.from_rodrigues_xyz(rows)
    P = rows.shape[0]
    odo_meas = se3.between(dr_poses[: P - 1], dr_poses[1:])
    poses0 = dr_poses
    if rng is not None:
        noise_sig = torch.tensor([cfg.init_noise_rpy_deg * deg] * 3 + [cfg.init_noise_xyz] * 3,
                                 dtype=torch.float32, device=device)
        noise = rng.normal((P, 6)).to(device=device, dtype=torch.float32) * noise_sig
        noise[0] = 0.0
        poses0 = se3.compose(dr_poses, se3.expmap(noise))
    return PoseGraph(
        poses0=poses0,
        odo_meas=odo_meas,
        odo_sigmas=odo_sigmas,
        lc_i=torch.as_tensor(np.asarray(lc_i), dtype=torch.int64, device=device),
        lc_j=torch.as_tensor(np.asarray(lc_j), dtype=torch.int64, device=device),
        lc_meas=lc_meas,
        lc_sigmas=torch.as_tensor(np.asarray(lc_sigmas), dtype=torch.float32, device=device),
        lc_valid=torch.as_tensor(np.asarray(lc_valid), dtype=torch.bool, device=device),
    )
