"""Global pose-graph optimization — batched LM on the chain pose graph.

Counterpart of :mod:`diasss_tpu.solvers.pose_graph`.  All poses of all
frames form one chain (odometry factors ``(i, i+1)``); loop closures are
sparse extra between factors with per-factor diagonal sigmas; pose 0 is
held fixed (the gauge).  Each LM trial solves the damped normal equations
either exactly (``"direct"``: the odometry chain by multi-RHS cyclic
reduction, the loop-closure columns by the Woodbury identity with one dense
Cholesky) or by preconditioned conjugate gradients with the factor-wise
Hessian product (``"jacobi"``, ``"tridiag"``, ``"dense_seg"``).
:func:`pg_pose_marginals` gives the exact per-pose marginal covariances at
the solution.

``"auto"`` is ``"direct"`` while the Woodbury width and its buffers stay
within the JAX package's guard and ``"dense_seg"`` above it — the JAX
package's TPU rule, keyed here on no device.  ``"chain"`` is on ROADMAP's
not-to-port list and raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..config import PoseGraphConfig

from ..factors.between import between_residual
from ..geometry import se3
from ..segments import Segments, chain_sum, segments

MAX_DIRECT_LC = 1024
# CG iterations between two host reads of the convergence flag; past
# convergence the iterate is frozen by a mask, so the result does not
# depend on it
CG_CHUNK = 16


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
    cg_iters_total: int = 0  # CG iterations over all trials (0 for the direct step)
    solver_kind: str = "direct"  # the resolved linear solve
    lam: Optional[torch.Tensor] = None  # () final LM damping (the resume state, with ``stall``)


def resolve_pg_solver_kind(preconditioner: str, P: int, L_lc: int) -> str:
    """The linear solve of a pose-graph run.  ``"auto"`` is ``"direct"``
    while ``L_lc <= 1024`` and its ``(P, 6, 6L+1)`` multi-RHS buffers (three
    of them) stay under 4 GB, else ``"dense_seg"``; ``"direct"``,
    ``"jacobi"``, ``"tridiag"`` and ``"dense_seg"`` are taken as given."""
    kind = preconditioner
    if kind == "chain":
        raise NotImplementedError(
            "the 'chain' preconditioner (tridiag.ChainFactor) is an opt-in negative result on ROADMAP's "
            "not-to-port list; dense_seg is the PCG fallback"
        )
    if kind == "auto":
        mem_ok = P * 6 * (6 * L_lc + 1) * 4 * 3 < 4e9
        kind = "direct" if (L_lc <= MAX_DIRECT_LC and mem_ok) else "dense_seg"
    if kind not in ("direct", "jacobi", "tridiag", "dense_seg"):
        raise ValueError(f"unknown pose-graph preconditioner {preconditioner!r}")
    return kind


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


def factor_segments(graph: PoseGraph, P: int) -> Tuple[Segments, Segments]:
    """The segment plans of every factor's source and target pose, in the
    order of :func:`_build_normal_terms` (odometry factors, then loop
    closures); one pair per solve."""
    ar = torch.arange(P, device=graph.lc_i.device)
    return segments(torch.cat([ar[:-1], graph.lc_i]), P), segments(torch.cat([ar[1:], graph.lc_j]), P)


def _factor_sum(segs, xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """(P, ...) sums of per-factor terms at each factor's two poses: ``xi``
    at its source pose, ``xj`` at its target pose."""
    return segs[0].sum(xi) + segs[1].sum(xj)


def _gradient_and_diag(segs, r, Ji, Jj):
    """g = J^T r and the block diagonal of H = J^T J, with pose 0 fixed."""
    Ji_t, Jj_t = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    g = _factor_sum(segs, (Ji_t @ r[..., None])[..., 0], (Jj_t @ r[..., None])[..., 0])
    D = _factor_sum(segs, Ji_t @ Ji, Jj_t @ Jj)
    g[0] = 0.0
    D[0] = torch.eye(6, dtype=D.dtype, device=D.device)
    return g, D


def _odometry_chain(Ji, Jj, P: int):
    """The odometry factors' block-tridiagonal Hessian, gauge-fixed: the
    couplings ``U`` (P-1, 6, 6) with ``U[0] = 0`` and the diagonal blocks
    (P, 6, 6) with the identity at pose 0."""
    Ji_o, Jj_o = Ji[: P - 1], Jj[: P - 1]
    U = Ji_o.transpose(-1, -2) @ Jj_o
    U[0] = 0.0
    D_odo = chain_sum(Ji_o.transpose(-1, -2) @ Ji_o, Jj_o.transpose(-1, -2) @ Jj_o)
    D_odo[0] = torch.eye(6, dtype=D_odo.dtype, device=D_odo.device)
    return U, D_odo


def _lc_columns(graph: PoseGraph, Ji, Jj, P: int):
    """The loop-closure factors' Woodbury column blocks ``A^T`` (L, 6, 6) at
    each endpoint; blocks touching the gauge pose vanish."""
    Ji_l = torch.where((graph.lc_i == 0)[:, None, None], 0.0, Ji[P - 1:])
    Jj_l = torch.where((graph.lc_j == 0)[:, None, None], 0.0, Jj[P - 1:])
    return Ji_l.transpose(-1, -2), Jj_l.transpose(-1, -2)


def woodbury_columns(cols_i: torch.Tensor, cols_j: torch.Tensor, idx_i: torch.Tensor, idx_j: torch.Tensor,
                     P: int) -> torch.Tensor:
    """Low-rank columns ``V`` (P, 6, c F) of F factors: factor f's column
    block (6, c) ``cols_i[f]`` sits at pose ``idx_i[f]`` and ``cols_j[f]`` at
    ``idx_j[f]``.  Built by two scatters into zeros, each to distinct
    (pose, factor) slots, so no two rows ever add into one slot at once; the
    JAX package builds the same values by a one-hot product, because a
    scatter with traced indices is slow on a TPU."""
    F_, _, c = cols_i.shape
    ar = torch.arange(F_, device=cols_i.device)
    V = torch.zeros((P, F_, 6, c), dtype=cols_i.dtype, device=cols_i.device)
    V[idx_i, ar] = cols_i
    V[idx_j, ar] = V[idx_j, ar] + cols_j
    return V.permute(0, 2, 1, 3).reshape(P, 6, c * F_)


def columns_t(cols_i, cols_j, idx_i, idx_j, W: torch.Tensor) -> torch.Tensor:
    """``V^T W`` (c F, n) for the columns of :func:`woodbury_columns` and
    ``W`` (P, 6, n), by gathering W at each factor's two poses."""
    F_, _, c = cols_i.shape
    VW = cols_i.transpose(-1, -2) @ W[idx_i] + cols_j.transpose(-1, -2) @ W[idx_j]
    return VW.reshape(c * F_, *W.shape[2:])


def lowrank_diag_blocks(Wv: torch.Tensor, L_cap: torch.Tensor) -> torch.Tensor:
    """The (P, 6, 6) diagonal blocks of ``Wv C^-1 Wv^T`` for ``Wv`` (P, 6, n)
    and the Cholesky factor ``L_cap`` of ``C``: ``X_p X_p^T`` with ``X = Wv
    L_cap^-T``, one triangular solve against every pose block at once."""
    P, _, n = Wv.shape
    X = torch.linalg.solve_triangular(L_cap.transpose(-1, -2), Wv.reshape(P * 6, n), upper=True, left=False)
    X = X.reshape(P, 6, n)
    return X @ X.transpose(-1, -2)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorisation fails (as
    ``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0).reshape(info.shape + (1, 1)), float("nan"), L)


def _direct_lm_step(graph, Ji, Jj, g, D, lam, P: int, L_lc: int):
    """Exact damped-LM step (P, 6) for damping ``lam`` — the JAX package's
    ``_direct_lm_step_multi`` for one damping value (its damping sweep is on
    ROADMAP's not-to-port list).

    ``H + lam*blockdiag(H) = T' + V V^T``: ``T'`` (odometry chain + damping)
    is solved by multi-RHS cyclic reduction, the loop-closure columns ``V``
    (6 per factor) are folded in by Woodbury with one (6L, 6L) Cholesky.
    Couplings to pose 0 are zeroed so ``delta[0] == 0`` exactly.

    Both solves run in float64 from the float32 blocks, and the step is
    returned in float32.  An odometry chain's Hessian is a 1-D Laplacian
    whose condition grows like P^2 as the damping falls: on a 12,000-pose
    chain at the damping floor a float32 reduction's step lies 30% of its
    scale away from the float64 solve (tests/test_torch_solvers.py), and the
    LM stalls away from the fixed point the JAX package reaches with its
    Thomas scan."""
    from .lm import cholesky_solve_or_nan
    from .tridiag import solve_block_tridiag_multi

    dtype, dev = torch.float64, D.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Ji, Jj = Ji.to(dtype), Jj.to(dtype)
    U, D_odo = _odometry_chain(Ji, Jj, P)
    T_diag = D_odo + lam.to(dtype) * D.to(dtype) + 1e-6 * eye6
    rhs = (-g).to(dtype)[:, :, None]
    if L_lc == 0:
        delta = solve_block_tridiag_multi(T_diag, U, rhs)[..., 0]
        delta[0] = 0.0
        return delta.to(D.dtype)

    cols_i, cols_j = _lc_columns(graph, Ji, Jj, P)
    V = woodbury_columns(cols_i, cols_j, graph.lc_i, graph.lc_j, P)
    W = solve_block_tridiag_multi(T_diag, U, torch.cat([rhs, V], dim=2))
    w0, Wv = W[:, :, 0], W[:, :, 1:]
    C = columns_t(cols_i, cols_j, graph.lc_i, graph.lc_j, Wv) + torch.eye(6 * L_lc, dtype=dtype, device=dev)
    c0 = columns_t(cols_i, cols_j, graph.lc_i, graph.lc_j, w0[..., None])[:, 0]
    y = cholesky_solve_or_nan(0.5 * (C + C.T), c0)
    delta = w0 - Wv @ y
    delta[0] = 0.0
    return delta.to(D.dtype)


def _make_matvec(idx_i, idx_j, segs, Ji, Jj, lam, D):
    """``v -> (H + lam*blockdiag(D)) v`` with H applied factor-wise (gather,
    batched 6x6 products, segment sums); pose 0 is the gauge, its row is
    the identity on a zeroed block."""
    Ji_t, Jj_t = Ji.transpose(-1, -2), Jj.transpose(-1, -2)

    def matvec(v):  # (P, 6)
        v = torch.cat([torch.zeros_like(v[:1]), v[1:]])
        a = (Ji @ v[idx_i][..., None] + Jj @ v[idx_j][..., None])[..., 0]
        out = _factor_sum(segs, (Ji_t @ a[..., None])[..., 0], (Jj_t @ a[..., None])[..., 0])
        out = out + lam * (D @ v[..., None])[..., 0]
        out[0] = 0.0
        return out

    return matvec


def _pcg(matvec, b: torch.Tensor, precond, tol: float, max_iters: int, chunk: int = CG_CHUNK):
    """Preconditioned CG on the (P, 6) block vector space, from ``x = 0``,
    until ``||r|| <= tol ||b||`` or ``max_iters``; returns (x, iterations).

    The JAX package's ``while_loop`` tests the residual before every
    iteration.  Here the iterations run in chunks of ``chunk`` with the test
    on the device: an iteration whose residual already passed is masked out
    (x, r, p and the count stay), so the result and the count are those of
    the JAX loop, and the host reads the flag once per chunk."""

    def dot(a, c):
        return torch.sum(a * c)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    thresh = tol * torch.clamp(torch.sqrt(dot(b, b)), min=1e-30)
    active = torch.sqrt(dot(r, r)) > thresh
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = n_iters = 0
    while done < max_iters:
        for _ in range(min(chunk, max_iters - done)):
            Ap = matvec(p)
            alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
            x = torch.where(active, x + alpha * p, x)
            r_new = r - alpha * Ap
            z = precond(r_new)
            rz_new = dot(r_new, z)
            p = torch.where(active, z + (rz_new / torch.clamp(rz, min=1e-30)) * p, p)
            r = torch.where(active, r_new, r)
            rz = torch.where(active, rz_new, rz)
            k = k + active.to(k.dtype)
            active = active & (torch.sqrt(dot(r, r)) > thresh)
        done += min(chunk, max_iters - done)
        still, n_iters = torch.stack([active.to(k.dtype), k]).tolist()
        if not still:
            break
    return x, n_iters


def _pcg_lm_step(kind: str, idx_i, idx_j, segs, Ji, Jj, g, D, lam, P: int, cfg: PoseGraphConfig):
    """Damped-LM step by PCG on the factor-wise Hessian; returns (delta, CG
    iterations).  Preconditioners of the damped diagonal ``Dp``: its 6x6
    blocks (``"jacobi"``), or the odometry chain on ``Dp`` cut into segments
    of ``cfg.tridiag_segment``, solved by cyclic reduction per application
    (``"tridiag"``) or inverted densely once per trial (``"dense_seg"``)."""
    from .tridiag import (apply_dense_segment_inverses, auto_dense_segment, dense_segment_inverses,
                          solve_block_tridiag_segmented)

    Dp = D * (1.0 + lam) + 1e-6 * torch.eye(6, dtype=D.dtype, device=D.device)
    if kind == "jacobi":
        L = _cholesky_or_nan(Dp)

        def precond(v):
            return torch.cholesky_solve(v[..., None], L)[..., 0]
    else:
        U = Ji[: P - 1].transpose(-1, -2) @ Jj[: P - 1]
        U[0] = 0.0  # pose 0 is the gauge: decouple it (its Dp block is the identity)
        if kind == "dense_seg":
            Minv = dense_segment_inverses(Dp, U, auto_dense_segment(P, cfg.tridiag_segment))

            def precond(v):
                return apply_dense_segment_inverses(Minv, v)
        else:
            def precond(v):
                return solve_block_tridiag_segmented(Dp, U, v, cfg.tridiag_segment)

    matvec = _make_matvec(idx_i, idx_j, segs, Ji, Jj, lam, D)
    return _pcg(matvec, -g, precond, cfg.cg_tol, cfg.cg_max_iters)


def solve_pose_graph(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig(), lam0=None, stall0=None):
    """Batched LM on the full pose graph; returns (poses, SolveInfo).

    One Python iteration per LM trial (damping *0.3 on accept, *10 on
    reject): the accept/reject and damping update stay on the device; the
    stall counter (two consecutive trials improving the error by < 1e-6
    relative end the solve) costs one host read per trial, and a PCG step
    one per :data:`CG_CHUNK` CG iterations.  ``lam0`` / ``stall0`` resume
    the damping (else 1e-4) and the stall counter (else 0) of a checkpoint
    (:mod:`..checkpoint`); ``SolveInfo.lam`` is the damping at exit."""
    P = graph.poses0.t.shape[0]
    L_lc = graph.lc_i.shape[0]
    kind = resolve_pg_solver_kind(cfg.preconditioner, P, L_lc)
    if tuple(cfg.lam_sweep_factors) != (1.0,):
        raise NotImplementedError(
            "lam_sweep_factors (the damping sweep) is an opt-in negative result on ROADMAP's "
            "not-to-port list; the port runs the single-damping schedule"
        )
    dtype, dev = graph.poses0.t.dtype, graph.poses0.t.device
    rel_exit_tol = 1e-6
    not_gauge = torch.arange(P, device=dev) != 0
    segs = factor_segments(graph, P)

    poses = graph.poses0
    err0 = graph_error(poses, graph)
    err = err0
    lam = torch.tensor(1e-4 if lam0 is None else float(lam0), dtype=dtype, device=dev)
    stall = 0 if stall0 is None else int(stall0)
    k = cg_total = 0
    while k < cfg.max_gn_iters and stall < 2:
        idx_i, idx_j, r, Ji, Jj = _build_normal_terms(poses, graph)
        g, D = _gradient_and_diag(segs, r, Ji, Jj)
        lam = torch.clamp(lam, 1e-9, 1e6)
        if kind == "direct":
            delta = _direct_lm_step(graph, Ji, Jj, g, D, lam, P, L_lc)
        else:
            delta, cg_k = _pcg_lm_step(kind, idx_i, idx_j, segs, Ji, Jj, g, D, lam, P, cfg)
            cg_total += cg_k
        cand = se3.where(not_gauge, se3.retract(poses, delta), poses)
        new_err = graph_error(cand, graph)
        good = torch.isfinite(new_err) & (new_err < err)
        poses = se3.where(good.expand(P), cand, poses)
        improved = (err - torch.where(good, new_err, err)) > rel_exit_tol * torch.clamp(err, min=1e-30)
        err = torch.where(good, new_err, err)
        lam = torch.where(good, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 10.0, max=1e6))
        k += 1
        stall = 0 if bool(improved) else stall + 1
    return poses, SolveInfo(error0=err0, error=err, iterations=k, stall=stall, cg_iters_total=cg_total,
                            solver_kind=kind, lam=lam)


def pg_pose_marginals(graph: PoseGraph, poses: se3.Pose3) -> torch.Tensor:
    """(P, 6, 6) exact marginal covariance blocks of the pose-graph estimate,
    linearized at ``poses``; pose 0 is the gauge (zero covariance).

        H = T + V V^T,  diag(H^-1)_p = diag(T^-1)_p - Wv_p C^-1 Wv_p^T

    with ``T`` the gauge-fixed odometry chain (selected inversion along the
    cyclic-reduction levels), ``V`` the loop-closure columns (6 per factor;
    loop closures subtract uncertainty), ``Wv = T^-1 V`` from one multi-RHS
    cyclic reduction and ``C = I + V^T T^-1 V``.

    The Jacobians are float32, as the solver's; the rest runs in float64 and
    the result is float64.  The variances inside one block span decades (a
    1 mm odometry z beside metres of drift in x, y), and each reduction
    level costs float32 about a bit where the reduced chain softens: in
    float32 the smaller sigmas would be off by a few 1e-3 relative."""
    from .tridiag import block_tridiag_selected_inverse, solve_block_tridiag_multi

    P = poses.t.shape[0]
    L = int(graph.lc_i.shape[0])
    dtype, dev = torch.float64, poses.t.device
    _, _, _, Ji, Jj = _build_normal_terms(poses, graph)
    Ji, Jj = Ji.to(dtype), Jj.to(dtype)
    U, D_odo = _odometry_chain(Ji, Jj, P)
    T_diag = D_odo + 1e-6 * torch.eye(6, dtype=dtype, device=dev)
    T_diag[0] = torch.eye(6, dtype=dtype, device=dev)
    cov = block_tridiag_selected_inverse(T_diag, U)
    if L > 0:
        cols_i, cols_j = _lc_columns(graph, Ji, Jj, P)
        Wv = solve_block_tridiag_multi(T_diag, U, woodbury_columns(cols_i, cols_j, graph.lc_i, graph.lc_j, P))
        C = columns_t(cols_i, cols_j, graph.lc_i, graph.lc_j, Wv) + torch.eye(6 * L, dtype=dtype, device=dev)
        cov = cov - lowrank_diag_blocks(Wv, _cholesky_or_nan(0.5 * (C + C.T)))
    cov[0] = 0.0
    return cov


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
