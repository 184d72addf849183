"""Global pose-graph optimization — batched LM on the chain pose graph.

Counterpart of :mod:`diasss_tpu.solvers.pose_graph`.  All poses of all
frames form one chain (odometry factors ``(i, i+1)``); loop closures are
sparse extra between factors with per-factor diagonal sigmas; pose 0 is
held fixed (the gauge).  Each LM trial solves the damped normal equations
either exactly (``"direct"``: the odometry chain by multi-RHS cyclic
reduction, the loop-closure columns by the Woodbury identity with one dense
Cholesky) or by preconditioned conjugate gradients with the factor-wise
Hessian product (``"jacobi"``, ``"tridiag"``, ``"dense_seg"``, ``"chain"``).
:func:`pg_pose_marginals` gives the exact per-pose marginal covariances at
the solution.

``"auto"`` is ``"direct"`` while the Woodbury width and its buffers stay
within the JAX package's guard and ``"dense_seg"`` above it — the JAX
package's TPU rule, keyed here on no device; it never picks ``"chain"``.
Two options of the JAX package change the schedule: a damping sweep of the
direct step (``PoseGraphConfig.lam_sweep_factors``) and a coarse-to-fine
initialization (``PoseGraphConfig.coarse_init_stride``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from .. import trace
from ..config import PoseGraphConfig

from ..factors.between import between_residual
from ..geometry import se3
from ..segments import Segments, chain_sum, segments

MAX_DIRECT_LC = 1024
PG_KINDS = ("direct", "jacobi", "tridiag", "dense_seg", "chain")
# bytes of the float64 multi-RHS buffers a damping sweep solves at once;
# past it the candidates are solved in turn on the shared terms
SWEEP_BYTES = 8e9
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
    error0: torch.Tensor  # () float64 graph error at the initial values
    error: torch.Tensor  # () float64 graph error at the solution
    iterations: int  # LM trials run
    stall: int  # consecutive trials without relative improvement at exit
    cg_iters_total: int = 0  # CG iterations over all trials (0 for the direct step)
    solver_kind: str = "direct"  # the resolved linear solve
    lam: Optional[torch.Tensor] = None  # () final LM damping (the resume state, with ``stall``)
    # () float64 graph error where the LM started: ``error0`` unless the
    # coarse-to-fine initialization was adopted
    error_init: Optional[torch.Tensor] = None
    # () norm of the last trial's gradient ``g`` (float64 for the direct
    # step, the poses' dtype for PCG); 0 when no trial ran
    grad_norm: Optional[torch.Tensor] = None


def resolve_pg_solver_kind(preconditioner: str, P: int, L_lc: int) -> str:
    """The linear solve of a pose-graph run.  ``"auto"`` is ``"direct"``
    while ``L_lc <= 1024`` and its ``(P, 6, 6L+1)`` multi-RHS buffers (three
    of them) stay under 4 GB, else ``"dense_seg"``; ``"direct"``,
    ``"jacobi"``, ``"tridiag"``, ``"dense_seg"`` and ``"chain"`` are taken
    as given."""
    kind = preconditioner
    if kind == "auto":
        mem_ok = P * 6 * (6 * L_lc + 1) * 4 * 3 < 4e9
        kind = "direct" if (L_lc <= MAX_DIRECT_LC and mem_ok) else "dense_seg"
    if kind not in PG_KINDS:
        raise ValueError(f"unknown pose-graph preconditioner {preconditioner!r}")
    return kind


def cost_residual(xi: se3.Pose3, xj: se3.Pose3, meas: se3.Pose3, sigmas: torch.Tensor) -> torch.Tensor:
    """(..., 6) whitened between residual in float64, the poses and the
    measurement promoted before the residual is formed.

    The LM's accept test and stall rule read the cost built from these.  In
    float32, ``between`` rounds ``R^T t`` at the poses' distance from the
    origin (float32 spacing is 6e-5 m at 500 m, against odometry sigmas of
    1e-3 m), and on a 12,000-pose chain that rounding reaches the size of
    the last LM decreases: where the solve stopped then depended on the
    arithmetic (one device, 2 or 4 ranks).  Casting a float32 residual
    afterwards would keep that rounding."""
    f64 = torch.float64
    return between_residual(_promoted(xi, f64), _promoted(xj, f64), _promoted(meas, f64)) / sigmas.to(f64)


def _promoted(p: se3.Pose3, dtype: torch.dtype) -> se3.Pose3:
    return se3.Pose3(p.R.to(dtype), p.t.to(dtype))


def _whitened_residuals(poses: se3.Pose3, graph: PoseGraph):
    r_odo = cost_residual(poses[:-1], poses[1:], graph.odo_meas, graph.odo_sigmas)
    r_lc = cost_residual(poses[graph.lc_i], poses[graph.lc_j], graph.lc_meas, graph.lc_sigmas)
    return r_odo, torch.where(graph.lc_valid[:, None], r_lc, torch.zeros_like(r_lc))


def graph_error(poses: se3.Pose3, graph: PoseGraph) -> torch.Tensor:
    """The graph's cost ``0.5 * sum ||r||^2`` in float64
    (:func:`cost_residual`); the JAX package's is float32."""
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


def _linearize_f64(xi: se3.Pose3, xj: se3.Pose3, meas: se3.Pose3, sigmas: torch.Tensor):
    """:func:`_linearize_between` formed in float64 from the promoted poses
    and rounded to their dtype (float32): the pose graph's linearization.
    Formed in float32, the residual carries the rounding of ``R^T t`` at
    hundreds of metres, and the values depend on how a batch is laid out
    (one device, or each rank's block), so the steps of the end game, and
    with them where the solve stops, differed between one device and 2 or 4
    ranks (ROADMAP C17); rounded once from float64 they are the same."""
    out = _linearize_between(_promoted(xi, torch.float64), _promoted(xj, torch.float64),
                             _promoted(meas, torch.float64), sigmas.to(torch.float64))
    return tuple(x.to(xi.t.dtype) for x in out)


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
    r, Ji, Jj = _linearize_f64(poses[idx_i], poses[idx_j], meas, sig)
    w = valid[:, None].to(r.dtype)
    return idx_i, idx_j, r * w, Ji * w[..., None], Jj * w[..., None]


class FactorTerms(NamedTuple):
    """Where :func:`solve_pose_graph` reads its factors: the cost and the
    per-factor linearization, each of ``(poses, graph)``.  The default
    evaluates every factor in this process;
    :func:`..parallel.shard.sharded_pose_graph_solve` passes terms that
    spread the loop closures over a mesh's ranks."""

    error: Callable = graph_error
    normal_terms: Callable = _build_normal_terms


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
    """Exact damped-LM step (P, 6) for damping ``lam``: the one-candidate
    case of :func:`_direct_lm_step_multi`."""
    return _direct_lm_step_multi(graph, Ji, Jj, g, D, lam.reshape(1), P, L_lc)[0]


def _direct_lm_step_multi(graph, Ji, Jj, g, D, lams, P: int, L_lc: int):
    """Exact damped-LM steps (K, P, 6) for a (K,) vector of damping values.

    ``H + lam*blockdiag(H) = T' + V V^T``: ``T'`` (odometry chain + damping)
    is solved by multi-RHS cyclic reduction, the loop-closure columns ``V``
    (6 per factor) are folded in by Woodbury with one (6L, 6L) Cholesky.
    Couplings to pose 0 are zeroed so ``delta[0] == 0`` exactly.  The
    linearization, the chain coupling ``U`` and the Woodbury right-hand
    sides ``[-g | V]`` do not depend on the damping and are built once; the
    damped chain reduction and the capacitance Cholesky run K wide, as one
    batch of chains, in groups whose right-hand sides stay within
    :data:`SWEEP_BYTES` (one candidate at a time past it).

    Both solves run in float64 from the float32 blocks, and the steps are
    returned in the Jacobians' dtype (float32).  ``g`` and ``D`` may be
    float64: :func:`solve_pose_graph` sums them in float64 from the float32
    per-factor terms, since float32 sums taken in another order (2 or 4
    ranks, :mod:`..parallel.seq`) round ``g`` differently, and the chain
    amplifies that rounding into steps that differ at the end game (ROADMAP
    C17).  An odometry chain's Hessian is a 1-D Laplacian
    whose condition grows like P^2 as the damping falls: on a 12,000-pose
    chain at the damping floor a float32 reduction's step lies 30% of its
    scale away from the float64 solve (tests/test_torch_solvers.py), and the
    LM stalls away from the fixed point the JAX package reaches with its
    Thomas scan."""
    from .lm import cholesky_solve_or_nan
    from .tridiag import _cr

    dtype, dev, out = torch.float64, D.device, Ji.dtype
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Ji, Jj = Ji.to(dtype), Jj.to(dtype)
    U, D_odo = _odometry_chain(Ji, Jj, P)
    D = D.to(dtype)
    rhs = (-g).to(dtype)[:, :, None]
    if L_lc > 0:
        cols_i, cols_j = _lc_columns(graph, Ji, Jj, P)
        rhs = torch.cat([rhs, woodbury_columns(cols_i, cols_j, graph.lc_i, graph.lc_j, P)], dim=2)
        eye_c = torch.eye(6 * L_lc, dtype=dtype, device=dev)
    lams = lams.to(dtype)
    group = max(1, int(SWEEP_BYTES // max(rhs.numel() * rhs.element_size(), 1)))
    steps = []
    for lam_g in lams.split(group):
        k = lam_g.shape[0]
        T_diag = D_odo + lam_g[:, None, None, None] * D + 1e-6 * eye6  # (k, P, 6, 6)
        W = _cr(T_diag, U.expand(k, *U.shape), rhs.expand(k, *rhs.shape))
        if L_lc == 0:
            steps.append(W[..., 0])
            continue
        w0, Wv = W[..., 0], W[..., 1:]
        C = torch.stack([columns_t(cols_i, cols_j, graph.lc_i, graph.lc_j, Wv[c]) for c in range(k)]) + eye_c
        c0 = torch.stack([columns_t(cols_i, cols_j, graph.lc_i, graph.lc_j, w0[c, :, :, None])[:, 0]
                          for c in range(k)])
        y = cholesky_solve_or_nan(0.5 * (C + C.transpose(-1, -2)), c0)
        steps.append(w0 - (Wv @ y[:, None, :, None])[..., 0])
    delta = torch.cat(steps)
    delta[:, 0] = 0.0
    return delta.to(out)


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
    (``"tridiag"``) or inverted densely once per trial (``"dense_seg"``), or
    the whole chain on ``Dp`` factored exactly once per trial
    (``"chain"``: :func:`.tridiag.chain_factor` with the ``"dense_seg"``
    segment, then products only per application)."""
    from .tridiag import (apply_dense_segment_inverses, auto_dense_segment, chain_factor, chain_solve,
                          dense_segment_inverses, solve_block_tridiag_segmented)

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
        elif kind == "chain":
            fac = chain_factor(Dp, U, auto_dense_segment(P, cfg.tridiag_segment))

            def precond(v):
                return chain_solve(fac, v)
        else:
            def precond(v):
                return solve_block_tridiag_segmented(Dp, U, v, cfg.tridiag_segment)

    matvec = _make_matvec(idx_i, idx_j, segs, Ji, Jj, lam, D)
    return _pcg(matvec, -g, precond, cfg.cg_tol, cfg.cg_max_iters)


def _dr_chain(graph: PoseGraph) -> se3.Pose3:
    """The clean dead-reckoning chain ``poses0[0] . odo[0] . ... . odo[p-1]``
    (P,) in float64: an inclusive scan of pose composition by doubling,
    ``log2(P)`` batched steps."""
    rel = _promoted(graph.odo_meas, torch.float64)
    d = 1
    while d < rel.t.shape[0]:
        rel = se3.cat([rel[:d], se3.compose(rel[:-d], rel[d:])])
        d *= 2
    first = _promoted(graph.poses0[:1], torch.float64)
    return se3.cat([first, se3.compose(first, rel)])


def _coarse_graph_and_chain(graph: PoseGraph, stride: int):
    """The pose graph restricted to every ``stride``-th pose, and the DR
    chain (float64).  Coarse odometry: the DR chain between consecutive
    anchors, its sigmas grown by ``sqrt(stride)``; a loop closure ``(i, j)``
    moves to the anchors ``(i // stride, j // stride)`` with its
    measurement carried along the DR offsets from each anchor to its
    endpoint; loop closures inside one segment are dropped.  The coarse
    initial poses are the DR chain at the anchors."""
    P = graph.poses0.t.shape[0]
    dtype = graph.poses0.t.dtype
    chain = _dr_chain(graph)
    idx_a = torch.arange(0, P, stride, device=graph.lc_i.device)
    ci, cj = graph.lc_i // stride, graph.lc_j // stride
    lc_adj = se3.compose(se3.between(chain[ci * stride], chain[graph.lc_i]),
                         se3.compose(_promoted(graph.lc_meas, torch.float64),
                                     se3.inverse(se3.between(chain[cj * stride], chain[graph.lc_j]))))
    cgraph = PoseGraph(
        poses0=_promoted(chain[idx_a], dtype),
        odo_meas=_promoted(se3.between(chain[idx_a[:-1]], chain[idx_a[1:]]), dtype),
        odo_sigmas=graph.odo_sigmas * math.sqrt(stride),
        lc_i=ci,
        lc_j=cj,
        lc_meas=_promoted(lc_adj, dtype),
        lc_sigmas=graph.lc_sigmas,
        lc_valid=graph.lc_valid & (ci != cj),
    )
    return cgraph, chain


def _prolongate(coarse_poses: se3.Pose3, chain: se3.Pose3, stride: int) -> se3.Pose3:
    """Fine initial values from a coarse solution: each pose is its
    segment anchor's coarse estimate composed with the DR offset from the
    anchor to it; in the dtype of ``coarse_poses``."""
    k = torch.arange(chain.t.shape[0], device=chain.t.device) // stride
    return _promoted(se3.compose(_promoted(coarse_poses[k], torch.float64), se3.between(chain[k * stride], chain)),
                     coarse_poses.t.dtype)


def _coarse_init(graph: PoseGraph, cfg: PoseGraphConfig, err0: torch.Tensor, stride: int, terms):
    """The coarse-to-fine initial poses and their error: the graph solved at
    every ``stride``-th pose (no coarse init of its own, a fresh damping),
    prolongated along the DR chain with pose 0 kept exactly, and adopted
    only where its error is finite and below ``err0``; else ``poses0`` and
    ``err0``."""
    cgraph, chain = _coarse_graph_and_chain(graph, stride)
    cposes, _ = solve_pose_graph(cgraph, dataclasses.replace(cfg, coarse_init_stride=0),
                                 allow_coarse_init=False, terms=terms)
    cand = _prolongate(cposes, chain, stride)
    cand = se3.cat([graph.poses0[:1], cand[1:]])
    err_cand = terms.error(cand, graph)
    better = torch.isfinite(err_cand) & (err_cand < err0)
    return se3.where(better.expand(graph.poses0.t.shape[0]), cand, graph.poses0), torch.where(better, err_cand, err0)


def solve_pose_graph(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig(), lam0=None, stall0=None,
                     terms: FactorTerms = FactorTerms(), allow_coarse_init: bool = True):
    """Batched LM on the full pose graph; returns (poses, SolveInfo).

    One Python iteration per LM trial: the accept/reject and damping update
    stay on the device; the stall counter (two consecutive trials improving
    the error by < 1e-6 relative end the solve) costs one host read per
    trial, and a PCG step one per :data:`CG_CHUNK` CG iterations.  ``lam0``
    / ``stall0`` resume the damping (else 1e-4) and the stall counter (else
    0) of a checkpoint (:mod:`..checkpoint`); ``SolveInfo.lam`` is the
    damping at exit.  ``terms``: the cost and the linearization
    (:class:`FactorTerms`).  The cost, and so ``SolveInfo.error``, is
    float64 (:func:`cost_residual`); the poses, Jacobians and steps stay
    float32.

    Damping: one candidate by default, *0.3 on accept and *10 on reject.
    The direct step with ``cfg.lam_sweep_factors`` of K > 1 values solves
    the exact step for every ``clip(lam * factor, 1e-9, 1e6)`` at once
    (:func:`_direct_lm_step_multi`) and keeps the best finite candidate: on
    accept the damping becomes that candidate's, on reject ``lam *
    max(max(factors), 10)`` (capped at 1e6).  The PCG kinds run the single
    schedule whatever the factors, as the JAX package's do.

    ``cfg.coarse_init_stride`` > 1 starts the LM from a coarse-to-fine
    initialization (:func:`_coarse_init`) when ``allow_coarse_init`` is
    true, no damping or stall counter is resumed and ``P > 4 * stride``:
    fresh solves only; a warm-started caller passes
    ``allow_coarse_init=False``.  ``SolveInfo.error0`` stays the error of
    ``graph.poses0``; ``SolveInfo.error_init`` is the error the LM started
    from.

    Spans (:mod:`..trace`): the solve is ``pose_graph.solve`` (attributes
    ``kind``, ``trials``, ``cg_iters``, ``stall``), each trial a
    ``pose_graph.trial`` of ``pose_graph.linearize`` (normal terms and
    gradient), ``pose_graph.step`` (the step, the candidates' errors and
    the accept) and ``pose_graph.read``, the host's wait at the stall read."""
    with trace.span("pose_graph.solve") as solve:
        P = graph.poses0.t.shape[0]
        L_lc = graph.lc_i.shape[0]
        kind = resolve_pg_solver_kind(cfg.preconditioner, P, L_lc)
        dtype, dev = graph.poses0.t.dtype, graph.poses0.t.device
        rel_exit_tol = 1e-6
        not_gauge = torch.arange(P, device=dev) != 0
        segs = factor_segments(graph, P)
        factors = torch.tensor(tuple(cfg.lam_sweep_factors), dtype=dtype, device=dev)
        decay = 0.3 if factors.numel() == 1 else 1.0
        up = max(max(cfg.lam_sweep_factors), 10.0)

        err0 = terms.error(graph.poses0, graph)
        poses, err = graph.poses0, err0
        stride = int(cfg.coarse_init_stride or 0)
        if allow_coarse_init and stride > 1 and lam0 is None and stall0 is None and P > 4 * stride:
            poses, err = _coarse_init(graph, cfg, err0, stride, terms)
        err_init = err
        lam = torch.tensor(1e-4 if lam0 is None else float(lam0), dtype=dtype, device=dev)
        stall = 0 if stall0 is None else int(stall0)
        k = cg_total = 0
        while k < cfg.max_gn_iters and stall < 2:
            with trace.span("pose_graph.trial"):
                with trace.span("pose_graph.linearize"):
                    idx_i, idx_j, r, Ji, Jj = terms.normal_terms(poses, graph)
                    lam = torch.clamp(lam, 1e-9, 1e6)
                    if kind == "direct":
                        g, D = _gradient_and_diag(segs, r.double(), Ji.double(), Jj.double())
                    else:
                        g, D = _gradient_and_diag(segs, r, Ji, Jj)
                with trace.span("pose_graph.step"):
                    if kind == "direct":
                        lams = torch.clamp(lam * factors, 1e-9, 1e6)
                        deltas = _direct_lm_step_multi(graph, Ji, Jj, g, D, lams, P, L_lc)
                        cands = [se3.where(not_gauge, se3.retract(poses, d), poses) for d in deltas]
                        errs = torch.stack([terms.error(c, graph) for c in cands])
                        errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, float("inf")))
                        best = torch.argmin(errs)
                        cand, new_err = se3.Pose3(torch.stack([c.R for c in cands])[best],
                                                  torch.stack([c.t for c in cands])[best]), errs[best]
                        lam_acc, lam_rej = torch.clamp(lams[best] * decay, min=1e-9), torch.clamp(lam * up, max=1e6)
                    else:
                        delta, cg_k = _pcg_lm_step(kind, idx_i, idx_j, segs, Ji, Jj, g, D, lam, P, cfg)
                        cg_total += cg_k
                        cand = se3.where(not_gauge, se3.retract(poses, delta), poses)
                        new_err = terms.error(cand, graph)
                        lam_acc, lam_rej = torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 10.0, max=1e6)
                    good = torch.isfinite(new_err) & (new_err < err)
                    poses = se3.where(good.expand(P), cand, poses)
                    improved = (err - torch.where(good, new_err, err)) > rel_exit_tol * torch.clamp(err, min=1e-30)
                    err = torch.where(good, new_err, err)
                    lam = torch.where(good, lam_acc, lam_rej)
                k += 1
                with trace.span("pose_graph.read"):
                    improved = bool(improved)
                stall = 0 if improved else stall + 1
        gnorm = torch.linalg.norm(g) if k else torch.zeros((), dtype=dtype, device=dev)  # the last trial's
        solve.set(kind=kind, trials=k, cg_iters=cg_total, stall=stall)
    return poses, SolveInfo(error0=err0, error=err, iterations=k, stall=stall, cg_iters_total=cg_total,
                            solver_kind=kind, lam=lam, error_init=err_init, grad_norm=gnorm)


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
