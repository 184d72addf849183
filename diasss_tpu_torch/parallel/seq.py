"""Sequence-parallel solvers: the pose chain block-partitioned over ranks.

Counterpart of :mod:`diasss_tpu.parallel.seq`.  The concatenated ping chain
is cut into ``n`` contiguous blocks of ``B = ceil(P / n)`` poses (padded
with identity poses); rank ``d`` owns its pose block, the odometry factors
whose source pose it owns (factor k couples ``k -> k+1``) and, in full BA,
the correspondences whose source pose it owns.  Every O(P) tensor is
O(P / n) per rank.  Each ``shard_map`` body of the JAX package is a
function every rank runs on its own block (:mod:`.collectives` maps the
``lax`` calls):

* **halo exchange**: a chain factor at a block boundary needs the next
  block's first pose (one :func:`.collectives.ppermute`), and sends its
  gradient and Hessian terms back the other way;
* **loop closures** (pose graph): endpoints gathered with an L-sized masked
  :func:`.collectives.psum`; every rank evaluates the same L-sized algebra
  and keeps the rows it owns;
* **correspondences** (full BA): owner-aligned by one build-time
  ``all_to_all`` (:mod:`.alltoall`), so the source pose is a local read; the
  target pose rides a routed ``all_to_all`` of only the unique rows each
  rank pair shares.

The linear solve of each LM trial is the exact direct step (SPIKE,
:func:`..solvers.tridiag.spike_block_tridiag_multi`, plus the Woodbury
correction over the loop-closure or landmark columns) or PCG with the
per-block chain preconditioners (``tridiag``, ``dense_seg``, ``jacobi``);
rank boundaries act as segment cuts.  ``"auto"`` takes the JAX package's
TPU rule on every device (the port keys nothing on the device).  As in the
single-device solver, the pose graph's direct step runs its chain solves and
capacitance in float64 (a 12,000-pose chain is too ill-conditioned for
float32 at the damping floor); full BA's stays float32.

Every quantity that steers the LM (error, gradient norm, CG inner
products) is summed over ranks in rank order (:func:`.collectives.psum_ordered`),
so every rank takes the same accept/reject decisions and returns the same
bits.  Inputs are the same full tensors on every rank; results come back
whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FullBAConfig, KeypointNoiseConfig, PoseGraphConfig
from ..factors.between import between_residual
from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
from ..geometry import se3
from ..segments import segments
from ..solvers.full_ba import BAInfo, BAProblem, _ba_error_from_residuals, _huber_weight, _sss_factor_terms
from ..solvers.lm import cholesky_solve_or_nan
from ..solvers.pose_graph import (CG_CHUNK, PoseGraph, SolveInfo, _cholesky_or_nan, _linearize_between, _linearize_f64,
                                  cost_residual, woodbury_columns)
from ..solvers.tridiag import (apply_dense_segment_inverses, auto_dense_segment, dense_segment_inverses,
                               solve_block_tridiag_segmented, spike_block_tridiag_multi)
from .collectives import Mesh, all_gather, all_to_all, ppermute, psum, psum_ordered

REL_EXIT_TOL = 1e-6


def _pack(p: se3.Pose3) -> torch.Tensor:
    """(..., 12) rows of a pose batch: one tensor per exchange."""
    return torch.cat([p.R.reshape(*p.t.shape[:-1], 9), p.t], dim=-1)


def _unpack(x: torch.Tensor) -> se3.Pose3:
    return se3.Pose3(x[..., :9].reshape(*x.shape[:-1], 3, 3), x[..., 9:])


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mask`` (F,) broadcast over the trailing dims of ``x`` (F, ...)."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def _tmv(J, r):  # J^T r per factor
    return (J.transpose(-1, -2) @ r[..., None])[..., 0]


def _mv(J, v):  # J v per factor
    return (J @ v[..., None])[..., 0]


def _tmm(A, B):  # A^T B per factor
    return A.transpose(-1, -2) @ B


def _pad_chain(graph: PoseGraph, n: int):
    """Poses padded to ``n * B`` with identity poses, the odometry factors
    to one per pose (factor k couples k -> k+1; entries >= P-1 invalid).
    Returns (poses0, odo_meas, B, P_real)."""
    P_real = int(graph.poses0.t.shape[0])
    B = -(-P_real // n)
    P_pad = n * B
    dtype, dev = graph.poses0.t.dtype, graph.poses0.t.device
    poses0 = se3.cat([graph.poses0, se3.identity((P_pad - P_real,), dtype, dev)])
    odo_meas = se3.cat([graph.odo_meas, se3.identity((P_pad - (P_real - 1),), dtype, dev)])
    return poses0, odo_meas, B, P_real


def _check_kind(kind: str, preconditioner: str) -> str:
    if kind == "chain":
        # the JAX package's resolve_seq_* pass "chain" on to their
        # block-Jacobi branch without a word (ROADMAP hazards); the port refuses
        raise NotImplementedError(
            "the 'chain' preconditioner (tridiag.ChainFactor) factors the whole chain on one device; the "
            "sequence-parallel solvers have no distributed form of it: use it with solve_pose_graph / "
            "solve_full_ba, or pick 'direct', 'dense_seg', 'tridiag' or 'jacobi' here")
    if kind not in ("direct", "jacobi", "tridiag", "dense_seg"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    return kind


def resolve_seq_pg_solver_kind(preconditioner: str, B: int, L: int) -> str:
    """The linear solve of a sequence-parallel pose-graph run: ``"auto"``
    is the SPIKE direct step while ``L <= 1024``, its per-rank ``(B, 6,
    6L+1)`` buffers stay under 4 GB and ``B >= 2``, else ``"dense_seg"``
    (the JAX package's TPU rule, on every device); ``"direct"`` with fewer
    than two rows per rank is ``"tridiag"``."""
    kind = preconditioner
    if kind == "auto":
        mem_ok = B * 6 * (6 * L + 1) * 4 * 3 < 4e9
        kind = "direct" if (L <= 1024 and mem_ok and B >= 2) else "dense_seg"
    if kind == "direct" and B < 2:
        kind = "tridiag"  # SPIKE needs >= 2 rows per rank
    return _check_kind(kind, preconditioner)


def resolve_seq_ba_solver_kind(preconditioner: str, B: int, n: int, Kf: int) -> str:
    """As :func:`resolve_seq_pg_solver_kind` for full BA: the guard counts
    3 capacitance columns per global (padded) correspondence slot ``n * Kf``."""
    kind = preconditioner
    if kind == "auto":
        Kg = n * Kf
        mem_ok = B * 6 * (3 * Kg + 1) * 4 * 3 < 4e9
        kind = "direct" if (Kg <= 1024 and mem_ok and B >= 2) else "dense_seg"
    if kind == "direct" and B < 2:
        kind = "tridiag"
    return _check_kind(kind, preconditioner)


class _Chain:
    """This rank's block of the padded chain: fixed rows (the gauge, global
    pose 0, and the padding), valid odometry factors, and the halo
    exchanges of the block-partitioned chain."""

    def __init__(self, mesh: Mesh, B: int, P_real: int, dev):
        n, d = mesh.size, mesh.rank
        self.mesh, self.B = mesh, B
        gidx = d * B + torch.arange(B, device=dev)
        self.fix_rows = (gidx == 0) | (gidx >= P_real)
        self.odo_valid = gidx < P_real - 1
        self.from_next = [((i + 1) % n, i) for i in range(n)]  # receive the next block's first row
        self.to_next = [(i, (i + 1) % n) for i in range(n)]  # send the boundary factor's terms forward
        # the boundary factor's far row is fixed iff it is padding (or the
        # cyclic wrap on the last rank, whose boundary factor is invalid)
        self.next_first_fixed = bool((d + 1) * B >= P_real or d == n - 1)

    def next_first(self, xs):
        """The next block's first row of each tensor in ``xs`` (one exchange)."""
        return ppermute(self.mesh, [x[0:1] for x in xs], self.from_next)

    def shifted(self, x: torch.Tensor) -> torch.Tensor:
        """Each factor's second operand: rows 1.. and the halo row."""
        return torch.cat([x[1:], self.next_first([x])[0]])

    def shifted_poses(self, p: se3.Pose3) -> se3.Pose3:
        return _unpack(self.shifted(_pack(p)))

    def chain_sum(self, a: list, b: list) -> list:
        """Per tensor pair: ``a`` at each factor's source row plus ``b`` at
        its target row, the block's last ``b`` row sent on to the next rank."""
        got = ppermute(self.mesh, [x[-1:] for x in b], self.to_next)
        out = []
        for x, y, h in zip(a, b, got):
            s = x.clone()
            s[1:] += y[:-1]
            s[0:1] += h
            out.append(s)
        return out

    def fix_vec(self, v):
        return torch.where(self.fix_rows[:, None], 0.0, v)

    def fix_blocks(self, D):
        eye = torch.eye(6, dtype=D.dtype, device=D.device)
        return torch.where(self.fix_rows[:, None, None], eye, D)

    def couplings(self, Ja, Jb):
        """The chain couplings (B, 6, 6): row k couples local k -> k+1 (k =
        B-1 crosses the boundary), zero around fixed rows."""
        U = _tmm(Ja, Jb)
        nxt = torch.tensor([self.next_first_fixed], device=U.device)
        cz = self.fix_rows | torch.cat([self.fix_rows[1:], nxt])
        return torch.where(cz[:, None, None], 0.0, U)

    def local_couplings(self, Ja, Jb):
        """The couplings inside the block only (B-1, 6, 6), for the
        per-block preconditioners: rank boundaries act as segment cuts."""
        B = self.B
        U = _tmm(Ja[:B - 1], Jb[:B - 1])
        cz = self.fix_rows[:B - 1] | self.fix_rows[1:]
        return torch.where(cz[:, None, None], 0.0, U)

    def gather_rows(self, x: torch.Tensor, P_real: int) -> torch.Tensor:
        """Every rank's block, whole, cut to ``P_real`` rows."""
        return all_gather(self.mesh, x).reshape(-1, *x.shape[1:])[:P_real]


def _block_precond(kind: str, Dp, U_loc, cfg, start: int, P: int):
    """The per-block PCG preconditioner of ``kind`` on the damped diagonal
    ``Dp`` and the in-block couplings ``U_loc`` of the rows from global row
    ``start`` on.  Its segments lie on the single device's grid (multiples
    of the segment length over the whole chain, the dense segment sized by
    the whole chain's ``P``): the block is padded in front with decoupled
    identity rows up to its grid line, so the preconditioner equals the
    single device's but for the segments a rank boundary cuts."""
    seg = auto_dense_segment(P, cfg.tridiag_segment) if kind == "dense_seg" else cfg.tridiag_segment
    off = start % seg
    eye = torch.eye(6, dtype=Dp.dtype, device=Dp.device)
    Dp = torch.cat([eye.expand(off, 6, 6), Dp])
    U_loc = torch.cat([U_loc.new_zeros((off, 6, 6)), U_loc])

    def padded(v):
        return torch.cat([v.new_zeros((off, 6)), v])

    if kind == "dense_seg":
        Minv = dense_segment_inverses(Dp, U_loc, seg)
        return lambda v: apply_dense_segment_inverses(Minv, padded(v))[off:]
    if kind == "tridiag":
        return lambda v: solve_block_tridiag_segmented(Dp, U_loc, padded(v), seg)[off:]
    raise ValueError(kind)


def _owned_products(Ai, Aj, W, own_i, own_j, loc_i, loc_j):
    """This rank's part of ``A_i W[loc_i] + A_j W[loc_j]`` per factor
    (``A`` (F, a, 6), ``W`` (B, 6, R)): the terms of the endpoints it owns,
    zero elsewhere.  Every factor gets at most two terms, each from the
    rank that owns that endpoint, so the :func:`.collectives.psum` of the
    parts moves one (F, a, R) buffer instead of the endpoints' W rows; an
    all-reduce hands every rank the same reduced bits (the ranks'
    bit-identical results are pinned by tests/test_torch_parallel_solvers.py)."""
    out = W.new_zeros((Ai.shape[0], Ai.shape[1], W.shape[2]))
    ii, jj = torch.nonzero(own_i)[:, 0], torch.nonzero(own_j)[:, 0]
    out[ii] = Ai[ii] @ W[loc_i[ii]]
    out[jj] = out[jj] + Aj[jj] @ W[loc_j[jj]]
    return out


def _pcg_dist(mesh: Mesh, matvec, b: torch.Tensor, precond, tol: float, max_iters: int, chunk: int = CG_CHUNK):
    """PCG over the ranks' blocks (``_pcg_dist`` of the JAX package): the
    single-device ``pose_graph._pcg`` with every inner product summed over
    the ranks in rank order, and the two of each iteration's tail, ``r.z``
    and ``r.r``, in one exchange.  Returns (x, iterations), the same on
    every rank."""

    def dots(*pairs):
        return psum_ordered(mesh, torch.stack([torch.sum(a * c) for a, c in pairs]))

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz, bb = dots((r, z), (b, b))
    thresh = tol * torch.clamp(torch.sqrt(bb), min=1e-30)
    active = torch.sqrt(bb) > thresh  # r = b at the start
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = n_iters = 0
    while done < max_iters:
        for _ in range(min(chunk, max_iters - done)):
            Ap = matvec(p)
            alpha = rz / torch.clamp(dots((p, Ap))[0], min=1e-30)
            x = torch.where(active, x + alpha * p, x)
            r_new = r - alpha * Ap
            z = precond(r_new)
            rz_new, rr_new = dots((r_new, z), (r_new, r_new))
            p = torch.where(active, z + (rz_new / torch.clamp(rz, min=1e-30)) * p, p)
            r = torch.where(active, r_new, r)
            rz = torch.where(active, rz_new, rz)
            k = k + active.to(k.dtype)
            active = active & (torch.sqrt(rr_new) > thresh)
        done += min(chunk, max_iters - done)
        still, n_iters = torch.stack([active.to(k.dtype), k]).tolist()
        if not still:
            break
    return x, n_iters


def to_host(x: torch.Tensor) -> np.ndarray:
    """A result as host numpy.  Every rank holds the whole result of a mesh
    solve, so nothing is gathered here (the JAX package gathers an array
    sharded over a multi-host mesh)."""
    return x.detach().cpu().numpy()


def _lm_update(good, lam):
    return torch.where(good, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 10.0, max=1e6))


def _seq_pg_run(mesh: Mesh, poses0, odo_meas, graph: PoseGraph, lam0: float, stall0: int, cfg: PoseGraphConfig,
                B: int, P_real: int, kind: str):
    n, d = mesh.size, mesh.rank
    dev, dtype = poses0.t.device, poses0.t.dtype
    ch = _Chain(mesh, B, P_real, dev)
    blk = slice(d * B, (d + 1) * B)
    poses_blk, odo_blk = poses0[blk], odo_meas[blk]
    sig_b = graph.odo_sigmas.expand(B, 6)
    lc_i, lc_j = graph.lc_i, graph.lc_j
    L = int(lc_i.shape[0])
    own_i, own_j = (lc_i // B) == d, (lc_j // B) == d
    loc_i, loc_j = lc_i % B, lc_j % B
    dump_i = torch.where(own_i, loc_i, B)  # row B: the rows other ranks own
    dump_j = torch.where(own_j, loc_j, B)
    seg_i, seg_j = segments(dump_i, B + 1), segments(dump_j, B + 1)

    def gather_lc(x):
        """(2, L, ...) values of ``x`` (B, ...) at every loop closure's two
        endpoints: masked local reads, one psum (each entry has one owner)."""
        vi = torch.where(_rows(own_i, x[loc_i]), x[loc_i], 0.0)
        vj = torch.where(_rows(own_j, x[loc_j]), x[loc_j], 0.0)
        return psum(mesh, torch.stack([vi, vj]))

    def gather_lc_poses(p):
        g = gather_lc(_pack(p))
        return _unpack(g[0]), _unpack(g[1])

    def scatter_lc(vi, vj):
        """The rows this rank owns of per-loop-closure terms at each endpoint."""
        return seg_i.sum(vi)[:B] + seg_j.sum(vj)[:B]

    def error(p):  # float64, as pose_graph.graph_error
        r_o = cost_residual(p, ch.shifted_poses(p), odo_blk, graph.odo_sigmas)
        r_o = torch.where(ch.odo_valid[:, None], r_o, 0.0)
        xi, xj = gather_lc_poses(p)
        r_l = cost_residual(xi, xj, graph.lc_meas, graph.lc_sigmas)
        r_l = torch.where(graph.lc_valid[:, None], r_l, 0.0)  # the same on every rank
        return 0.5 * (psum_ordered(mesh, torch.sum(r_o * r_o)) + torch.sum(r_l * r_l))

    def direct_step(g, D, Ji, Jj, Jli, Jlj, lam):
        """The exact damped step in float64: the chain by SPIKE, the
        loop-closure columns by Woodbury (``_direct_lm_step`` distributed).
        The chain's blocks are formed in float64 from the float32
        Jacobians, as the single-device step forms them: rounding them to
        float32 first moves a 12,000-pose step by decimetres."""
        f64 = torch.float64
        eye6 = torch.eye(6, dtype=f64, device=dev)
        Ji, Jj = Ji.to(f64), Jj.to(f64)
        U_all = ch.couplings(Ji, Jj)
        D_chain = ch.chain_sum([_tmm(Ji, Ji)], [_tmm(Jj, Jj)])[0]
        Jli0 = torch.where((lc_i == 0)[:, None, None], 0.0, Jli).to(f64)  # the gauge's blocks vanish
        Jlj0 = torch.where((lc_j == 0)[:, None, None], 0.0, Jlj).to(f64)
        V = woodbury_columns(Jli0.transpose(-1, -2), Jlj0.transpose(-1, -2), dump_i, dump_j, B + 1)[:B]
        T_diag = D_chain + lam.to(f64) * D.to(f64) + 1e-6 * eye6
        T_diag = torch.where(ch.fix_rows[:, None, None], eye6, T_diag)
        W = spike_block_tridiag_multi(mesh, T_diag, U_all[:B - 1], U_all[B - 1],
                                      torch.cat([(-g).to(f64)[:, :, None], V], dim=2))
        w0, Wv = W[:, :, 0], W[:, :, 1:]
        AW = psum(mesh, _owned_products(Jli0, Jlj0, W, own_i, own_j, loc_i, loc_j))  # (L, 6, 1 + 6L)
        C = AW[:, :, 1:].reshape(6 * L, 6 * L) + torch.eye(6 * L, dtype=f64, device=dev)
        y = cholesky_solve_or_nan(0.5 * (C + C.T), AW[:, :, 0].reshape(-1))
        return ch.fix_vec(w0 - Wv @ y).to(dtype)

    def trial(p, err, lam):
        r_o, Ji, Jj = _linearize_f64(p, ch.shifted_poses(p), odo_blk, sig_b)
        w = ch.odo_valid[:, None].to(dtype)
        r_o, Ji, Jj = r_o * w, Ji * w[..., None], Jj * w[..., None]
        xl_i, xl_j = gather_lc_poses(p)
        r_l, Jli, Jlj = _linearize_f64(xl_i, xl_j, graph.lc_meas, graph.lc_sigmas)
        wl = graph.lc_valid[:, None].to(dtype)
        r_l, Jli, Jlj = r_l * wl, Jli * wl[..., None], Jlj * wl[..., None]

        # the direct step sums g and D in float64, as the one-device solve
        # does: float32 sums round differently on every partition (C17)
        acc = torch.float64 if kind == "direct" else dtype
        a_o, b_o, a_l, b_l, c_l = (x.to(acc) for x in (Ji, Jj, Jli, Jlj, r_l))
        g, D_chain = ch.chain_sum([_tmv(a_o, r_o.to(acc)), _tmm(a_o, a_o)], [_tmv(b_o, r_o.to(acc)), _tmm(b_o, b_o)])
        g = ch.fix_vec(g + scatter_lc(_tmv(a_l, c_l), _tmv(b_l, c_l)))
        D = ch.fix_blocks(D_chain + scatter_lc(_tmm(a_l, a_l), _tmm(b_l, b_l)))

        if kind == "direct":
            delta, cg_k = direct_step(g, D, Ji, Jj, Jli, Jlj, lam), 0
        else:
            Dp = D * (1.0 + lam) + 1e-6 * torch.eye(6, dtype=dtype, device=dev)
            if kind == "jacobi":
                Lp = _cholesky_or_nan(Dp)

                def precond(v):
                    return torch.cholesky_solve(v[..., None], Lp)[..., 0]
            else:
                precond = _block_precond(kind, Dp, ch.local_couplings(Ji, Jj), cfg, d * B, P_real)

            def matvec(v):
                v = ch.fix_vec(v)
                a = _mv(Ji, v) + _mv(Jj, ch.shifted(v))
                out = ch.chain_sum([_tmv(Ji, a)], [_tmv(Jj, a)])[0]
                vl = gather_lc(v)
                al = _mv(Jli, vl[0]) + _mv(Jlj, vl[1])
                out = out + scatter_lc(_tmv(Jli, al), _tmv(Jlj, al)) + lam * _mv(D, v)
                return torch.where(ch.fix_rows[:, None], v, out)

            delta, cg_k = _pcg_dist(mesh, matvec, -g, precond, cfg.cg_tol, cfg.cg_max_iters)
            delta = ch.fix_vec(delta)
        cand = se3.where(~ch.fix_rows, se3.retract(p, delta), p)
        new_err = error(cand)
        good = torch.isfinite(new_err) & (new_err < err)
        return se3.where(good.expand(B), cand, p), torch.where(good, new_err, err), _lm_update(good, lam), cg_k, g

    err0 = error(poses_blk)
    err = err0
    lam = torch.clamp(torch.tensor(lam0, dtype=dtype, device=dev), 1e-9, 1e6)
    stall, k, cg_total = int(stall0), 0, 0
    while k < cfg.max_gn_iters and stall < 2:
        poses_blk, err2, lam, cg_k, g = trial(poses_blk, err, lam)
        improved = bool((err - err2) > REL_EXIT_TOL * torch.clamp(err, min=1e-30))
        err, k, cg_total = err2, k + 1, cg_total + cg_k
        stall = 0 if improved else stall + 1
    poses = _unpack(ch.gather_rows(_pack(poses_blk), P_real))
    # the last trial's gradient norm, summed in rank order: the same bits on every rank
    g_norm = torch.sqrt(psum_ordered(mesh, torch.sum(g * g))) if k else torch.zeros((), dtype=dtype, device=dev)
    return poses, SolveInfo(error0=err0, error=err, iterations=k, stall=stall, cg_iters_total=cg_total,
                            solver_kind="sp_" + kind, lam=lam, grad_norm=g_norm)


def seq_pose_graph_solve(mesh: Mesh, graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig(), lam0=None,
                         stall0=None):
    """Pose-graph LM with the pose chain block-partitioned over the ranks;
    returns ``(poses, SolveInfo)`` whole on every rank, ``solver_kind`` =
    ``"sp_<kind>"``.  ``lam0`` / ``stall0`` resume a damping and stall
    counter (:mod:`.recovery`).  Same fixed point as
    :func:`..solvers.pose_graph.solve_pose_graph` up to the linear solve's
    tolerance.  As in the JAX package, the sequence-parallel direct step
    always runs the single-damping schedule (``cfg.lam_sweep_factors`` is
    not read) and there is no coarse-to-fine initialization
    (``cfg.coarse_init_stride`` is not read)."""
    poses0, odo_meas, B, P_real = _pad_chain(graph, mesh.size)
    kind = resolve_seq_pg_solver_kind(cfg.preconditioner, B, int(graph.lc_i.shape[0]))
    return _seq_pg_run(mesh, poses0, odo_meas, graph, 1e-4 if lam0 is None else float(lam0),
                       0 if stall0 is None else int(stall0), cfg, B, P_real, kind)


# ---------------------------------------------------------------------------
# Full BA: pose chain sequence-parallel, correspondences owner-aligned
# ---------------------------------------------------------------------------
#
# Correspondences move to the rank that owns their SOURCE pose (one
# all_to_all at problem build, alltoall.reshard_local), so the source-pose
# gather is a local read.  The target pose is served by a routed exchange
# built once on the host: each rank's table ``need`` (n, Rj) lists the
# unique rows of its block each peer reads, and each factor's slot in the
# receive buffer is ``recv_slot``; per call one all_to_all of (n, Rj, row)
# rows, and the transposed scatter rides the same routing back.


def _simulate_reshard_layout(dest: np.ndarray, valid: np.ndarray, n: int, capacity: int) -> np.ndarray:
    """Host replica of :func:`.alltoall.reshard_rows`'s placement: the
    original row index in each of the ``n * n * capacity`` post-reshard
    slots (-1 = empty).  Rank d's slots are ``[lane from rank 0 (capacity),
    lane from rank 1, ...]``, each lane in its sender's stable
    destination-sorted order."""
    K = len(dest)
    pad = (-K) % n
    dest_p = np.concatenate([dest, np.zeros(pad, dest.dtype)])
    valid_p = np.concatenate([valid, np.zeros(pad, bool)])
    kb = (K + pad) // n
    Kf = n * capacity
    out_orig = np.full(n * Kf, -1, np.int64)
    for a in range(n):
        base = a * kb
        d_blk = np.where(valid_p[base:base + kb], dest_p[base:base + kb], n)
        order = np.argsort(d_blk, kind="stable")
        d_sorted = d_blk[order]
        for d in range(n):
            rows = (base + order[d_sorted == d])[:capacity]
            out_orig[d * Kf + a * capacity:d * Kf + a * capacity + len(rows)] = rows
    return out_orig


def _align_ba(mesh: Mesh, prob: BAProblem):
    """Owner-align a BAProblem over the ranks (once per problem): the
    padded chain, this rank's resharded factor rows and routing tables,
    and the layout (``out_orig``) that maps the slots back."""
    from .alltoall import reshard_local

    n, d = mesh.size, mesh.rank
    dev = prob.poses0.t.device
    chain = PoseGraph(poses0=prob.poses0, odo_meas=prob.odo_meas, odo_sigmas=prob.odo_sigmas, lc_i=None,
                      lc_j=None, lc_meas=None, lc_sigmas=None, lc_valid=None)
    poses0, odo_meas, B, P_real = _pad_chain(chain, n)

    host = torch.stack([prob.kp_i, prob.kp_j, prob.kp_valid.to(torch.int64)]).cpu().numpy()
    kp_i, kp_j, valid = host[0], host[1], host[2].astype(bool)
    K = len(kp_i)
    dest = np.minimum(kp_i // B, n - 1)
    pad = (-K) % n
    kb = (K + pad) // n
    lane = np.zeros((n, n), np.int64)
    np.add.at(lane, ((np.arange(K) // kb)[valid], dest[valid]), 1)
    capacity = max(1, int(lane.max()))  # exact: the reshard drops nothing

    # constant-pose (fixed-lag window) endpoints ride along as factor data
    fix_i = prob.kp_i_fix if prob.kp_i_fix is not None else torch.zeros(K, dtype=torch.bool, device=dev)
    fix_j = prob.kp_j_fix if prob.kp_j_fix is not None else torch.zeros(K, dtype=torch.bool, device=dev)
    ident = se3.identity((K,), prob.poses0.t.dtype, dev)
    cps = prob.kp_pose_s if prob.kp_pose_s is not None else ident
    cpt = prob.kp_pose_t if prob.kp_pose_t is not None else ident
    tree = dict(sr_s=prob.kp_sr_s, sr_t=prob.kp_sr_t, lm0=prob.lm0, lm_prior=prob.lm_prior, fix_i=fix_i,
                fix_j=fix_j, cps=_pack(cps), cpt=_pack(cpt))
    from ..padding import pad_rows

    tree = {k: pad_rows(v, K + pad) for k, v in tree.items()}
    out, vout, dropped = reshard_local(mesh, tree, pad_rows(torch.as_tensor(dest, device=dev), K + pad),
                                       pad_rows(prob.kp_valid, K + pad), capacity)
    dropped = int(psum_ordered(mesh, dropped).sum())
    if dropped:
        raise AssertionError(f"owner-align reshard dropped {dropped} rows at exact capacity")

    out_orig = _simulate_reshard_layout(dest, valid, n, capacity)
    Kf = n * capacity
    v_r = out_orig >= 0
    safe = np.where(v_r, out_orig, 0)
    kp_i_r, kp_j_r = np.where(v_r, kp_i[safe], 0), np.where(v_r, kp_j[safe], 0)
    owner_j, loc_j = kp_j_r // B, kp_j_r % B
    uniq = {}
    Rj = 1
    for dd in range(n):
        sl = slice(dd * Kf, (dd + 1) * Kf)
        for a in range(n):
            uniq[(a, dd)] = np.unique(loc_j[sl][v_r[sl] & (owner_j[sl] == a)])
            Rj = max(Rj, len(uniq[(a, dd)]))
    sl = slice(d * Kf, (d + 1) * Kf)
    slot = np.zeros(Kf, np.int64)
    for a in range(n):
        m = v_r[sl] & (owner_j[sl] == a)
        if len(uniq[(a, d)]):
            slot[m] = a * Rj + np.searchsorted(uniq[(a, d)], loc_j[sl][m])
    need = np.zeros((n, Rj), np.int64)  # the rows of my block each peer reads
    for dd in range(n):
        need[dd, :len(uniq[(d, dd)])] = uniq[(d, dd)]

    def up(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    aligned = dict(loc_i=up(kp_i_r[sl] % B), slot=up(slot), need=up(need), gj=up(kp_j_r[sl]),
                   gi_all=up(kp_i_r), gj_all=up(kp_j_r), occupied=torch.as_tensor(v_r, device=dev),
                   kv=vout, **out)
    return poses0, odo_meas, aligned, out_orig, B, Kf, Rj, P_real


def _seq_ba_run(mesh: Mesh, poses0, odo_meas, prob: BAProblem, al: dict, cfg: FullBAConfig, kp_cfg, B: int,
                Kf: int, Rj: int, P_real: int, kind: str):
    n, d = mesh.size, mesh.rank
    dev, dtype = poses0.t.device, poses0.t.dtype
    ch = _Chain(mesh, B, P_real, dev)
    blk = slice(d * B, (d + 1) * B)
    poses_blk, odo_blk = poses0[blk], odo_meas[blk]
    sig_b = prob.odo_sigmas.expand(B, 6)
    lps = prob.lm_prior_sigmas
    loc_i, slot, need, kv = al["loc_i"], al["slot"], al["need"], al["kv"]
    sr_s, sr_t, lmp = al["sr_s"], al["sr_t"], al["lm_prior"]
    fix_i, fix_j = al["fix_i"], al["fix_j"]
    cps, cpt = _unpack(al["cps"]), _unpack(al["cpt"])
    nR = n * Rj
    sig_s = kp_noise_sigmas(sr_s, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    sig_t = kp_noise_sigmas(sr_t, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
    seg_loc, seg_slot, seg_need = segments(loc_i, B), segments(slot, nR), segments(need.reshape(-1), B)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    kv1, kv2 = kv[:, None], kv[:, None, None]

    def routed_gather(x):
        """Each factor's value of ``x`` (B, ...) at its TARGET pose: every
        rank sends the rows its peers read, one all_to_all, each factor
        reads its slot."""
        recv = all_to_all(mesh, x[need])  # (n, Rj, ...)
        return recv.reshape(nR, *x.shape[1:])[slot]

    def routed_scatter(vals):
        """Transpose of :func:`routed_gather`: per-factor terms summed by
        slot, back over the same all_to_all, summed into the owners' rows."""
        got = all_to_all(mesh, seg_slot.sum(vals).reshape(n, Rj, *vals.shape[1:]))
        return seg_need.sum(got.reshape(nR, *vals.shape[1:]))

    def endpoint_poses(p):
        pi = se3.where(fix_i, cps, p[loc_i])
        pj = se3.where(fix_j, cpt, _unpack(routed_gather(_pack(p))))
        return pi, pj

    def error(p, lms):
        r_o = between_residual(p, ch.shifted_poses(p), odo_blk) / prob.odo_sigmas
        r_o = torch.where(ch.odo_valid[:, None], r_o, 0.0)
        pose_i, pose_j = endpoint_poses(p)
        Ts = se3.identity((), dtype, dev)

        def kp_res(pose, sr, sig):
            return sss_point_residual(lms, pose, Ts, torch.stack([sr, torch.zeros_like(sr)], dim=-1)) / sig

        r_s = torch.where(kv1, kp_res(pose_i, sr_s, sig_s), 0.0)
        r_t = torch.where(kv1, kp_res(pose_j, sr_t, sig_t), 0.0)
        r_pr = torch.where(kv1, (lms - lmp) / lps, 0.0)
        return psum_ordered(mesh, _ba_error_from_residuals(r_o, r_s, r_t, r_pr, cfg.huber_delta))

    def direct_step(g_red, D_p, Ja, Jb, L_ll, Hpl_s, Hpl_t, lam):
        """The exact damped step of the Schur-reduced system (zero CG):
        SPIKE for the chain, Woodbury over the landmark coupling columns
        (3 per valid global slot; the empty slots' columns are zero and
        drop), built from one all-gather of the per-factor blocks."""
        U_all = ch.couplings(Ja, Jb)
        Hpl_s0 = torch.where(((d * B + loc_i) == 0)[:, None, None], 0.0, Hpl_s)
        Hpl_t0 = torch.where((al["gj"] == 0)[:, None, None], 0.0, Hpl_t)
        Vhat = torch.stack([
            torch.linalg.solve_triangular(L_ll, H.transpose(-1, -2), upper=False).transpose(-1, -2)
            for H in (Hpl_s0, Hpl_t0)])  # (2, Kf, 6, 3)
        occ = al["occupied"]
        V_all = all_gather(mesh, Vhat).transpose(0, 1).reshape(2, n * Kf, 6, 3)[:, occ]  # (2, Kv, 6, 3)
        gi, gj = al["gi_all"][occ], al["gj_all"][occ]
        own_i, own_j = (gi // B) == d, (gj // B) == d
        V = woodbury_columns(V_all[0], V_all[1], torch.where(own_i, gi % B, B), torch.where(own_j, gj % B, B),
                             B + 1)[:B]
        T_diag = ch.fix_blocks((1.0 + lam) * D_p + 1e-6 * eye6)
        W = spike_block_tridiag_multi(mesh, T_diag, U_all[:B - 1], U_all[B - 1],
                                      torch.cat([(-g_red)[:, :, None], V], dim=2))
        w0, Wv = W[:, :, 0], W[:, :, 1:]
        if not gi.numel():
            return ch.fix_vec(w0)
        AW = psum(mesh, _owned_products(V_all[0].transpose(-1, -2), V_all[1].transpose(-1, -2), W, own_i, own_j,
                                        gi % B, gj % B))  # (Kv, 3, 1 + 3Kv)
        m = AW.shape[0] * 3
        C = torch.eye(m, dtype=dtype, device=dev) - AW[:, :, 1:].reshape(m, m)
        y = cholesky_solve_or_nan(0.5 * (C + C.T), AW[:, :, 0].reshape(-1))
        return ch.fix_vec(w0 + Wv @ y)

    def trial(p, lms, err, lam):
        r_o, Ja, Jb = _linearize_between(p, ch.shifted_poses(p), odo_blk, sig_b)
        w = ch.odo_valid[:, None].to(dtype)
        r_o, Ja, Jb = r_o * w, Ja * w[..., None], Jb * w[..., None]

        pose_i, pose_j = endpoint_poses(p)
        r_s, Jp_s, Jl_s = _sss_factor_terms(pose_i, lms, sr_s, sig_s)
        r_t, Jp_t, Jl_t = _sss_factor_terms(pose_j, lms, sr_t, sig_t)
        Jp_s = torch.where(fix_i[:, None, None], 0.0, Jp_s)  # a frozen endpoint has no pose Jacobian
        Jp_t = torch.where(fix_j[:, None, None], 0.0, Jp_t)
        r_s, r_t = torch.where(kv1, r_s, 0.0), torch.where(kv1, r_t, 0.0)
        w_s = _huber_weight(torch.sum(r_s ** 2, -1), cfg.huber_delta)
        w_t = _huber_weight(torch.sum(r_t ** 2, -1), cfg.huber_delta)
        r_s, r_t = r_s * w_s[:, None], r_t * w_t[:, None]
        Jp_s = torch.where(kv2, Jp_s * w_s[:, None, None], 0.0)
        Jp_t = torch.where(kv2, Jp_t * w_t[:, None, None], 0.0)
        Jl_s = torch.where(kv2, Jl_s * w_s[:, None, None], 0.0)
        Jl_t = torch.where(kv2, Jl_t * w_t[:, None, None], 0.0)
        r_pr = torch.where(kv1, (lms - lmp) / lps, 0.0)
        Jl_pr = (eye3 / lps[:, None]).expand(Kf, 3, 3) * kv.to(dtype)[:, None, None]

        g_p, D_p = ch.chain_sum([_tmv(Ja, r_o), _tmm(Ja, Ja)], [_tmv(Jb, r_o), _tmm(Jb, Jb)])
        tgt = routed_scatter(torch.cat([_tmv(Jp_t, r_t), _tmm(Jp_t, Jp_t).reshape(Kf, 36)], dim=1))
        g_p = ch.fix_vec(g_p + seg_loc.sum(_tmv(Jp_s, r_s)) + tgt[:, :6])
        D_p = ch.fix_blocks(D_p + seg_loc.sum(_tmm(Jp_s, Jp_s)) + tgt[:, 6:].reshape(B, 6, 6))
        g_l = _tmv(Jl_s, r_s) + _tmv(Jl_t, r_t) + _tmv(Jl_pr, r_pr)
        H_ll = _tmm(Jl_s, Jl_s) + _tmm(Jl_t, Jl_t) + _tmm(Jl_pr, Jl_pr)
        L_ll = _cholesky_or_nan(H_ll * (1.0 + lam) + 1e-6 * eye3)

        def ll_solve(x):  # (Kf, 3)
            return torch.cholesky_solve(x[..., None], L_ll)[..., 0]

        Hpl_s, Hpl_t = _tmm(Jp_s, Jl_s), _tmm(Jp_t, Jl_t)
        y = ll_solve(g_l)
        g_red = ch.fix_vec(g_p - seg_loc.sum(_mv(Hpl_s, y)) - routed_scatter(_mv(Hpl_t, y)))

        if kind == "direct":
            delta_p, cg_k = direct_step(g_red, D_p, Ja, Jb, L_ll, Hpl_s, Hpl_t, lam), 0
        else:
            def matvec(v):
                v = ch.fix_vec(v)
                a = _mv(Ja, v) + _mv(Jb, ch.shifted(v))
                out = ch.chain_sum([_tmv(Ja, a)], [_tmv(Jb, a)])[0]
                b_s, b_t = _mv(Jp_s, v[loc_i]), _mv(Jp_t, routed_gather(v))
                yv = ll_solve(_tmv(Jl_s, b_s) + _tmv(Jl_t, b_t))
                out = out + seg_loc.sum(_tmv(Jp_s, b_s) - _mv(Hpl_s, yv))
                out = out + routed_scatter(_tmv(Jp_t, b_t) - _mv(Hpl_t, yv)) + lam * _mv(D_p, v)
                return torch.where(ch.fix_rows[:, None], v, out)

            corr_t = routed_scatter((Hpl_t @ torch.cholesky_solve(Hpl_t.transpose(-1, -2), L_ll)).reshape(Kf, 36))
            S_corr = seg_loc.sum(Hpl_s @ torch.cholesky_solve(Hpl_s.transpose(-1, -2), L_ll)) + corr_t.reshape(B, 6, 6)
            Dp_damped = ch.fix_blocks(D_p * (1.0 + lam) - S_corr) + 1e-5 * eye6
            fallback = D_p * (1.0 + lam) + 1e-5 * eye6
            L_d = _cholesky_or_nan(Dp_damped)
            if kind == "jacobi":
                Lp = torch.where(torch.isfinite(L_d).all(), L_d, _cholesky_or_nan(fallback))

                def precond(v):
                    return torch.cholesky_solve(v[..., None], Lp)[..., 0]
            else:
                ok = torch.isfinite(L_d).all(-1, keepdim=True).all(-2, keepdim=True)
                precond = _block_precond(kind, torch.where(ok, Dp_damped, fallback), ch.local_couplings(Ja, Jb),
                                         cfg, d * B, P_real)
            delta_p, cg_k = _pcg_dist(mesh, matvec, -g_red, precond, cfg.cg_tol, cfg.cg_max_iters)
            delta_p = ch.fix_vec(delta_p)

        # landmark back-substitution, retract, LM accept gate
        hv, ht = _mv(Jp_s, delta_p[loc_i]), _mv(Jp_t, routed_gather(delta_p))
        delta_l = ll_solve(-g_l - _tmv(Jl_s, hv) - _tmv(Jl_t, ht))
        new_p = se3.where(~ch.fix_rows, se3.retract(p, delta_p), p)
        new_lms = lms + delta_l
        new_err = error(new_p, new_lms)
        good = torch.isfinite(new_err) & (new_err < err)
        p = se3.where(good.expand(B), new_p, p)
        lms = torch.where(good, new_lms, lms)
        return p, lms, torch.where(good, new_err, err), _lm_update(good, lam), cg_k

    lms_b = al["lm0"]
    err0 = error(poses_blk, lms_b)
    err = err0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    k = stall = cg_total = 0
    while k < cfg.max_iters and stall < 2:
        poses_blk, lms_b, err2, lam, cg_k = trial(poses_blk, lms_b, err, lam)
        improved = bool((err - err2) > REL_EXIT_TOL * torch.clamp(err, min=1e-30))
        err, k, cg_total = err2, k + 1, cg_total + cg_k
        stall = 0 if improved else stall + 1
    poses = _unpack(ch.gather_rows(_pack(poses_blk), P_real))
    lms_all = all_gather(mesh, lms_b).reshape(n * Kf, 3)
    return poses, lms_all, BAInfo(error0=err0, error=err, iterations=k, stall=stall, cg_iters_total=cg_total,
                                  solver_kind="sp_" + kind, lam=lam)


def seq_full_ba_solve(mesh: Mesh, prob: BAProblem, cfg: FullBAConfig = FullBAConfig(),
                      kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig()):
    """Joint Schur-complement BA with the pose chain sequence-parallel and
    the correspondences owner-aligned (module docstring): per rank O(P/n)
    pose-chain and O(K/n) correspondence state, per matvec O(n * Rj)
    exchanged rows, no O(P) collective.  Same fixed point as
    :func:`..solvers.full_ba.solve_full_ba` up to the linear solve's
    tolerance.  Returns ``(poses, landmarks, BAInfo)`` whole on every rank,
    landmarks in the caller's factor order (an invalid row keeps its
    initial value)."""
    poses0, odo_meas, al, out_orig, B, Kf, Rj, P_real = _align_ba(mesh, prob)
    kind = resolve_seq_ba_solver_kind(cfg.preconditioner, B, mesh.size, Kf)
    poses, lms_all, info = _seq_ba_run(mesh, poses0, odo_meas, prob, al, cfg, kp_cfg, B, Kf, Rj, P_real, kind)
    occ = torch.as_tensor(out_orig >= 0, device=lms_all.device)
    lms = prob.lm0.clone()
    lms[torch.as_tensor(out_orig[out_orig >= 0], device=lms.device)] = lms_all[occ]
    return poses, lms, info

