"""The mesh constructor and the data-parallel solves.

Counterpart of :mod:`diasss_tpu.parallel.shard`.  :func:`make_mesh` is the
port's ``make_mesh``: a :class:`.collectives.Mesh` over the ranks of a
process group.  Data parallel over a factor batch, the pose system on
every rank (the sequence-parallel partition of the chain is
:mod:`.seq`):

* :func:`sharded_lc_solve` — the loop-closure mini-solves (independent
  9-dof problems; the reference runs them serially, optimizer.cpp:690-965):
  no collective inside the solve, one all-gather of the results;
* :func:`sharded_pose_graph_solve` — the global pose graph with the
  loop-closure factors sharded: each rank linearizes its block, one
  all-gather of the per-factor terms per trial, the error summed over the
  ranks in rank order;
* :func:`sharded_full_ba_solve` — full BA with the correspondence axis K
  sharded the same way (the per-landmark linearization is the O(K) work).

Where the JAX package lets XLA reduce the scattered segment sums across
devices, the port gathers the per-factor terms once per trial and sums
them on every rank in one fixed order: the same values on every rank.

Inputs are the same full tensors on every rank (the JAX package's
multi-process model); each rank takes its own block and the results come
back whole on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..config import FullBAConfig, KeypointNoiseConfig, LoopClosureConfig, PoseGraphConfig
from ..padding import pad_to_multiple
from .collectives import Mesh, all_gather


def make_mesh(n_devices: int | None = None, device=None, group=None) -> Mesh:
    """The mesh of ``n_devices`` ranks: every rank of ``group`` (default
    the default group), computing on ``device`` (default the rank's CUDA
    device; without CUDA the default raises, so CPU ranks pass
    ``device="cpu"``).

    Raises without a process group, and when the group does not hold
    exactly ``n_devices`` ranks: the JAX package's silent drop to one chip
    is on ROADMAP's not-to-port list, and every rank of the group runs the
    same mesh program.  The transport is the group's backend."""
    from .distributed import default_device

    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs a process group: run under "
            f"`torchrun --nproc-per-node {n_devices or 'N'}` or call diasss_tpu_torch.parallel.distributed.initialize()")
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    n = n_devices or world
    if world != n:
        raise RuntimeError(f"a mesh of {n} devices needs a process group of {n} ranks, this one has {world}")
    ranks = tuple(range(world)) if group is dist.group.WORLD else tuple(dist.get_process_group_ranks(group))
    return Mesh(group=group, rank=dist.get_rank(group), size=n,
                device=torch.device(device) if device is not None else default_device(),
                transport=dist.get_backend(group), ranks=ranks)


def block_of(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of an axis of ``n_rows`` (a multiple of the mesh size)."""
    b = n_rows // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def gather_rows(mesh: Mesh, tree, n_rows: int):
    """Every rank's block of ``tree`` (leading axis), concatenated in rank
    order and cut to ``n_rows``: the whole result on every rank."""
    return pytree.tree_map(lambda a: all_gather(mesh, a).reshape(-1, *a.shape[1:])[:n_rows], tree)


def sharded_lc_solve(mesh: Mesh, pairs, valid, dr_s, dr_t, geo_s, geo_t, alts_s, alts_t, gras_t, n_bins: int,
                     kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig(),
                     cfg: LoopClosureConfig = LoopClosureConfig()):
    """One frame pair's loop-closure batch sharded over the ranks (the
    correspondences padded with invalid rows to a mesh multiple); the frame
    tensors are whole on every rank.  Returns the :class:`LCResult` of
    every correspondence, whole on every rank."""
    from ..solvers.lc import loop_closing_tfs

    K = int(pairs.shape[0])
    pairs_p, valid_p = pad_to_multiple(pairs, mesh.size), pad_to_multiple(valid, mesh.size)
    blk = block_of(mesh, int(pairs_p.shape[0]))
    out = loop_closing_tfs(pairs_p[blk], valid_p[blk], dr_s, dr_t, geo_s, geo_t, alts_s, alts_t, gras_t,
                           n_bins=n_bins, kp_cfg=kp_cfg, cfg=cfg)
    return gather_rows(mesh, out, K)


def _pose_graph_terms(mesh: Mesh):
    """:class:`..solvers.pose_graph.FactorTerms` with the loop-closure batch
    (a mesh multiple) data-parallel: each rank evaluates and linearizes its
    block; the cost's blocks are summed in rank order, the per-factor
    terms all-gathered; the odometry chain on every rank."""
    from ..solvers import pose_graph as pg
    from .collectives import psum_ordered

    def error(poses, graph):  # float64, as pg.graph_error
        r_odo = pg.cost_residual(poses[:-1], poses[1:], graph.odo_meas, graph.odo_sigmas)
        blk = block_of(mesh, int(graph.lc_i.shape[0]))
        r_lc = pg.cost_residual(poses[graph.lc_i[blk]], poses[graph.lc_j[blk]], graph.lc_meas[blk],
                                graph.lc_sigmas[blk])
        r_lc = torch.where(graph.lc_valid[blk][:, None], r_lc, torch.zeros_like(r_lc))
        return 0.5 * (torch.sum(r_odo * r_odo) + psum_ordered(mesh, torch.sum(r_lc * r_lc)))

    def normal_terms(poses, graph):
        P, dev, L = poses.t.shape[0], poses.t.device, int(graph.lc_i.shape[0])
        ar = torch.arange(P, device=dev)
        r_o, Ji_o, Jj_o = pg._linearize_f64(poses[:-1], poses[1:], graph.odo_meas, graph.odo_sigmas.expand(P - 1, 6))
        blk = block_of(mesh, L)
        lc = pg._linearize_f64(poses[graph.lc_i[blk]], poses[graph.lc_j[blk]], graph.lc_meas[blk],
                               graph.lc_sigmas[blk])
        w = graph.lc_valid[blk][:, None].to(r_o.dtype)
        r_l, Ji_l, Jj_l = gather_rows(mesh, (lc[0] * w, lc[1] * w[..., None], lc[2] * w[..., None]), L)
        return (torch.cat([ar[:-1], graph.lc_i]), torch.cat([ar[1:], graph.lc_j]), torch.cat([r_o, r_l]),
                torch.cat([Ji_o, Ji_l]), torch.cat([Jj_o, Jj_l]))

    return pg.FactorTerms(error, normal_terms)


def _full_ba_terms(mesh: Mesh):
    """:class:`..solvers.full_ba.FactorTerms` with the correspondence batch
    (a mesh multiple) data-parallel: each rank evaluates and linearizes its
    block; the robust cost's blocks are summed in rank order, the
    per-correspondence terms all-gathered; the odometry on every rank."""
    from ..factors.between import between_residual
    from ..factors.sss_point import kp_noise_sigmas, sss_point_residual
    from ..geometry import se3
    from ..solvers import full_ba as fb
    from .collectives import psum_ordered

    def error(poses, lms, prob, kp_cfg, huber_delta=0.0):
        r_odo = between_residual(poses[:-1], poses[1:], prob.odo_meas) / prob.odo_sigmas
        Ts = se3.identity((), lms.dtype, lms.device)
        blk = block_of(mesh, int(prob.kp_i.shape[0]))
        lm = lms[blk]

        def kp_res(pose, sr):
            m = torch.stack([sr, torch.zeros_like(sr)], dim=-1)
            sig = kp_noise_sigmas(sr, kp_cfg.sigma_r, kp_cfg.alpha_bw_deg)
            return sss_point_residual(lm, pose, Ts, m) / sig

        pose_i, pose_j = fb._endpoint_poses(poses, prob)
        v = prob.kp_valid[blk, None]
        # where-mask (not multiply): padded slots can hold inf/nan residuals
        r_s = torch.where(v, kp_res(pose_i[blk], prob.kp_sr_s[blk]), 0.0)
        r_t = torch.where(v, kp_res(pose_j[blk], prob.kp_sr_t[blk]), 0.0)
        r_pr = torch.where(v, (lm - prob.lm_prior[blk]) / prob.lm_prior_sigmas, 0.0)
        return 0.5 * torch.sum(r_odo ** 2) + psum_ordered(
            mesh, fb._ba_error_from_residuals(r_odo[:0], r_s, r_t, r_pr, huber_delta))

    def sonar(pose, lms, sr, sig):
        K = int(lms.shape[0])
        blk = block_of(mesh, K)
        return gather_rows(mesh, fb._sss_factor_terms(pose[blk], lms[blk], sr[blk], sig[blk]), K)

    return fb.FactorTerms(error, sonar)


def sharded_pose_graph_solve(mesh: Mesh, graph, cfg: PoseGraphConfig = PoseGraphConfig()):
    """:func:`..solvers.pose_graph.solve_pose_graph` with the loop-closure
    factor batch sharded over the ranks (padded with invalid slots to a
    mesh multiple); the chain on every rank.  Returns ``(poses, SolveInfo)``
    whole on every rank."""
    from ..geometry import se3
    from ..padding import pad_rows
    from ..solvers.pose_graph import solve_pose_graph

    n_lc = int(graph.lc_i.shape[0])
    n = n_lc + (-n_lc) % mesh.size
    if n != n_lc:
        graph = graph._replace(
            lc_i=pad_rows(graph.lc_i, n), lc_j=pad_rows(graph.lc_j, n),
            lc_meas=se3.cat([graph.lc_meas, se3.Pose3(graph.lc_meas.R[:1].expand(n - n_lc, 3, 3),
                                                      graph.lc_meas.t[:1].expand(n - n_lc, 3))]),
            lc_sigmas=pad_rows(graph.lc_sigmas, n, 1.0), lc_valid=pad_rows(graph.lc_valid, n))
    return solve_pose_graph(graph, cfg, terms=_pose_graph_terms(mesh))


def sharded_full_ba_solve(mesh: Mesh, prob, ba_cfg: FullBAConfig | None = None,
                          kp_cfg: KeypointNoiseConfig = KeypointNoiseConfig()):
    """:func:`..solvers.full_ba.solve_full_ba` with the correspondence axis
    K sharded over the ranks (padded with invalid slots to a mesh multiple,
    as the JAX package pads); the pose system on every rank.  Returns
    ``(poses, landmarks, BAInfo)`` whole on every rank, the landmarks of the
    caller's K slots."""
    from ..padding import pad_rows
    from ..solvers.full_ba import solve_full_ba

    ba_cfg = ba_cfg or FullBAConfig()
    K = int(prob.kp_i.shape[0])
    n = K + (-K) % mesh.size
    if n != K:
        prob = prob._replace(kp_i=pad_rows(prob.kp_i, n), kp_j=pad_rows(prob.kp_j, n),
                             kp_sr_s=pad_rows(prob.kp_sr_s, n, 1.0), kp_sr_t=pad_rows(prob.kp_sr_t, n, 1.0),
                             kp_valid=pad_rows(prob.kp_valid, n), lm0=pad_rows(prob.lm0, n),
                             lm_prior=pad_rows(prob.lm_prior, n))
    poses, lms, info = solve_full_ba(prob, ba_cfg, kp_cfg, terms=_full_ba_terms(mesh))
    return poses, lms[:K], info
