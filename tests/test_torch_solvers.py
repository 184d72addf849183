"""Parity of the port's solvers (LM, loop-closure mini-solves, cyclic
reduction, direct pose-graph LM) with the JAX package.

Tolerances and why: the LM problems are whitened by sigmas down to 1e-3 and
1e-6, so float32 rounding differences (GEMM and Cholesky order) are amplified
in the iterates; the LM accept/stall decisions may then differ by a trial.
The accepted loop-closure set must be identical; relative poses agree to
1e-4 m / 1e-5 rad, marginal variances and quality scores to 1% relative.
Chain solves are held to 1e-4 relative to the solution's scale against a
float64 dense solve and against both JAX chain solvers; the direct pose-graph
solve to 1e-3 m in pose and 1e-3 relative in graph error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu.config import LoopClosureConfig, PipelineConfig, PoseGraphConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.pipeline import _assemble_pairs as jax_assemble_pairs
from diasss_tpu.pipeline import _overlap_pairs as jax_overlap_pairs
from diasss_tpu.solvers import lc as jlc
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu.solvers import tridiag as jtri
from diasss_tpu.solvers.triangulate import triangulate_batch as jax_triangulate
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.solvers import lc, pose_graph, tridiag
from diasss_tpu_torch.solvers.triangulate import triangulate_batch


def _T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def lc_problem():
    """The annotation keypoint pairs of a small survey, stacked as the
    pipeline stacks them, with both packages' LC results."""
    survey = small_survey()
    jf, tf = jax_and_port_frames(survey)
    cfg = PipelineConfig()
    pair_ids = jax_overlap_pairs(jf, cfg.min_overlap)
    kps, cap = jax_assemble_pairs(jf, None, pair_ids, cfg, True)
    rows = np.concatenate([kps[k].pairs for k in pair_ids])
    valid = np.concatenate([kps[k].valid for k in pair_ids])
    src = np.concatenate([np.full(cap, i) for i, _ in pair_ids])
    tgt = np.concatenate([np.full(cap, j) for _, j in pair_ids])
    stacks = [np.stack([np.asarray(getattr(f, a)) for f in jf]) for a in ("dr_poses", "geo", "altitudes", "ground_ranges")]
    ref = jax.device_get(jlc.loop_closing_tfs_stacked(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(src, jnp.int32), jnp.asarray(tgt, jnp.int32),
        *[jnp.asarray(s) for s in stacks], n_bins=int(jf[0].raw.shape[1])))
    ours = lc.loop_closing_tfs_stacked(_T(rows), _T(valid), _T(src), _T(tgt), *[_T(s) for s in stacks],
                                       n_bins=int(jf[0].raw.shape[1]))
    return dict(jf=jf, tf=tf, rows=rows, valid=valid, cap=cap, pair_ids=pair_ids, ref=ref, ours=ours)


def test_lc_stacked_accepts_the_same_set(lc_problem):
    ref, ours, v = lc_problem["ref"], lc_problem["ours"], lc_problem["valid"]
    acc_ref = v & (np.asarray(ref.quality) > 0) & np.all(np.isfinite(ref.variance6), axis=1)
    acc_ours = v & (ours.quality.numpy() > 0) & np.all(np.isfinite(ours.variance6.numpy()), axis=1)
    assert acc_ref.sum() >= 2
    np.testing.assert_array_equal(acc_ours, acc_ref)
    np.testing.assert_allclose(ours.rel_pose.t.numpy()[v], np.asarray(ref.rel_pose.t)[v], atol=1e-4)
    np.testing.assert_allclose(ours.rel_pose.R.numpy()[v], np.asarray(ref.rel_pose.R)[v], atol=1e-5)
    np.testing.assert_allclose(ours.variance6.numpy()[v], np.asarray(ref.variance6)[v], rtol=1e-2)
    np.testing.assert_allclose(ours.quality.numpy()[v], np.asarray(ref.quality)[v], rtol=1e-2)
    for f in ("ini_dist", "fnl_dist", "dr_range_e", "depth_est", "depth_drape"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[v], np.asarray(getattr(ref, f))[v], atol=1e-4)


def test_lc_per_pair_equals_stacked(lc_problem):
    tf, cap, ours = lc_problem["tf"], lc_problem["cap"], lc_problem["ours"]
    rows, valid = lc_problem["rows"], lc_problem["valid"]
    for k, (i, j) in enumerate(lc_problem["pair_ids"]):
        sl = slice(k * cap, (k + 1) * cap)
        one = lc.loop_closing_tfs(_T(rows[sl]), _T(valid[sl]), tf[i].dr_poses, tf[j].dr_poses, tf[i].geo,
                                  tf[j].geo, tf[i].altitudes, tf[j].altitudes, tf[j].ground_ranges,
                                  n_bins=int(tf[0].raw.shape[1]))
        np.testing.assert_allclose(one.rel_pose.t.numpy(), ours.rel_pose.t.numpy()[sl], atol=1e-6)
        np.testing.assert_allclose(one.quality.numpy(), ours.quality.numpy()[sl], rtol=1e-6)


def test_compass_flip_matches_jax():
    yaw = np.array([0.0, 2.0, 2.2, -2.2, np.pi - 1e-4, -np.pi + 1e-4], np.float32)
    ours = lc._compass_flip(_T(yaw), LoopClosureConfig().compass_flip_yaw)
    ref = jlc._compass_flip(jnp.asarray(yaw), LoopClosureConfig().compass_flip_yaw, jnp.float32)
    np.testing.assert_allclose(ours.R.numpy(), np.asarray(ref.R), atol=1e-7)


def test_triangulation_matches_jax():
    rng = np.random.default_rng(0)
    k = 40
    rows_s = np.zeros((k, 6), np.float32)
    rows_t = np.zeros((k, 6), np.float32)
    rows_s[:, 3] = rng.uniform(0, 50, k)
    rows_t[:, 3] = rows_s[:, 3] + rng.normal(0, 0.3, k)
    rows_t[:, 4] = 30.0
    rows_t[:, 2] = np.pi
    lm = np.stack([rows_s[:, 3], rng.uniform(5, 25, k), np.full(k, -12.0)], 1).astype(np.float32)
    sr_s = np.linalg.norm(lm - rows_s[:, 3:], axis=1).astype(np.float32)
    sr_t = (np.linalg.norm(lm - rows_t[:, 3:], axis=1) + rng.normal(0, 0.05, k)).astype(np.float32)
    init = (lm + rng.normal(0, 1.0, lm.shape)).astype(np.float32)
    Ts = se3.identity((k,))
    ours = triangulate_batch(se3.from_rodrigues_xyz(_T(rows_s)), se3.from_rodrigues_xyz(_T(rows_t)), Ts, Ts,
                             _T(sr_s), _T(sr_t), _T(init))
    jTs = jse3.identity((k,))
    ref = jax_triangulate(jse3.from_rodrigues_xyz(jnp.asarray(rows_s)), jse3.from_rodrigues_xyz(jnp.asarray(rows_t)),
                          jTs, jTs, jnp.asarray(sr_s), jnp.asarray(sr_t), jnp.asarray(init))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)


def _chain(P, R, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, 6, 6))
    D = A @ A.transpose(0, 2, 1) + 6.0 * np.eye(6)
    U = rng.normal(size=(P - 1, 6, 6)) * 0.5
    B = rng.normal(size=(P, 6, R))
    T = np.zeros((6 * P, 6 * P))
    for i in range(P):
        T[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
    for i in range(P - 1):
        T[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
        T[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    x = np.linalg.solve(T, B.reshape(6 * P, R)).reshape(P, 6, R)
    return [a.astype(np.float32) for a in (D, U, B)], x


@pytest.mark.parametrize("P", [1, 2, 3, 37])
def test_cyclic_reduction_multi_rhs(P):
    (D, U, B), x = _chain(P, 5, P)
    ours = tridiag.solve_block_tridiag_multi(_T(D), _T(U), _T(B)).numpy()
    scale = np.abs(x).max()
    np.testing.assert_allclose(ours, x, atol=1e-4 * scale)
    if P > 1:
        for ref in (jtri.solve_block_tridiag_multi, jtri.thomas_block_tridiag_multi):
            np.testing.assert_allclose(ours, np.asarray(ref(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))),
                                       atol=1e-4 * scale)
    one = tridiag.solve_block_tridiag(_T(D), _T(U), _T(B[..., 0])).numpy()
    np.testing.assert_allclose(one, x[..., 0], atol=1e-4 * scale)


@pytest.fixture(scope="module")
def graph_problem():
    """A 3-line DR chain with four loop closures measured from ground truth
    (one invalid slot), built by hand so the test does not depend on the
    pipeline."""
    survey = small_survey(n_pings=100)
    rows = [l.dr_poses.astype(np.float32) for l in survey.lines]
    P = sum(len(r) for r in rows)
    rng = np.random.default_rng(1)
    lc_i = np.array([20, 45, 80, 130], np.int32)
    lc_j = np.array([180, 150, 260, 230], np.int32)
    gt = np.concatenate([l.gt_poses for l in survey.lines]).astype(np.float32)
    meas = jse3.between(jse3.from_rodrigues_xyz(jnp.asarray(gt[lc_i])), jse3.from_rodrigues_xyz(jnp.asarray(gt[lc_j])))
    sig = (np.abs(rng.normal(size=(4, 6))) * 0.01 + 0.01).astype(np.float32)
    valid = np.array([True, True, True, False])
    cfg = PoseGraphConfig(preconditioner="direct")
    jg = jpg.build_chain_graph(rows, lc_i, lc_j, meas, sig, valid, cfg, noise_key=jax.random.PRNGKey(cfg.seed))
    tg = pose_graph.build_chain_graph(rows, lc_i, lc_j, se3.Pose3(_T(meas.R), _T(meas.t)), sig, valid, port_cfg(cfg),
                                      rng=JaxRng(noise_seed=cfg.seed), device="cpu")
    return jg, tg, cfg, P


def test_chain_graph_noise_matches_jax(graph_problem):
    jg, tg, _, _ = graph_problem
    np.testing.assert_allclose(tg.poses0.t.numpy(), np.asarray(jg.poses0.t), atol=5e-5)
    np.testing.assert_allclose(tg.poses0.R.numpy(), np.asarray(jg.poses0.R), atol=2e-6)
    np.testing.assert_allclose(tg.odo_meas.t.numpy(), np.asarray(jg.odo_meas.t), atol=5e-5)


def test_direct_pose_graph_solve_matches_jax(graph_problem):
    jg, tg, cfg, P = graph_problem
    jposes, jinfo = jpg.solve_pose_graph(jg, cfg)
    poses, info = pose_graph.solve_pose_graph(tg, port_cfg(cfg))
    assert float(info.error) < 1e-2 * float(info.error0)
    np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    assert float(poses.t[0].sub(tg.poses0.t[0]).abs().max()) == 0.0  # the gauge pose never moves
    # the normal terms feed the same gradient
    _, _, r, Ji, Jj = pose_graph._build_normal_terms(tg.poses0, tg)
    g, _ = pose_graph._gradient_and_diag(pose_graph.factor_segments(tg, P), r, Ji, Jj)
    jt = jpg._build_normal_terms(jg.poses0, jg)
    jgrad, _ = jpg._gradient_and_diag(*jt, P, fixed0=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-3, atol=1e-3 * float(np.abs(jgrad).max()))


@pytest.mark.parametrize("cfg, n_lc", [
    (PoseGraphConfig(preconditioner="tridiag"), 4),
    (PoseGraphConfig(preconditioner="dense_seg"), 4),
    (PoseGraphConfig(), 1025),
])
def test_unported_solver_kinds_raise(cfg, n_lc):
    """Every kind of the JAX package resolves on one device, "chain" among
    them, and "auto" above the direct step's 1024 factors is dense_seg;
    what still raises: an unknown kind, and "chain" on the
    sequence-parallel path, which has no distributed form of it (the JAX
    package's resolvers hand it to their block-Jacobi branch: ROADMAP
    hazards)."""
    from diasss_tpu_torch.parallel import seq

    assert pose_graph.resolve_pg_solver_kind("auto", 100, 10) == "direct"
    expected = "dense_seg" if cfg.preconditioner == "auto" else cfg.preconditioner
    assert pose_graph.resolve_pg_solver_kind(cfg.preconditioner, 3000, n_lc) == expected
    assert pose_graph.resolve_pg_solver_kind("chain", 3000, n_lc) == "chain"
    with pytest.raises(ValueError, match="unknown"):
        pose_graph.resolve_pg_solver_kind("cholmod", 3000, n_lc)
    assert seq.resolve_seq_pg_solver_kind(cfg.preconditioner, 750, n_lc) == expected
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        seq.resolve_seq_pg_solver_kind("chain", 750, n_lc)
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        seq.resolve_seq_ba_solver_kind("chain", 750, 4, 64)


def test_damping_sweep_is_not_ported(graph_problem):
    """The damping sweep is not ported to the sequence-parallel direct step,
    as in the JAX package: there ``lam_sweep_factors`` is not read and the
    solve runs the single-damping schedule (on a one-rank mesh, the same
    result bit for bit), while the one-device direct step sweeps (its parity
    with the JAX package: ``tests/test_torch_optin.py``)."""
    from diasss_tpu_torch.parallel import seq
    from diasss_tpu_torch.parallel.collectives import Mesh

    _, tg, cfg, _ = graph_problem
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"), transport="gloo", ranks=(0,))
    sweep = dataclasses.replace(port_cfg(cfg), lam_sweep_factors=(0.1, 1.0, 10.0))
    p1, i1 = seq.seq_pose_graph_solve(mesh, tg, port_cfg(cfg))
    pk, ik = seq.seq_pose_graph_solve(mesh, tg, sweep)
    assert ik.iterations == i1.iterations and float(ik.lam) == float(i1.lam)
    assert torch.equal(pk.t, p1.t) and torch.equal(pk.R, p1.R)
    _, one = pose_graph.solve_pose_graph(tg, sweep)
    assert one.solver_kind == "direct" and float(one.error) < 1e-2 * float(one.error0)


def test_direct_step_holds_a_12k_chain_at_low_damping():
    """The direct step on an odometry-only chain of 12,000 poses (the DR of
    the 20-line, 600-ping survey with the pipeline's initial noise) at the
    damping floor: its relative residual against the same system in float64
    stays at 1e-5, and it agrees with a float64 banded solve to 1e-4 of the
    solution's scale.  The chain's condition grows like P^2: a float32 cyclic
    reduction leaves a residual of 1e-7 there, but its solution is 30% of
    the scale away from the float64 one."""
    import scipy.linalg

    from diasss_tpu_torch.synthetic import make_survey

    survey = make_survey(n_lines=20, n_pings=600, n_bins=64, n_landmarks=0)
    rows = [l.dr_poses.astype(np.float32) for l in survey.lines]
    cfg = port_cfg(PoseGraphConfig())
    graph = pose_graph.build_chain_graph(rows, [0], [1], se3.identity((1,), torch.float32, "cpu"),
                                         np.ones((1, 6), np.float32), np.zeros(1, bool), cfg,
                                         rng=JaxRng(noise_seed=cfg.seed), device="cpu")
    P = int(graph.poses0.t.shape[0])
    assert P == 12000
    _, _, r, Ji, Jj = pose_graph._build_normal_terms(graph.poses0, graph)
    g, D = pose_graph._gradient_and_diag(pose_graph.factor_segments(graph, P), r, Ji, Jj)
    lam = torch.tensor(1e-9)
    delta = pose_graph._direct_lm_step(graph, Ji, Jj, g, D, lam, P, 1)
    assert delta.dtype == torch.float32 and float(delta[0].abs().max()) == 0.0

    # the damped system in float64: diagonal blocks, couplings (i, i+1), gauge decoupled
    U, D_odo = pose_graph._odometry_chain(Ji.double(), Jj.double(), P)
    T = (D_odo + 1e-9 * D.double() + 1e-6 * torch.eye(6, dtype=torch.float64)).numpy()
    U = U.numpy()
    b = -g.double().numpy()
    x = delta.double().numpy()
    Tx = np.einsum("pij,pj->pi", T, x)
    Tx[:-1] += np.einsum("pij,pj->pi", U, x[1:])
    Tx[1:] += np.einsum("pji,pj->pi", U, x[:-1])
    rel = np.linalg.norm((Tx - b)[1:]) / np.linalg.norm(b)
    assert rel <= 1e-5, rel

    # float64 banded solve (half bandwidth 11) of the same system
    n = 6 * P
    ab = np.zeros((23, n))
    p, a, c = np.meshgrid(np.arange(P), np.arange(6), np.arange(6), indexing="ij")
    ab[11 + a - c, 6 * p + c] = T[p, a, c]
    p, a, c = p[:-1], a[:-1], c[:-1]
    ab[11 + a - c - 6, 6 * p + 6 + c] = U[p, a, c]  # row 6p+a, column 6p+6+c
    ab[11 + c - a + 6, 6 * p + a] = U[p, a, c]  # row 6p+6+c, column 6p+a
    x64 = scipy.linalg.solve_banded((11, 11), ab, b.reshape(-1)).reshape(P, 6)
    assert np.abs(x - x64).max() <= 1e-4 * np.abs(x64).max()
