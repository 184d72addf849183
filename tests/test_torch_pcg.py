"""Parity of the port's PCG family with the JAX package's: the segment
preconditioners of ``tridiag``, the chunked conjugate-gradient loop
(``pose_graph._pcg``), the pose-graph and full-BA solves with the
``jacobi`` / ``tridiag`` / ``dense_seg`` preconditioners, and the
``"auto"`` rules on both sides of both guards.

Tolerances and why: the segment solves and inverses are float32 6x6 (or
6*segment-wide) algebra, held at 1e-4 relative to their largest entry.  CG
on a fixed well-conditioned system takes the same number of iterations on
both sides and lands within 1e-4 relative; the chunked loop's masked
iterations leave x and the count bit-identical for every chunk size.  The
solves are held to 1e-3 m in pose, as the direct solves are
(``tests/test_torch_solvers.py``): the LM iterates differ in float32
rounding, and PCG stops at ``cg_tol`` 1e-6.  Segments of 64 keep the dense
inverses small on the CPU; the rule is the same at 256.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu.config import PipelineConfig, PoseGraphConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.pipeline import _assemble_pairs as jax_assemble_pairs
from diasss_tpu.pipeline import _overlap_pairs as jax_overlap_pairs
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu.solvers import tridiag as jtri
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.solvers import full_ba, pose_graph, tridiag


def _T(a):
    return torch.as_tensor(np.array(a))


def _chain(P, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, 6, 6))
    D = (A @ A.transpose(0, 2, 1) + 6.0 * np.eye(6)).astype(np.float32)
    U = (rng.normal(size=(P - 1, 6, 6)) * 0.5).astype(np.float32)
    b = rng.normal(size=(P, 6)).astype(np.float32)
    return D, U, b


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("P, segment", [(100, 16)])
def test_segment_preconditioners_match_jax(P, segment):
    D, U, b = _chain(P, P)
    jD, jU, jb = jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)
    seg = tridiag.solve_block_tridiag_segmented(_T(D), _T(U), _T(b), segment)
    assert _rel(seg.numpy(), jtri.solve_block_tridiag_segmented(jD, jU, jb, segment)) < 1e-4
    Minv = tridiag.dense_segment_inverses(_T(D), _T(U), segment)
    jMinv = jtri.dense_segment_inverses(jD, jU, segment)
    assert Minv.shape == jMinv.shape == (-(-P // segment), 6 * segment, 6 * segment)
    assert _rel(Minv.numpy(), jMinv) < 1e-4
    applied = tridiag.apply_dense_segment_inverses(Minv, _T(b))
    assert _rel(applied.numpy(), jtri.apply_dense_segment_inverses(jMinv, jb)) < 1e-4
    assert _rel(applied.numpy(), seg.numpy()) < 1e-4  # one preconditioner, two applications


def test_auto_dense_segment_identical():
    for P in (1, 10, 300, 4200, 12000, 100_000, 1_000_000):
        for requested in (1, 8, 16, 64, 100, 256, 1024):
            assert tridiag.auto_dense_segment(P, requested) == jtri.auto_dense_segment(P, requested), (P, requested)


@pytest.fixture(scope="module")
def spd_system():
    rng = np.random.default_rng(5)
    P = 40
    n = 6 * P
    M = rng.normal(size=(n, n))
    A = (M @ M.T / n + 0.05 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(P, 6)).astype(np.float32)
    blocks = np.stack([A[6 * p:6 * p + 6, 6 * p:6 * p + 6] for p in range(P)])
    return A, b, np.linalg.inv(blocks).astype(np.float32)


def _pcg_both(spd_system, tol, max_iters, chunk):
    A, b, Binv = spd_system
    jA, jBinv = jnp.asarray(A), jnp.asarray(Binv)
    jx, jk = jpg._pcg(lambda v: (jA @ v.reshape(-1)).reshape(-1, 6), jnp.asarray(b),
                      lambda v: jnp.einsum("pab,pb->pa", jBinv, v), tol, max_iters)
    tA, tBinv = _T(A), _T(Binv)
    x, k = pose_graph._pcg(lambda v: (tA @ v.reshape(-1)).reshape(-1, 6), _T(b),
                           lambda v: (tBinv @ v[..., None])[..., 0], tol, max_iters, chunk=chunk)
    return np.asarray(jx), int(jk), x.numpy(), k


@pytest.mark.parametrize("tol, max_iters", [(1e-5, 250), (1e-12, 9)])
def test_pcg_matches_jax_for_every_chunk(spd_system, tol, max_iters):
    runs = [_pcg_both(spd_system, tol, max_iters, chunk) for chunk in (1, 3, 16, 1000)]
    jx, jk = runs[0][:2]
    assert 5 < jk <= max_iters and (jk == max_iters) == (tol < 1e-9)
    for _, _, x, k in runs:
        assert k == jk
        assert _rel(x, jx) < 1e-4
        np.testing.assert_array_equal(x, runs[0][2])  # masked iterations change nothing


@pytest.fixture(scope="module")
def graph_problem():
    """A 3-line DR chain with four loop closures from ground truth (one
    invalid slot), as ``tests/test_torch_solvers.py`` builds it."""
    survey = small_survey(n_pings=100)
    rows = [l.dr_poses.astype(np.float32) for l in survey.lines]
    rng = np.random.default_rng(1)
    lc_i = np.array([20, 45, 80, 130], np.int32)
    lc_j = np.array([180, 150, 260, 230], np.int32)
    gt = np.concatenate([l.gt_poses for l in survey.lines]).astype(np.float32)
    meas = jse3.between(jse3.from_rodrigues_xyz(jnp.asarray(gt[lc_i])), jse3.from_rodrigues_xyz(jnp.asarray(gt[lc_j])))
    sig = (np.abs(rng.normal(size=(4, 6))) * 0.01 + 0.01).astype(np.float32)
    valid = np.array([True, True, True, False])
    cfg = PoseGraphConfig()
    jg = jpg.build_chain_graph(rows, lc_i, lc_j, meas, sig, valid, cfg, noise_key=jax.random.PRNGKey(cfg.seed))
    tg = pose_graph.build_chain_graph(rows, lc_i, lc_j, se3.Pose3(_T(meas.R), _T(meas.t)), sig, valid, port_cfg(cfg),
                                      rng=JaxRng(noise_seed=cfg.seed), device="cpu")
    return jg, tg


@pytest.mark.parametrize("kind", ["jacobi", "tridiag", "dense_seg"])
def test_pcg_pose_graph_matches_jax(graph_problem, kind):
    jg, tg = graph_problem
    cfg = PoseGraphConfig(preconditioner=kind, tridiag_segment=64)
    jposes, jinfo = jpg.solve_pose_graph(jg, cfg)
    poses, info = pose_graph.solve_pose_graph(tg, port_cfg(cfg))
    assert info.solver_kind == kind and info.cg_iters_total > info.iterations
    assert float(info.error) < 1e-2 * float(info.error0)
    np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    assert float(poses.t[0].sub(tg.poses0.t[0]).abs().max()) == 0.0


@pytest.fixture(scope="module")
def ba_problems():
    survey = make_survey(n_lines=3, n_pings=120, n_bins=256, n_landmarks=80, n_tie_lines=1, seed=3)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    jf, tf = jax_and_port_frames(survey)
    pair_ids = jax_overlap_pairs(jf, cfg.min_overlap)
    kps, _ = jax_assemble_pairs(jf, None, pair_ids, cfg, True)
    jprob = jfba.build_ba_problem(jf, kps, pair_ids, cfg.full_ba, cfg.pose_graph, jax.random.PRNGKey(0))
    tprob = full_ba.build_ba_problem(tf, kps, pair_ids, port_cfg(cfg.full_ba), port_cfg(cfg.pose_graph),
                                     rng=JaxRng(noise_seed=0))
    return cfg, jprob, tprob


@pytest.mark.parametrize("kind", ["tridiag", "dense_seg"])
def test_pcg_full_ba_matches_jax(ba_problems, kind):
    cfg, jprob, tprob = ba_problems
    ba_cfg = dataclasses.replace(cfg.full_ba, preconditioner=kind, tridiag_segment=64)
    jposes, _, jinfo = jfba.solve_full_ba(jprob, ba_cfg, cfg.kp_noise)
    poses, lms, info = full_ba.solve_full_ba(tprob, port_cfg(ba_cfg), port_cfg(cfg.kp_noise))
    assert info.solver_kind == kind and info.cg_iters_total > info.iterations
    assert float(info.error) < 0.5 * float(info.error0)
    np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    assert torch.isfinite(lms).all()


@pytest.mark.parametrize("P, L_lc, kind", [
    (3000, 1024, "direct"),  # at the factor limit
    (3000, 1025, "dense_seg"),  # one factor over it
    (8000, 1000, "direct"),  # buffers 8000*6*6001*4*3 = 3.5e9 B, under 4e9
    (12000, 1000, "dense_seg"),  # 5.2e9 B: the buffer guard alone decides
])
def test_resolve_pg_solver_kind_guards(P, L_lc, kind):
    assert pose_graph.resolve_pg_solver_kind("auto", P, L_lc) == kind
    for explicit in ("direct", "jacobi", "tridiag", "dense_seg", "chain"):
        assert pose_graph.resolve_pg_solver_kind(explicit, P, L_lc) == explicit
    with pytest.raises(ValueError):
        pose_graph.resolve_pg_solver_kind("cholmod", P, L_lc)


@pytest.mark.parametrize("P, K_pad, kind", [
    (4200, 2048, "direct"),
    (4200, 4096, "dense_seg"),  # over the K_pad limit
    (8000, 2048, "direct"),  # buffers 8000*6*6145*4*3 = 3.5e9 B, under 4e9
    (10000, 2048, "dense_seg"),  # 4.4e9 B: the buffer guard alone decides
])
def test_resolve_ba_solver_kind_guards(P, K_pad, kind):
    assert full_ba.resolve_ba_solver_kind("auto", P, K_pad) == kind
    with pytest.raises(ValueError):
        full_ba.resolve_ba_solver_kind("cholmod", P, K_pad)
