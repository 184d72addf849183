"""Parity of the port's exact pose marginals with the JAX package's:
selected inversion of the chain (``tridiag.block_tridiag_selected_inverse``),
``pose_graph.pg_pose_marginals``, ``full_ba.ba_pose_marginals`` and the
pipeline's ``pose_sigmas`` with their dump.

Tolerances and why: the selected inverse is held to a float64 dense inverse
and to JAX's two-scan recursion at 1e-4 of the largest entry (float32 6x6
algebra over log2(P) levels).  The marginals are held at 1e-3 of the
largest entry, as ``tests/test_pose_graph.py`` holds JAX's own to a dense
inverse.  The port computes them in float64 from float32 Jacobians, the JAX
package in float32, where the smallest sigmas of a block (yaw, z) come out
up to 5e-4 relative off a float64 dense inverse on the pipeline's survey;
so the pipeline's sigmas agree to 1e-3 relative (the two solves' poses
differ by under 1e-4 m there).
"""

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
from diasss_tpu.pipeline import run_slam as jax_run_slam
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu.solvers import tridiag as jtri
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.pipeline import run_slam
from diasss_tpu_torch.solvers import full_ba, pose_graph, tridiag


def _T(a):
    return torch.as_tensor(np.array(a))


def _dense_chain(P, seed):
    """A random SPD chain (float32 blocks) and its dense float64 matrix."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, 6, 6))
    D = (A @ A.transpose(0, 2, 1) + 6.0 * np.eye(6)).astype(np.float32)
    U = (rng.normal(size=(P - 1, 6, 6)) * 0.5).astype(np.float32)
    T = np.zeros((6 * P, 6 * P))
    for i in range(P):
        T[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
    for i in range(P - 1):
        T[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
        T[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    return D, U, T


@pytest.mark.parametrize("P", [1, 2, 3, 7, 64, 129])
def test_selected_inverse_matches_dense_and_jax(P):
    D, U, T = _dense_chain(P, P)
    Tinv = np.linalg.inv(T)
    dense = np.stack([Tinv[6 * p:6 * p + 6, 6 * p:6 * p + 6] for p in range(P)])
    ours = tridiag.block_tridiag_selected_inverse(_T(D), _T(U)).numpy()
    ref = np.asarray(jtri.block_tridiag_selected_inverse(jnp.asarray(D), jnp.asarray(U)))
    scale = np.abs(dense).max()
    assert ours.shape == (P, 6, 6)
    assert np.abs(ours - dense).max() < 1e-4 * scale
    assert np.abs(ours - ref).max() < 1e-4 * scale


@pytest.fixture(scope="module")
def pg60():
    """The 60-pose graph of ``tests/test_pose_graph.py``'s marginal test,
    solved by the JAX package, carried over to the port."""
    rng = np.random.default_rng(9)
    n = 60
    rows = np.zeros((n, 6))
    rows[:, 3] = np.arange(n) * 0.5
    rows[:, 4] = 0.05 * rng.normal(size=n)
    gt = jse3.from_rodrigues_xyz(jnp.asarray(rows, jnp.float32))
    lc_i = np.arange(2, n - 25, 7, dtype=np.int32)
    lc_j = (lc_i + 20).astype(np.int32)
    meas = jse3.between(gt[jnp.asarray(lc_i)], gt[jnp.asarray(lc_j)])
    g = jpg.build_chain_graph([rows], lc_i=lc_i, lc_j=lc_j, lc_meas=meas,
                              lc_sigmas=np.full((len(lc_i), 6), 0.05, np.float32),
                              lc_valid=np.ones(len(lc_i), bool), noise_key=jax.random.PRNGKey(2))
    poses, _ = jpg.solve_pose_graph(g, PoseGraphConfig(max_gn_iters=15))
    return g, poses, to_torch(g, device="cpu"), to_torch(poses, device="cpu")


def _dense_pg_marginals(tg, tposes):
    """Pose blocks of the dense inverse of the gauge-fixed Gauss-Newton
    Hessian (float64) from the port's own Jacobians."""
    idx_i, idx_j, _, Ji, Jj = pose_graph._build_normal_terms(tposes, tg)
    Ji, Jj = Ji.double().numpy(), Jj.double().numpy()
    ii, jj = idx_i.numpy(), idx_j.numpy()
    P = tposes.t.shape[0]
    H = np.zeros((6 * P, 6 * P))
    for f in range(len(ii)):
        a = slice(6 * ii[f], 6 * ii[f] + 6)
        b = slice(6 * jj[f], 6 * jj[f] + 6)
        H[a, a] += Ji[f].T @ Ji[f]
        H[b, b] += Jj[f].T @ Jj[f]
        H[a, b] += Ji[f].T @ Jj[f]
        H[b, a] += Jj[f].T @ Ji[f]
    H[:6, :] = 0.0
    H[:, :6] = 0.0
    H[:6, :6] = np.eye(6)
    H += 1e-6 * np.eye(6 * P)
    Hinv = np.linalg.inv(H)
    ref = np.stack([Hinv[6 * p:6 * p + 6, 6 * p:6 * p + 6] for p in range(P)])
    ref[0] = 0.0
    return ref


def test_pg_pose_marginals_match_jax_and_dense(pg60):
    g, poses, tg, tposes = pg60
    ours = pose_graph.pg_pose_marginals(tg, tposes).numpy()
    ref = np.asarray(jpg.pg_pose_marginals(g, poses))
    dense = _dense_pg_marginals(tg, tposes)
    scale = np.abs(dense).max()
    assert ours.shape == (60, 6, 6) and np.all(ours[0] == 0.0)
    assert np.abs(ours - dense).max() < 1e-3 * scale
    assert np.abs(ours - ref).max() < 1e-3 * scale


def test_pg_pose_marginals_without_loop_closures_grow(pg60):
    _, _, tg, tposes = pg60
    cov = pose_graph.pg_pose_marginals(tg, tposes).numpy()
    cov_nolc = pose_graph.pg_pose_marginals(tg._replace(lc_valid=torch.zeros_like(tg.lc_valid)), tposes).numpy()
    assert np.trace(cov_nolc[-1]) > np.trace(cov[-1])


@pytest.fixture(scope="module")
def ba_solved():
    """A small tie survey's BA problem in both packages, solved by the port
    (direct step); marginals are taken at the port's solution on both
    sides."""
    survey = make_survey(n_lines=3, n_pings=120, n_bins=256, n_landmarks=80, n_tie_lines=1, seed=3)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    jf, tf = jax_and_port_frames(survey)
    pair_ids = jax_overlap_pairs(jf, cfg.min_overlap)
    kps, _ = jax_assemble_pairs(jf, None, pair_ids, cfg, True)
    jprob = jfba.build_ba_problem(jf, kps, pair_ids, cfg.full_ba, cfg.pose_graph, jax.random.PRNGKey(0))
    tprob = full_ba.build_ba_problem(tf, kps, pair_ids, port_cfg(cfg.full_ba), port_cfg(cfg.pose_graph),
                                     rng=JaxRng(noise_seed=0))
    poses, lms, _ = full_ba.solve_full_ba(tprob, port_cfg(cfg.full_ba), port_cfg(cfg.kp_noise))
    n_valid = int(tprob.kp_valid.sum())
    assert 8 <= n_valid < tprob.kp_i.shape[0]  # a padding tail for k_cols to trim
    return cfg, jprob, tprob, poses, lms, n_valid


@pytest.mark.parametrize("trim", [False, True])
def test_ba_pose_marginals_match_jax(ba_solved, trim):
    cfg, jprob, tprob, poses, lms, n_valid = ba_solved
    k_cols = n_valid if trim else None
    ours = full_ba.ba_pose_marginals(tprob, poses, lms, port_cfg(cfg.full_ba), port_cfg(cfg.kp_noise),
                                     k_cols=k_cols).numpy()
    jposes = jse3.Pose3(jnp.asarray(poses.R.numpy()), jnp.asarray(poses.t.numpy()))
    ref = np.asarray(jfba.ba_pose_marginals(jprob, jposes, jnp.asarray(lms.numpy()), cfg.full_ba, cfg.kp_noise,
                                            k_cols=k_cols))
    scale = np.abs(ref).max()
    assert np.all(ours[0] == 0.0) and np.all(np.diagonal(ours[1:], axis1=1, axis2=2) > 0)
    assert np.abs(ours - ref).max() < 1e-3 * scale
    if trim:  # the trimmed columns are exactly zero: the same covariance
        full = full_ba.ba_pose_marginals(tprob, poses, lms, port_cfg(cfg.full_ba), port_cfg(cfg.kp_noise)).numpy()
        assert np.abs(ours - full).max() < 1e-5 * scale


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    survey = small_survey()
    jf, tf = jax_and_port_frames(survey)
    gt = [l.gt_poses for l in survey.lines]
    cfg = PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="direct", marginals=True))
    out = tmp_path_factory.mktemp("marginals")
    ref = jax_run_slam(jf, cfg, gt_rows_list=gt, out_dir=str(out / "jax"), run_eval2=False)
    ours = run_slam(tf, port_cfg(cfg), gt_rows_list=gt, out_dir=str(out / "port"), run_eval2=False, rng=JaxRng())
    return out, ref, ours


def test_pipeline_pose_sigmas_match_jax(pipeline_runs):
    out, ref, ours = pipeline_runs
    assert ours.n_lc_accepted == ref.n_lc_accepted > 0
    assert ours.pose_sigmas.shape == ref.pose_sigmas.shape == (int(ours.poses.t.shape[0]), 6)
    assert np.all(ours.pose_sigmas[0] == 0.0) and np.all(ours.pose_sigmas[1:] > 0)
    np.testing.assert_allclose(ours.pose_sigmas, ref.pose_sigmas, rtol=1e-3, atol=0)
    assert "pose_marginals" in ours.timings


def test_pipeline_writes_the_sigma_dump(pipeline_runs):
    out, _, ours = pipeline_runs
    rows = np.loadtxt(out / "port" / "est_pose_sigmas_all.txt")
    ref_rows = np.loadtxt(out / "jax" / "est_pose_sigmas_all.txt")
    assert rows.shape == ref_rows.shape == ours.pose_sigmas.shape
    np.testing.assert_allclose(rows, ours.pose_sigmas, rtol=0, atol=1e-9)  # written at 9 decimals
    np.testing.assert_allclose(rows, ref_rows, rtol=1e-3, atol=1e-8)
