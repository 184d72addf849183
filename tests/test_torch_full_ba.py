"""Parity of the port's full bundle adjustment
(``diasss_tpu_torch/solvers/full_ba.py``) with the JAX package's direct path,
on the annotation correspondences of a small survey with a tie line.

The single direct step is held against the JAX package's
``_direct_ba_step``, which on the CPU solves the odometry chain by the Thomas
recursion where the port uses cyclic reduction, so it agrees to a relative
tolerance, not bit for bit.  The whole solve is held against the JAX
package's CPU default (``"auto"``: chain-preconditioned PCG to ``cg_tol``
1e-6), not against its direct path: XLA compiles that path slowly when
several test workers share the cores (measured 360 s against 4 s alone),
and the two JAX paths themselves differ by 4.9e-4 m in the poses on this
problem.  Tolerances: problem assembly identical (index rows, ranges, validity,
landmark initial values); initial poses the same noise draws through
``JaxRng``, composed in float32 on both sides: rotations 1e-5, translations
1e-4 m (a few float32 ulps at coordinates of hundreds of meters); factor
residuals and
Jacobians 1e-5 relative; one direct step 1e-3 relative to its largest entry;
the solve: poses within 1e-3 m, final error 1e-3 relative, iteration count
within one trial.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg
from diasss_tpu.config import PipelineConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.pipeline import _assemble_pairs as jax_assemble_pairs
from diasss_tpu.pipeline import _overlap_pairs as jax_overlap_pairs
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.solvers import full_ba

CFG = PipelineConfig(min_overlap=0.1, estimator="full_ba")


def _T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def problems():
    survey = make_survey(n_lines=3, n_pings=200, n_bins=256, n_landmarks=120, n_tie_lines=1, seed=3)
    jf, tf = jax_and_port_frames(survey)
    pair_ids = jax_overlap_pairs(jf, CFG.min_overlap)
    kps, _ = jax_assemble_pairs(jf, None, pair_ids, CFG, True)
    jprob = jfba.build_ba_problem(jf, kps, pair_ids, CFG.full_ba, CFG.pose_graph,
                                  jax.random.PRNGKey(CFG.pose_graph.seed))
    tprob = full_ba.build_ba_problem(tf, kps, pair_ids, port_cfg(CFG.full_ba), port_cfg(CFG.pose_graph),
                                     rng=JaxRng(noise_seed=CFG.pose_graph.seed))
    return jprob, tprob


def test_build_ba_problem_identical(problems):
    jprob, tprob = problems
    assert int(np.asarray(jprob.kp_valid).sum()) >= 20
    for f in ("kp_i", "kp_j", "kp_sr_s", "kp_sr_t", "kp_valid", "lm0", "lm_prior", "lm_prior_sigmas", "odo_sigmas"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(), np.asarray(getattr(jprob, f)), err_msg=f)
    np.testing.assert_allclose(tprob.poses0.t.numpy(), np.asarray(jprob.poses0.t), atol=1e-4)
    np.testing.assert_allclose(tprob.poses0.R.numpy(), np.asarray(jprob.poses0.R), atol=1e-5)
    np.testing.assert_allclose(tprob.odo_meas.t.numpy(), np.asarray(jprob.odo_meas.t), atol=1e-4)


def test_sss_factor_terms_match_jax():
    rng = np.random.default_rng(0)
    K = 64
    xi = rng.normal(0, 0.3, (K, 6)).astype(np.float32)
    xi[:, 3:] *= 30.0
    lm = (xi[:, 3:] + rng.normal(0, 8.0, (K, 3))).astype(np.float32)
    lm[:, 2] -= 15.0
    sr = np.linalg.norm(lm - xi[:, 3:], axis=1).astype(np.float32) * 1.01
    sig = np.stack([np.full(K, 0.1), sr * np.deg2rad(0.1)], 1).astype(np.float32)
    jpose = jse3.expmap(jnp.asarray(xi))
    r0, Jp0, Jl0 = jax.vmap(jfba._sss_factor_terms)(jpose, jnp.asarray(lm), jnp.asarray(sr), jnp.asarray(sig))
    tpose = se3.Pose3(_T(jpose.R), _T(jpose.t))
    r1, Jp1, Jl1 = full_ba._sss_factor_terms(tpose, _T(lm), _T(sr), _T(sig))
    assert Jp1.dtype == torch.float32
    for ours, ref in ((r1, r0), (Jp1, Jp0), (Jl1, Jl0)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_one_direct_step_matches_jax():
    rng = np.random.default_rng(1)
    P, K = 40, 16
    A = rng.normal(0, 1, (P, 6, 6))
    D_p = (A @ A.transpose(0, 2, 1) + 8 * np.eye(6)).astype(np.float32)
    U = (0.3 * rng.normal(0, 1, (P - 1, 6, 6))).astype(np.float32)
    M = rng.normal(0, 1, (K, 3, 3))
    L_ll = np.linalg.cholesky(M @ M.transpose(0, 2, 1) + 2 * np.eye(3)).astype(np.float32)
    Hs = (0.3 * rng.normal(0, 1, (K, 6, 3))).astype(np.float32)
    Ht = (0.3 * rng.normal(0, 1, (K, 6, 3))).astype(np.float32)
    g = rng.normal(0, 1, (P, 6)).astype(np.float32)
    g[0] = 0.0
    kp_i = rng.integers(0, P, K)
    kp_j = rng.integers(0, P, K)
    kp_i[0] = 0
    lam = np.float32(1e-3)
    ref = jfba._direct_ba_step(types.SimpleNamespace(kp_i=jnp.asarray(kp_i, jnp.int32), kp_j=jnp.asarray(kp_j, jnp.int32)),
                               *[jnp.asarray(a) for a in (g, U, D_p, L_ll, Hs, Ht, lam)], P, K)
    ours = full_ba._direct_ba_step(types.SimpleNamespace(kp_i=_T(kp_i), kp_j=_T(kp_j)),
                                   *[_T(a) for a in (g, U, D_p, L_ll, Hs, Ht, lam)], P, K)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-2 and np.all(ours[0].numpy() == 0)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
    trimmed = full_ba._direct_ba_step(types.SimpleNamespace(kp_i=_T(kp_i), kp_j=_T(kp_j)),
                                      *[_T(a) for a in (g, U, D_p, L_ll, Hs, Ht, lam)], P, K, k_cols=K)
    torch.testing.assert_close(trimmed, ours)


def test_solve_full_ba_matches_jax(problems):
    jprob, tprob = problems
    jposes, _, jinfo = jfba.solve_full_ba(jprob, CFG.full_ba, CFG.kp_noise)
    poses, lms, info = full_ba.solve_full_ba(tprob, port_cfg(CFG.full_ba), port_cfg(CFG.kp_noise))
    assert info.solver_kind == "direct"
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert float(info.error) < 0.5 * float(info.error0)
    np.testing.assert_allclose(float(info.error0), float(jinfo.error0), rtol=1e-5)
    np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    assert torch.isfinite(lms).all()


def test_auto_resolves_to_direct_and_raises_above_the_guard():
    assert full_ba.resolve_ba_solver_kind("auto", 4200, 2048) == "direct"
    assert full_ba.resolve_ba_solver_kind("direct", 600, 64) == "direct"
    for args in (("auto", 4200, 4096), ("auto", 60000, 2048), ("dense_seg", 600, 64), ("tridiag", 600, 64)):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            full_ba.resolve_ba_solver_kind(*args)
