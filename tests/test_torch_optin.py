"""Parity of the port's opt-in solver and detector options with the JAX
package: the coarse-to-fine initialization (``coarse_init_stride``), the
exact ``"chain"`` preconditioner (``tridiag.chain_factor`` /
``chain_solve``) in the pose graph and full BA, the damping sweep of the
direct step (``lam_sweep_factors``) and the stacked detector layout
(``detect_features(stacked=True)``).  The graphs are built by the JAX
package as its own tests build them (``tests/test_pose_graph.py``; the
drifted one with its dead reckoning drifted from the ground truth) and
carried over by ``convert.to_torch``.

Tolerances and why:

* coarse-to-fine initialization with stride 4: the same adopt decision, the
  initial error within 1e-5 relative (the coarse solve is the direct LM on a
  30-pose graph, float32 iterates either side), the same LM trial count and
  poses within 2e-3 m (the JAX package's own bound between the coarse and
  the plain run);
* ``chain_solve``: 1e-5 relative to the solution's largest entry, against
  the JAX package's and against the port's cyclic reduction (float64
  chains: the segment inverses and the boundary system are exact solves,
  so only the arithmetic order differs);
* the pose graph with ``"chain"``: poses within 1e-3 m of the JAX package's
  ``"chain"`` run and no more CG iterations than ``"dense_seg"`` (the JAX
  package's own assertion; the graph's loop closures agree with its
  odometry, so the final cost is float rounding and is not compared);
* full BA with ``"chain"``: poses within 1e-3 m, final error 1e-3
  relative, trial count within one, as the other full-BA PCG kinds
  (``tests/test_torch_pcg.py``);
* the damping sweep: poses within 1e-3 m and final error 1e-3 relative of
  the JAX package's sweep, the trial count within one (the port's cost is
  float64, the JAX package's float32, so the stall exit can read the last
  trials differently: ROADMAP C17); each candidate of the K-wide step equals
  the single-damping step at its damping to 1e-5 relative;
* the stacked detector: valid keypoints (position, response, size, level)
  bit-identical to the JAX package's stacked layout on the same pyramid and
  to the port's per-level layout; angles bit-identical to the per-level
  layout and within 1e-3 rad of the JAX package's (each moment is a float32
  sum of 961 terms that nearly cancel for some keypoints, summed in another
  order: measured up to 4.1e-4 rad on this image, which also moves the
  descriptors, so those are held to the per-level layout only); descriptors
  within 1e-3 of the per-level layout (the batched SIFT contraction sums in
  another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pose_graph import _no_lc, make_chain
from torch_parity_helpers import jax_and_port_frames, port_cfg
from diasss_tpu.config import DetectorConfig, PipelineConfig, PoseGraphConfig
from diasss_tpu.features import detector as jdet
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.pipeline import _assemble_pairs as jax_assemble_pairs
from diasss_tpu.pipeline import _overlap_pairs as jax_overlap_pairs
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu.solvers import tridiag as jtri
from diasss_tpu.solvers.pose_graph import build_chain_graph
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.features import detector
from diasss_tpu_torch.solvers import full_ba, pose_graph, tridiag


def _T(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


# ---------------------------------------------------------------------------
# coarse-to-fine initialization (ROADMAP C18)


def _drifted_graph(n=120, n_lc=13, seed=5):
    """The JAX package's drifted loop-closure graph (``_drifted_lc_graph``
    of ``tests/test_pose_graph.py``), with its dead reckoning drifted away
    from the ground truth the loop closures measure (a random walk in
    y and yaw), so the optimum keeps a real residual: the LM's stall exit
    then reads a cost well above float rounding, and the trial counts of
    the two packages are comparable."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 6))
    gt[:, 3] = np.arange(n) * 0.5
    gt[:, 4] = 0.05 * rng.normal(size=n)
    dr = gt.copy()
    dr[:, 4] += np.cumsum(0.02 * rng.normal(size=n))
    dr[:, 2] += np.cumsum(0.002 * rng.normal(size=n))
    poses_gt = jse3.from_rodrigues_xyz(jnp.asarray(gt, jnp.float32))
    lc_i = np.arange(2, n - 40, max((n - 42) // n_lc, 1), dtype=np.int32)[:n_lc]
    lc_j = (lc_i + 30).astype(np.int32)
    meas = jse3.between(poses_gt[jnp.asarray(lc_i)], poses_gt[jnp.asarray(lc_j)])
    return build_chain_graph([dr], lc_i=lc_i, lc_j=lc_j, lc_meas=meas,
                             lc_sigmas=np.full((len(lc_i), 6), 0.05, np.float32),
                             lc_valid=np.ones(len(lc_i), bool), noise_key=jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def drifted():
    jg = _drifted_graph()
    return jg, to_torch(jg, device="cpu")


def _jax_coarse_init(jg, cfg, stride):
    """The JAX package's coarse candidate and adopt decision, from the same
    private steps its ``solve_pose_graph`` takes."""
    cgraph, chain = jpg._coarse_graph_and_chain(jg, stride)
    cposes, _ = jpg.solve_pose_graph(cgraph, dataclasses.replace(cfg, coarse_init_stride=0),
                                     allow_coarse_init=False)
    cand = jpg._prolongate(cposes, chain, stride)
    cand = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a[:1], b[1:]]), jg.poses0, cand)
    err0, err_cand = float(jpg.graph_error(jg.poses0, jg)), float(jpg.graph_error(cand, jg))
    adopted = bool(np.isfinite(err_cand) and err_cand < err0)
    return adopted, (err_cand if adopted else err0)


def test_coarse_init_matches_jax(drifted):
    jg, tg = drifted
    cfg = PoseGraphConfig(preconditioner="direct", coarse_init_stride=4)
    adopted, err_init = _jax_coarse_init(jg, cfg, 4)
    jposes, jinfo = jpg.solve_pose_graph(jg, cfg)
    _, jplain = jpg.solve_pose_graph(jg, dataclasses.replace(cfg, coarse_init_stride=0))
    poses, info = pose_graph.solve_pose_graph(tg, port_cfg(cfg))
    assert adopted and int(jinfo.iterations) != int(jplain.iterations)  # the stride changes the run
    assert info.iterations == int(jinfo.iterations)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=2e-3)
    assert (float(info.error_init) < float(info.error0)) == adopted
    np.testing.assert_allclose(float(info.error_init), err_init, rtol=1e-5)
    np.testing.assert_allclose(float(info.error0), float(jinfo.error0), rtol=1e-5)
    assert torch.equal(poses.t[0], tg.poses0.t[0]) and torch.equal(poses.R[0], tg.poses0.R[0])


def test_coarse_graph_and_prolongation_match_jax(drifted):
    jg, tg = drifted
    jc, jchain = jpg._coarse_graph_and_chain(jg, 4)
    tc, tchain = pose_graph._coarse_graph_and_chain(tg, 4)
    np.testing.assert_allclose(tchain.t.numpy(), np.asarray(jchain.t), atol=1e-4)
    for f in ("lc_i", "lc_j", "lc_valid"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_allclose(tc.odo_sigmas.numpy(), np.asarray(jc.odo_sigmas), rtol=1e-6)
    for f in ("poses0", "odo_meas", "lc_meas"):
        np.testing.assert_allclose(getattr(tc, f).t.numpy(), np.asarray(getattr(jc, f).t), atol=1e-4, err_msg=f)
        np.testing.assert_allclose(getattr(tc, f).R.numpy(), np.asarray(getattr(jc, f).R), atol=1e-5, err_msg=f)
    fine = pose_graph._prolongate(tc.poses0, tchain, 4)
    np.testing.assert_allclose(fine.t.numpy(), np.asarray(jpg._prolongate(jc.poses0, jchain, 4).t), atol=1e-4)


@pytest.mark.parametrize("why, kwargs", [
    ("resumed damping", dict(lam0=1e-4)),
    ("resumed stall counter", dict(stall0=0)),
    ("warm-started caller", dict(allow_coarse_init=False)),
])
def test_coarse_init_gate_skips(drifted, why, kwargs):
    """The gate of the JAX package: a resumed or warm-started solve starts
    from ``poses0`` (the error it starts from is ``error0``)."""
    _, tg = drifted
    _, info = pose_graph.solve_pose_graph(tg, port_cfg(PoseGraphConfig(coarse_init_stride=4)), **kwargs)
    assert float(info.error_init) == float(info.error0), why


# ---------------------------------------------------------------------------
# the exact chain factorization


@pytest.mark.parametrize("P, segment, R", [(100, 16, 0), (100, 16, 5), (64, 64, 3), (37, 8, 0)])
def test_chain_solve_matches_jax_and_cyclic_reduction(P, segment, R):
    rng = np.random.default_rng(P + R)
    A = rng.normal(size=(P, 6, 6))
    D = A @ A.transpose(0, 2, 1) + 6.0 * np.eye(6)
    U = rng.normal(size=(P - 1, 6, 6)) * 0.5
    b = rng.normal(size=(P, 6) if R == 0 else (P, 6, R))
    fac = tridiag.chain_factor(_T(D), _T(U), segment)
    x = tridiag.chain_solve(fac, _T(b)).numpy()
    assert x.shape == b.shape
    cr = tridiag.solve_block_tridiag_multi(_T(D), _T(U), _T(b if R else b[..., None]))
    assert _rel(x, cr.numpy() if R else cr[..., 0].numpy()) < 1e-5
    with jax.enable_x64(True):
        jx = jtri.chain_solve(jtri.chain_factor(jnp.asarray(D), jnp.asarray(U), segment), jnp.asarray(b))
        assert _rel(x, jx) < 1e-5


@pytest.fixture(scope="module")
def lc_graph_120():
    """The 120-pose loop-closure graph of the JAX package's dense_seg /
    chain test (tests/test_pose_graph.py)."""
    rng = np.random.default_rng(5)
    n = 120
    rows = np.zeros((n, 6))
    rows[:, 3] = np.arange(n) * 0.5
    rows[:, 4] = 0.05 * rng.normal(size=n)
    gt = jse3.from_rodrigues_xyz(jnp.asarray(rows, jnp.float32))
    lc_i = np.arange(2, n - 40, 9, dtype=np.int32)
    lc_j = (lc_i + 30).astype(np.int32)
    meas = jse3.between(gt[jnp.asarray(lc_i)], gt[jnp.asarray(lc_j)])
    jg = build_chain_graph([rows], lc_i=lc_i, lc_j=lc_j, lc_meas=meas,
                           lc_sigmas=np.full((len(lc_i), 6), 0.05, np.float32),
                           lc_valid=np.ones(len(lc_i), bool), noise_key=jax.random.PRNGKey(1))
    return jg, to_torch(jg, device="cpu")


def test_chain_preconditioner_pose_graph_matches_jax(lc_graph_120):
    jg, tg = lc_graph_120
    cfg = PoseGraphConfig(max_gn_iters=10, preconditioner="chain", tridiag_segment=32)
    jposes, jinfo = jpg.solve_pose_graph(jg, cfg)
    poses, info = pose_graph.solve_pose_graph(tg, port_cfg(cfg))
    _, dense = pose_graph.solve_pose_graph(tg, port_cfg(dataclasses.replace(cfg, preconditioner="dense_seg")))
    assert info.solver_kind == "chain" and info.cg_iters_total > 0
    assert info.cg_iters_total <= dense.cg_iters_total, (info.cg_iters_total, dense.cg_iters_total)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)


def test_chain_preconditioner_full_ba_matches_jax():
    """``tests/test_torch_full_ba.py``'s problem (three lines and a tie
    line) with ``"chain"``; segments of 64 keep the dense inverses small on
    the CPU (the rule is ``cfg.tridiag_segment`` at any value)."""
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    survey = make_survey(n_lines=3, n_pings=200, n_bins=256, n_landmarks=120, n_tie_lines=1, seed=3)
    jf, tf = jax_and_port_frames(survey)
    pair_ids = jax_overlap_pairs(jf, cfg.min_overlap)
    kps, _ = jax_assemble_pairs(jf, None, pair_ids, cfg, True)
    jprob = jfba.build_ba_problem(jf, kps, pair_ids, cfg.full_ba, cfg.pose_graph,
                                  jax.random.PRNGKey(cfg.pose_graph.seed))
    ba_cfg = dataclasses.replace(cfg.full_ba, preconditioner="chain", tridiag_segment=64)
    jposes, _, jinfo = jfba.solve_full_ba(jprob, ba_cfg, cfg.kp_noise)
    poses, lms, info = full_ba.solve_full_ba(to_torch(jprob, device="cpu"), port_cfg(ba_cfg),
                                             port_cfg(cfg.kp_noise))
    assert info.solver_kind == "chain" and info.cg_iters_total > info.iterations
    assert float(info.error) < 0.5 * float(info.error0)
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    assert torch.isfinite(lms).all()


# ---------------------------------------------------------------------------
# the damping sweep


def _chain_only_graph():
    g = build_chain_graph([make_chain()], **_no_lc(), noise_key=jax.random.PRNGKey(1))
    return g._replace(lc_i=jnp.zeros((0,), jnp.int32), lc_j=jnp.zeros((0,), jnp.int32),
                      lc_meas=jse3.identity((0,), jnp.float32), lc_sigmas=jnp.ones((0, 6), jnp.float32),
                      lc_valid=jnp.zeros((0,), bool))


@pytest.mark.parametrize("graph, factors", [("drifted", (0.01, 0.1, 1.0, 10.0)),
                                            ("chain_only", (0.1, 1.0, 10.0))])
def test_damping_sweep_matches_jax(drifted, graph, factors):
    """The JAX package's two sweep setups: loop closures (on the drifted
    graph) and the ``L = 0`` branch (its chain-only graph, whose optimum is
    the dead reckoning at zero cost: there the stall exit reads float
    rounding, so the trial counts and final errors are not compared)."""
    jg = drifted[0] if graph == "drifted" else _chain_only_graph()
    cfg = PoseGraphConfig(preconditioner="direct", lam_sweep_factors=factors)
    jposes, jinfo = jpg.solve_pose_graph(jg, cfg)
    poses, info = pose_graph.solve_pose_graph(to_torch(jg, device="cpu"), port_cfg(cfg))
    assert info.solver_kind == "direct" and info.cg_iters_total == 0
    assert float(info.error) < 1e-3 * float(info.error0)
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=1e-3)
    if graph == "drifted":
        assert abs(info.iterations - int(jinfo.iterations)) <= 1
        np.testing.assert_allclose(float(info.error), float(jinfo.error), rtol=1e-3)


def test_sweep_step_is_the_single_step_per_candidate(drifted):
    """Each candidate of the K-wide step is the single-damping step at its
    damping, also when the candidates are solved in groups."""
    _, tg = drifted
    P, L = tg.poses0.t.shape[0], tg.lc_i.shape[0]
    _, _, r, Ji, Jj = pose_graph._build_normal_terms(tg.poses0, tg)
    g, D = pose_graph._gradient_and_diag(pose_graph.factor_segments(tg, P), r.double(), Ji.double(), Jj.double())
    lams = torch.tensor([1e-3, 1e-1, 10.0], dtype=torch.float64)
    multi = pose_graph._direct_lm_step_multi(tg, Ji, Jj, g, D, lams, P, L)
    for k, lam in enumerate(lams):
        single = pose_graph._direct_lm_step(tg, Ji, Jj, g, D, lam, P, L)
        torch.testing.assert_close(multi[k], single, rtol=1e-5, atol=1e-7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pose_graph, "SWEEP_BYTES", 1.0)  # one candidate per group
        torch.testing.assert_close(pose_graph._direct_lm_step_multi(tg, Ji, Jj, g, D, lams, P, L), multi,
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the stacked detector


@pytest.fixture(scope="module")
def stacked_detections():
    """``tests/test_features.py``'s 401x250 image (odd sizes: the pyramid's
    rounding paths) through both packages' stacked layout and the port's
    per-level one.  The port's stacked run against the JAX package's reads
    the JAX package's pyramid: the two resize implementations differ in the
    last bits (``tests/test_torch_features.py``), which moves FAST
    responses by an ulp on the upper levels."""
    from diasss_tpu.features import pyramid as jpyr

    rng = np.random.default_rng(3)
    img = rng.rayleigh(20.0, (401, 250))
    for (y, x) in [(200, 120), (120, 180), (300, 60), (60, 130), (350, 200)]:
        ys, xs = np.mgrid[y - 3:y + 4, x - 3:x + 4]
        img[y - 3:y + 4, x - 3:x + 4] += 150 * np.exp(-((ys - y) ** 2 + (xs - x) ** 2) / 4.0)
    norm = np.clip(img / img.max() * 255, 0, 255).astype(np.float32)
    cfg = DetectorConfig(n_features=400)
    j = jdet.detect_features(jnp.asarray(norm), None, cfg, stacked=True)
    out = {"jax": {f: np.asarray(getattr(j, f)) for f in j._fields}}

    def jax_pyramid(img, n_levels, scale_factor):
        return [_T(lvl) for lvl in jpyr.build_pyramid(jnp.asarray(img.numpy()), n_levels, scale_factor)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detector, "build_pyramid", jax_pyramid)
        t = detector.detect_features(_T(norm), None, port_cfg(cfg), stacked=True)
        out["stacked_jax_pyramid"] = {f: getattr(t, f).numpy() for f in t._fields}
    for name, stacked in (("stacked", True), ("per_level", False)):
        t = detector.detect_features(_T(norm), None, port_cfg(cfg), stacked=stacked)
        out[name] = {f: getattr(t, f).numpy() for f in t._fields}
    return out


def test_stacked_detector_matches_jax_stacked(stacked_detections):
    j, t = stacked_detections["jax"], stacked_detections["stacked_jax_pyramid"]
    np.testing.assert_array_equal(t["valid"], j["valid"])
    v = j["valid"]
    assert v.sum() > 100 and len(np.unique(j["level"][v])) > 3
    for f in ("xy", "response", "size", "level"):
        np.testing.assert_array_equal(t[f][v], j[f][v], err_msg=f)
    np.testing.assert_allclose(t["angle"][v], j["angle"][v], atol=1e-3)


def test_stacked_detector_matches_per_level(stacked_detections):
    s, p = stacked_detections["stacked"], stacked_detections["per_level"]
    np.testing.assert_array_equal(s["valid"], p["valid"])
    v = p["valid"]
    for f in ("xy", "response", "angle", "size", "level"):
        np.testing.assert_array_equal(s[f][v], p[f][v], err_msg=f)
    np.testing.assert_allclose(s["desc"][v], p["desc"][v], rtol=0, atol=1e-3)
