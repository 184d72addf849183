"""Parity of the port's resumable solves (``lam0`` / ``stall0``) and
checkpoints (``diasss_tpu_torch/checkpoint.py``) with the JAX package's.

Tolerances, and why:

* a pose-graph solve started at a given damping and stall count, against
  the JAX package's on the same graph, both on the direct step: poses and
  the final damping 1e-4 (the LM decisions are the same; the chain solves
  sum in another order), trials and the stall count equal.  The port's
  accept test reads a float64 cost (ROADMAP C17), the JAX package's a
  float32 one, so each case runs only trials whose cost decreases float32
  resolves (above the float32 spacing of the cost), and asserts so;
* the default start run to its stall exit: trials, the stall count and
  poses as above.  Its last accepted decrease (8e-11) lies below the
  float32 spacing, so the JAX package rejects that trial (damping *10)
  where the port accepts it (*0.3): the port's damping is JAX's times
  0.03, to 1e-4;
* a full-BA solve started the same way, both on ``dense_seg`` PCG: poses
  1e-4 m, trials within one;
* chunked against one-shot in the port: the same trials and bit-identical
  poses on the CPU (the damping round-trips through float64 exactly, and
  the error at a chunk's start is the same function of the same iterate);
* snapshots written by one package and read by the other: arrays
  identical.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import port_cfg
from diasss_tpu import checkpoint as jckpt
from diasss_tpu.config import FullBAConfig, PipelineConfig, PoseGraphConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu.solvers import lc as jlc
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu_torch import checkpoint
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.solvers import full_ba, lc, pose_graph

PG_CFG = PoseGraphConfig(init_noise_xyz=0.0, init_noise_rpy_deg=0.0, preconditioner="direct")
BA_CFG = FullBAConfig(preconditioner="dense_seg", tridiag_segment=32, max_iters=12)


def _drifted_graph(P=80, seed=5):
    """The JAX package's checkpoint-test graph: a straight line with DR
    drift in y and three loop closures."""
    rng = np.random.default_rng(seed)
    tt = np.zeros((P, 6), np.float32)
    tt[:, 3] = np.arange(P) * 0.4
    dr = tt.copy()
    dr[:, 4] += np.cumsum(rng.normal(0, 0.05, P)).astype(np.float32)
    lc_i = np.asarray([5, 20, 33], np.int32)
    lc_j = np.asarray([50, 65, 75], np.int32)
    lc_rows = np.zeros((3, 6), np.float32)
    lc_rows[:, 3:6] = tt[lc_j, 3:6] - tt[lc_i, 3:6]
    return jpg.build_chain_graph([dr], lc_i=lc_i, lc_j=lc_j, lc_meas=jse3.from_rodrigues_xyz(jnp.asarray(lc_rows)),
                                 lc_sigmas=np.full((3, 6), 0.05, np.float32), lc_valid=np.ones(3, bool), cfg=PG_CFG,
                                 noise_key=None)


@pytest.fixture(scope="module")
def graphs():
    g = _drifted_graph()
    return g, to_torch(g, device="cpu")


@pytest.fixture(scope="module")
def ba_problems():
    from diasss_tpu.pipeline import _assemble_pairs, _overlap_pairs
    from torch_parity_helpers import jax_and_port_frames
    from diasss_tpu.synthetic import make_survey

    survey = make_survey(n_lines=2, n_pings=80, n_bins=256, n_landmarks=40, seed=9)
    jf, _ = jax_and_port_frames(survey)
    cfg = PipelineConfig()
    pair_ids = _overlap_pairs(jf, cfg.min_overlap)
    kps, _ = _assemble_pairs(jf, {}, pair_ids, cfg, True)
    prob = jfba.build_ba_problem(jf, kps, pair_ids, BA_CFG, cfg.pose_graph, None)
    return prob, to_torch(prob, device="cpu"), cfg.kp_noise


def _port_solve_with_costs(tg, cfg, lam0=None, stall0=None):
    """The port's solve and its accepted trials as ``(cost before, cost
    decrease)`` pairs, read from the cost it evaluates at the start and at
    every trial's candidate."""
    costs = []

    def error(poses, graph):
        costs.append(pose_graph.graph_error(poses, graph))
        return costs[-1]

    tp, ti = pose_graph.solve_pose_graph(tg, port_cfg(cfg), lam0=lam0, stall0=stall0,
                                         terms=pose_graph.FactorTerms(error=error))
    err, accepted = float(costs[0]), []
    for cand in map(float, costs[1:]):
        if cand < err:
            accepted.append((err, err - cand))
            err = cand
    return tp, ti, accepted


@pytest.mark.parametrize("lam0, stall0, trials", [pytest.param(None, None, 3, id="None-None"),
                                                  pytest.param(1e-2, 0, 6, id="0.01-0"),
                                                  pytest.param(3e-3, 1, 6, id="0.003-1")])
def test_pose_graph_resume_matches_jax(graphs, lam0, stall0, trials):
    jg, tg = graphs
    cfg = dataclasses.replace(PG_CFG, max_gn_iters=trials)
    jp, ji = jpg.solve_pose_graph(jg, cfg, lam0=lam0, stall0=stall0)
    tp, ti, accepted = _port_solve_with_costs(tg, cfg, lam0, stall0)
    assert accepted and all(d > np.spacing(np.float32(e)) for e, d in accepted), accepted
    assert ti.iterations == int(ji.iterations) and ti.stall == int(ji.stall)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-4)
    np.testing.assert_allclose(float(ti.lam), float(ji.lam), rtol=1e-4)


def test_pose_graph_stall_exit_matches_jax(graphs):
    jg, tg = graphs
    cfg = dataclasses.replace(PG_CFG, max_gn_iters=6)
    jp, ji = jpg.solve_pose_graph(jg, cfg)
    tp, ti, accepted = _port_solve_with_costs(tg, cfg)
    assert ti.iterations == int(ji.iterations) < cfg.max_gn_iters and ti.stall == int(ji.stall) == 2
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-4)
    err, dec = accepted[-1]
    assert dec < np.spacing(np.float32(err)), accepted
    np.testing.assert_allclose(float(ti.lam), float(ji.lam) * 0.3 / 10.0, rtol=1e-4)


@pytest.mark.parametrize("lam0, stall0", [(1e-2, 1)])
def test_full_ba_resume_matches_jax(ba_problems, lam0, stall0):
    jprob, tprob, kp = ba_problems
    jp, _, ji = jfba.solve_full_ba(jprob, BA_CFG, kp, lam0=lam0, stall0=stall0)
    tp, _, ti = full_ba.solve_full_ba(tprob, port_cfg(BA_CFG), port_cfg(kp), lam0=lam0, stall0=stall0)
    assert abs(ti.iterations - int(ji.iterations)) <= 1
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-4)


def test_pose_graph_chunked_equals_one_shot(graphs, tmp_path):
    _, tg = graphs
    cfg = port_cfg(PG_CFG)
    ref, ref_info = pose_graph.solve_pose_graph(tg, cfg)
    poses, info = checkpoint.solve_pose_graph_checkpointed(tg, cfg, str(tmp_path / "pg.npz"), chunk=3)
    np.testing.assert_array_equal(poses.t.numpy(), ref.t.numpy())
    assert float(info.error) == float(ref_info.error) and float(info.lam) == float(ref_info.lam)
    assert not os.path.exists(tmp_path / "pg.npz")


def test_full_ba_chunked_equals_one_shot(ba_problems, tmp_path):
    _, tprob, kp = ba_problems
    cfg, kp = port_cfg(BA_CFG), port_cfg(kp)
    ref, ref_lms, ref_info = full_ba.solve_full_ba(tprob, cfg, kp)
    poses, lms, info = checkpoint.solve_full_ba_checkpointed(tprob, cfg, kp, str(tmp_path / "ba.npz"), chunk=5)
    np.testing.assert_array_equal(poses.t.numpy(), ref.t.numpy())
    np.testing.assert_array_equal(lms.numpy(), ref_lms.numpy())
    assert float(info.error) == float(ref_info.error)


def test_kill_after_first_chunk_then_resume(graphs, tmp_path, monkeypatch):
    """A snapshot taken after the first chunk resumes to the one-shot
    result, paying only the remaining trials."""
    _, tg = graphs
    cfg = port_cfg(PG_CFG)
    ref, ref_info = pose_graph.solve_pose_graph(tg, cfg)
    path = str(tmp_path / "ck.npz")
    orig = checkpoint.save_solver_state

    def crashing(*a, **k):
        orig(*a, **k)
        raise KeyboardInterrupt("simulated kill after the first snapshot")

    monkeypatch.setattr(checkpoint, "save_solver_state", crashing)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.solve_pose_graph_checkpointed(tg, cfg, path, chunk=2)
    monkeypatch.setattr(checkpoint, "save_solver_state", orig)
    st = checkpoint.load_solver_state(path, device="cpu")
    assert st["iterations"] == 2 and np.isfinite(st["lam"])

    poses, info = checkpoint.solve_pose_graph_checkpointed(tg, cfg, path, chunk=50)
    np.testing.assert_array_equal(poses.t.numpy(), ref.t.numpy())
    assert info.iterations == ref_info.iterations - 2
    assert not os.path.exists(path)


def test_resume_at_a_stalled_snapshot_returns_a_consistent_info(graphs, tmp_path):
    jg, tg = graphs
    cfg = port_cfg(PG_CFG)
    ref, ref_info = pose_graph.solve_pose_graph(tg, cfg)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_solver_state(path, ref, ref_info.lam, ref_info.iterations, stall=2)
    poses, info = checkpoint.solve_pose_graph_checkpointed(tg, cfg, path, chunk=5)
    assert info.iterations == 0 and info.stall == 2
    assert float(info.error) == float(pose_graph.graph_error(ref, tg))
    np.testing.assert_array_equal(poses.t.numpy(), ref.t.numpy())
    assert not os.path.exists(path)


def test_solver_snapshots_cross_load(graphs, tmp_path):
    jg, tg = graphs
    rng = np.random.default_rng(1)
    lms = rng.normal(size=(7, 3)).astype(np.float32)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_solver_state(a, jg.poses0, np.float32(3.5e-3), 7, landmarks=jnp.asarray(lms), meta={"k": 1}, stall=1)
    checkpoint.save_solver_state(b, tg.poses0, torch.tensor(3.5e-3), 7, landmarks=torch.as_tensor(lms),
                                 meta={"k": 1}, stall=1)
    for ours, ref in ((checkpoint.load_solver_state(a, device="cpu"), jckpt.load_solver_state(b)),
                      (checkpoint.load_solver_state(b, device="cpu"), jckpt.load_solver_state(a))):
        np.testing.assert_array_equal(ours["poses"].R.numpy(), np.asarray(ref["poses"].R))
        np.testing.assert_array_equal(ours["poses"].t.numpy(), np.asarray(ref["poses"].t))
        np.testing.assert_array_equal(ours["landmarks"].numpy(), np.asarray(ref["landmarks"]))
        assert {k: ours[k] for k in ("lam", "iterations", "stall", "meta")} == \
               {k: ref[k] for k in ("lam", "iterations", "stall", "meta")}
    assert set(np.load(a).files) == set(np.load(b).files)


def test_lc_results_and_trajectory_cross_load(graphs, tmp_path):
    jg, tg = graphs
    assert lc.LCResult._fields == jlc.LCResult._fields
    rng = np.random.default_rng(2)
    K = 5

    def arrays():
        return {f: rng.normal(size=(K, 6) if f == "variance6" else (K,)).astype(np.float32)
                for f in lc.LCResult._fields if f != "rel_pose"}

    vals = {(0, 1): arrays(), (1, 2): arrays()}
    rel = se3.from_rodrigues_xyz(torch.as_tensor(rng.normal(size=(K, 6)).astype(np.float32)))
    port_lc = {k: lc.LCResult(rel_pose=rel, **{f: torch.as_tensor(v) for f, v in d.items()}) for k, d in vals.items()}
    jax_lc = {k: jlc.LCResult(rel_pose=jse3.Pose3(jnp.asarray(rel.R.numpy()), jnp.asarray(rel.t.numpy())),
                              **{f: jnp.asarray(v) for f, v in d.items()}) for k, d in vals.items()}
    a, b = str(tmp_path / "lc_jax.npz"), str(tmp_path / "lc_port.npz")
    jckpt.save_lc_results(a, jax_lc)
    checkpoint.save_lc_results(b, port_lc)
    for ours, ref in ((checkpoint.load_lc_results(a, device="cpu"), jckpt.load_lc_results(b)),):
        assert set(ours) == set(ref) == set(vals)
        for k in vals:
            for f in lc.LCResult._fields:
                x, y = getattr(ours[k], f), getattr(ref[k], f)
                for u, v in zip(x if f == "rel_pose" else (x,), y if f == "rel_pose" else (y,)):
                    np.testing.assert_array_equal(u.numpy(), np.asarray(v))

    t1, t2 = str(tmp_path / "traj_jax.npz"), str(tmp_path / "traj_port.npz")
    slices = [slice(0, 40), slice(40, 80)]
    jckpt.save_trajectory_state(t1, jg.poses0, slices, {"ate": 1.25})
    checkpoint.save_trajectory_state(t2, tg.poses0, slices, {"ate": 1.25})
    poses, sl, meta = checkpoint.load_trajectory_state(t1, device="cpu")
    jposes, jsl, jmeta = jckpt.load_trajectory_state(t2)
    np.testing.assert_array_equal(poses.t.numpy(), np.asarray(jposes.t))
    assert sl == jsl == slices and meta == jmeta == {"ate": 1.25}
