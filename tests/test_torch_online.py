"""Parity of the port's online stream (``diasss_tpu_torch/online.py``) with
the JAX package's ``OnlineSlam``.

Tolerances, and why:

* ``bucket_capacity``, ``_pad_chain_to``, and ``_window_ba_problem`` /
  ``_pad_ba_problem`` on a BAProblem carried over from the JAX package:
  index rows, masks and padding identical; values 1e-6 (pure gathers and
  copies; the poses of the constant endpoints are gathers too);
* the two-stage annotation stream, with and without a fixed-lag window, and
  without one under ``coarse_init_stride=4``: after every arrival the same
  pose count and loop closures in the solve, translations within 1e-3 m
  (the loop-closure mini-solves and the pose-graph LM agree to a few 1e-5
  m, as in the batch pipeline's tests), and no coarse-to-fine
  initialization run (the stream's warm-started solves pass
  ``allow_coarse_init=False``, as the JAX package's do);
* the automatic stream (dense per-pair matching, warm-started full BA) is
  held to the port's own batch run with ``rematch_iters=0``, within the JAX
  package's own bound for the same comparison
  (``tests/test_online.py:62-85``): ``|ATE_online - ATE_batch| < 0.1 *
  max(ATE_DR, 1)``;
* the unwindowed full-BA stream on annotations against the JAX package's
  ``OnlineSlam`` after every arrival, the JAX side on its CPU default
  (PCG; its direct BA compiles for minutes under xdist, as
  test_torch_full_ba.py says): the same correspondences, 1e-3 m (measured
  8.2e-5 m); the same with a window of two lines over four arrivals, whose
  last arrival drops the first line's correspondences from the solve: 1e-3
  m (measured 5.9e-5 m);
* the automatic stream against the JAX package's ``OnlineSlam`` after every
  arrival, both on the JAX detector's keypoints: the same correspondences,
  0.02 m (the automatic profile's bound, test_torch_auto.py; measured
  3.7e-4 m: the JAX package's CPU dense matcher takes its lattice branch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu import online as jonline
from diasss_tpu.config import PipelineConfig, PoseGraphConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.pipeline import _assemble_pairs as jax_assemble_pairs
from diasss_tpu.pipeline import _overlap_pairs as jax_overlap_pairs
from diasss_tpu.solvers import full_ba as jfba
from diasss_tpu_torch import online
from diasss_tpu_torch.config import automatic_config
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.diagnostics import check_finite
from diasss_tpu_torch.evaluate import trajectory_ate_pair
from diasss_tpu_torch.geometry import se3


@pytest.mark.parametrize("n, base", [(1, 256), (256, 256), (257, 256), (300, 256), (5, 16), (17, 16), (65, 64)])
def test_bucket_capacity_identical(n, base):
    assert online.bucket_capacity(n, base) == jonline.bucket_capacity(n, base)


def test_pad_chain_to_identical():
    rng = np.random.default_rng(3)
    rows = rng.normal(0, 0.3, (7, 6)).astype(np.float32)
    poses = jse3.from_rodrigues_xyz(jnp.asarray(rows))
    odo = jse3.between(poses[:-1], poses[1:])
    ref = jonline._pad_chain_to(poses, odo, 16)
    ours = online._pad_chain_to(*(to_torch(p, device="cpu") for p in (poses, odo)), 16)
    for a, b in zip(jax.tree_util.tree_leaves(ref), [x for p in ours for x in p]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ours[0].t.shape == (16, 3) and ours[1].t.shape == (15, 3)


# the direct pose-graph step on both sides (the JAX package's CPU default is PCG)
STREAM_CFG = PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="direct"))
STREAM_PINGS = 80


@pytest.fixture(scope="module")
def stream_frames():
    """3 lines of 80 pings: the JAX package's keyframes and the port's copy."""
    return jax_and_port_frames(small_survey(n_lines=3, n_pings=STREAM_PINGS, n_bins=256, n_landmarks=40, seed=7))


# a coarse-to-fine stride: the stream's warm-started solves skip it, as the
# JAX package's do (allow_coarse_init=False)
COARSE_CFG = dataclasses.replace(STREAM_CFG, pose_graph=dataclasses.replace(STREAM_CFG.pose_graph,
                                                                            coarse_init_stride=4))


@pytest.fixture(scope="module", params=[(2, STREAM_CFG), (None, STREAM_CFG), (None, COARSE_CFG)],
                ids=["window2", "nowindow", "nowindow_coarse4"])
def window(request):
    return request.param


@pytest.fixture(scope="module")
def port_stream(stream_frames, window):
    """The port's two-stage annotation stream: (poses, loop closures in the
    solve, frame slices, coarse initializations run) after every arrival."""
    from diasss_tpu_torch.solvers import pose_graph

    coarse_runs = []
    entry = pose_graph._coarse_init

    def counted(*args, **kwargs):
        coarse_runs.append(1)
        return entry(*args, **kwargs)

    p = online.OnlineSlam(port_cfg(window[1]), window_frames=window[0], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pose_graph, "_coarse_init", counted)
        return [(p.add_frame(f).t.numpy(), p.state.n_lc, list(p.state.frame_slices), len(coarse_runs))
                for f in stream_frames[1]]


@pytest.fixture(scope="module")
def jax_stream(stream_frames, window):
    j = jonline.OnlineSlam(window[1], window_frames=window[0])
    return [(np.asarray(j.add_frame(f).t), j.state.n_lc) for f in stream_frames[0]]


def test_port_stream_grows_by_one_frame_per_arrival(port_stream):
    for k, (t, n_lc, slices, _) in enumerate(port_stream):
        total = STREAM_PINGS * (k + 1)
        assert t.shape == (total, 3) and np.isfinite(t).all()
        assert slices == [slice(STREAM_PINGS * f, STREAM_PINGS * (f + 1)) for f in range(k + 1)]
    assert port_stream[-1][1] >= 2  # loop closures reach the last solve


def test_two_stage_stream_matches_jax_after_every_arrival(port_stream, jax_stream):
    for (tt, tn, _, coarse_runs), (jt, jn) in zip(port_stream, jax_stream):
        assert tt.shape == jt.shape
        assert tn == jn
        np.testing.assert_allclose(tt, jt, atol=1e-3)
        assert coarse_runs == 0  # warm-started solves skip the coarse init, as the JAX package's do


@pytest.fixture(scope="module")
def ba_problem():
    """A full-BA problem of the JAX package on annotations (2 lines and a
    tie line), and a pose estimate standing in for the stream's previous one."""
    from diasss_tpu.synthetic import make_survey

    survey = make_survey(n_lines=2, n_pings=60, n_bins=256, n_landmarks=60, n_tie_lines=1, seed=3)
    jf, _ = jax_and_port_frames(survey)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    pair_ids = jax_overlap_pairs(jf, cfg.min_overlap)
    kps, _ = jax_assemble_pairs(jf, None, pair_ids, cfg, True)
    prob = jfba.build_ba_problem(jf, kps, pair_ids, cfg.full_ba, cfg.pose_graph, None)
    rng = np.random.default_rng(0)
    est = jse3.retract(prob.poses0, jnp.asarray(rng.normal(0, 0.01, (prob.poses0.t.shape[0], 6)), jnp.float32))
    return cfg, prob, est


@pytest.mark.parametrize("cut", [0, 70, 150])
def test_window_and_pad_ba_problem_identical(ba_problem, cut):
    cfg, prob, est = ba_problem
    j = jonline.OnlineSlam(cfg)
    j.state.poses = est
    p = online.OnlineSlam(port_cfg(cfg), device="cpu")
    p.state.poses = to_torch(est, device="cpu")
    tprob = to_torch(prob, device="cpu")
    ref = j._pad_ba_problem(j._window_ba_problem(prob, cut) if cut else prob)
    ours = p._pad_ba_problem(p._window_ba_problem(tprob, cut) if cut else tprob)
    assert ours._fields == ref._fields
    for name, a, b in zip(ref._fields, ref, ours):
        if a is None:
            assert b is None, name
            continue
        for x, y in zip(jax.tree_util.tree_leaves(a), [y for y in (b if isinstance(b, tuple) else (b,))]):
            x = np.asarray(x)
            assert y.shape == x.shape, name
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y.numpy(), x, err_msg=name)
            else:
                np.testing.assert_allclose(y.numpy(), x, atol=1e-6, err_msg=name)
    assert ours.poses0.t.shape[0] == online.bucket_capacity(int(prob.poses0.t.shape[0]) - cut)
    if cut == 70:  # factors across the cut keep their frozen endpoint as a constant pose
        assert bool(ours.kp_i_fix.any()) and bool(ours.kp_valid.any())


def test_online_automatic_stream_matches_the_batch_run(monkeypatch):
    """The automatic profile streamed through ``run_stream`` (dense per-pair
    matching, one correlation per new pair, warm-started full BA) against the
    port's batch run on the same keyframes, as the JAX package's own test
    holds its stream to its batch run."""
    from diasss_tpu_torch.frame import build_keyframes_batch
    from diasss_tpu_torch.matching import dense
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.synthetic import make_survey

    torch.set_num_threads(2)
    survey = make_survey(n_lines=2, n_pings=150, n_bins=256, n_landmarks=150, n_tie_lines=1, seed=11,
                         drift_xy=0.004)
    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    cfg = automatic_config()
    cfg = dataclasses.replace(cfg, rematch_iters=0, detector=dataclasses.replace(cfg.detector, n_features=300))
    calls = []
    entry = dense.qcorr
    monkeypatch.setattr(dense, "qcorr", lambda *a: calls.append(a[0].shape[0]) or entry(*a))
    slam = online.OnlineSlam(cfg, device="cpu")
    counts = []
    for k, poses in enumerate(slam.run_stream(lambda it=it: it for it in items)):
        counts.append(slam.counters.get("match_perpair_pairs", 0))
        assert poses.t.shape[0] == 150 * (k + 1)
        assert check_finite(poses, "poses") == []
    # every new pair of each arrival matched once, one correlation each
    assert counts == [0, 1, 3] and len(calls) == 3 and set(calls) == {300}
    assert slam.state.n_lc > 0

    frames = build_keyframes_batch(items, device="cpu")
    gt = [l.gt_poses for l in survey.lines]
    batch = run_slam(frames, cfg, gt_rows_list=gt, run_eval2=False)
    ate_dr, ate_online = trajectory_ate_pair(torch.cat([f.dr_poses[:, 3:6] for f in frames]), poses,
                                             np.concatenate(gt))
    assert batch.counters["match_stacked_pairs"] == 3
    assert abs(ate_online - batch.ate_est) < 0.1 * max(ate_dr, 1.0), (ate_online, batch.ate_est, ate_dr)


def test_full_ba_stream_matches_jax_after_every_arrival():
    from diasss_tpu.synthetic import make_survey

    survey = make_survey(n_lines=2, n_pings=60, n_bins=256, n_landmarks=60, n_tie_lines=1, seed=3)
    jf, tf = jax_and_port_frames(survey)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    j = jonline.OnlineSlam(cfg)
    p = online.OnlineSlam(port_cfg(cfg), device="cpu")
    for k, (a, b) in enumerate(zip(jf, tf)):
        jt, tt = np.asarray(j.add_frame(a).t), p.add_frame(b).t.numpy()
        assert tt.shape == jt.shape == (60 * (k + 1), 3)
        assert p.state.n_lc == j.state.n_lc
        np.testing.assert_allclose(tt, jt, atol=1e-3)
    assert p.state.n_lc > 0


def test_windowed_full_ba_stream_matches_jax_after_every_arrival():
    """Four lines through a window of two: from the third arrival on, the
    solve holds the window's poses with constant-pose endpoints outside it."""
    from diasss_tpu.synthetic import make_survey

    survey = make_survey(n_lines=3, n_pings=60, n_bins=256, n_landmarks=60, n_tie_lines=1, seed=3)
    jf, tf = jax_and_port_frames(survey)
    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba")
    j = jonline.OnlineSlam(cfg, window_frames=2)
    p = online.OnlineSlam(port_cfg(cfg), window_frames=2, device="cpu")
    for k, (a, b) in enumerate(zip(jf, tf)):
        jt, tt = np.asarray(j.add_frame(a).t), p.add_frame(b).t.numpy()
        assert tt.shape == jt.shape == (60 * (k + 1), 3)
        assert p.state.n_lc == j.state.n_lc
        np.testing.assert_allclose(tt, jt, atol=1e-3)
    assert len(tf) == 4 and p.state.n_lc > 0


def test_automatic_stream_matches_jax_after_every_arrival(monkeypatch):
    """Both streams detect nothing themselves here: the port's arrival takes
    the JAX detector's keypoints of the same frame (the detectors differ in
    a few higher-level keypoints, test_torch_features.py)."""
    from diasss_tpu.config import automatic_config as jax_automatic_config
    from diasss_tpu.features import detect_features as jax_detect
    from diasss_tpu.synthetic import make_survey
    import diasss_tpu_torch.features

    torch.set_num_threads(2)
    cfg = jax_automatic_config()
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, n_features=300))
    survey = make_survey(n_lines=2, n_pings=150, n_bins=256, n_landmarks=150, seed=11, drift_xy=0.004)
    jf, tf = jax_and_port_frames(survey)
    feats = iter([to_torch(jax_detect(f.norm, f.mask, cfg.detector), device="cpu") for f in jf])
    monkeypatch.setattr(diasss_tpu_torch.features, "detect_features", lambda *args: next(feats))
    j = jonline.OnlineSlam(cfg)
    p = online.OnlineSlam(port_cfg(cfg), device="cpu", rng=JaxRng())
    for k, (a, b) in enumerate(zip(jf, tf)):
        jt, tt = np.asarray(j.add_frame(a).t), p.add_frame(b).t.numpy()
        assert tt.shape == jt.shape == (150 * (k + 1), 3)
        assert p.state.n_lc == j.state.n_lc
        np.testing.assert_allclose(tt, jt, atol=0.02)
    assert p.state.n_lc > 0 and p.counters == {"match_perpair_pairs": 1}


@pytest.mark.parametrize("kwargs, exc, match", [
    (dict(window_frames=1), ValueError, "window_frames must be >= 2"),
    # ported (ROADMAP A14): without a process group of 4 ranks it names the torchrun line
    (dict(cfg=PipelineConfig(mesh_devices=4)), RuntimeError, "needs a process group: run under `torchrun --nproc-per-node 4`"),
])
def test_rejected_settings_raise(kwargs, exc, match):
    kw = dict(kwargs)
    if "cfg" in kw:
        kw["cfg"] = port_cfg(kw["cfg"])
    with pytest.raises(exc, match=match):
        online.OnlineSlam(device="cpu", **kw)
    if "window_frames" in kw:
        with pytest.raises(ValueError, match="window_frames must be >= 2"):
            jonline.OnlineSlam(window_frames=1)


def test_online_defaults_to_the_card():
    import inspect

    assert inspect.signature(online.OnlineSlam).parameters["device"].default == "cuda"
    assert check_finite(se3.identity((2,)), "pose") == []
