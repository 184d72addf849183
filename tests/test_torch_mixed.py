"""Parity of the port with the JAX package on surveys whose lines differ in
bin count (``torch_parity_helpers.crop_lines``): 3 parallel lines of 200
pings cropped to 240, 256 and 224 bins (annotations: two-stage and the
stream; one gated pair has the narrower line as its source, the other the
wider one), and 2 lines and a tie line of 200 pings cropped to 336, 384 and
288 bins (full BA and the automatic profile, whose dense matcher needs the
crossing line).

The JAX package takes its per-pair branches there (loop closures,
evaluation, the dense matcher's mixed raster branch); the port keeps one
stacked program with a bin count per row and padded tables.

Tolerances, and why:

* two-stage on annotations: the same pairs and accepted loop closures,
  every valid row's ``rel_pose`` within 1e-4 m (the LC tolerance of
  test_torch_solvers.py), the ATE within 1e-3 m, the eval_1 values and the
  eval_2 averages within 1e-4 (float32 projections of the same poses), the
  eval_2 rows within 1e-3 (a float32 LM re-triangulates each landmark);
* full BA on annotations against the JAX package's CPU PCG (its direct BA
  compiles for minutes under xdist, test_torch_full_ba.py): 1e-3 m;
* the automatic profile on the same keypoints (the port's detector on the
  frames of both widths, handed to the JAX package too): the dense rows at
  least 99% shared (the JAX package's CPU lattice branch sums its refinement
  in another order, test_torch_dense_perpair.py) and the ATE within 0.02 m
  (test_torch_auto.py);
* the two-stage stream's arrival of the narrower line's pair: 1e-3 m
  (test_torch_online.py), or, where the two LMs stop after different trial
  counts, a final graph error no higher than the JAX package's and 5e-3 m:
  there the JAX package stalls after 7 trials at 35.99921 (float32) and the
  port after 8 at 35.99840 (float64), 2.1e-3 m apart.  Both errors are
  evaluated on the port's graph in float64, the cost the port's accept
  test reads since ROADMAP C17 (on the first arrival, the DR chain alone,
  the JAX package's float32 cost rounds to 0 and the port's float64 cost
  is 1.4e-6 after 3 trials against the JAX package's 2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, crop_lines, jax_and_port_frames, port_cfg
from diasss_tpu import online as jonline
from diasss_tpu.config import PipelineConfig, PoseGraphConfig, automatic_config
from diasss_tpu.features.detector import DetectedFeatures as JaxFeatures
from diasss_tpu.matching import dense as jdense
from diasss_tpu.pipeline import _pad_feats_common as jax_pad_feats
from diasss_tpu.pipeline import run_slam as jax_run_slam
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch import online
from diasss_tpu_torch.features import detect_features
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.matching import dense
from diasss_tpu_torch.pipeline import run_slam
from diasss_tpu_torch.solvers import pose_graph

CROPS = {0: 8, 2: 16}
TIE_CROPS = {0: 24, 2: 48}
ANNOTATED = PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="direct"))
BA_ANNO = PipelineConfig(min_overlap=0.1, estimator="full_ba")
AUTO = automatic_config()
AUTO = dataclasses.replace(AUTO, detector=dataclasses.replace(AUTO.detector, n_features=300), rematch_iters=1,
                           rematch_stop_resid_cells=0.0)


def _base():
    return make_survey(n_lines=3, n_pings=200, n_bins=256, n_landmarks=200, drift_xy=0.01, seed=7)


@pytest.fixture(scope="module")
def survey():
    return crop_lines(_base(), CROPS)


@pytest.fixture(scope="module")
def frames(survey):
    jf, tf = jax_and_port_frames(survey)
    assert [int(f.raw.shape[1]) for f in tf] == [240, 256, 224]
    return jf, tf


@pytest.fixture(scope="module")
def tie_survey():
    base = make_survey(n_lines=2, n_pings=200, n_bins=384, n_landmarks=150, n_tie_lines=1, drift_xy=0.006, seed=7)
    return crop_lines(base, TIE_CROPS)


@pytest.fixture(scope="module")
def tie_frames(tie_survey):
    jf, tf = jax_and_port_frames(tie_survey)
    assert [int(f.raw.shape[1]) for f in tf] == [336, 384, 288]
    return jf, tf


def test_crop_keeps_geometry(survey):
    """A cropped line keeps its geometry: the ground range of every kept
    column (but port column 0, which the clamp of the table's index reads
    one entry short), and its annotations at the shifted bins."""
    base = _base()
    for k, c in CROPS.items():
        line, orig = survey.lines[k], base.lines[k]
        cols = np.arange(1, line.image.shape[1])
        half = line.image.shape[1] // 2
        gr = line.ground_ranges[np.clip(np.abs(cols - half), 0, half - 1)]
        gr0 = orig.ground_ranges[np.clip(np.abs(cols + c - 128), 0, 127)]
        np.testing.assert_array_equal(gr, gr0)
        np.testing.assert_array_equal(line.image, orig.image[:, c:256 - c])
        assert 0 < len(line.annos) <= len(orig.annos)
        assert (line.annos[:, 3] >= 0).all() and (line.annos[:, 3] < line.image.shape[1]).all()


@pytest.fixture(scope="module")
def two_stage(survey, frames):
    jf, tf = frames
    gt = [l.gt_poses for l in survey.lines]
    ref = jax_run_slam(jf, ANNOTATED, gt_rows_list=gt)
    ours = run_slam(tf, port_cfg(ANNOTATED), gt_rows_list=gt, rng=JaxRng())
    return ref, ours


def test_two_stage_matches_jax(two_stage):
    ref, ours = two_stage
    assert ours.pair_ids == ref.pair_ids == [(0, 1), (1, 2)]
    assert ours.n_lc_accepted == ref.n_lc_accepted > 0
    for key in ref.pair_ids:
        r, o = ref.lc_results[key], ours.lc_results[key]
        valid = np.asarray(r.valid)
        assert valid.sum() > 0 and np.array_equal(o.valid.numpy(), valid)
        np.testing.assert_allclose(o.rel_pose.t.numpy()[valid], np.asarray(r.rel_pose.t)[valid], atol=1e-4)
        np.testing.assert_array_equal(o.quality.numpy()[valid] > 0, np.asarray(r.quality)[valid] > 0)
    assert abs(ours.ate_dr - ref.ate_dr) < 1e-5
    assert abs(ours.ate_est - ref.ate_est) < 1e-3
    assert ours.ate_est < ours.ate_dr


def test_two_stage_evaluation_and_counters_match_jax(two_stage):
    """The JAX package evaluates these pairs one by one
    (``eval_perpair_pairs``); the port in one stacked batch."""
    ref, ours = two_stage
    n = len(ref.pair_ids)
    assert ref.timings["eval_perpair_pairs"] == n and "eval_stacked_pairs" not in ref.timings
    assert ours.counters == {"eval_stacked_pairs": n, "solver_direct_solves": 1}
    for key in ref.pair_ids:
        a, b = ours.eval1[key], ref.eval1[key]
        assert a.n_pairs == b.n_pairs > 0
        for name in a._fields:
            np.testing.assert_allclose(np.asarray(getattr(a, name), np.float64),
                                       np.asarray(getattr(b, name), np.float64), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} {name}")
        # eval_2 re-triangulates each landmark by a float32 LM: its
        # averages agree to 1e-4, its rows to 1e-3 (so a near tie of DR and
        # estimate may flip one row's "improved")
        a, b = ours.eval2[key], ref.eval2[key]
        assert a.n_pairs == b.n_pairs > 0
        for name in a._fields:
            x, y = np.asarray(getattr(a, name), np.float64), np.asarray(getattr(b, name), np.float64)
            if name.endswith("_pct"):
                assert abs(x - y) <= 100.0 / a.n_pairs + 1e-9, (key, name)
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 if x.ndim == 0 else 1e-3, err_msg=f"{key} {name}")


def test_full_ba_matches_jax(tie_survey, tie_frames):
    jf, tf = tie_frames
    gt = [l.gt_poses for l in tie_survey.lines]
    ref = jax_run_slam(jf, BA_ANNO, gt_rows_list=gt, run_eval2=False)
    ours = run_slam(tf, port_cfg(BA_ANNO), gt_rows_list=gt, run_eval2=False, rng=JaxRng())
    assert ours.pair_ids == ref.pair_ids
    assert ours.n_lc_accepted == ref.n_lc_accepted > 20
    assert abs(ours.ate_est - ref.ate_est) < 1e-3
    assert ours.ate_est < ours.ate_dr
    assert ours.counters == {"eval_stacked_pairs": len(ref.pair_ids), "solver_direct_solves": 1,
                             "full_ba_trials": ours.counters["full_ba_trials"]}
    assert 1 <= ours.counters["full_ba_trials"] <= BA_ANNO.full_ba.max_iters


@pytest.fixture(scope="module")
def feats(tie_frames):
    """The port's keypoints of each frame (its detector on frames of three
    widths) and the same arrays as the JAX package's features."""
    ours = [detect_features(f.norm, f.mask, port_cfg(AUTO.detector)) for f in tie_frames[1]]
    assert all(int(f.valid.sum()) > 30 for f in ours)
    return ours, [JaxFeatures(*[np.asarray(x) for x in f]) for f in ours]


def test_stacked_dense_matcher_mixed_branch_matches_jax(tie_frames, feats):
    """The stacked dense matcher on frames of three widths: each frame on
    its own raster at the survey-common shape, keypoint geo clipped per
    frame, as the JAX package's mixed branch."""
    jf, tf = tie_frames
    pairs = [(0, 1), (1, 2), (0, 2)]
    dcfg, mcfg = AUTO.detector, AUTO.matcher.dense
    ref = jdense.dense_matching_stacked(pairs, [0, 1, 2], jax_pad_feats(feats[1])[0], [f.norm for f in jf],
                                        [f.geo for f in jf], dcfg, mcfg)
    ours = dense.dense_matching_stacked(pairs, [0, 1, 2], feats[0], [f.norm for f in tf], [f.geo for f in tf],
                                        port_cfg(dcfg), port_cfg(mcfg))
    rows_o = np.concatenate([ours[p][0] for p in pairs])
    rows_r = np.concatenate([ref[p][0] for p in pairs])
    for p in pairs:
        assert abs(ours[p][2] - ref[p][2]) <= 1, (p, ours[p][2], ref[p][2])
    assert len(rows_r) >= 15
    a, b = {tuple(r) for r in rows_o}, {tuple(r) for r in rows_r}
    assert len(a & b) >= 0.99 * len(b), (len(a & b), len(b))


def test_automatic_profile_matches_jax(tie_survey, tie_frames, feats):
    jf, tf = tie_frames
    gt = [l.gt_poses for l in tie_survey.lines]
    ref = jax_run_slam(jf, AUTO, gt_rows_list=gt, run_eval2=False, feats=feats[1])
    ours = run_slam(tf, port_cfg(AUTO), gt_rows_list=gt, run_eval2=False, feats=feats[0], rng=JaxRng())
    assert ours.pair_ids == ref.pair_ids
    assert ours.counters["match_stacked_pairs"] == ref.timings["match_stacked_pairs"]
    assert abs(ours.n_lc_accepted - ref.n_lc_accepted) <= 0.03 * ref.n_lc_accepted
    assert abs(ours.ate_est - ref.ate_est) < 0.02
    assert ours.ate_est < ours.ate_dr


def test_two_stage_stream_matches_jax_after_every_arrival(frames, monkeypatch):
    """The first two lines (240 and 256 bins) arrive in turn.  Where the
    trial counts differ, the port's stop is no worse than the JAX
    package's: both costs evaluated on the port's graph in float64 (the
    port's accept test reads that cost, ROADMAP C17; the JAX package's
    float32 cost of the first arrival's DR chain rounds to 0)."""
    jf, tf = frames
    graphs = []
    entry = pose_graph.solve_pose_graph

    def solve(graph, *args, **kwargs):
        graphs.append(graph)
        return entry(graph, *args, **kwargs)

    monkeypatch.setattr(pose_graph, "solve_pose_graph", solve)
    j = jonline.OnlineSlam(ANNOTATED)
    p = online.OnlineSlam(port_cfg(ANNOTATED), device="cpu")
    for k, (a, b) in enumerate(zip(jf[:2], tf[:2])):
        jposes, tposes = j.add_frame(a), p.add_frame(b)
        jt, tt = np.asarray(jposes.t), tposes.t.numpy()
        assert tt.shape == jt.shape == (200 * (k + 1), 3)
        assert p.state.n_lc == j.state.n_lc
        gap = float(np.abs(tt - jt).max())
        if p._last_info.iterations == int(j._last_info.iterations):
            assert gap <= 1e-3, (k, gap)
        else:
            g, n = graphs[-1], len(tt)  # the real poses' factors of a chain padded to its bucket
            g = g._replace(poses0=g.poses0[:n], odo_meas=g.odo_meas[:n - 1])
            ours = float(pose_graph.graph_error(tposes, g))
            theirs = float(pose_graph.graph_error(se3.Pose3(torch.as_tensor(np.asarray(jposes.R)),
                                                            torch.as_tensor(jt)), g))
            assert ours <= theirs * (1 + 1e-6) and gap <= 5e-3, (k, gap, ours, theirs)
    assert p.state.n_lc > 0
