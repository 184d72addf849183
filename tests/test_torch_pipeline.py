"""End-to-end parity of the port's ``run_slam`` with the JAX package's, on a
3-line survey, in the annotation and the detected two-stage configurations,
plus the port's CLI.

Both pipelines start from the same keyframe state (the JAX package's,
carried over by ``diasss_tpu_torch.convert``) and the same random draws
(``JaxRng``).  Tolerances: overlap pairs, keypoint-pair rows (the
``annotated_kps.txt`` dump) and the accepted loop-closure count are
identical; the ATE agrees to 1e-3 m (float32 LM iterates differ in the last
digits, see test_torch_solvers.py).  The run through the port's own detector
differs from the JAX detector in a few higher-level keypoints (resize
rounding, see test_torch_features.py), so it is held to the same pairs and
an ATE within 0.05 m of the JAX run.
"""

import json

import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, crop_lines, frame_items, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu.config import DetectorConfig, FullBAConfig, MatcherConfig, PipelineConfig, PoseGraphConfig
from diasss_tpu.features import detect_features as jax_detect
from diasss_tpu.pipeline import run_slam as jax_run_slam
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.pipeline import run_slam

DETECTED = PipelineConfig(
    detector=DetectorConfig(n_features=600),
    matcher=MatcherConfig(ratio_test=0.9, sift_dist_bound=600.0, scc_mode="x"),
    pose_graph=PoseGraphConfig(use_anno=False, preconditioner="direct"),
)
ANNOTATED = PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="direct"))


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def survey():
    return small_survey(n_pings=300, n_bins=512, n_landmarks=150)


@pytest.fixture(scope="module")
def frames(survey):
    return jax_and_port_frames(survey)


def test_annotation_run_matches_jax(survey, frames, tmp_path):
    jf, tf = frames
    gt = [l.gt_poses for l in survey.lines]
    ref = jax_run_slam(jf, ANNOTATED, gt_rows_list=gt, out_dir=str(tmp_path / "jax"))
    ours = run_slam(tf, port_cfg(ANNOTATED), gt_rows_list=gt, out_dir=str(tmp_path / "port"), rng=JaxRng())
    assert ours.pair_ids == ref.pair_ids
    assert ours.n_lc_accepted == ref.n_lc_accepted > 0
    assert abs(ours.ate_dr - ref.ate_dr) < 1e-5
    assert abs(ours.ate_est - ref.ate_est) < 1e-3
    assert ours.ate_est < ours.ate_dr
    for key in ref.pair_ids:
        assert abs(ours.eval1[key].avg_norm_est - ref.eval1[key].avg_norm_est) < 1e-3
        assert abs(ours.eval2[key].avg_range_est - ref.eval2[key].avg_range_est) < 1e-3
    for name in ("annotated_kps.txt", "depth_drape.txt"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "ini_lm_errors.txt"),
                               np.loadtxt(tmp_path / "jax" / "ini_lm_errors.txt"), atol=1e-5)
    assert ours.counters == {"eval_stacked_pairs": len(ref.pair_ids), "solver_direct_solves": 1}


@pytest.fixture(scope="module")
def detected_runs(survey, frames, tmp_path_factory):
    jf, tf = frames
    gt = [l.gt_poses for l in survey.lines]
    out = tmp_path_factory.mktemp("detected")
    feats = [jax_detect(f.norm, f.mask, DETECTED.detector) for f in jf]
    ref = jax_run_slam(jf, DETECTED, gt_rows_list=gt, out_dir=str(out / "jax"), run_eval2=False, feats=feats)
    fed = run_slam(tf, port_cfg(DETECTED), gt_rows_list=gt, out_dir=str(out / "port"), run_eval2=False,
                   feats=[to_torch(f, device="cpu") for f in feats], rng=JaxRng())
    own = run_slam(tf, port_cfg(DETECTED), gt_rows_list=gt, run_eval2=False, rng=JaxRng())
    return out, ref, fed, own


def test_detected_run_on_jax_features_matches_jax(detected_runs):
    out, ref, fed, _ = detected_runs
    rows = _read(out / "jax" / "annotated_kps.txt")
    assert len(rows.splitlines()) >= 10
    assert _read(out / "port" / "annotated_kps.txt") == rows
    assert fed.pair_ids == ref.pair_ids
    assert fed.n_lc_accepted == ref.n_lc_accepted
    assert abs(fed.ate_est - ref.ate_est) < 1e-3
    assert fed.counters["match_stacked_pairs"] == len(ref.pair_ids)


def test_detected_run_through_port_detector(detected_runs):
    _, ref, _, own = detected_runs
    assert own.pair_ids == ref.pair_ids
    assert "detect" in own.timings and "matching" in own.timings
    assert abs(own.ate_est - ref.ate_est) < 0.05
    assert own.ate_est <= own.ate_dr + 1e-2


@pytest.mark.parametrize("cfg, item", [
    (PipelineConfig(estimator="full_ba", full_ba=FullBAConfig(marginals=True)), "A9"),
    (PipelineConfig(mesh_devices=4), "A14"),
    (PipelineConfig(pose_graph=PoseGraphConfig(marginals=True)), "A9"),
    (PipelineConfig(estimator="full_ba", full_ba=FullBAConfig(preconditioner="dense_seg", tridiag_segment=32,
                                                              max_iters=6)), "A7"),
    (PipelineConfig(detector=DetectorConfig(descriptor="geo_patch", n_features=300),
                    matcher=MatcherConfig(desc_metric="ncc", cross_check=True, scc_mode="xy"),
                    pose_graph=PoseGraphConfig(use_anno=False, preconditioner="direct")), "A11"),
    (PipelineConfig(), "A8"),
])
def test_unported_options_raise_naming_roadmap(survey, frames, cfg, item):
    """Options still unported raise, naming their ROADMAP item; those ported
    since (A9: the pose marginals, A7: the PCG family, A11: geo-patch
    descriptors attached for the keypoint matcher, A8: lines of different
    bin counts) run."""
    if item in ("A7", "A9"):
        result = run_slam(frames[1], port_cfg(cfg), rng=JaxRng())
        assert torch.isfinite(result.poses.t).all()
        assert result.counters == {"eval_stacked_pairs": len(result.pair_ids),
                                   f"solver_{'dense_seg' if item == 'A7' else 'direct'}_solves": 1}
        assert (result.pose_sigmas is not None) == (item == "A9")
        return
    if item == "A11":
        result = run_slam(frames[1], port_cfg(cfg), rng=JaxRng(), run_eval2=False)
        assert torch.isfinite(result.poses.t).all()
        assert result.counters == {"match_stacked_pairs": len(result.pair_ids),
                                   "eval_stacked_pairs": len(result.pair_ids), "solver_direct_solves": 1}
        assert sum(int(r.valid.sum()) for r in result.lc_results.values()) > 0
        return
    if item == "A8":
        from diasss_tpu_torch.frame import build_keyframes_batch

        mixed = crop_lines(survey, {0: 32})
        tf = build_keyframes_batch(frame_items(mixed), device="cpu")
        assert [int(f.raw.shape[1]) for f in tf] == [448, 512, 512]
        result = run_slam(tf, port_cfg(cfg), gt_rows_list=[l.gt_poses for l in mixed.lines], rng=JaxRng())
        assert torch.isfinite(result.poses.t).all() and len(result.pair_ids) > 0
        assert result.counters == {"eval_stacked_pairs": len(result.pair_ids), "solver_direct_solves": 1}
        assert result.ate_est <= result.ate_dr
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_slam(frames[1], port_cfg(cfg))


@pytest.fixture(scope="module")
def survey_dirs(tmp_path_factory):
    from diasss_tpu_torch.io import save_survey

    survey = small_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=30, seed=2)
    out = tmp_path_factory.mktemp("survey")
    folders = save_survey(survey, str(out))
    args = []
    for k in ("image", "pose", "altitude", "groundrange", "annotation"):
        args += [f"--{k}", folders[k]]
    return args + ["--gt", str(out / "gt-poses"), "--device", "cpu"]


def test_cli_runs_and_writes_metrics(survey_dirs, tmp_path):
    from diasss_tpu_torch.cli import main

    metrics = tmp_path / "m.json"
    assert main(survey_dirs + ["--metrics", str(metrics), "--out", str(tmp_path / "out"), "--no-marginals"]) == 0
    m = json.loads(metrics.read_text())
    assert m["n_frames"] == 2 and m["device"] == "cpu"
    assert m["ate_est"] is not None and np.isfinite(m["ate_est"])
    assert m["counters"] == {"eval_stacked_pairs": 1, "solver_direct_solves": 1}
    assert (tmp_path / "out" / "est_poses_all.txt").exists()
    assert (tmp_path / "out" / "est_poses.txt").exists()  # two lines: the pairwise dumps too


@pytest.mark.parametrize("flags, item", [
    (["--metrics", "m.json"], "A9"),
    (["--online", "--window", "2", "--out", "online", "--metrics", "m.json"], "A13"),
    (["--mesh", "2"], "A14"),
    (["--detected", "--descriptor", "orb"], "A11"),
])
def test_cli_rejects_unported_flags(survey_dirs, capsys, flags, item, tmp_path, monkeypatch):
    """Flags still unported exit naming their ROADMAP item; those ported
    since run: ``--metrics`` without ``--no-marginals`` (A9) reports the
    marginals, ``--online --window`` (A13) streams the lines (one line per
    arrival, the ATE, the per-line estimates; no marginals, no metrics
    file), ``--detected --descriptor orb`` (A11) matches ORB bits."""
    from diasss_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    if item == "A9":
        assert main(survey_dirs + flags) == 0
        m = json.loads((tmp_path / "m.json").read_text())
        assert len(m["pose_sigma_mean"]) == 6 and m["pose_sigma_max_xy"] > 0
        return
    if item == "A13":
        assert main(survey_dirs + flags) == 0
        out = capsys.readouterr().out
        assert "frame 0 (0): estimate over 120 pings" in out and "frame 1 (1): estimate over 240 pings" in out
        assert "ATE DR/EST:" in out
        assert sorted(p.name for p in (tmp_path / "online").iterdir()) == \
            ["online_est_poses_0.txt", "online_est_poses_1.txt"]
        assert not (tmp_path / "m.json").exists()
        return
    if item == "A11":
        assert main(survey_dirs + flags + ["--no-eval2"]) == 0
        assert "ATE DR/EST:" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as exc:
        main(survey_dirs + flags)
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_cli_trace_writes_a_chrome_trace_and_reports_the_reader(survey_dirs, tmp_path, capsys):
    """``--trace DIR``: a ``torch.profiler`` Chrome trace of the solve (CPU
    activity here; on the card also CUDA kernels, chip_smoke.py); the load
    line names the reader that ran."""
    from diasss_tpu_torch.cli import main

    assert main(survey_dirs + ["--trace", str(tmp_path / "trace"), "--no-eval2"]) == 0
    out = capsys.readouterr().out
    assert "pipelined" in out and "reader: native" in out
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    events = trace["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert any("solve" in e.get("name", "") or "linalg" in e.get("name", "") for e in events)
