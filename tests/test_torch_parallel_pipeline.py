"""``run_slam`` and ``OnlineSlam`` with ``mesh_devices=2`` on gloo ranks
(CPU) against the JAX package's own runs with ``mesh_devices=2`` on the
virtual CPU mesh, on a tiny survey (3 lines of 120 x 256).

Both sides start from the same keyframes (carried over by
``diasss_tpu_torch.convert``), the same initial-noise draws (the JAX
package's, replayed in the ranks) and, on the automatic path, the JAX
detector's keypoints.  The linear solves are named (``tridiag``) on both
sides.  The data-parallel matchers (the stacked keypoint matcher, the dense
matcher and the ring NN search) are held to their single-device paths on
the same rank, row for row.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parallel_helpers import Ranks
from torch_parity_helpers import JaxRng, jax_and_port_frames

N = 2
AUTO_KPS = 200
AUTO_REMATCH = 0
WINDOW = 2


def _jax_cfg(name):
    from diasss_tpu.config import FullBAConfig, PipelineConfig, PoseGraphConfig, automatic_config

    if name == "two_stage":
        return PipelineConfig(pose_graph=PoseGraphConfig(preconditioner="tridiag"), mesh_devices=N)
    if name == "full_ba":
        return PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="tridiag"),
                              mesh_devices=N)
    auto = automatic_config()
    return dataclasses.replace(auto, detector=dataclasses.replace(auto.detector, n_features=AUTO_KPS),
                               full_ba=dataclasses.replace(auto.full_ba, preconditioner="tridiag"),
                               rematch_iters=AUTO_REMATCH, rematch_stop_resid_cells=0.0, mesh_devices=N)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from diasss_tpu.features import detect_features
    from diasss_tpu.synthetic import make_survey
    from diasss_tpu_torch.convert import to_torch

    survey = make_survey(n_lines=3, n_pings=120, n_bins=256, n_landmarks=60, seed=3)
    jf, tf = jax_and_port_frames(survey)
    feats = [detect_features(f.norm, f.mask, _jax_cfg("auto").detector) for f in jf]
    tmp = tmp_path_factory.mktemp("pipe")
    torch.save(tf, tmp / "frames.pt")
    torch.save([to_torch(f, device="cpu") for f in feats], tmp / "feats.pt")
    P = sum(int(f.dr_poses.shape[0]) for f in jf)
    gt = [l.gt_poses for l in survey.lines]
    inp = {"frames_path": str(tmp / "frames.pt"), "feats_path": str(tmp / "feats.pt"), "mesh_devices": N,
           "auto_kps": AUTO_KPS, "auto_rematch": AUTO_REMATCH, "online_window": WINDOW,
           "noise": JaxRng().normal((P, 6)).numpy(), "match_pairs": np.asarray([(0, 1), (0, 2), (1, 2)]),
           **{f"gt_{k}": g for k, g in enumerate(gt)}}
    # one world per pipeline run and one for the rest, all started together
    ranks = {name: Ranks(tmp / name, N, ["pipeline"], {**inp, "pipeline_names": name})
             for name in ("two_stage", "full_ba", "auto")}
    ranks["rest"] = Ranks(tmp / "rest", N, ["matchers", "online", "mesh_errors"], inp)
    return dict(jf=jf, feats=feats, gt=gt, ranks=ranks)


@pytest.mark.parametrize("name, tol", [("two_stage", 1e-3), ("full_ba", 1e-3), ("auto", 0.02)])
def test_run_slam_on_a_mesh_matches_jax(setup, name, tol):
    from diasss_tpu.pipeline import run_slam

    ref = run_slam(setup["jf"], _jax_cfg(name), gt_rows_list=setup["gt"], run_eval2=False,
                   feats=setup["feats"] if name == "auto" else None)
    res = setup["ranks"][name].wait()
    for out in res:
        assert [tuple(p) for p in out[f"pipeline/{name}_pairs"]] == ref.pair_ids
        assert abs(float(out[f"pipeline/{name}_ate_dr"]) - ref.ate_dr) < 1e-5
        assert abs(float(out[f"pipeline/{name}_ate_est"]) - ref.ate_est) < tol
        np.testing.assert_array_equal(out[f"pipeline/{name}_t"], res[0][f"pipeline/{name}_t"])
        counters = eval(str(out[f"pipeline/{name}_counters"]))
        assert counters.get("solver_sp_tridiag_solves") == ref.timings.get("solver_sp_tridiag_solves") >= 1
        if name == "auto":
            assert counters["match_mesh_devices"] == ref.timings["match_mesh_devices"] > 0
            assert abs(int(out[f"pipeline/{name}_n_lc"]) - ref.n_lc_accepted) <= 0.03 * ref.n_lc_accepted
        else:
            assert int(out[f"pipeline/{name}_n_lc"]) == ref.n_lc_accepted > 0
            assert float(out[f"pipeline/{name}_ate_est"]) < float(out[f"pipeline/{name}_ate_dr"])


@pytest.mark.parametrize("matcher", ["dense", "kp"])
def test_data_parallel_matchers_equal_single_device_rows(setup, matcher):
    res = setup["ranks"]["rest"].wait()
    total = 0
    for out in res:
        for (i, j) in [(0, 1), (0, 2), (1, 2)]:
            rows = out[f"matchers/{matcher}_{i}_{j}"]
            np.testing.assert_array_equal(rows, out[f"matchers/{matcher}_single_{i}_{j}"])
            np.testing.assert_array_equal(rows, res[0][f"matchers/{matcher}_{i}_{j}"])
            total += len(rows)
    assert total > 0


def test_ring_matcher_equals_single_device_rows(setup):
    for out in setup["ranks"]["rest"].wait():
        np.testing.assert_array_equal(out["matchers/ring_rows"], out["matchers/ring_single_rows"])
        assert len(out["matchers/ring_rows"]) > 0


def test_online_full_ba_on_a_mesh_matches_jax(setup):
    from diasss_tpu.config import FullBAConfig, PipelineConfig
    from diasss_tpu.online import OnlineSlam

    cfg = PipelineConfig(min_overlap=0.1, estimator="full_ba", full_ba=FullBAConfig(preconditioner="tridiag"),
                         mesh_devices=N)
    slam = OnlineSlam(cfg, window_frames=WINDOW)
    ref = [np.asarray(slam.add_frame(f).t) for f in setup["jf"]]
    for out in setup["ranks"]["rest"].wait():
        assert str(out["online/kind"]) == "sp_tridiag"
        for k, t in enumerate(ref):
            np.testing.assert_allclose(out[f"online/t{k}"], t, rtol=0, atol=1e-3)


def test_mesh_larger_than_the_world_raises(setup):
    for out in setup["ranks"]["rest"].wait():
        msgs = [str(m) for m in out["mesh_errors/msgs"]]
        assert all(f"needs a process group of {2 * N} ranks, this one has {N}" in m for m in msgs), msgs
