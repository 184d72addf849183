"""The port's mission scripts (``diasss_tpu_torch/scripts/``) against the
JAX package, at reduced depth on the CPU.

The JAX scripts (``scripts/auto_scale.py``, ``scripts/stress_bench.py``)
act at import (a compile cache; argparse at module level), so their bodies
run here through the JAX package's public functions on the same
``make_survey`` arguments.  The port's ``main``s run as a user calls them,
with ``device="cpu"``; their initial-value noise is the JAX package's own
draws (``JaxRng``), as in the other parity tests.

* ``auto_scale.main(2, 1, 160)``: the mission survey at 2 main lines, 1 tie
  line and 160 pings (3 gated pairs, 2000 keypoint slots as on the card)
  against JAX ``run_slam(automatic_config())``: the same pairs, ATE DR
  within 1e-5 m, ATE EST within 0.1 m (the bound ``test_torch_auto.py``
  holds the port's own detector to), as many full-BA solves (JAX's CPU
  default, ``tridiag`` PCG, against the port's direct step).  Measured: 9
  correspondences in the last solve, 3 solves, ATE 0.8286 -> 0.2443 m (JAX
  0.2439 m).
* The mid-run cutover: ``main``'s warm-up pass, which it discards, runs
  with full BA's direct guard (``full_ba.MAX_DIRECT_KPAD``) patched below
  the last round's padded correspondence count (8, 8 and 16 in the three
  rounds), so one ``run_slam`` takes the direct step and then ``dense_seg``
  PCG; its ATE is within 5% of the timed pass's (the guard left alone), the
  chip smoke's gate of a full-BA PCG pass against the direct pass.
* ``stress_bench.main(lines=4, pings=200)`` against JAX
  ``run_slam(PipelineConfig())`` on frames built line by line: the same
  pairs and accepted loop closures, ATE EST within 1e-3 m.
* Both ``main``s raise without CUDA unless given the CPU.
"""

import contextlib
import io

import pytest
import torch

from torch_parity_helpers import JaxRng
from diasss_tpu.config import PipelineConfig as JaxPipelineConfig
from diasss_tpu.config import automatic_config as jax_automatic_config
from diasss_tpu.frame import build_keyframe as jax_build_keyframe
from diasss_tpu.frame import build_keyframes_batch as jax_build_keyframes_batch
from diasss_tpu.pipeline import run_slam as jax_run_slam
from diasss_tpu.synthetic import make_survey as jax_make_survey
from diasss_tpu_torch import pipeline
from diasss_tpu_torch.scripts import auto_scale, stress_bench
from diasss_tpu_torch.solvers import full_ba

MISSION = dict(n_lines=2, n_ties=1, n_pings=160)
STRESS = dict(lines=4, pings=200)
CUTOVER_KPAD = 8  # the reduced mission's rounds pad to 8, 8 and 16 correspondences


class _JaxNoise:
    """Stands in for ``pipeline.TorchRng``: each ``run_slam`` draws the JAX
    package's noise from the configuration's seeds."""

    @staticmethod
    def from_config(cfg, device):
        return JaxRng(cfg.matcher.rng_seed, cfg.pose_graph.seed)


@pytest.fixture(scope="module")
def port_mission():
    """``auto_scale.main`` at the reduced depth: (its dict, its printed
    lines, the warm-up pass's result with the guard patched, and each
    full-BA solve of that pass as (K_pad, the kind it took, the kind
    ``resolve_ba_solver_kind`` gives under the patched guard))."""
    runs, solves = [], []
    run_entry, solve_entry = auto_scale.run_once, full_ba.solve_full_ba

    def run_once(survey, cfg, device):
        with pytest.MonkeyPatch.context() as mp:
            if not runs:  # the warm-up pass
                mp.setattr(full_ba, "MAX_DIRECT_KPAD", CUTOVER_KPAD)
            runs.append(run_entry(survey, cfg, device))
        return runs[-1]

    def solve(prob, *args, **kwargs):
        out = solve_entry(prob, *args, **kwargs)
        if len(runs) == 0:
            P, K_pad = int(prob.poses0.t.shape[0]), int(prob.kp_i.shape[0])
            solves.append((K_pad, out[-1].solver_kind, full_ba.resolve_ba_solver_kind("auto", P, K_pad)))
        return out

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(pipeline, "TorchRng", _JaxNoise)
        mp.setattr(auto_scale, "run_once", run_once)
        mp.setattr(full_ba, "solve_full_ba", solve)
        got = auto_scale.main(**MISSION, device="cpu")
    assert len(runs) == 2
    return got, out.getvalue().splitlines(), runs[0][1], solves


@pytest.fixture(scope="module")
def jax_mission():
    survey = jax_make_survey(n_lines=MISSION["n_lines"], n_pings=MISSION["n_pings"], n_bins=512, n_landmarks=1200,
                             n_tie_lines=MISSION["n_ties"], drift_xy=0.004, seed=3)
    frames = jax_build_keyframes_batch(
        [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines])
    return jax_run_slam(frames, jax_automatic_config(), gt_rows_list=[l.gt_poses for l in survey.lines],
                        run_eval2=False)


def test_auto_scale_main_prints_the_four_lines(port_mission):
    got, lines, _, _ = port_mission
    assert len(lines) == 4
    assert lines[0].startswith("2+1 lines, 480 pings: wall ")
    assert lines[1].startswith("counters: ") and lines[2].startswith("times: ")
    assert lines[3] == f"accepted correspondences: {got['n_lc_accepted']} over {len(got['pair_ids'])} pairs"
    assert got["pings"] == 480 and got["wall"] > 0 and got["pings_per_sec"] == 480 / got["wall"]
    assert {"detect", "matching", "full_ba"} <= set(got["timings"])


def test_auto_scale_main_matches_jax(port_mission, jax_mission):
    got, ref = port_mission[0], jax_mission
    assert got["pair_ids"] == ref.pair_ids and len(ref.pair_ids) >= 3
    assert abs(got["ate_dr"] - ref.ate_dr) < 1e-5
    assert abs(got["ate_est"] - ref.ate_est) < 0.1
    assert got["ate_est"] < 0.5 * got["ate_dr"]
    assert got["counters"]["solver_direct_solves"] == ref.timings["solver_tridiag_solves"]
    assert got["n_lc_accepted"] > 0


def test_full_ba_cutover_mid_run(port_mission):
    got, _, cut, solves = port_mission
    assert all(kind == resolved for _, kind, resolved in solves), solves
    assert cut.counters["solver_direct_solves"] >= 1 and cut.counters["solver_dense_seg_solves"] >= 1
    assert cut.counters["solver_direct_solves"] + cut.counters["solver_dense_seg_solves"] == len(solves)
    assert got["counters"].get("solver_dense_seg_solves", 0) == 0  # the guard left alone: every solve direct
    assert abs(cut.ate_est - got["ate_est"]) <= 0.05 * got["ate_est"]


@pytest.fixture(scope="module")
def port_stress():
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(pipeline, "TorchRng", _JaxNoise)
        return stress_bench.main(**STRESS, device="cpu")


def test_stress_bench_main_matches_jax(port_stress):
    survey = jax_make_survey(n_lines=STRESS["lines"], n_pings=STRESS["pings"], n_bins=512, n_landmarks=600)
    frames = [jax_build_keyframe(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos)
              for l in survey.lines]
    ref = jax_run_slam(frames, JaxPipelineConfig(), gt_rows_list=[l.gt_poses for l in survey.lines],
                       run_eval2=False)
    got = port_stress
    assert got["poses"] == 800 and got["wall"] > 0
    assert got["pair_ids"] == ref.pair_ids and len(ref.pair_ids) >= 3
    assert got["n_lc_accepted"] == ref.n_lc_accepted > 0
    assert abs(got["ate_est"] - ref.ate_est) < 1e-3
    assert got["ate_est"] < got["ate_dr"]


@pytest.mark.parametrize("main", [auto_scale.main, stress_bench.main], ids=["auto_scale", "stress_bench"])
def test_mission_mains_raise_without_cuda(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main()
