"""The annotated crossing survey under joint bundle adjustment (the
benchmark's ``annofba20`` configuration) on the CPU at its ``tiny_survey``:
the port held to the plain sparse-LM reference (``benchmark/plainref_fba.py``)
inside the configuration's limits, the full-BA spans with their parents and
attributes, the configuration's profile found by name, the cell's three
readers on a recorded pass, and planted faults that read ``correct`` false."""

import ast
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, harness, registry as reg, slampass, synthetic  # noqa: E402

CELL = "annofba20.batch"
SEED = 4294967311
CPU = torch.device("cpu")
FULL_BA_SPANS = ("full_ba.build", "full_ba.solve", "full_ba.trial", "full_ba.linearize", "full_ba.step",
                 "full_ba.read")


@pytest.fixture(scope="module")
def plan():
    r = reg.Registry(harness.SPEC)
    return r, r.plan(CELL)


@pytest.fixture(scope="module")
def survey(plan):
    return synthetic.make_survey(**plan[1].config["tiny_survey"], seed=SEED)


@pytest.fixture(scope="module")
def reference(plan, survey):
    return plan[1].reference.run(survey)


def _pass(plan, survey, cfg=None):
    """One recorded pass of the port: its ``PassRecord`` and spans."""
    pkg = harness.program()
    cfg = cfg or slampass.pipeline_config(pkg.config, plan[1].config["pipeline"])
    one_pass = slampass.make_pass(pkg, *slampass.survey_items(survey), cfg, CPU)
    return harness.recorded(pkg, one_pass)


@pytest.fixture(scope="module")
def recorded(plan, survey):
    return _pass(plan, survey)


def _numbers(plan, record, ref):
    ref_mod = plan[1].reference
    return check.compare(ref_mod.numbers([ref_mod.outputs(record)], ref), plan[1].config["check"])


def test_profile_is_found_by_name(plan):
    from diasss_tpu_torch import config

    cfg = slampass.pipeline_config(config, plan[1].config["pipeline"])
    assert cfg == config.annotated_full_ba_config() == config.PipelineConfig(
        min_overlap=0.1, estimator="full_ba", full_ba=config.FullBAConfig(preconditioner="direct"))
    assert plan[1].reference.PROFILE == plan[1].config["pipeline"]


def test_port_holds_to_the_plain_reference(plan, recorded, reference):
    """Every number well inside its limit; the landmarks in the problem's
    order, one per nadir-passing keypoint pair of the gated pairs."""
    record, _ = recorded
    result = record.result
    assert result.landmarks is not None and result.landmarks.shape == reference["landmarks"].shape
    assert len(result.pair_ids) == 6 and 40 <= result.landmarks.shape[0] <= 128
    numbers, failed = _numbers(plan, record, reference)
    assert check.passed(numbers, failed), numbers
    assert all(v <= 0.01 * lim for v, lim in numbers.values()), numbers


def test_full_ba_spans_and_counter(recorded):
    record, spans = recorded
    by_name = {}
    for k, s in enumerate(spans):
        by_name.setdefault(s.name, []).append(k)
    assert set(FULL_BA_SPANS) <= set(by_name)

    def parent(k):
        return spans[spans[k].parent].name

    trials = record.result.counters["full_ba_trials"]
    assert 1 <= trials <= 40
    assert [parent(k) for k in by_name["full_ba.build"]] == ["full_ba"]
    assert [parent(k) for k in by_name["full_ba.solve"]] == ["full_ba"]
    for name, up in (("full_ba.trial", "full_ba.solve"), ("full_ba.linearize", "full_ba.trial"),
                     ("full_ba.step", "full_ba.trial"), ("full_ba.read", "full_ba.trial")):
        assert len(by_name[name]) == trials and {parent(k) for k in by_name[name]} == {up}, name
    attrs = spans[by_name["full_ba.solve"][0]].attrs
    P = int(record.result.poses.t.shape[0])
    K = int(record.result.landmarks.shape[0])
    K_pad = 2 ** math.ceil(math.log2(K))
    assert attrs == {"kind": "direct", "P": P, "K": K, "K_pad": K_pad, "k_cols": min(K_pad, max(128, -(-K // 128) * 128)),
                     "trials": trials, "stall": attrs["stall"], "cg_iters": 0}
    assert attrs["stall"] in (0, 2)
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)


def test_readers_on_a_recorded_pass(plan, recorded):
    record, spans = recorded
    ctx = harness.Context([record.stages], None, [spans], [])
    readers = plan[0].readers(plan[1])
    assert set(readers) == {"full_ba.stage_s", "full_ba.trial_s", "full_ba.read_wait_s"}
    stage, trial, wait = (readers[n].read(ctx) for n in ("full_ba.stage_s", "full_ba.trial_s", "full_ba.read_wait_s"))
    trials = record.result.counters["full_ba_trials"]
    assert stage == record.stages["full_ba"] > 0
    assert 0 < wait < trials * trial < stage
    # a program without the spans gives the readers nothing to read
    bare = harness.Context([{"keyframes": 1.0}], None, [[]], [])
    assert [readers[n].read(bare) for n in readers] == [None] * 3


def test_the_control_solves(plan, survey, reference):
    """The control, in the precision below the configuration's, takes the
    poses the whole way from DR towards the minimum: it stops under a
    tenth of the DR drift from the reference, so its reading is what the
    lower precision does to a solve, not a solve left undone."""
    from benchmark import plainref

    ref_mod = plan[1].reference
    control = ref_mod.run(survey, control=True)
    dr = np.concatenate([line.dr for line in plainref.survey_lines(survey)])[:, 3:6]
    drift = plainref.pose_gap({"poses_t": dr}, reference)
    assert drift > 0.5
    assert plainref.pose_gap(control, reference) < 0.1 * drift
    assert ref_mod.lm_gap(control, reference) < 0.1 * drift


@pytest.mark.parametrize("fault", ["huber_off", "prior_z_sigma", "half_pairs"])
def test_planted_fault_is_not_correct(plan, recorded, survey, reference, monkeypatch, fault):
    """The Huber loss off or the landmark prior's z sigma changed moves the
    answers by more than ten times the sound run's own gaps: read against
    those limits, they are not correct.  (The configuration's limits are
    set from 12,000-pose readings; the tiny survey's whole drift is ~1.3 m,
    so a wrong cost there stays under them.)  Half of the gated pairs left
    out changes the landmark count, which reads infinite under the
    configuration's own limits."""
    from diasss_tpu_torch import config, pipeline

    sound, _ = _numbers(plan, recorded[0], reference)
    limits = {name: 10 * value for name, (value, _) in sound.items()}
    cfg = config.annotated_full_ba_config()
    if fault == "half_pairs":
        gate = pipeline._overlap_pairs
        monkeypatch.setattr(pipeline, "_overlap_pairs", lambda *a, **k: gate(*a, **k)[::2])
        limits = plan[1].config["check"]
    else:
        change = {"huber_off": dict(huber_delta=0.0), "prior_z_sigma": dict(lm_prior_z_sigma=0.5)}[fault]
        cfg = dataclasses.replace(cfg, full_ba=dataclasses.replace(cfg.full_ba, **change))
    record, _ = _pass(plan, survey, cfg)
    ref_mod = plan[1].reference
    numbers, failed = check.compare(ref_mod.numbers([ref_mod.outputs(record)], reference), limits)
    assert not check.passed(numbers, failed), numbers


def test_the_cell_is_new_entries_only(plan):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = [w for w in spec["workloads"] if w["name"] == CELL]
    assert cell == [dict(cell[0], chips=1, config="annofba20", traffic="batch")]
    assert [m["name"] for m in plan[1].per_layer] == ["full_ba.stage_s", "full_ba.trial_s", "full_ba.read_wait_s"]
    tree = ast.parse((ROOT / "benchmark" / "plainref_fba.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported == {"math", "sys", "time", "typing", "numpy", "scipy.sparse", "scipy.sparse.linalg", "benchmark"}
