"""A configuration joins the benchmark as new files and entries only: its
pipeline profile and plain reference found by name, its check numbers the
reference's own; the refusals; ``anno20`` read through the lookup as
before; and the program's spans handed to the metric readers."""

import hashlib
import json
import shutil
from typing import NamedTuple

import pytest
import torch

from benchmark import check, devtrace, harness, plainref, registry as reg, slampass, synthetic, traffic

from .conftest import ROOT, tiny_plan

SEED = 4294967311
CPU = torch.device("cpu")

STUB_REFERENCE = '''"""A stand-in reference: it counts the survey's pings and holds each pass's
estimated poses to that count."""

PROFILE = {"profile": "automatic", "args": {"drift_budget": 4.0}}
NUMBERS = ("pings_missing",)


def run(survey, control=False):
    return {"pings": sum(len(line.dr_poses) for line in survey.lines)}


def outputs(record):
    return {"pings": int(record.result.poses.t.shape[0])}


def numbers(passes, ref):
    return {"pings_missing": [abs(p["pings"] - ref["pings"]) for p in passes]}
'''


def _tree_digest(path):
    files = sorted(p for p in path.rglob("*") if p.is_file() and "__pycache__" not in p.parts)
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def _throwaway(tmp_path, spec, **config):
    """A copy of the spec and of the benchmark's data files in ``tmp_path``,
    with one more configuration, ``auto_tiny`` (automatic profile, the stub
    reference above), and its cell ``auto_tiny.batch``."""
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, root / sub)
    shutil.copy(ROOT / "benchmark" / "plainref.py", root)
    (root / "stubref.py").write_text(STUB_REFERENCE)
    cfg = {"name": "auto_tiny", "survey": dict(n_lines=20, n_pings=400, n_bins=512, n_landmarks=1200),
           "tiny_survey": dict(n_lines=2, n_pings=120, n_bins=256, n_landmarks=40),
           "pipeline": {"profile": "automatic", "args": {"drift_budget": 4.0}}, "reference": "stubref",
           "precision": "float32", "reduced": [], "assumed": {}, "check": {"pings_missing": 0},
           "warmup_passes": 1}
    cfg.update(config)
    (root / "configs" / "auto_tiny.json").write_text(json.dumps(cfg))
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "auto_tiny", "source": "test", "file": "benchmark/configs/auto_tiny.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "auto_tiny.batch", "config": "auto_tiny", "traffic": "batch", "chips": 1,
                             "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    return reg.Registry(tmp_path / "BENCHMARK.json", root=root)


def test_a_throwaway_configuration_runs_without_harness_edits(tmp_path, spec):
    """A second configuration with a non-default profile and a reference of
    its own is planned and run, one tiny pass on the CPU, with every file
    of the benchmark as it is."""
    before = _tree_digest(ROOT / "benchmark"), (ROOT / "BENCHMARK.json").read_bytes()
    r = _throwaway(tmp_path, spec)
    plan = tiny_plan(r, "auto_tiny.batch")
    assert plan.reference.PROFILE == plan.config["pipeline"] and plan.per_layer == []
    out = harness.run_cell(plan, r, SEED, 0.0, False, CPU, 0.0)
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert out["numbers"] == {"pings_missing": (0.0, 0.0)}
    assert set(out["metrics"]) == {"pings_per_s", "setup_s"}
    assert r.plan("anno20.batch").reference.PROFILE == {"profile": "default"}
    assert (_tree_digest(ROOT / "benchmark"), (ROOT / "BENCHMARK.json").read_bytes()) == before


def test_the_profile_is_found_by_name():
    from diasss_tpu_torch import config

    assert slampass.pipeline_config(config, {"profile": "default"}) == config.PipelineConfig()
    assert slampass.pipeline_config(config, {"profile": "default", "args": {}}) == config.PipelineConfig()
    assert (slampass.pipeline_config(config, {"profile": "automatic", "args": {"drift_budget": 8.0}})
            == config.automatic_config(drift_budget=8.0))
    assert slampass.pipeline_config(config, {"profile": "pair_mode"}) == config.pair_mode_config()


@pytest.mark.parametrize("pipeline", [
    {"profile": "nosuch"},  # an unknown profile
    {"profile": "automatic", "args": {"budget": 4.0}},  # an argument the profile does not take
    {"profile": "default", "args": {"drift_budget": 4.0}},  # a constant takes none
    {"profile": "detected"},  # a profile whose arguments cannot be given as data
    {"profile": "default", "extra": 1},
    {"args": {}},
])
def test_refused_profiles(pipeline):
    from diasss_tpu_torch import config

    with pytest.raises(ValueError):
        slampass.pipeline_config(config, pipeline)


@pytest.mark.parametrize("change", [
    {"pipeline": {"profile": "automatic", "args": {"drift_budget": 8.0}}},  # not the profile the reference states
    {"pipeline": {"profile": "default"}},
    {"check": {"pings_missing": 0, "pose_gap_m": 1.0}},  # a number the reference does not form
    {"reference": "../plainref"},
    {"reference": "nosuchref"},
])
def test_refused_configurations(tmp_path, spec, change):
    r = _throwaway(tmp_path, spec, **change)
    with pytest.raises((ValueError, FileNotFoundError)):
        r.plan("auto_tiny.batch")


def test_a_limit_on_a_number_not_formed_raises_and_one_not_formable_fails():
    with pytest.raises(ValueError):
        check.compare({"a": 0.0}, {"a": 1.0, "b": 1.0})
    numbers, failed = check.compare({"a": [0.5, float("nan"), 2.0], "b": None}, {"a": 1.0, "b": 1.0})
    assert numbers == {"a": (float("inf"), 1.0), "b": (float("inf"), 1.0)} and failed == 2
    numbers, failed = check.compare({"a": [0.5, 0.25], "b": 3.0}, {"a": 1.0})
    assert numbers == {"a": (0.5, 1.0)} and failed == 0 and check.passed(numbers, failed)


# --- anno20 through the lookup, and the spans that reach the readers -----------------------------

# the parent commit's check numbers of the tiny anno20 pass at SEED on the CPU,
# through its direct calls (slampass.outputs, plainref.run, check.compare)
PARENT = {"pose_gap_m": float.fromhex("0x1.a17daaa477c25p-15"), "lc_flips": 0.0,
          "lc_gap_m": float.fromhex("0x1.c2f48bde56401p-18")}


@pytest.fixture(scope="module")
def anno20_runs():
    r = reg.Registry(harness.SPEC)
    plan = tiny_plan(r, "anno20.batch")
    return plan, {trace: harness.run_cell(plan, r, SEED, 0.0, trace, CPU, 0.0) for trace in (False, True)}


def test_anno20_reads_as_before(anno20_runs):
    """The lookup gives the parent's check numbers bit for bit, and the same
    as the direct calls of the moved arithmetic on the same pass."""
    plan, runs = anno20_runs
    assert plan.reference.PROFILE == plan.config["pipeline"]
    pkg = harness.program()
    mix = traffic.check_mix(plan.mix)
    checked = traffic.order(SEED, len(mix["survey_seeds"]))[0]
    survey = synthetic.make_survey(**plan.config["survey"], seed=mix["survey_seeds"][checked])
    cfg = slampass.pipeline_config(pkg.config, plan.config["pipeline"])
    prog = plainref.outputs(slampass.make_pass(pkg, *slampass.survey_items(survey), cfg, CPU)())
    ref = plainref.run(survey)
    flips, gap = plainref.lc_numbers(prog, ref)
    direct = {"pose_gap_m": plainref.pose_gap(prog, ref), "lc_flips": flips, "lc_gap_m": gap}
    for out in runs.values():
        assert out["correct"] and out["failed"] == 0
        assert {k: v for k, (v, _) in out["numbers"].items()} == direct == PARENT
        assert {k: lim for k, (_, lim) in out["numbers"].items()} == plan.config["check"]


def test_spans_reach_the_readers(anno20_runs):
    """The traced run's pose-graph span metrics read from the program's
    spans; the untraced run records none and reports only end-to-end
    metrics; idle gaps are named by program spans."""
    plan, runs = anno20_runs
    traced = runs[True]["metrics"]
    assert {m["name"] for m in plan.per_layer} - set(traced) == {"device.idle_pct.batch"}  # no device here
    assert traced["pose_graph.trial_s"]["value"] > 0 and traced["pose_graph.read_wait_s"]["value"] > 0
    assert traced["pose_graph.trial_s"]["value"] < traced["pose_graph.stage_s"]["value"]
    assert set(runs[False]["metrics"]) == {"pings_per_s", "setup_s"}
    labels = [name.split(" > ")[0] for name, _ in runs[True]["breakdown"]["idle_gaps"]]
    assert labels and all(lab != "-" and not lab.startswith("benchmark.") for lab in labels)


class _Ev(NamedTuple):
    """A ``_KinetoEvent``'s methods that :func:`devtrace.events_of` reads."""

    name_: str
    start: int
    dur: int
    on_device: bool
    annotation: bool = False
    tid: int = 1

    def name(self):
        return self.name_

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.on_device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.annotation

    def start_thread_id(self):
        return self.tid


def test_events_keep_program_spans_apart_from_device_work():
    """The stretch is found; a program span is a span on the host and its
    mirror on the device's timeline is no device work, whether or not the
    profiler marks the mirror as an annotation."""
    events = [
        _Ev(devtrace.STRETCH_SPAN, 0, 100, False, True),
        _Ev("pose_graph.trial", 5, 55, False, True),
        _Ev("pose_graph.read", 40, 10, False, True, tid=2),  # another thread's
        _Ev("aten::mm", 8, 6, False),
        _Ev("pose_graph.trial", 11, 50, True, True),  # mirrors
        _Ev("pose_graph.trial", 11, 50, True, False),
        _Ev(devtrace.STRETCH_SPAN, 0, 100, True, False),
        _Ev("gemm_kernel", 20, 10, True),
    ]
    prof = type("Prof", (), {})()
    prof.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda self: events})()})()
    device, host, spans, lo, hi = devtrace.events_of(prof)
    assert [e.name for e in device] == ["gemm_kernel"]
    assert [e.name for e in host] == ["aten::mm"] and [e.name for e in spans] == ["pose_graph.trial"]
    assert (lo, hi) == (0, 100)
    s = devtrace.summarize(device, host, spans, lo, hi)
    assert s.ops == {"gemm_kernel": (pytest.approx(10e-9), 1)}
    assert dict(s.idle_gaps) == {"pose_graph.trial > aten::mm": pytest.approx(20e-9), "- > -": pytest.approx(70e-9)}
