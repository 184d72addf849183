"""The port's spans (:mod:`diasss_tpu_torch.trace`) on a toy annotated survey.

``run_slam`` is run once plain and once inside ``trace.recording()``: the
results are bit-identical, ``timings`` has the same keys, ``counters`` are
equal, and the host reads a pass makes (``Tensor.item``, ``.tolist``,
``.cpu``, ``__bool__`` and the pipeline's synchronise) are the same count.
The recorded spans form a well-formed tree per run, carry the counts the
solvers compute, and, under ``torch.profiler``, appear as its user
annotations: each record lies inside its annotation to within 1 ms, and
the median gap at either end is under 1 ms."""

import contextlib
import json
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from diasss_tpu_torch import pipeline, trace
from diasss_tpu_torch.config import LoopClosureConfig, PipelineConfig
from diasss_tpu_torch.frame import build_keyframes_batch
from diasss_tpu_torch.solvers import pose_graph
from diasss_tpu_torch.synthetic import make_survey

CFG = PipelineConfig(loop_closure=LoopClosureConfig(max_lm_iters=8))  # a shorter LM keeps the file fast
STAGES = ("overlap_gate", "kps_assembly", "loop_closures", "lc_gate", "pose_graph", "evaluation", "result_fetch")
READS = ("item", "tolist", "cpu", "__bool__")
TOL_NS = 1_000_000  # the recording's clock against the profiler's


@pytest.fixture(scope="module")
def survey():
    return make_survey(n_lines=3, n_pings=150, n_bins=256, n_landmarks=40, seed=7)


@contextlib.contextmanager
def counted_reads(counts):
    """Count the host reads of the block in ``counts`` (name -> calls), and
    keep the pose graph's ``SolveInfo`` of each solve in ``counts['infos']``."""
    saved = [(torch.Tensor, name, getattr(torch.Tensor, name)) for name in READS]
    saved += [(pipeline, "_sync", pipeline._sync), (pose_graph, "solve_pose_graph", pose_graph.solve_pose_graph)]

    def counting(name, fn):
        def run(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    def solve(*args, **kwargs):
        poses, info = saved[-1][2](*args, **kwargs)
        counts.setdefault("infos", []).append(info)
        return poses, info

    try:
        for owner, name, fn in saved[:-1]:
            setattr(owner, name, counting(name, fn))
        pose_graph.solve_pose_graph = solve
        yield counts
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def one_pass(survey):
    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    frames = build_keyframes_batch(items, device="cpu")
    return pipeline.run_slam(frames, CFG, gt_rows_list=[l.gt_poses for l in survey.lines], run_eval2=False)


@pytest.fixture(scope="module")
def runs(survey):
    """``(plain result, its read counts, recorded result, its read counts, the
    recording)``; the plain pass runs under ``torch.profiler`` and counts the
    ``record_function`` spans it opens in its read counts."""
    real = torch.autograd.profiler.record_function

    def opened(*args, **kwargs):
        off_reads["record_function"] = off_reads.get("record_function", 0) + 1
        return real(*args, **kwargs)

    with counted_reads({}) as off_reads, profile(activities=[ProfilerActivity.CPU]):
        torch.autograd.profiler.record_function = opened
        try:
            off = one_pass(survey)
        finally:
            torch.autograd.profiler.record_function = real
    with counted_reads({}) as on_reads, trace.recording() as rec:
        on = one_pass(survey)
    return off, off_reads, on, on_reads, rec


def _leaves(result):
    return pytree.tree_leaves((result.poses, result.lc_results))


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)  # NaN rows (padding) compare too


def test_results_identical_with_recording_on_and_off(runs):
    off, _, on, _, rec = runs
    assert rec.spans and off.n_lc_accepted == on.n_lc_accepted > 0
    for a, b in zip(_leaves(off), _leaves(on), strict=True):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert (off.solve_error0, off.solve_error, off.ate_dr, off.ate_est) == \
        (on.solve_error0, on.solve_error, on.ate_dr, on.ate_est)
    assert sorted(off.timings) == sorted(on.timings) == sorted(STAGES)
    assert off.counters == on.counters
    assert off.pair_ids == on.pair_ids


def test_host_reads_equal_with_recording_on_and_off(runs):
    _, off_reads, _, on_reads, _ = runs
    keys = READS + ("_sync",)
    assert {k: off_reads.get(k, 0) for k in keys} == {k: on_reads.get(k, 0) for k in keys}
    assert off_reads["__bool__"] >= len(off_reads["infos"])  # a read per pose-graph trial at least


def test_recording_off_keeps_nothing_and_opens_no_profiler_span(runs):
    assert "record_function" not in runs[1]
    assert trace._active is None
    assert trace.span("lm.iteration") is trace.span("pose_graph.trial")  # one shared object: no allocation
    assert not trace.span("lm.iteration").recorded
    timings = {}
    with trace.span("stage", timings) as s:
        assert not s.recorded
    assert list(timings) == ["stage"] and timings["stage"] >= 0.0


def _children(spans):
    kids = {i: [] for i in range(len(spans))}
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def test_span_tree_is_well_formed(runs):
    spans = runs[4].spans
    kids = _children(spans)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["frame.build_keyframes", "run_slam"]
    assert spans[roots[0]].run != spans[roots[1]].run
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and i in kids[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.run == p.run
        own = (s.end_ns - s.start_ns) - sum(spans[k].end_ns - spans[k].start_ns for k in kids[i])
        assert own >= 0, s.name
    run_id = spans[roots[1]].run
    names = {s.name for s in spans if s.run == run_id}
    assert set(STAGES) | {"pose_graph.build", "pose_graph.solve", "lc.mini_solve", "lc.triangulate"} <= names
    for stage in STAGES:
        (i,) = [k for k, s in enumerate(spans) if s.name == stage]
        assert spans[i].parent == roots[1]


def _under(spans, name, ancestor):
    """Indices of the spans named ``name`` with an ancestor named ``ancestor``."""
    def has(i):
        while i >= 0:
            if spans[i].name == ancestor:
                return True
            i = spans[i].parent
        return False
    return [i for i, s in enumerate(spans) if s.name == name and has(s.parent)]


def test_spans_carry_the_solvers_counts(runs):
    _, _, on, on_reads, rec = runs
    spans = rec.spans
    max_lm = CFG.loop_closure.max_lm_iters
    assert len(_under(spans, "lm.iteration", "loop_closures")) == 2 * max_lm
    assert len(_under(spans, "lm.linearize", "loop_closures")) == 2 * (max_lm + 1)
    assert len(_under(spans, "lm.step", "lm.iteration")) == 2 * max_lm
    (info,) = on_reads["infos"]
    trials = _under(spans, "pose_graph.trial", "pose_graph.solve")
    assert len(trials) == info.iterations > 0
    for name in ("pose_graph.linearize", "pose_graph.step", "pose_graph.read"):
        assert len(_under(spans, name, "pose_graph.trial")) == info.iterations
    (solve,) = [s for s in spans if s.name == "pose_graph.solve"]
    assert solve.attrs == {"kind": info.solver_kind, "trials": info.iterations,
                           "cg_iters": info.cg_iters_total, "stall": info.stall}
    (lc,) = [s for s in spans if s.name == "loop_closures"]
    iters = torch.cat([r.lm_iters[r.valid] for r in on.lc_results.values()])
    assert lc.attrs == {"batch": sum(int(r.valid.shape[0]) for r in on.lc_results.values()),
                        "lm_iters_active": int(iters.max()), "unfrozen": int((iters == max_lm).sum())}


def test_recorded_spans_are_the_profilers_user_annotations(survey):
    with profile(activities=[ProfilerActivity.CPU]), trace.recording():
        with trace.span("warm-up"):  # the profiler's first annotation pays its set-up
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as rec:
        one_pass(survey)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert set(by_name) <= set(events)
    lead, lag = [], []
    for name, recorded in by_name.items():
        marks = sorted(events[name])
        assert len(marks) == len(recorded), name
        for (s0, s1), (e0, e1) in zip(recorded, marks):
            # the annotation opens before the record's clock read and closes
            # after it, so on one clock the record lies inside its annotation
            assert e0 - TOL_NS <= s0 <= s1 <= e1 + TOL_NS, name
            lead.append(s0 - e0)
            lag.append(e1 - s1)
    assert statistics.median(lead) < TOL_NS and statistics.median(lag) < TOL_NS


def test_cli_trace_carries_the_program_spans(survey, tmp_path):
    """``cli.py --trace DIR`` records the solve: its Chrome trace holds the
    program's spans as user annotations."""
    from diasss_tpu_torch.cli import _traced

    result = _traced(str(tmp_path), torch.device("cpu"), lambda: one_pass(survey))
    assert result.n_lc_accepted > 0 and trace._active is None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert set(STAGES) | {"run_slam", "lc.mini_solve", "lc.triangulate", "pose_graph.read"} <= set(names)
    assert names.count("lm.iteration") == 2 * CFG.loop_closure.max_lm_iters
    assert names.count("pose_graph.trial") == names.count("pose_graph.read") > 0
