"""The readers of the program's spans and the launch attribution
(:mod:`benchmark.spans`), on synthetic spans and events."""

from typing import NamedTuple

import pytest
import torch

from benchmark import spans

MS = 1_000_000


class Span(NamedTuple):
    """A record of ``diasss_tpu_torch.trace.recording()``, as the readers see it."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    attrs: dict


def one_pass(offset=0):
    """A pass's spans: an LC stage of two LM solves of two iterations each,
    then a pose graph of two trials (times in ms from ``offset``)."""
    def s(name, parent, a, b, **attrs):
        return Span(name, parent, (offset + a) * MS, (offset + b) * MS, attrs)

    return [
        s("run_slam", -1, 0, 100),
        s("loop_closures", 0, 1, 50, lm_iters_active=2),  # 1
        s("lc.mini_solve", 1, 2, 30),  # 2
        s("lm.iteration", 2, 3, 13),  # 3
        s("lm.linearize", 3, 3, 10),
        s("lm.step", 3, 10, 13),
        s("lm.iteration", 2, 13, 23),  # 6
        s("lm.linearize", 6, 13, 20),
        s("lm.step", 6, 20, 23),
        s("lm.linearize", 2, 23, 27),
        s("lc.triangulate", 1, 31, 45),  # 10
        s("lm.iteration", 10, 31, 36),  # 11
        s("lm.linearize", 11, 31, 34),
        s("lm.iteration", 10, 36, 41),  # 13
        s("lm.linearize", 13, 36, 39),
        s("lm.linearize", 10, 41, 43),
        s("pose_graph", 0, 60, 99),  # 16
        s("pose_graph.solve", 16, 62, 98, trials=2),  # 17
        s("pose_graph.trial", 17, 62, 80),  # 18
        s("pose_graph.read", 18, 75, 80),
        s("pose_graph.trial", 17, 80, 94),  # 20
        s("pose_graph.read", 20, 91, 94),
        s("lm.iteration", -1, 200, 210),  # outside any LC stage: not counted
    ]


def test_readers_of_one_pass():
    p = one_pass()
    assert spans.lc_lm_iters([p]) == 4
    assert spans.lc_jacobian_s([p]) == pytest.approx((7 + 7 + 4 + 3 + 3 + 2) / 1e3)
    assert spans.pose_graph_trial_s([p]) == pytest.approx((18 + 14) / 2 / 1e3)
    assert spans.pose_graph_read_wait_s([p]) == pytest.approx((5 + 3) / 1e3)


def test_readers_average_over_passes():
    a, b = one_pass(), one_pass(1000)[:16]  # the second pass has no pose graph
    assert spans.lc_lm_iters([a, b]) == 4
    assert spans.pose_graph_read_wait_s([a, b]) == pytest.approx(8 / 2 / 1e3)
    assert spans.pose_graph_trial_s([a, b]) == pytest.approx(16 / 1e3)  # a mean over trials, not passes


def test_readers_of_a_program_without_spans_read_nothing():
    for read in (spans.lc_jacobian_s, spans.lc_lm_iters, spans.pose_graph_trial_s, spans.pose_graph_read_wait_s):
        assert read([]) is None
        assert read([[], []]) is None
    assert spans.lc_launches_per_iter([], [5, 6]) is None


def test_innermost_span_at_each_time():
    p = one_pass()
    times = [t * MS for t in (0.5, 4, 11, 27.5, 35, 70, 77, 99.5, 150, -1)]
    names = [p[i].name if i >= 0 else "-" for i in spans.innermost(p, times)]
    assert names == ["run_slam", "lm.linearize", "lm.step", "lc.mini_solve", "lm.iteration",
                     "pose_graph.trial", "pose_graph.read", "run_slam", "-", "-"]


class Ev(NamedTuple):
    """A ``_KinetoEvent``'s methods the attribution reads."""

    name_: str
    cid: int
    start: int
    on_device: bool
    annotation: bool = False

    def correlation_id(self):
        return self.cid

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.on_device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start


def test_launches_join_device_work_to_the_host_call_by_correlation_id():
    events = [
        Ev("cudaLaunchKernel", 7, 4 * MS, False),
        Ev("kernel_a", 7, 90 * MS, True),  # runs late, launched at 4 ms
        Ev("cudaMemcpyAsync", 8, 11 * MS, False),
        Ev("memcpy", 8, 12 * MS, True),
        Ev("cudaLaunchKernel", 9, 35 * MS, False),
        Ev("kernel_b", 9, 36 * MS, True),
        Ev("cudaLaunchKernel", 10, 77 * MS, False),
        Ev("kernel_c", 10, 78 * MS, True),
        Ev("kernel_lost", 11, 40 * MS, True),  # no host call recorded: left out
        Ev("lm.iteration", 12, 3 * MS, True, annotation=True),  # a span's mirror: not device work
        Ev("aten::mul", 0, 4 * MS, False),
    ]
    launches = spans.launch_times(events)
    assert sorted(launches) == [4 * MS, 11 * MS, 35 * MS, 77 * MS]
    p = one_pass()
    assert spans.launches_per_span(p, launches, "lm.iteration", "loop_closures") == (3, 4)
    assert spans.lc_launches_per_iter(p, launches) == pytest.approx(3 / 4)
    assert spans.launches_per_span(p, launches, "pose_graph.trial") == (1, 2)
    assert spans.launches_per_span(p, launches, "lm.step", "lc.mini_solve") == (1, 2)
