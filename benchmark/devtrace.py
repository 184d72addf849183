"""The device trace of a profiled stretch, and what the metrics read of it.

``torch.profiler`` records the host's operations and the device's
activity (kernels, copies, sets) over a stretch of the traced run.  From
its events this module takes:

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies and sets; overlapping ones counted once) inside the stretch, and
  ``window_s``, the stretch's span on the profiler's clock;
* ``ops``: every device operation's seconds and count, by name;
* the ``breakdown``: the device operations that took the most time, and
  the idle gaps summed by what the host was running when they fell (the
  innermost ``record_function`` span, which is the program's innermost
  open span, and the innermost host operation at the gap's middle)."""

from typing import Dict, List, NamedTuple, Tuple

STRETCH_SPAN = "benchmark.stretch"  # the harness's record_function span around the stretch
TOP = 10


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class TraceSummary(NamedTuple):
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]  # the TOP operations by seconds
    idle_gaps: List[Tuple[str, float]]  # the TOP idle gaps by seconds
    n_device_events: int
    ops: Dict[str, Tuple[float, int]]  # every device operation's (seconds, count), by name


def union_seconds(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """``(busy_ns, gaps)``: the length of the union of ``intervals`` clipped
    to ``[lo, hi]``, and the uncovered ``(start, end)`` stretches of it."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _covering(events: List[Event], times: List[int]) -> List[str]:
    """For each of ``times`` (ascending), the name of the innermost event of
    ``events`` that covers it, ``"-"`` where none does.  Events of one
    thread nest, so a stack swept forward in time holds the open ones, the
    innermost on top."""
    events = sorted(events, key=lambda e: (e.start_ns, -e.end_ns))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(events) and events[k].start_ns <= t:
            while stack and stack[-1].end_ns < events[k].start_ns:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1].name if stack else "-")
    return out


def label_gaps(gaps: List[Tuple[int, int]], host: List[Event], spans: List[Event]) -> Dict[str, float]:
    """Gap seconds summed by ``"<span> > <host op>"`` at each gap's middle."""
    gaps = sorted(gaps)
    mids = [(s + e) // 2 for s, e in gaps]
    out: Dict[str, float] = {}
    for (s, e), span, op in zip(gaps, _covering(spans, mids), _covering(host, mids)):
        key = f"{span} > {op}"
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def summarize(device: List[Event], host: List[Event], spans: List[Event], lo: int, hi: int) -> TraceSummary:
    busy, gaps = union_seconds([(e.start_ns, e.end_ns) for e in device], lo, hi)
    ops: Dict[str, Tuple[float, int]] = {}
    for e in device:
        if e.end_ns <= lo or e.start_ns >= hi:
            continue
        s, k = ops.get(e.name, (0.0, 0))
        ops[e.name] = (s + (e.end_ns - e.start_ns) / 1e9, k + 1)
    idle = label_gaps(gaps, host, spans)
    top = sorted(((name, s) for name, (s, _) in ops.items()), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy / 1e9, (hi - lo) / 1e9, top, top_idle, sum(k for _, k in ops.values()), ops)


def events_of(prof):
    """``(device, host, spans, lo, hi)`` from a finished ``torch.profiler``
    run: device activity, host operations and ``record_function`` spans (the
    program's, which it opens under an active profiler) of the thread that
    opened the stretch, and the stretch's bounds."""
    import torch

    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    named = {e.name() for e in raw if e.device_type() != cuda and e.is_user_annotation()}
    device, cpu = [], []
    stretch = None
    for e in raw:
        start = e.start_ns()
        ev = (e.name(), start, start + e.duration_ns())
        if e.device_type() == cuda:
            # record_function spans, the program's and the stretch's, are
            # mirrored onto the device's timeline (gpu_user_annotation): they
            # are not device work
            if not (e.is_user_annotation() or ev[0] in named):
                device.append(Event(*ev))
        else:
            cpu.append((Event(*ev), e.start_thread_id(), e.is_user_annotation()))
            if ev[0] == STRETCH_SPAN:
                stretch = (Event(*ev), e.start_thread_id())
    if stretch is None:
        raise RuntimeError(f"the profiler recorded no {STRETCH_SPAN!r} span")
    (span, tid) = stretch
    host = [ev for ev, t, ann in cpu if t == tid and not ann]
    spans = [ev for ev, t, ann in cpu if t == tid and ann and ev.name != STRETCH_SPAN]
    return device, host, spans, span.start_ns, span.end_ns
