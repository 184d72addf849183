"""Spans and counts of the program's own work, on the profiler's clock.

A span marks a stretch of the host's work by name::

    with trace.span("pose_graph", timings):  # adds its seconds to timings["pose_graph"]
        ...
    with trace.span("pose_graph.solve") as s:
        ...
        if s.recorded:
            s.set(trials=k)

Outside :func:`recording`, a span without ``timings`` costs one flag check:
no clock read, no record, no profiler call; a span with ``timings`` reads
the clock twice.  Inside ``with recording() as rec:`` every span of every
thread is kept in ``rec.spans`` as a :class:`SpanRecord` (its parent, its
start and end in nanoseconds on the profiler's clock, the id of the root
span it belongs to, its attributes), and under an active
``torch.profiler`` it also opens ``record_function(name)``, so that the
device trace carries it.  Nothing is written anywhere while spans are
recorded.

The profiler's events carry Unix-epoch nanoseconds (``_KinetoEvent.
start_ns()``); the recording reads ``time.perf_counter_ns()`` and adds an
offset to the epoch clock taken once, when it starts."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_active: Optional["Recording"] = None
_run_ids = itertools.count(1)


@dataclasses.dataclass
class SpanRecord:
    name: str
    parent: int  # index of the enclosing span in Recording.spans, -1 for a root
    start_ns: int  # on the profiler's clock (Unix epoch)
    end_ns: int  # -1 while the span is open
    run: int  # id of the root span: shared by every span of one run_slam call
    attrs: dict


def _epoch_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the closest of a
    few back-to-back pairs of readings."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        epoch = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, epoch - (a + b) // 2)
    return best[1]


class Recording:
    """The spans of one :func:`recording` block, in the order they opened."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.offset_ns = _epoch_offset_ns()
        self.lock = threading.Lock()  # spans of several threads share ``spans``
        self._local = threading.local()  # each thread's stack of open span indices

    def stack(self) -> list:
        if not hasattr(self._local, "open"):
            self._local.open = []
        return self._local.open


class _Span:
    __slots__ = ("name", "timings", "rec", "attrs", "t0", "index", "fn")

    def __init__(self, name: str, timings: Optional[Dict[str, float]], rec: Optional[Recording], attrs: dict):
        self.name, self.timings, self.rec, self.attrs = name, timings, rec, attrs
        self.fn = None

    @property
    def recorded(self) -> bool:
        return self.rec is not None

    def set(self, **attrs) -> None:
        """Add attributes to the span's record (small ints, short strings)."""
        if self.rec is not None:
            self.rec.spans[self.index].attrs.update(attrs)

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            if torch.autograd._profiler_enabled():
                self.fn = torch.autograd.profiler.record_function(self.name)
                self.fn.__enter__()
            stack = rec.stack()
            parent = stack[-1] if stack else -1
            with rec.lock:
                run = rec.spans[parent].run if stack else next(_run_ids)
                self.index = len(rec.spans)
                rec.spans.append(SpanRecord(self.name, parent, 0, -1, run, self.attrs))
            stack.append(self.index)
        self.t0 = time.perf_counter_ns()
        if rec is not None:
            rec.spans[self.index].start_ns = self.t0 + rec.offset_ns
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.timings is not None:
            self.timings[self.name] = self.timings.get(self.name, 0.0) + (t1 - self.t0) / 1e9
        rec = self.rec
        if rec is not None:
            rec.spans[self.index].end_ns = t1 + rec.offset_ns
            rec.stack().pop()
            if self.fn is not None:
                self.fn.__exit__(*exc)
        return False


class _Off:
    """The span outside a recording when no ``timings`` is given."""

    recorded = False

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, timings: Optional[Dict[str, float]] = None, **attrs):
    """A context manager around one stretch of work named ``name``; with
    ``timings``, its seconds are added to ``timings[name]``."""
    rec = _active
    if rec is None and timings is None:
        return _OFF
    return _Span(name, timings, rec, attrs)


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` keeps every span opened in the block in
    ``rec.spans``.  Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace recording is already active")
    _active = rec = Recording()
    try:
        yield rec
    finally:
        _active = None
