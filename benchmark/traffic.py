"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and drives the cell's passes.

A mix today is a closed loop of whole-survey passes (``"loop": "closed"``,
one client) over a fixed set of survey realizations (``survey_seeds``:
the surveys are made in set-up from the configuration's sizes and these
seeds).  ``--seed`` draws the order in which the passes visit them, so
every seed offers the same work in another order.  After the
configuration's ``warmup_passes`` untimed passes, which visit the surveys
in the same order, passes start back to back while the clock since the
first timed pass's start is under the window's seconds, and the window
ends with the last pass's end, its overrun counted."""

import time
from typing import Callable, List, NamedTuple

import numpy as np

KNOWN_LOOPS = ("closed",)


class Window(NamedTuple):
    passes: list  # what each timed pass returned, in order
    start: float  # perf_counter at the first timed pass's start
    end: float  # perf_counter at the last timed pass's end


def check_mix(mix: dict) -> dict:
    """``mix`` if its parameters are ones this generator runs; raises otherwise."""
    if mix.get("loop") not in KNOWN_LOOPS:
        raise ValueError(f"traffic loop {mix.get('loop')!r} is not one of {KNOWN_LOOPS}")
    if int(mix.get("clients", 1)) != 1:
        raise ValueError("a closed loop of whole-survey passes has one client")
    if not mix.get("survey_seeds"):
        raise ValueError("a mix names the seeds of its surveys")
    return mix


def order(seed: int, n: int) -> List[int]:
    """The order, drawn from ``seed``, in which the passes visit the mix's
    ``n`` surveys (pass k runs survey ``order[k % n]``)."""
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


def warm_up(one_pass: Callable[[int], object], passes: int) -> None:
    if passes < 0:
        raise ValueError("warmup_passes is a count")
    for k in range(passes):
        one_pass(k)


def run_window(one_pass: Callable[[int], object], seconds: float, mix: dict,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """``one_pass(k)`` for k = 0, 1, ... back to back, each started while
    the window is under ``seconds``; at least one."""
    check_mix(mix)
    passes: List[object] = []
    start = clock()
    while not passes or clock() - start < seconds:
        passes.append(one_pass(len(passes)))
    return Window(passes, start, clock())


def rate(units_per_pass: List[float], window: Window) -> float:
    """All units of all passes over the window's whole time."""
    return sum(units_per_pass) / (window.end - window.start)
