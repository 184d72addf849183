"""The comparison that decides ``correct``: the program's outputs against
the plain reference's (:mod:`.plainref`), number by number, each against
its limit.

The numbers (a configuration's ``check`` entry names the ones it holds,
with their limits):

* ``pose_gap_m``: the widest distance between a ping's estimated position
  in a pass of the window and in the reference, over every ping of every
  pass of the checked survey (metres);
* ``lc_flips``: keypoint pairs whose loop closure one side accepts and the
  other does not (a count; the last pass of the checked survey);
* ``lc_gap_m``: the widest distance between the relative translations that
  the two sides' loop-closure problems give one keypoint pair, over every
  pair, accepted or not (metres; the same pass).

A pass whose ``pose_gap_m`` is above its limit is a failed answer.  A
number that cannot be formed (another set of gated pairs, another count of
keypoint pairs, a shape that differs) reads as infinite, and so fails."""

import math
from typing import Dict, List

import numpy as np

KNOWN = ("pose_gap_m", "lc_flips", "lc_gap_m")


def pose_gap(prog: dict, ref: dict) -> float:
    a, b = prog["poses_t"], ref["poses_t"]
    if a.shape != b.shape:
        return math.inf
    gap = np.linalg.norm(a - b, axis=-1)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else math.inf


def lc_numbers(prog: dict, ref: dict):
    """``(lc_flips, lc_gap_m)``."""
    a, b = prog["lc"], ref["lc"]
    if a.keys() != b.keys():
        return math.inf, math.inf
    flips, gap = 0, 0.0
    for key, theirs in b.items():
        mine = a[key]
        if mine is None or mine[0].shape != theirs[0].shape:
            return math.inf, math.inf
        (acc_a, t_a), (acc_b, t_b) = mine, theirs
        flips += int(np.sum(acc_a != acc_b))
        if len(t_b):
            d = np.linalg.norm(t_a - t_b, axis=-1)
            gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d)) else math.inf)
    return float(flips), gap


def compare(passes: List[dict], last: dict, ref: dict, limits: Dict[str, float]):
    """``(numbers, failed)``: ``{name: (value, limit)}`` for every number in
    ``limits`` (``passes``: the outputs of every pass of the checked survey;
    ``last``: the last of them), and the count of passes whose poses fail."""
    unknown = set(limits) - set(KNOWN)
    if unknown:
        raise ValueError(f"unknown check numbers {sorted(unknown)}")
    gaps = [pose_gap(p, ref) for p in passes]
    values = {"pose_gap_m": max(gaps)}
    values["lc_flips"], values["lc_gap_m"] = lc_numbers(last, ref)
    numbers = {name: (values[name], float(limit)) for name, limit in limits.items()}
    failed = sum(1 for g in gaps if not g <= float(limits.get("pose_gap_m", math.inf)))
    return numbers, failed


def passed(numbers: Dict[str, tuple], failed: int) -> bool:
    return failed == 0 and all(v <= lim for v, lim in numbers.values())
