"""The comparison that decides ``correct``: the numbers that a
configuration's plain reference forms (its ``numbers``, see
:mod:`.registry`), each held to the limit that the configuration's ``check``
entry gives it.

A number given per pass reads as its widest, and a pass above its limit
is a failed answer.  A number that cannot be formed (None, NaN) reads as
infinite, and so fails."""

import math
from typing import Dict


def _value(v) -> float:
    v = math.inf if v is None else float(v)
    return math.inf if math.isnan(v) else v


def compare(values: Dict[str, object], limits: Dict[str, float]):
    """``(numbers, failed)``: ``{name: (value, limit)}`` for every number in
    ``limits``, and the count of passes above the limit of a number given
    per pass.  A limit on a number that ``values`` lacks raises."""
    missing = set(limits) - set(values)
    if missing:
        raise ValueError(f"the reference formed no {sorted(missing)}")
    numbers, over = {}, set()
    for name, limit in limits.items():
        limit, v = float(limit), values[name]
        if isinstance(v, (list, tuple)):
            per_pass = [_value(x) for x in v]
            over.update(k for k, x in enumerate(per_pass) if not x <= limit)
            v = max(per_pass, default=math.inf)
        numbers[name] = (_value(v), limit)
    return numbers, len(over)


def passed(numbers: Dict[str, tuple], failed: int) -> bool:
    return failed == 0 and all(v <= lim for v, lim in numbers.values())
