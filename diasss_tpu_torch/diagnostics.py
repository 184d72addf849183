"""Numerical health and determinism diagnostics.

Counterpart of :mod:`diasss_tpu.diagnostics`:

* :func:`check_finite` walks a result tree (the port's NamedTuples,
  ``Pose3``, dicts, lists; tensor, numpy or scalar leaves) for NaN / Inf;
* :func:`determinism_report` runs a computation several times and compares
  the results bit for bit.  The solvers' and the matcher's segment sums add
  in a fixed order on every device (:mod:`.segments`), so a solve repeats
  itself bit for bit on the card as on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    try:
        return np.asarray(leaf)
    except Exception:  # noqa: BLE001 — a leaf numpy cannot hold is not numeric
        return None


def check_finite(tree: Any, name: str = "result") -> List[str]:
    """Paths of the tree's floating leaves that hold non-finite values, each
    as ``"{name}{path}: {bad}/{size} non-finite"``."""
    bad: List[str] = []
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex()):
            n_bad, size = int((~torch.isfinite(leaf)).sum()), leaf.numel()
        else:
            arr = _host(leaf)
            if arr is None or arr.dtype.kind not in "fc":
                continue
            n_bad, size = int((~np.isfinite(arr)).sum()), arr.size
        if n_bad:
            bad.append(f"{name}{pytree.keystr(path)}: {n_bad}/{size} non-finite")
    return bad


def determinism_report(fn, *args, runs: int = 2) -> Dict[str, Any]:
    """Run ``fn(*args)`` ``runs`` times; report whether every leaf came out
    bit-identical and the largest absolute deviation of a floating leaf."""
    outs = [[_host(leaf) for leaf in pytree.tree_leaves(fn(*args))] for _ in range(runs)]
    report: Dict[str, Any] = {"deterministic": True, "max_abs_dev": 0.0}
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            if a is None or b is None:
                continue
            if a.dtype.kind in "fc":
                dev = float(np.max(np.abs(a - b))) if a.size else 0.0
                if dev > 0:
                    report["deterministic"] = False
                    report["max_abs_dev"] = max(report["max_abs_dev"], dev)
            elif not np.array_equal(a, b):
                report["deterministic"] = False
    return report
