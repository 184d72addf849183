"""Shared helpers of the benchmark's own tests: the cells at a size the CPU
holds in seconds, with their own limits and readers."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# per configuration, a survey of the same layout that the CPU runs in seconds
TINY_SURVEYS = {
    "anno20": dict(n_lines=3, n_pings=200, n_bins=256, n_landmarks=80, drift_xy=0.004),
}


@pytest.fixture(scope="session")
def registry():
    from benchmark import harness, registry as reg

    return reg.Registry(harness.SPEC)


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_plan(registry, cell: str):
    """The cell's plan with its survey cut to :data:`TINY_SURVEYS` and no
    warm-up pass: one pass, then the reference."""
    plan = registry.plan(cell)
    config = dict(plan.config, survey=TINY_SURVEYS[plan.config["name"]], warmup_passes=0)
    return plan._replace(config=config)
