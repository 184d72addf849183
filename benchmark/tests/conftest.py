"""Shared helpers of the benchmark's own tests: the cells at a size the CPU
holds in seconds, with their own limits and readers."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session")
def registry():
    from benchmark import harness, registry as reg

    return reg.Registry(harness.SPEC)


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_plan(registry, cell: str):
    """The cell's plan with its survey cut to the configuration's
    ``tiny_survey`` (the same layout, which the CPU runs in seconds) and no
    warm-up pass: one pass, then the reference."""
    plan = registry.plan(cell)
    config = dict(plan.config, survey=plan.config["tiny_survey"], warmup_passes=0)
    return plan._replace(config=config)
