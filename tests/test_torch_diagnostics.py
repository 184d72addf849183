"""The port's diagnostics (``diasss_tpu_torch/diagnostics.py``) against the
JAX package's: ``check_finite`` reports the same paths and counts for the
same tree of the same structure (dict entries in insertion order, where
JAX sorts the keys), and ``determinism_report`` tells a
deterministic computation from one that is not.  Exact: counts and strings.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diasss_tpu import diagnostics as jdiag
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu_torch import diagnostics
from diasss_tpu_torch.geometry import se3


def _trees():
    t = np.zeros((4, 3), np.float32)
    t[1, 2] = np.nan
    t[3, 0] = np.inf
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    err = np.array([1.0, np.nan], np.float32)
    ids = np.arange(3, dtype=np.int32)
    port = {"poses": se3.Pose3(torch.as_tensor(R), torch.as_tensor(t)), "stats": [torch.as_tensor(err), 3, None],
            "ids": torch.as_tensor(ids), "host": np.array([np.nan, 0.0])}
    ref = {"poses": jse3.Pose3(jnp.asarray(R), jnp.asarray(t)), "stats": [jnp.asarray(err), 3, None],
           "ids": jnp.asarray(ids), "host": np.array([np.nan, 0.0])}
    return port, ref


def test_check_finite_paths_and_counts_match_jax():
    port, ref = _trees()
    ours = diagnostics.check_finite(port, "result")
    assert sorted(ours) == jdiag.check_finite(ref, "result")
    assert ours == ["result['poses'].t: 2/12 non-finite", "result['stats'][0]: 1/2 non-finite",
                    "result['host']: 1/2 non-finite"]
    assert diagnostics.check_finite(se3.identity((3,)), "poses") == []


@pytest.mark.parametrize("deterministic", [True, False])
def test_determinism_report(deterministic):
    counter = itertools.count()

    def fn(x):
        bump = 0.0 if deterministic else 1e-3 * next(counter)
        return {"y": x * 2.0 + bump, "idx": torch.arange(3) + (0 if deterministic else next(counter))}

    report = diagnostics.determinism_report(fn, torch.ones(5), runs=3)
    assert report["deterministic"] is deterministic
    assert report["max_abs_dev"] == (0.0 if deterministic else pytest.approx(4e-3, rel=1e-3))
