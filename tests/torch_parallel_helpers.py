"""Launcher of the port's parallel parity tests (not collected by pytest).

:func:`run_ranks` starts ``n`` rank processes of
``tests/torch_parallel_worker.py`` (gloo over a ``FileStore`` under the
test's temporary directory, one thread each), hands them the JAX package's
inputs as one ``.npz`` and returns each rank's results.  The JAX side runs
in the test process on ``make_mesh(n)`` of the conftest's 8 virtual
devices.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")


class Ranks:
    """``n`` rank processes of the worker running ``jobs``, started at
    construction; :meth:`wait` returns one ``{job/key: array}`` per rank
    and raises with a failing rank's output.  Start several worlds (and
    the JAX side's work) before waiting on any, so that they overlap."""

    def __init__(self, tmp_dir, n: int, jobs, inputs: dict, timeout: float = 240.0, backend: str = "gloo",
                 device: str = "cpu"):
        self.dir, self.n, self.timeout = str(tmp_dir), n, timeout
        os.makedirs(self.dir, exist_ok=True)
        inp = os.path.join(self.dir, "inputs.npz")
        np.savez(inp, **{k: np.asarray(v) for k, v in inputs.items()})
        store = os.path.join(self.dir, "store")
        if os.path.exists(store):
            os.remove(store)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "OMP_"))}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        self.procs = [subprocess.Popen([sys.executable, WORKER, "--rank", str(r), "--world", str(n), "--store", store,
                                        "--inputs", inp, "--out", self.dir, "--jobs", ",".join(jobs),
                                        "--backend", backend, "--device", device],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
                      for r in range(n)]
        self._results = None

    def wait(self):
        if self._results is not None:
            return self._results
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {self.n} exited {p.returncode}:\n{out[-4000:]}")
        self._results = [dict(np.load(os.path.join(self.dir, f"rank{r}.npz"), allow_pickle=False))
                         for r in range(self.n)]
        return self._results


def run_ranks(tmp_dir, n: int, jobs, inputs: dict, timeout: float = 240.0, **kw):
    """Run ``jobs`` on ``n`` ranks and wait (see :class:`Ranks`)."""
    return Ranks(tmp_dir, n, jobs, inputs, timeout, **kw).wait()


def pose_arrays(prefix: str, p) -> dict:
    return {prefix + "_R": np.asarray(p.R), prefix + "_t": np.asarray(p.t)}


def graph_arrays(g, p: str = "pg_") -> dict:
    """A JAX-package PoseGraph as the arrays ``graph_from`` of the worker reads."""
    out = {**pose_arrays(p + "poses0", g.poses0), **pose_arrays(p + "odo_meas", g.odo_meas),
           **pose_arrays(p + "lc_meas", g.lc_meas)}
    for k in ("odo_sigmas", "lc_i", "lc_j", "lc_sigmas", "lc_valid"):
        out[p + k] = np.asarray(getattr(g, k))
    return out


def ba_arrays(prob, p: str = "ba_") -> dict:
    """A JAX-package BAProblem (no constant-pose endpoints) as arrays."""
    out = {**pose_arrays(p + "poses0", prob.poses0), **pose_arrays(p + "odo_meas", prob.odo_meas)}
    for k in ("odo_sigmas", "kp_i", "kp_j", "kp_sr_s", "kp_sr_t", "kp_valid", "lm0", "lm_prior", "lm_prior_sigmas"):
        out[p + k] = np.asarray(getattr(prob, k))
    return out
