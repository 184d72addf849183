"""Elastic recovery, the multi-process check and the mesh's entry errors of
the port's multi-device layer, on gloo ranks (CPU).

As ``tests/test_recovery.py`` does for the JAX package: a solve that loses
half its ranks at a chunk boundary, one whose ranks come back a chunk
later, and one resumed from its on-disk snapshot after every rank "died",
each within 2e-3 m of the uninterrupted single-device solve (on the
problem of ``tests/test_recovery.py``).  Then
``python -m diasss_tpu_torch.parallel.multihost_check`` in two OS processes
over ``tcp://localhost``, and ``--mesh 2`` without torchrun.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from test_recovery import _graph
from torch_parallel_helpers import REPO, Ranks, graph_arrays

N = 4


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    graph, _ = _graph()
    return Ranks(tmp, N, ["elastic"], {**graph_arrays(graph, "el_"), "el_path": str(tmp / "snapshot.npz")}).wait()


def test_survives_losing_half_the_ranks(elastic):
    for out in elastic:
        assert [tuple(e) for e in out["elastic/shrink_events"]] == [(1, N, N // 2)]
        np.testing.assert_allclose(out["elastic/shrink_t"], out["elastic/ref_t"], rtol=0, atol=2e-3)
        np.testing.assert_array_equal(out["elastic/shrink_t"], elastic[0]["elastic/shrink_t"])


def test_chunks_and_rank_loss_keep_the_solve_exact(elastic):
    """Chunk boundaries carry the iterate, damping and stall counter
    exactly; a solve that loses half its ranks ends where the uninterrupted
    solve on the survivors ends."""
    for out in elastic:
        np.testing.assert_array_equal(out["elastic/chunked_t"], out["elastic/whole_t"])
        assert out["elastic/chunked_lam"] == out["elastic/whole_lam"]
    for out in elastic[: N // 2]:
        np.testing.assert_allclose(out["elastic/shrink_t"], out["elastic/survivors_t"], rtol=0, atol=1e-5)


def test_ranks_regrow_after_temporary_loss(elastic):
    for out in elastic:
        events = [tuple(e) for e in out["elastic/regrow_events"]]
        assert (1, N, N // 2) in events and (2, N // 2, N) in events, events
        np.testing.assert_allclose(out["elastic/regrow_t"], out["elastic/ref_t"], rtol=0, atol=2e-3)
        np.testing.assert_array_equal(out["elastic/regrow_t"], elastic[0]["elastic/regrow_t"])


def test_process_loss_resumes_from_the_snapshot(elastic):
    for out in elastic:
        assert bool(out["elastic/crashed"]) and bool(out["elastic/snapshot_left"])
        np.testing.assert_allclose(out["elastic/resumed_t"], out["elastic/ref_t"], rtol=0, atol=2e-3)
        assert bool(out["elastic/snapshot_removed"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_check_two_processes():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "OMP_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "diasss_tpu_torch.parallel.multihost_check", "--init-method",
                               f"tcp://localhost:{port}", "--world-size", "2", "--rank", str(r), "--backend", "gloo",
                               "--device", "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        for marker in ("MULTIHOST_OK", "MULTIHOST_BA_OK", "MULTIHOST_ELASTIC_OK"):
            assert marker in out, f"rank {r} missing {marker}:\n{out[-3000:]}"


def test_cli_mesh_without_torchrun_gives_the_torchrun_line(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    d = str(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "diasss_tpu_torch.cli", "--image", d, "--pose", d, "--altitude", d,
                           "--groundrange", d, "--annotation", d, "--mesh", "2", "--device", "cpu"],
                          capture_output=True, text=True, env={**env, "PYTHONPATH": REPO}, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert "torchrun --nproc-per-node 2 -m diasss_tpu_torch.cli --mesh 2" in proc.stderr, proc.stderr[-2000:]
