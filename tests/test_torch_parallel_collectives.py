"""The port's collectives, owner-aligned reshard, ring NN search, heartbeat
and replica check on gloo ranks (CPU), against their definitions and the
JAX package's own multi-device functions.

Each world (4 ranks, 2 ranks) is one set of rank processes
(``tests/torch_parallel_worker.py``) started once per module; the JAX side
runs here on ``make_mesh(n)`` of the conftest's 8 virtual CPU devices.
"""

import numpy as np
import pytest

from torch_parallel_helpers import Ranks

# (seed, K, n): the JAX package pins its host layout simulation against its
# device reshard at these (tests/test_seq_parallel.py); the port's device
# reshard is held to the same simulation
RESHARD = {4: [(0, 257), (1, 64)], 2: [(2, 500)]}
RING = {
    "l2": dict(ratio_test=0.9),
    "ncc": dict(desc_metric="ncc", ncc_min=0.5),
    "hamming": dict(desc_metric="hamming", ratio_test=0.8),
}


def _reshard_inputs(n):
    out, cases = {}, []
    for seed, k in RESHARD[n]:
        rng = np.random.default_rng(seed)
        dest = rng.integers(0, n, k).astype(np.int64)
        valid = rng.random(k) > 0.15
        case = f"{seed}:{k}"
        cases.append(case)
        out[f"reshard_{case}_dest"] = dest
        out[f"reshard_{case}_valid"] = valid
        out[f"reshard_{case}_capacity"] = int(max(1, np.bincount(dest[valid], minlength=n).max()))
    out["reshard_cases"] = ",".join(cases)
    return out


def _ring_inputs(metric, seed=7):
    """The JAX package's ring test problem (tests/test_sharding.py), and a
    +-1 bit version of it for the Hamming metric."""
    rng = np.random.default_rng(seed)
    Kq, Kr, D = 256, 320, 128
    geo_q = rng.uniform(0, 50, (Kq, 2)).astype(np.float32)
    geo_r = rng.uniform(0, 50, (Kr, 2)).astype(np.float32)
    desc_q = (rng.normal(0, 1, (Kq, D)) * 60).astype(np.float32)
    desc_r = (rng.normal(0, 1, (Kr, D)) * 60).astype(np.float32)
    if metric == "ncc":
        desc_q /= np.linalg.norm(desc_q, axis=1, keepdims=True)
        desc_r /= np.linalg.norm(desc_r, axis=1, keepdims=True)
    ri = rng.choice(Kr, 60, replace=False)
    qi = rng.choice(Kq, 60, replace=False)
    desc_q[qi] = desc_r[ri] + (0.0 if metric == "ncc" else 1.0)
    geo_q[qi] = geo_r[ri] + 0.5
    if metric == "hamming":
        desc_q, desc_r = np.sign(desc_q).astype(np.float32), np.sign(desc_r).astype(np.float32)
        desc_q[qi[:30], :4] *= -1.0  # near, not exact, copies
    vq = rng.uniform(size=Kq) > 0.1
    vr = rng.uniform(size=Kr) > 0.1
    bbox = np.asarray([0.0, 50.0, 0.0, 50.0], np.float32)
    return dict(gq=geo_q, dq=desc_q, vq=vq, gr=geo_r, dr=desc_r, vr=vr, bbox=bbox)


def _inputs(n):
    inp = _reshard_inputs(n)
    if n == 4:
        inp["ring_metrics"] = ",".join(RING)
        for metric, kw in RING.items():
            inp.update({f"ring_{metric}_{k}": v for k, v in _ring_inputs(metric).items()})
            inp.update({f"ringcfg_{metric}_{k}": v for k, v in kw.items()})
            inp[f"ring_{metric}_flip"] = metric == "hamming"
    return inp


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return {4: Ranks(tmp_path_factory.mktemp("w4"), 4, ["collectives", "reshard", "ring", "heartbeat"], _inputs(4)),
            2: Ranks(tmp_path_factory.mktemp("w2"), 2, ["collectives", "reshard", "heartbeat"], _inputs(2))}


@pytest.fixture(scope="module")
def ranks4(started):
    return started[4].wait()


@pytest.fixture(scope="module")
def ranks2(started):
    return started[2].wait()


@pytest.fixture(params=[2, 4])
def world(request):
    """(n, that world's rank results), waiting for that world only."""
    return request.param, request.getfixturevalue(f"ranks{request.param}")


def test_collectives_match_their_definitions(world):
    n, res = world
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(n)]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["collectives/psum"], sum(xs))
        ordered = xs[0] * np.float32(0.1)
        for k in range(1, n):
            ordered = ordered + xs[k] * np.float32(0.1)
        np.testing.assert_array_equal(out["collectives/psum_ordered"], ordered)
        np.testing.assert_array_equal(out["collectives/all_gather"], np.stack(xs))
        np.testing.assert_array_equal(out["collectives/ppermute"], xs[(r - 1) % n])  # from the previous rank
        np.testing.assert_array_equal(out["collectives/ppermute_mask"], xs[(r - 1) % n] > 12)
        partial = xs[0] if r == n - 1 else np.zeros_like(xs[0])  # (0 -> n-1) only
        np.testing.assert_array_equal(out["collectives/ppermute_partial"], partial)
        a2a = np.stack([np.arange(2 * r, 2 * r + 2) + 100 * a for a in range(n)])  # block r of every rank
        np.testing.assert_array_equal(out["collectives/all_to_all"], a2a)
        np.testing.assert_array_equal(out["collectives/broadcast"], xs[n - 1])


def test_reshard_rows_matches_the_layout_simulation(world):
    """The device reshard places every row where the JAX package's host
    simulation says, drops nothing at exact capacity, and the JAX package's
    own reshard on the virtual mesh agrees."""
    import jax.numpy as jnp

    from diasss_tpu.parallel.alltoall import reshard_rows as jax_reshard
    from diasss_tpu.parallel.seq import _simulate_reshard_layout
    from diasss_tpu.parallel.shard import make_mesh

    n, res = world
    inp = _reshard_inputs(n)
    for seed, k in RESHARD[n]:
        case = f"{seed}:{k}"
        dest, valid = inp[f"reshard_{case}_dest"], inp[f"reshard_{case}_valid"]
        cap = inp[f"reshard_{case}_capacity"]
        sim = _simulate_reshard_layout(dest.astype(np.int32), valid, n, cap)
        occupied = sim >= 0
        jout, jvout, jdropped = jax_reshard(make_mesh(n), {"key": jnp.arange(k, dtype=jnp.int32)},
                                            jnp.asarray(dest.astype(np.int32)), jnp.asarray(valid), capacity=cap)
        for out in res:
            key, vout = out[f"reshard/{case}_key"], out[f"reshard/{case}_valid"]
            assert int(out[f"reshard/{case}_dropped"]) == 0 == int(jdropped)
            np.testing.assert_array_equal(vout, occupied)
            np.testing.assert_array_equal(key[occupied], sim[occupied])
            np.testing.assert_array_equal(vout, np.asarray(jvout))
            np.testing.assert_array_equal(key[occupied], np.asarray(jout["key"])[occupied])


@pytest.mark.parametrize("metric", list(RING))
def test_ring_search_equals_jax_ring_and_single_device(ranks4, metric):
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import jax
    from diasss_tpu.config import MatcherConfig
    from diasss_tpu.parallel.ring import ring_geo_nn_search

    inp = _ring_inputs(metric)
    args = [jnp.asarray(inp[k]) for k in ("gq", "dq", "vq", "gr", "dr", "vr", "bbox")]
    ref = ring_geo_nn_search(*args, MatcherConfig(**RING[metric]), metric == "hamming",
                             Mesh(jax.devices()[:4], ("ring",)))
    for out in ranks4:
        corres = out[f"ring/{metric}_corres"]
        np.testing.assert_array_equal(corres, out[f"ring/{metric}_single_corres"])
        np.testing.assert_array_equal(out[f"ring/{metric}_ncand"], out[f"ring/{metric}_single_ncand"])
        np.testing.assert_array_equal(corres, np.asarray(ref.corres))
        np.testing.assert_array_equal(out[f"ring/{metric}_ncand"], np.asarray(ref.n_candidates))
        assert (corres >= 0).sum() > 10  # a problem with matches


def test_heartbeat_and_replica_divergence(world):
    n, res = world
    for out in res:
        assert int(out["heartbeat/count"]) == n
        assert float(out["heartbeat/div_same"]) == 0.0
        assert float(out["heartbeat/div_differ"]) == 0.5 * (n - 1)
