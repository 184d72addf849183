"""The port's sequence-parallel pose graph and full BA on gloo ranks (CPU)
against the JAX package's ``seq_pose_graph_solve`` / ``seq_full_ba_solve``
on ``make_mesh(n)`` of the virtual 8-device CPU mesh, n = 2 and 4.

The linear solve is named on both sides: the port resolves ``"auto"`` by
the JAX package's TPU rule on every device, the JAX package by its backend.
Full BA follows the split of ROADMAP's hazard list: the port's
sequence-parallel ``tridiag`` solve is held to the JAX package's, and its
sequence-parallel direct step to the port's single-device direct step
(JAX's direct BA compiles for minutes on a busy CPU).
"""

import dataclasses

import numpy as np
import pytest

from test_seq_parallel import _chain_problem
from torch_parallel_helpers import Ranks, ba_arrays, graph_arrays

PG_KINDS = ("direct", "tridiag", "dense_seg")
PG_ITERS = 10
BA_ITERS = 12


@pytest.fixture(scope="module")
def ba_problem():
    """The 2-line, 120-ping survey with a tie line of tests/test_seq_parallel.py."""
    from diasss_tpu.config import FullBAConfig, PipelineConfig
    from diasss_tpu.frame import build_keyframe
    from diasss_tpu.pairs import get_kps_pairs
    from diasss_tpu.pipeline import _overlap_pairs
    from diasss_tpu.solvers.full_ba import build_ba_problem
    from diasss_tpu.synthetic import make_survey

    survey = make_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=40, n_tie_lines=1, seed=3)
    frames = [build_keyframe(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos)
              for l in survey.lines]
    pair_ids = _overlap_pairs(frames, 0.1)
    kps = {k: get_kps_pairs(frames[k[0]].annos, frames[k[1]].img_id, np.asarray(frames[k[0]].altitudes),
                            np.asarray(frames[k[0]].ground_ranges), np.asarray(frames[k[1]].altitudes),
                            np.asarray(frames[k[1]].ground_ranges), use_anno=True)
           for k in pair_ids}
    ba = FullBAConfig(max_iters=BA_ITERS)
    return build_ba_problem(frames, kps, pair_ids, ba, PipelineConfig().pose_graph, None), ba


@pytest.fixture(scope="module")
def graph():
    return _chain_problem()  # P = 100: not a multiple of 4 (padding)


@pytest.fixture(scope="module")
def lc_inputs():
    """The loop-closure batch of tests/test_sharding.py (16 correspondences)."""
    import jax.numpy as jnp

    from diasss_tpu.geometry import sonar

    n_pings, n_bins = 16, 32
    half = n_bins // 2
    rng = np.random.default_rng(0)
    gras = np.linspace(5.0, 20.0, half).astype(np.float32)
    dr_s = np.zeros((n_pings, 6), np.float32)
    dr_s[:, 3] = np.arange(n_pings)
    dr_t = dr_s.copy()
    dr_t[:, 4] += 25.0
    dr_t[:, 2] = np.pi
    alts = np.full((n_pings,), 12.0, np.float32)
    geo_s = sonar.geo_image(jnp.asarray(dr_s[:, 3:5]), jnp.asarray(dr_s[:, 2]), jnp.asarray(gras), n_bins)
    geo_t = sonar.geo_image(jnp.asarray(dr_t[:, 3:5]), jnp.asarray(dr_t[:, 2]), jnp.asarray(gras), n_bins)
    K = 16
    sr = float(np.sqrt(12.0 ** 2 + 12.0 ** 2))
    pairs = np.tile(np.asarray([3, half + 5, sr, 3, half + 5, sr, -12.0], np.float32), (K, 1))
    pairs[:, 0] = rng.integers(1, n_pings - 1, K)
    pairs[:, 3] = rng.integers(1, n_pings - 1, K)
    return dict(pairs=pairs, valid=np.ones(K, bool), dr_s=dr_s, dr_t=dr_t, geo_s=np.asarray(geo_s),
                geo_t=np.asarray(geo_t), alts_s=alts, alts_t=alts, gras_t=gras, n_bins=n_bins)


@pytest.fixture(scope="module")
def started(tmp_path_factory, graph, ba_problem, lc_inputs):
    """Every world started at once, to overlap each other and the JAX side:
    the pose-graph jobs and the BA jobs on 2 and on 4 ranks."""
    prob, _ = ba_problem
    inp = {**graph_arrays(graph), "pg_kinds": ",".join(PG_KINDS), "pg_iters": PG_ITERS,
           **ba_arrays(prob), "ba_kinds": "tridiag,direct", "ba_iters": BA_ITERS,
           **{f"lc_{k}": v for k, v in lc_inputs.items()}}
    jobs = {"pg": ["seq_pg"], "ba2": ["seq_ba"], "ba4": ["seq_ba", "sharded"]}
    return {(part, n): Ranks(tmp_path_factory.mktemp(f"{part}{n}"), n, jobs[part if part == "pg" else f"ba{n}"], inp)
            for part in ("pg", "ba") for n in (2, 4)}


@pytest.fixture(scope="module")
def pg2(started):
    return started[("pg", 2)].wait()


@pytest.fixture(scope="module")
def pg4(started):
    return started[("pg", 4)].wait()


@pytest.fixture(scope="module")
def ba2(started):
    return started[("ba", 2)].wait()


@pytest.fixture(scope="module")
def ba4(started):
    return started[("ba", 4)].wait()


@pytest.fixture(params=[2, 4])
def world(request):
    """(n, the pose-graph world's rank results), waiting for that world only."""
    return request.param, request.getfixturevalue(f"pg{request.param}")


@pytest.fixture(params=[2, 4])
def ba_world(request):
    """(n, the BA world's rank results)."""
    return request.param, request.getfixturevalue(f"ba{request.param}")


@pytest.mark.parametrize("kind", PG_KINDS)
def test_seq_pose_graph_matches_jax(world, graph, kind):
    from diasss_tpu.config import PoseGraphConfig
    from diasss_tpu.parallel.seq import seq_pose_graph_solve
    from diasss_tpu.parallel.shard import make_mesh

    n, res = world
    poses, info = seq_pose_graph_solve(make_mesh(n), graph, PoseGraphConfig(max_gn_iters=PG_ITERS,
                                                                            preconditioner=kind))
    out = res[0]
    assert str(out[f"seq_pg/{kind}_kind"]) == f"sp_{kind}" == info.solver_kind
    np.testing.assert_allclose(out[f"seq_pg/{kind}_t"], np.asarray(poses.t), rtol=0, atol=1e-3)
    e_port, e_jax = float(out[f"seq_pg/{kind}_error"]), float(info.error)
    assert abs(e_port - e_jax) <= 1e-3 * max(e_jax, 1.0)
    assert e_port < 1e-3 * float(info.error0)  # a real solve
    assert (int(out[f"seq_pg/{kind}_cg"]) == 0) == (kind == "direct")


def test_seq_pose_graph_ranks_bit_identical_and_gauge_fixed(world, graph):
    n, res = world
    t0 = np.asarray(graph.poses0.t[0])
    R0 = np.asarray(graph.poses0.R[0])
    for kind in PG_KINDS:
        for out in res[1:]:
            np.testing.assert_array_equal(out[f"seq_pg/{kind}_t"], res[0][f"seq_pg/{kind}_t"])
            np.testing.assert_array_equal(out[f"seq_pg/{kind}_R"], res[0][f"seq_pg/{kind}_R"])
            assert out[f"seq_pg/{kind}_error"] == res[0][f"seq_pg/{kind}_error"]
        np.testing.assert_array_equal(res[0][f"seq_pg/{kind}_t"][0], t0)
        np.testing.assert_array_equal(res[0][f"seq_pg/{kind}_R"][0], R0)


def test_seq_pose_graph_grad_norm(world):
    """``SolveInfo.grad_norm``, summed over ranks in rank order: the same
    bits on every rank, and after one trial within 1e-4 relative of the
    one-device solve's (the gradient's sum runs in another order); after
    the full solve finite and at most the one-trial value."""
    n, res = world
    for kind in PG_KINDS:
        for out in res[1:]:
            for key in ("grad_norm", "grad_norm_1"):
                assert out[f"seq_pg/{kind}_{key}"] == res[0][f"seq_pg/{kind}_{key}"], (kind, key)
        one, single = float(res[0][f"seq_pg/{kind}_grad_norm_1"]), float(res[0][f"seq_pg/{kind}_single_grad_norm_1"])
        assert one > 0
        np.testing.assert_allclose(one, single, rtol=1e-4, err_msg=kind)
        full = float(res[0][f"seq_pg/{kind}_grad_norm"])
        assert np.isfinite(full) and full <= one, (kind, full, one)


@pytest.mark.parametrize("kind", PG_KINDS)
def test_seq_pose_graph_mesh_size_invariance(pg2, pg4, kind):
    np.testing.assert_allclose(pg4[0][f"seq_pg/{kind}_t"], pg2[0][f"seq_pg/{kind}_t"], rtol=0, atol=2e-3)


def test_seq_full_ba_tridiag_matches_jax(ba_world, ba_problem):
    from diasss_tpu.config import KeypointNoiseConfig
    from diasss_tpu.parallel.seq import seq_full_ba_solve
    from diasss_tpu.parallel.shard import make_mesh

    n, res = ba_world
    prob, ba = ba_problem
    poses, lms, info = seq_full_ba_solve(make_mesh(n), prob, dataclasses.replace(ba, preconditioner="tridiag"),
                                         KeypointNoiseConfig())
    valid = np.asarray(prob.kp_valid)
    for out in res:
        assert str(out["seq_ba/tridiag_kind"]) == "sp_tridiag" == info.solver_kind
        np.testing.assert_allclose(out["seq_ba/tridiag_t"], np.asarray(poses.t), rtol=0, atol=3e-3)
        np.testing.assert_allclose(out["seq_ba/tridiag_lms"][valid], np.asarray(lms)[valid], rtol=0, atol=5e-2)
        np.testing.assert_array_equal(out["seq_ba/tridiag_t"], res[0]["seq_ba/tridiag_t"])
        assert abs(float(out["seq_ba/tridiag_error"]) - float(info.error)) < 1e-2 * max(float(info.error), 1.0)


def test_seq_full_ba_direct_matches_single_device_direct(ba_world, ba_problem):
    n, res = ba_world
    prob, _ = ba_problem
    valid = np.asarray(prob.kp_valid)
    ref = res[0]
    for out in res:
        assert str(out["seq_ba/direct_kind"]) == "sp_direct" and int(out["seq_ba/direct_cg"]) == 0
        np.testing.assert_allclose(out["seq_ba/direct_t"], ref["seq_ba/single_direct_t"], rtol=0, atol=3e-3)
        np.testing.assert_allclose(out["seq_ba/direct_lms"][valid], ref["seq_ba/single_direct_lms"][valid], rtol=0,
                                   atol=5e-2)
        np.testing.assert_array_equal(out["seq_ba/direct_t"], ref["seq_ba/direct_t"])
        e, e1 = float(out["seq_ba/direct_error"]), float(ref["seq_ba/single_direct_error"])
        assert abs(e - e1) < 1e-2 * max(e1, 1.0)


def test_sharded_lc_solve_matches_jax(ba4, lc_inputs):
    import jax.numpy as jnp

    from diasss_tpu.config import KeypointNoiseConfig, LoopClosureConfig
    from diasss_tpu.solvers.lc import loop_closing_tfs

    res = ba4
    args = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in lc_inputs.items()}
    ref = loop_closing_tfs(**args, kp_cfg=KeypointNoiseConfig(), cfg=LoopClosureConfig(max_lm_iters=10))
    for out in res:
        np.testing.assert_allclose(out["sharded/lc_quality"], np.asarray(ref.quality), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(out["sharded/lc_t"], np.asarray(ref.rel_pose.t), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(out["sharded/lc_t"], out["sharded/lc_single_t"])


def test_sharded_pose_graph_and_full_ba_match_single_device(ba4, ba_problem):
    res = ba4
    valid = np.asarray(ba_problem[0].kp_valid)
    for out in res:
        np.testing.assert_allclose(out["sharded/pg_t"], out["sharded/pg_single_t"], rtol=0, atol=1e-4)
        assert abs(float(out["sharded/pg_error"]) - float(out["sharded/pg_single_error"])) <= 1e-3 * max(
            float(out["sharded/pg_single_error"]), 1.0)
        np.testing.assert_allclose(out["sharded/ba_t"], out["sharded/ba_single_t"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["sharded/ba_lms"][valid], out["sharded/ba_single_lms"][valid], rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(out["sharded/pg_t"], res[0]["sharded/pg_t"])
