"""The port's public surface against the JAX package's.

Every public name of every ``diasss_tpu`` module (its ``__all__``, else its
top-level functions, jitted functions and classes and their public
methods) has a counterpart at the same path in ``diasss_tpu_torch``, apart
from the exclusions below, each with its reason.  Module by module, every
public function, class and method takes the JAX parameter (or field)
names, keeps the shared ones in the JAX order and has the same defaults,
apart from :data:`EXCLUDED_PARAMS`.  The functions ported last get a
parity case against their JAX originals on seeded numpy inputs:

* geometry and factors, float32 on both sides with the same formulas:
  atol 2e-6 on O(1) values, 5e-5 on positions of tens of metres (a few
  float32 ulps, as ``test_torch_geometry.py``);
* the per-pair evaluators: the same values as the port's stacked
  evaluators bit for bit, and the JAX package's to 1e-4 m; eval_2
  re-triangulates each landmark by a float32 LM, so its rows agree to
  1e-3 m and its shares to one row (as ``test_torch_mixed.py``);
* ATE 1e-5 m; the trajectory loader and ``SlamResult.frame_poses`` exact.

Where CUDA is absent, the multi-device layer's device defaults raise.  The
port's bench point keeps the parameters of the repository's ``bench.run``.
"""

import dataclasses
import importlib
import inspect
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import jax_and_port_frames, port_cfg, small_survey

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# module paths of the JAX package without a counterpart, and why
EXCLUDED_MODULES = {
    "diasss_tpu.cache": "the XLA compile cache: ROADMAP's not-to-port list (the CLI's --no-compile-cache)",
    "diasss_tpu.features.fast_pallas": "the Pallas kernel B1: ported as features.fast_cuda (csrc/fast9.cu)",
    "diasss_tpu.matching.dense_pallas": "the Pallas kernel B2: ported as matching.dense_cuda (csrc/qcorr.cu)",
}
# names without a counterpart at the same path, and why
EXCLUDED_NAMES = {
    "diasss_tpu.features.fast.fast_score": "renamed fast_score_plain: the plain version beside the CUDA kernel",
    "diasss_tpu.solvers.tridiag.thomas_block_tridiag_multi":
        "a backend-keyed branch (ROADMAP hazard 1): the port's chain solve is cyclic reduction everywhere",
    "diasss_tpu.parallel.seq.shard_map":
        "JAX's SPMD transform (a version shim): the port runs one process per rank on torch.distributed",
}
_PRNG = "a JAX PRNG key: the port draws through ``rng`` (ROADMAP hazard 2)"
_TUNNEL = "the tunnel upload options: ROADMAP's not-to-port list"
_MESH = ("the port's Mesh (one process group per mesh) carries the axis and devices, and initialize takes "
         "(init_method, world_size, rank)")
# parameters of a JAX callable (the qualified name where it is defined)
# without a counterpart in the port's, and why
EXCLUDED_PARAMS = {
    ("diasss_tpu.solvers.lm.levenberg_marquardt", "rel_tol"):
        "accepted and never read by the JAX package (its stops are the gradient test and abs_tol, lm.py:120-121): "
        "porting it would copy a silent ignore",
    ("diasss_tpu.matching.scc.scc_filter", "key"): _PRNG,
    ("diasss_tpu.solvers.pose_graph.build_chain_graph", "noise_key"): _PRNG,
    ("diasss_tpu.solvers.full_ba.build_ba_problem", "noise_key"): _PRNG,
    **{(f"diasss_tpu.{fn}", arg): _TUNNEL
       for fn in ("frame.build_keyframe", "frame.build_keyframes_batch", "parallel.prefetch.load_keyframes_pipelined")
       for arg in ("host_preprocess", "host_imagery")},
    **{(f"diasss_tpu.parallel.{fn}", arg): _MESH for fn, args in (
        ("shard.make_mesh", ("axis", "devices")), ("ring.ring_geo_nn_search", ("axis",)),
        ("alltoall.reshard_rows", ("axis",)),
        ("distributed.initialize", ("coordinator_address", "num_processes", "process_id")),
        ("distributed.global_mesh", ("axis",)), ("distributed.heartbeat", ("axis",)),
        ("recovery.heartbeat_probe", ("devices",)), ("recovery.elastic_seq_pose_graph_solve", ("devices",)),
        ("seq.seq_pose_graph_solve", ("axis",)), ("seq.seq_full_ba_solve", ("axis",))) for arg in args},
    ("diasss_tpu.solvers.tridiag.spike_block_tridiag_multi", "axis"): _MESH,
    ("diasss_tpu.solvers.tridiag.spike_block_tridiag_multi", "n"): _MESH,
}


def _jax_modules():
    root = os.path.join(REPO, "diasss_tpu")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3].replace(os.sep, ".")
                yield rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    # jitted JAX functions carry their function as ``__wrapped__``
    return [n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(inspect.unwrap(v)) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__]


def _public_methods(cls):
    return [a for a, v in vars(cls).items() if not a.startswith("_")
            and (inspect.isfunction(v) or isinstance(v, (property, staticmethod, classmethod)))]


def test_every_public_name_has_a_counterpart():
    missing = []
    for name in sorted(_jax_modules()):
        if name in EXCLUDED_MODULES:
            continue
        mod = importlib.import_module(name)
        port_name = "diasss_tpu_torch" + name[len("diasss_tpu"):]
        try:
            port = importlib.import_module(port_name)
        except ImportError:
            missing.append(port_name)
            continue
        for attr in _public_names(mod):
            if f"{name}.{attr}" in EXCLUDED_NAMES:
                assert not hasattr(port, attr), f"{name}.{attr} is listed as excluded but exists in the port"
                continue
            if not hasattr(port, attr):
                missing.append(f"{port_name}.{attr}")
                continue
            ours, theirs = getattr(port, attr), getattr(mod, attr)
            if inspect.isclass(theirs):
                missing += [f"{port_name}.{attr}.{m}" for m in _public_methods(theirs) if not hasattr(ours, m)]
    assert missing == []


_EMPTY = inspect.Parameter.empty


def _qualified(obj):
    obj = inspect.unwrap(obj)
    return f"{obj.__module__}.{obj.__qualname__}"


def _fields(cls):
    """A record's field names and defaults, in order."""
    if dataclasses.is_dataclass(cls):
        return {f.name: f.default if f.default is not dataclasses.MISSING else
                f.default_factory() if f.default_factory is not dataclasses.MISSING else _EMPTY
                for f in dataclasses.fields(cls)}
    return {f: cls._field_defaults.get(f, _EMPTY) for f in cls._fields}


def _params(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


def _same_default(theirs, ours):
    """Numbers, strings, tuples and None by value (and type), config
    dataclasses through ``port_cfg``, dtypes by name (``jnp.float32`` is
    ``torch.float32``), arrays element by element, and functions as the
    port's function of the same name."""
    if theirs is None or isinstance(theirs, (bool, int, float, str, tuple)):
        return type(theirs) is type(ours) and theirs == ours
    if dataclasses.is_dataclass(theirs):
        return port_cfg(theirs) == ours
    if isinstance(ours, torch.dtype):
        return np.dtype(theirs).name == str(ours).removeprefix("torch.")
    if isinstance(theirs, np.ndarray):
        return isinstance(ours, np.ndarray) and theirs.dtype == ours.dtype and np.array_equal(theirs, ours)
    if callable(theirs):
        return callable(ours) and _qualified(ours) == "diasss_tpu_torch" + _qualified(theirs)[len("diasss_tpu"):]
    return False


def _compare(qual, theirs, ours, ordered, defaults, excluded):
    """What differs between a JAX callable's parameters (or a record's
    fields) ``theirs`` and the port's ``ours``; the JAX parameters the port
    leaves out by :data:`EXCLUDED_PARAMS` go into ``excluded``."""
    out = []
    for k in theirs:
        if (qual, k) in EXCLUDED_PARAMS:
            excluded.add((qual, k))
            if k in ours:
                out.append(f"{qual}: {k} is listed as excluded but exists in the port")
        elif k not in ours:
            out.append(f"{qual}: no {k}")
    shared = [k for k in theirs if k in ours]
    if ordered and shared != [k for k in ours if k in theirs]:
        out.append(f"{qual}: order {[k for k in ours if k in theirs]}, JAX {shared}")
    if defaults:
        out += [f"{qual}: {k}={ours[k]!r}, JAX {theirs[k]!r}" for k in shared
                if theirs[k] is not _EMPTY and not _same_default(theirs[k], ours[k])]
    return out


@pytest.mark.parametrize("path", [n[len("diasss_tpu."):] if n != "diasss_tpu" else "__init__"
                                  for n in sorted(_jax_modules()) if n not in EXCLUDED_MODULES])
def test_new_names_keep_the_jax_signatures(path):
    """Every public function, class and public method of the JAX module has
    the JAX parameter (or field) names in the port's counterpart, apart
    from :data:`EXCLUDED_PARAMS`; functions, methods and constructors keep
    the shared names in the same relative order, so positional callers meet
    the same arguments, and every shared default equal
    (:func:`_same_default`).  Result records (named tuples, and dataclasses
    outside ``config``) are built by keyword in both packages and are
    checked by field name only; config dataclasses by name and default."""
    name = "diasss_tpu" if path == "__init__" else "diasss_tpu." + path
    mod = importlib.import_module(name)
    port = importlib.import_module("diasss_tpu_torch" + name[len("diasss_tpu"):])
    problems, excluded = [], set()
    for attr in _public_names(mod):
        theirs = getattr(mod, attr)
        if f"{name}.{attr}" in EXCLUDED_NAMES or not callable(theirs):
            continue
        ours = getattr(port, attr)
        qual = _qualified(theirs)
        if not inspect.isclass(theirs):
            problems += _compare(qual, _params(theirs), _params(ours), True, True, excluded)
            continue
        if dataclasses.is_dataclass(theirs) or hasattr(theirs, "_fields"):
            problems += _compare(qual, _fields(theirs), _fields(ours), False,
                                 theirs.__module__ == "diasss_tpu.config", excluded)
        else:
            problems += _compare(qual, _params(theirs), _params(ours), True, True, excluded)
        for m in _public_methods(theirs):
            if not isinstance(vars(theirs)[m], property):
                problems += _compare(f"{qual}.{m}", _params(getattr(theirs, m)), _params(getattr(ours, m)), True,
                                     True, excluded)
    stale = {e for e in EXCLUDED_PARAMS if e[0].rsplit(".", 1)[0] == name} - excluded
    assert problems == [] and stale == set(), (problems, stale)


def test_bench_run_keeps_the_jax_signature():
    """The port's bench point (``diasss_tpu_torch.bench.run``) takes every
    parameter of the repository's ``bench.run`` in the same order with equal
    defaults; ``device`` (the card unless given), last, is its only
    addition."""
    import bench
    from diasss_tpu_torch import bench as port_bench

    theirs, ours = _params(bench.run), _params(port_bench.run)
    assert _compare("bench.run", theirs, ours, True, True, set()) == []
    assert list(ours) == list(theirs) + ["device"] and ours["device"] is None


def _poses(seed, n=32, spread=30.0):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.normal(size=(n, 3)) * 0.5, rng.normal(size=(n, 3)) * spread], 1).astype(np.float32)
    from diasss_tpu.geometry import se3 as jse3
    from diasss_tpu_torch.geometry import se3

    return rows, jse3.from_rodrigues_xyz(jnp.asarray(rows)), se3.from_rodrigues_xyz(torch.as_tensor(rows))


def test_geometry_matches_jax():
    from diasss_tpu.geometry import se3 as jse3
    from diasss_tpu import geometry as jgeometry
    from diasss_tpu_torch import geometry
    from diasss_tpu_torch.geometry import se3

    _, ja, ta = _poses(0)
    p = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32) * 20
    np.testing.assert_allclose(se3.transform_from(ta, torch.as_tensor(p)).numpy(),
                               np.asarray(jse3.transform_from(ja, jnp.asarray(p))), atol=5e-5)
    adj, jadj = se3.adjoint(ta).numpy(), np.asarray(jse3.adjoint(ja))
    np.testing.assert_allclose(adj[..., :3, :], jadj[..., :3, :], atol=2e-6)  # R and 0
    np.testing.assert_allclose(adj[..., 3:, :], jadj[..., 3:, :], atol=5e-5)  # hat(t) R and R
    for name in jgeometry.__all__:
        if name not in ("so3", "sonar", "Pose3"):
            assert getattr(geometry, name) is getattr(se3, name), name


@pytest.mark.parametrize("shift", [(0.0, 0.0), (30.0, -20.0), (500.0, 0.0)])
def test_bbox_iou_overlap_matches_jax(shift):
    from diasss_tpu.geometry import sonar as jsonar
    from diasss_tpu_torch.geometry import sonar

    rng = np.random.default_rng(2)
    a = (rng.random((40, 24, 2)) * [100.0, 60.0]).astype(np.float32)
    b = (rng.random((30, 24, 2)) * [80.0, 90.0] + shift).astype(np.float32)
    ours = float(sonar.bbox_iou_overlap(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(ours, float(jsonar.bbox_iou_overlap(jnp.asarray(a), jnp.asarray(b))), atol=2e-6)
    assert (ours == 0.0) == (shift[0] == 500.0)


def test_factors_match_jax():
    from diasss_tpu import factors as jfactors
    from diasss_tpu.geometry import se3 as jse3
    from diasss_tpu_torch import factors
    from diasss_tpu_torch.geometry import se3

    _, ja, ta = _poses(3)
    _, jb, tb = _poses(4, spread=0.5)
    np.testing.assert_allclose(factors.prior_residual(ta, tb).numpy(),
                               np.asarray(jfactors.prior_residual(ja, jb)), atol=5e-5)
    p, q = (np.random.default_rng(s).normal(size=(32, 3)).astype(np.float32) * 20 for s in (5, 6))
    np.testing.assert_allclose(factors.point_prior_residual(torch.as_tensor(p), torch.as_tensor(q)).numpy(),
                               np.asarray(jfactors.point_prior_residual(jnp.asarray(p), jnp.asarray(q))), atol=0)
    rng = np.random.default_rng(7)
    m = np.stack([rng.random(32) * 40 + 10, np.zeros(32)], 1).astype(np.float32)
    sig = np.stack([np.full(32, 0.1), m[:, 0] * 1.7e-3], 1).astype(np.float32)
    ours = factors.sss_point_whitened(torch.as_tensor(p), ta, se3.identity((32,)), torch.as_tensor(m),
                                      torch.as_tensor(sig)).numpy()
    theirs = jfactors.sss_point_whitened(jnp.asarray(p), ja, jse3.identity((32,)), jnp.asarray(m), jnp.asarray(sig))
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5, atol=1e-3)  # whitened by sigmas down to 0.02
    for name in jfactors.__all__:
        assert hasattr(factors, name), name


@pytest.fixture(scope="module")
def eval_pair():
    """One annotated frame pair of a small survey, both packages' frames,
    and estimated poses: DR with seeded noise."""
    from diasss_tpu.config import PipelineConfig
    from diasss_tpu.pipeline import _assemble_pairs, _overlap_pairs

    survey = small_survey()
    jf, tf = jax_and_port_frames(survey)
    pair_ids = _overlap_pairs(jf, PipelineConfig().min_overlap)
    kps, _ = _assemble_pairs(jf, None, pair_ids, PipelineConfig(), True)
    key = max(pair_ids, key=lambda k: int(np.asarray(kps[k].valid).sum()))
    rows = np.asarray(kps[key].pairs)[np.asarray(kps[key].valid)]
    rng = np.random.default_rng(11)
    est = []
    for f in key:
        dr = np.asarray(jf[f].dr_poses)
        est.append((dr + rng.normal(size=dr.shape) * np.array([1e-3] * 3 + [0.5] * 3)).astype(np.float32))
    return jf, tf, key, rows, est


def test_eval_landmark_consistency_matches_jax_and_the_stacked_form(eval_pair):
    from diasss_tpu import evaluate as jev
    from diasss_tpu.geometry import se3 as jse3
    from diasss_tpu_torch import evaluate
    from diasss_tpu_torch.geometry import se3

    jf, tf, (s, t), rows, est = eval_pair
    assert len(rows) > 0
    n_bins = int(tf[s].raw.shape[1])
    ours = evaluate.eval_landmark_consistency(rows, tf[s].geo, tf[t].geo, tf[s].ground_ranges, tf[t].ground_ranges,
                                              se3.from_rodrigues_xyz(torch.as_tensor(est[0])),
                                              se3.from_rodrigues_xyz(torch.as_tensor(est[1])), n_bins)
    theirs = jev.eval_landmark_consistency(rows, jf[s].geo, jf[t].geo, jf[s].ground_ranges, jf[t].ground_ranges,
                                           jse3.from_rodrigues_xyz(jnp.asarray(est[0])),
                                           jse3.from_rodrigues_xyz(jnp.asarray(est[1])), n_bins)
    assert ours.n_pairs == theirs.n_pairs == len(rows) and ours.improved_pct == theirs.improved_pct
    np.testing.assert_allclose(ours.ini_dists, theirs.ini_dists, atol=1e-4)
    np.testing.assert_allclose(ours.fnl_dists, theirs.fnl_dists, atol=1e-4)
    for f in ("avg_x_dr", "avg_x_est", "avg_y_dr", "avg_y_est", "avg_norm_dr", "avg_norm_est"):
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f), atol=1e-4)
    stacked = _stacked(evaluate.eval_landmark_consistency_stacked, tf, s, t, rows, est,
                       lambda geo, gras, dr, alts: (geo, gras), n_bins)
    for a, b in zip(ours, stacked):
        np.testing.assert_array_equal(a, b)


def test_eval_triangulated_consistency_matches_jax_and_the_stacked_form(eval_pair):
    from diasss_tpu import evaluate as jev
    from diasss_tpu.geometry import se3 as jse3
    from diasss_tpu_torch import evaluate
    from diasss_tpu_torch.geometry import se3

    jf, tf, (s, t), rows, est = eval_pair
    ours = evaluate.eval_triangulated_consistency(rows, tf[s].dr_poses, tf[t].dr_poses, tf[s].geo, tf[t].geo,
                                                  tf[s].altitudes, tf[t].altitudes,
                                                  se3.from_rodrigues_xyz(torch.as_tensor(est[0])),
                                                  se3.from_rodrigues_xyz(torch.as_tensor(est[1])))
    theirs = jev.eval_triangulated_consistency(rows, jf[s].dr_poses, jf[t].dr_poses, jf[s].geo, jf[t].geo,
                                               jf[s].altitudes, jf[t].altitudes,
                                               jse3.from_rodrigues_xyz(jnp.asarray(est[0])),
                                               jse3.from_rodrigues_xyz(jnp.asarray(est[1])))
    assert ours.n_pairs == theirs.n_pairs == len(rows)
    for name in ours._fields:
        x, y = np.asarray(getattr(ours, name), np.float64), np.asarray(getattr(theirs, name), np.float64)
        if name.endswith("_pct"):
            assert abs(x - y) <= 100.0 / ours.n_pairs + 1e-9, name
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 if x.ndim == 0 else 1e-3, err_msg=name)
    stacked = _stacked(evaluate.eval_triangulated_consistency_stacked, tf, s, t, rows, est,
                       lambda geo, gras, dr, alts: (dr, geo, alts))
    for a, b in zip(ours, stacked):
        np.testing.assert_array_equal(a, b)


def _stacked(fn, tf, s, t, rows, est, frame_args, *extra):
    """``fn``'s result for the one block of rows of frames ``(s, t)``."""
    from diasss_tpu_torch.geometry import se3

    geo = torch.stack([tf[s].geo, tf[t].geo])
    gras = torch.stack([tf[s].ground_ranges, tf[t].ground_ranges])
    dr = torch.stack([tf[s].dr_poses, tf[t].dr_poses])
    alts = torch.stack([tf[s].altitudes, tf[t].altitudes])
    K = len(rows)
    poses = se3.from_rodrigues_xyz(torch.as_tensor(np.concatenate(est)))
    out = fn(rows, np.zeros(K, np.int64), np.ones(K, np.int64), [("pair", 0, K)], *frame_args(geo, gras, dr, alts),
             poses, np.asarray([0, len(est[0])]), *extra)
    return out["pair"]


def test_trajectory_ate_matches_jax():
    from diasss_tpu import evaluate as jev
    from diasss_tpu_torch import evaluate

    rows, ja, ta = _poses(8)
    gt = rows + np.random.default_rng(9).normal(size=rows.shape).astype(np.float32) * 0.3
    np.testing.assert_allclose(evaluate.trajectory_ate(ta, gt), jev.trajectory_ate(ja, gt), atol=1e-5)
    assert evaluate.trajectory_ate(ta, gt) == evaluate.trajectory_ate_pair(ta.t, ta, gt)[1]


def test_load_poses_rpy_and_frame_poses_match_jax(tmp_path):
    from diasss_tpu import pipeline as jpipeline
    from diasss_tpu import trajectory as jtrajectory
    from diasss_tpu_torch import pipeline, trajectory
    from diasss_tpu_torch.parallel.seq import to_host

    from diasss_tpu.geometry import se3 as jse3

    _, _, ta = _poses(10)
    ja = jse3.Pose3(jnp.asarray(ta.R.numpy()), jnp.asarray(ta.t.numpy()))  # the same arrays on both sides
    path = str(tmp_path / "poses.txt")
    trajectory.save_poses_rpy(path, ta)
    np.testing.assert_array_equal(trajectory.load_poses_rpy(path), jtrajectory.load_poses_rpy(path))
    slices = [slice(0, 12), slice(12, 32)]

    def result(cls, poses):
        blank = {f.name: None for f in dataclasses.fields(cls) if f.default is dataclasses.MISSING}
        return cls(**{**blank, "poses": poses, "frame_slices": slices})

    ours, theirs = result(pipeline.SlamResult, ta), result(jpipeline.SlamResult, ja)
    for f in range(len(slices)):
        np.testing.assert_array_equal(to_host(ours.frame_poses(f).t), np.asarray(theirs.frame_poses(f).t))
        np.testing.assert_array_equal(to_host(ours.frame_poses(f).R), np.asarray(theirs.frame_poses(f).R))


def test_package_exports():
    from diasss_tpu_torch import parallel, solvers
    from diasss_tpu_torch.parallel import ring, shard
    from diasss_tpu_torch.solvers import lm

    assert solvers.LMResult is lm.LMResult and solvers.levenberg_marquardt is lm.levenberg_marquardt
    assert parallel.ring_geo_nn_search is ring.ring_geo_nn_search
    for name in ("make_mesh", "sharded_full_ba_solve", "sharded_lc_solve", "sharded_pose_graph_solve"):
        assert getattr(parallel, name) is getattr(shard, name)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the defaults resolve to the card where CUDA is present")
def test_multi_device_defaults_raise_without_cuda(tmp_path):
    import torch.distributed as dist

    from diasss_tpu_torch.parallel import distributed, shard

    with pytest.raises(RuntimeError, match='device="cpu"'):
        distributed.default_device()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        distributed.initialize("file://" + str(tmp_path / "store0"), 1, 0)
    assert not dist.is_initialized()
    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0, backend="gloo")
    try:
        for fn in (lambda: shard.make_mesh(1), distributed.global_mesh):
            with pytest.raises(RuntimeError, match="--device cpu"):
                fn()
        assert shard.make_mesh(1, device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.run([sys.executable, "-m", "diasss_tpu_torch.parallel.multihost_check", "--init-method",
                           f"tcp://localhost:{port}", "--world-size", "1", "--rank", "0"], cwd=REPO,
                          env={**env, "PYTHONPATH": REPO}, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr, proc.stderr[-2000:]
    assert "MULTIHOST_OK" not in proc.stdout
