"""Parity of the parameters and result fields the port took last from the
JAX package's public signatures: ``geo_image``'s sensor lever arms,
keyframes built in float64, and ``SolveInfo.grad_norm``.  The same numpy
inputs go through both packages.

Tolerances and why:

* ``geo_image`` with lever arms: 5e-5 m, a few float32 ulps on positions of
  tens of metres (as ``test_torch_geometry.py``); zero lever arms give the
  output without them bit for bit;
* float64 keyframes against the JAX package's under ``jax.enable_x64``:
  geo within 1e-9 m (both sides compute in float64 with the same formulas;
  the cosines and sines round differently in the last ulp), poses,
  altitudes, ground ranges and raw exact (the same float32 values
  widened), the mask bit-identical, the uint8 ``norm`` within one grey
  level with at most 0.1% of the pixels off by one (both normalize in
  float32, and a pixel that sits on a rounding boundary can land either
  side when the frame-wide mean is summed in another order: one pixel of
  the 115,200 of this survey differs); against the port's float32 build
  the same norm and mask, and geo within 5e-5 m (float32 rounding);
* ``grad_norm`` after one trial: 1e-4 relative to the JAX package's (the
  port sums the direct step's gradient in float64, the JAX package in
  float32); after a full solve it is finite and at most the one-trial
  value, and a solve with no trial reports 0 as the JAX package's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import frame_items, port_cfg, small_survey
from diasss_tpu import frame as jframe
from diasss_tpu.config import PoseGraphConfig
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.geometry import sonar as jsonar
from diasss_tpu.solvers import pose_graph as jpg
from diasss_tpu_torch import frame
from diasss_tpu_torch.checkpoint import solve_pose_graph_checkpointed
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.geometry import sonar
from diasss_tpu_torch.solvers import pose_graph

TF_STB = (0.3, -0.2, 0.1)
TF_PORT = (-0.25, 0.15, 0.0)


@pytest.mark.parametrize("levers", [(TF_STB, TF_PORT), (TF_STB, None), (None, TF_PORT)])
def test_geo_image_lever_arms_match_jax(levers):
    rng = np.random.default_rng(0)
    n, m = 40, 64
    xy = (rng.normal(size=(2, n, 2)) * 30.0).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=(2, n)).astype(np.float32)
    gr = np.linspace(2.0, 40.0, m // 2, dtype=np.float32)
    ours = sonar.geo_image(torch.as_tensor(xy), torch.as_tensor(yaw), torch.as_tensor(gr), m,
                           *[None if a is None else torch.tensor(a) for a in levers])
    assert ours.shape == (2, n, m, 2) and ours.dtype == torch.float32
    for f in range(2):  # the port batches frames; the JAX function takes one
        theirs = jsonar.geo_image(jnp.asarray(xy[f]), jnp.asarray(yaw[f]), jnp.asarray(gr), m, *levers)
        np.testing.assert_allclose(ours[f].numpy(), np.asarray(theirs), rtol=0, atol=5e-5)
    plain = sonar.geo_image(torch.as_tensor(xy), torch.as_tensor(yaw), torch.as_tensor(gr), m)
    zero = sonar.geo_image(torch.as_tensor(xy), torch.as_tensor(yaw), torch.as_tensor(gr), m, (0.0, 0.0, 0.0),
                           [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(zero.numpy(), plain.numpy())
    shift = (plain - ours).numpy()  # each side moved by its own lever arm, as array-likes or tensors
    for side, cols in ((levers[0], slice(m // 2, m)), (levers[1], slice(0, m // 2))):
        expect = np.zeros(2) if side is None else np.asarray(side[:2])
        np.testing.assert_allclose(shift[..., cols, :], np.broadcast_to(expect, shift[..., cols, :].shape), atol=2e-5)


@pytest.fixture(scope="module")
def f64_frames():
    survey = small_survey()
    with jax.enable_x64(True):
        jf = jframe.build_keyframes_batch(frame_items(survey), dtype=jnp.float64)
        jf = [{k: np.asarray(getattr(f, k)) for k in ("raw", "norm", "mask", "geo", "dr_poses", "altitudes",
                                                       "ground_ranges")} for f in jf]
    return survey, jf, frame.build_keyframes_batch(frame_items(survey), dtype=torch.float64, device="cpu")


def test_float64_keyframes_match_jax_under_x64(f64_frames):
    survey, jf, tf = f64_frames
    off_by_one = 0
    for j, t in zip(jf, tf):
        for k in ("raw", "geo", "dr_poses", "altitudes", "ground_ranges"):
            assert j[k].dtype == np.float64 and getattr(t, k).dtype == torch.float64, k
        for k in ("raw", "dr_poses", "altitudes", "ground_ranges"):
            np.testing.assert_array_equal(getattr(t, k).numpy(), j[k], err_msg=k)
        np.testing.assert_allclose(t.geo.numpy(), j["geo"], rtol=0, atol=1e-9)
        assert t.mask.dtype == torch.bool and t.norm.dtype == torch.uint8
        np.testing.assert_array_equal(t.mask.numpy(), j["mask"])
        diff = np.abs(t.norm.numpy().astype(np.int64) - j["norm"].astype(np.int64))
        assert diff.max() <= 1
        off_by_one += int(diff.sum())
    assert off_by_one <= 1e-3 * sum(j["norm"].size for j in jf), off_by_one
    line = survey.lines[0]
    one = frame.build_keyframe(line.img_id, line.image, line.dr_poses, line.altitudes, line.ground_ranges,
                               dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(one.geo.numpy(), tf[0].geo.numpy())


def test_float32_keyframes_keep_float32_geo(f64_frames):
    survey, _, tf = f64_frames
    f32 = frame.build_keyframes_batch(frame_items(survey), device="cpu")
    for t, s in zip(tf, f32):
        assert s.geo.dtype == s.dr_poses.dtype == s.raw.dtype == torch.float32
        np.testing.assert_array_equal(t.norm.numpy(), s.norm.numpy())
        np.testing.assert_array_equal(t.mask.numpy(), s.mask.numpy())
        np.testing.assert_allclose(t.geo.numpy(), s.geo.numpy(), rtol=0, atol=5e-5)


@pytest.fixture(scope="module")
def lc_graph_120():
    """The 120-pose loop-closure graph of the JAX package's dense_seg /
    chain test (as ``tests/test_torch_optin.py`` builds it)."""
    rng = np.random.default_rng(5)
    n = 120
    rows = np.zeros((n, 6))
    rows[:, 3] = np.arange(n) * 0.5
    rows[:, 4] = 0.05 * rng.normal(size=n)
    gt = jse3.from_rodrigues_xyz(jnp.asarray(rows, jnp.float32))
    lc_i = np.arange(2, n - 40, 9, dtype=np.int32)
    lc_j = (lc_i + 30).astype(np.int32)
    meas = jse3.between(gt[jnp.asarray(lc_i)], gt[jnp.asarray(lc_j)])
    jg = jpg.build_chain_graph([rows], lc_i=lc_i, lc_j=lc_j, lc_meas=meas,
                               lc_sigmas=np.full((len(lc_i), 6), 0.05, np.float32),
                               lc_valid=np.ones(len(lc_i), bool), noise_key=jax.random.PRNGKey(1))
    return jg, to_torch(jg, device="cpu")


@pytest.mark.parametrize("kind", ["direct", "dense_seg"])
def test_grad_norm_after_one_trial_matches_jax(lc_graph_120, kind):
    jg, tg = lc_graph_120
    cfg = PoseGraphConfig(max_gn_iters=1, preconditioner=kind)
    _, jinfo = jpg.solve_pose_graph(jg, cfg)
    _, info = pose_graph.solve_pose_graph(tg, port_cfg(cfg))
    assert info.iterations == int(jinfo.iterations) == 1 and info.solver_kind == kind
    assert info.grad_norm.dtype == (torch.float64 if kind == "direct" else torch.float32)
    np.testing.assert_allclose(float(info.grad_norm), float(jinfo.grad_norm), rtol=1e-4)


def test_grad_norm_of_a_full_direct_solve(lc_graph_120, tmp_path):
    _, tg = lc_graph_120
    cfg = port_cfg(PoseGraphConfig(preconditioner="direct"))
    _, one = pose_graph.solve_pose_graph(tg, dataclasses.replace(cfg, max_gn_iters=1))
    _, full = pose_graph.solve_pose_graph(tg, cfg)
    assert full.iterations > 1
    assert torch.isfinite(full.grad_norm) and float(full.grad_norm) <= float(one.grad_norm)
    _, none = pose_graph.solve_pose_graph(tg, dataclasses.replace(cfg, max_gn_iters=0))
    assert none.iterations == 0 and float(none.grad_norm) == 0.0
    # a chunked solve ends on the same trial as the one-shot solve
    _, chunked = solve_pose_graph_checkpointed(tg, cfg, path=str(tmp_path / "ckpt.npz"), chunk=3)
    assert float(chunked.grad_norm) == float(full.grad_norm)
