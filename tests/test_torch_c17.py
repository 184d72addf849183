"""Where the pose-graph solve stops must not depend on the arithmetic.

A chain pose graph of 1200 poses whose coordinates sit 2 km from the
origin, with 48 loop closures measured from ground truth.  At that distance
a float32 ``between`` rounds ``R^T t`` by about 1e-4 m against odometry
sigmas of 1e-3 m, so a float32 cost is off its float64 value by more than
the last LM decreases, and float32 gradient sums taken in another order (a
sequence-parallel solve on 2 ranks) steer the end game elsewhere.  The
port forms the cost in float64 from the float32 poses and sums the direct
step's gradient and damping blocks in float64, so the one-device solve and
the 2-rank solve stop after the same trials at the same poses.

Tolerances: the same trial count; poses within 1e-4 m (measured: 0 m; the
float32 cost and sums left them 2-3 mm apart); the cost within 1e-9
relative of a numpy float64 evaluation of the same residuals.
"""

import numpy as np
import pytest
import torch

from torch_parallel_helpers import run_ranks
from diasss_tpu_torch.config import PoseGraphConfig
from diasss_tpu_torch.factors.between import between_residual
from diasss_tpu_torch.geometry import se3
from diasss_tpu_torch.solvers import pose_graph
from diasss_tpu_torch.synthetic import make_survey

OFFSET_M = 2000.0  # the survey's origin moved by this much in x and y
N_LC = 48


class _NumpyNoise:
    """The initial-value noise as numpy draws from a seed."""

    def __init__(self, seed: int):
        self._g = np.random.default_rng(seed)

    def normal(self, shape):
        return torch.as_tensor(self._g.standard_normal(shape).astype(np.float32))


@pytest.fixture(scope="module")
def far_graph():
    survey = make_survey(n_lines=3, n_pings=400, n_bins=64, n_landmarks=0)
    rows = [l.dr_poses.astype(np.float64) for l in survey.lines]
    gt = np.concatenate([l.gt_poses for l in survey.lines]).astype(np.float64)
    for r in rows + [gt]:
        r[:, 3:5] += OFFSET_M
    P = len(gt)
    rng = np.random.default_rng(0)
    lc_i = rng.integers(1, P - 300, N_LC)
    lc_j = lc_i + rng.integers(100, 300, N_LC)
    gt_poses = se3.from_rodrigues_xyz(torch.as_tensor(gt.astype(np.float32)))
    meas = se3.between(gt_poses[torch.as_tensor(lc_i)], gt_poses[torch.as_tensor(lc_j)])
    cfg = PoseGraphConfig()
    graph = pose_graph.build_chain_graph([r.astype(np.float32) for r in rows], lc_i, lc_j, meas,
                                         np.full((N_LC, 6), 0.05, np.float32), np.ones(N_LC, bool), cfg,
                                         rng=_NumpyNoise(0), device="cpu")
    return graph, cfg, pose_graph.solve_pose_graph(graph, cfg)


def _graph_arrays(g) -> dict:
    out = {}
    for k in ("poses0", "odo_meas", "lc_meas"):
        p = getattr(g, k)
        out[f"pg_{k}_R"], out[f"pg_{k}_t"] = p.R.numpy(), p.t.numpy()
    for k in ("odo_sigmas", "lc_i", "lc_j", "lc_sigmas", "lc_valid"):
        out[f"pg_{k}"] = getattr(g, k).numpy()
    return out


def test_one_device_and_two_ranks_stop_at_the_same_point(far_graph, tmp_path):
    graph, cfg, (poses, info) = far_graph
    ranks = run_ranks(tmp_path, 2, ["seq_pg"], {**_graph_arrays(graph), "pg_kinds": "direct",
                                                 "pg_iters": cfg.max_gn_iters})
    for r in ranks:
        assert str(r["seq_pg/direct_kind"]) == "sp_direct"
        trials = int(r["seq_pg/direct_iters"])
        gap = float(np.abs(r["seq_pg/direct_t"] - poses.t.numpy()).max())
        assert trials == info.iterations and gap <= 1e-4, (trials, info.iterations, gap)
        np.testing.assert_allclose(float(r["seq_pg/direct_error"]), float(info.error), rtol=1e-9)
    assert info.error.dtype == torch.float64 and poses.t.dtype == torch.float32
    assert float(info.error) < 1e-6 * float(info.error0)


def _log_so3(R):
    """GTSAM's Rot3::Logmap in float64, with the port's arccos clamp (its
    argument held 1e-7 inside [-1, 1], which keeps forward-mode Jacobians at
    the identity finite)."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = np.arccos(c)
    assert theta.max() < np.pi - 1e-3
    antisym = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    return (theta / (2.0 * np.sin(theta)))[..., None] * antisym


def _hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1), np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _between_residual(Ri, ti, Rj, tj, Rm, tm):
    """Logmap(m^-1 (xi^-1 xj)) in float64: (omega, V^-1 t)."""
    R = Ri.swapaxes(-1, -2) @ Rj
    t = np.einsum("...ji,...j->...i", Ri, tj - ti)
    E = Rm.swapaxes(-1, -2) @ R
    e = np.einsum("...ji,...j->...i", Rm, t - tm)
    w = _log_so3(E)
    th2 = np.sum(w * w, -1)
    th = np.sqrt(th2)
    half = th / 2.0
    small = th2 < 1e-8
    coef = np.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - half * np.cos(half) / np.sin(np.where(small, 1.0, half))) / np.where(small, 1.0, th2))
    W = _hat(w)
    Vinv = np.eye(3) - 0.5 * W + coef[..., None, None] * (W @ W)
    return np.concatenate([w, np.einsum("...ij,...j->...i", Vinv, e)], -1)


def _numpy_graph_error(poses, g):
    R, t = poses.R.double().numpy(), poses.t.double().numpy()
    om, lm = g.odo_meas, g.lc_meas
    r_o = _between_residual(R[:-1], t[:-1], R[1:], t[1:], om.R.double().numpy(), om.t.double().numpy())
    r_o = r_o / g.odo_sigmas.double().numpy()
    i, j = g.lc_i.numpy(), g.lc_j.numpy()
    r_l = _between_residual(R[i], t[i], R[j], t[j], lm.R.double().numpy(), lm.t.double().numpy())
    r_l = np.where(g.lc_valid.numpy()[:, None], r_l / g.lc_sigmas.double().numpy(), 0.0)
    return 0.5 * (np.sum(r_o ** 2) + np.sum(r_l ** 2))


def test_graph_error_is_float64(far_graph):
    """``graph_error`` at the initial and the solved poses against numpy in
    float64; the float32 cost of the same poses is far off (the scale of
    the fault)."""
    graph, _, (solved, _) = far_graph
    for poses in (graph.poses0, solved):
        err = pose_graph.graph_error(poses, graph)
        ref = _numpy_graph_error(poses, graph)
        assert err.dtype == torch.float64
        np.testing.assert_allclose(float(err), ref, rtol=1e-9)
    r_o = between_residual(solved[:-1], solved[1:], graph.odo_meas) / graph.odo_sigmas
    r_l = between_residual(solved[graph.lc_i], solved[graph.lc_j], graph.lc_meas) / graph.lc_sigmas
    err32 = float(0.5 * (torch.sum(r_o * r_o) + torch.sum(r_l[graph.lc_valid] ** 2)))
    assert r_o.dtype == torch.float32
    assert abs(err32 - ref) > 1e-6 * ref
