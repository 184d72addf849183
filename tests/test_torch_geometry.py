"""Parity of the port's geometry (so3 / se3 / sonar) with the JAX package.

Same numpy inputs through both packages.  Tolerance: both sides compute in
float32 with the same formulas, but transcendental functions and 3x3 products
round differently in the last ulp, so values agree to a few float32 ulps
(atol 2e-6 on O(1) rotations, 5e-5 on positions of tens of metres); near pi
the log map's axis is conditioned by 1/sin and is held to 1e-3, as the JAX
package's own test holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

import torch_parity_helpers  # noqa: F401  (thread settings)
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.geometry import so3 as jso3
from diasss_tpu.geometry import sonar as jsonar
from diasss_tpu_torch.factors.between import between_residual
from diasss_tpu_torch.geometry import se3, so3, sonar


def _w(seed, n=64, scale=0.8):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32) * scale


def _T(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["exp", "left_jacobian", "left_jacobian_inv", "hat"])
def test_so3_vector_maps_match_jax(name):
    w = np.concatenate([_w(0), _w(1, 8, 1e-6), np.zeros((1, 3), np.float32)])
    np.testing.assert_allclose(_np(getattr(so3, name)(_T(w))), _np(getattr(jso3, name)(jnp.asarray(w))), atol=2e-6)


@pytest.mark.parametrize("name", ["log", "rpy", "yaw", "to_quaternion"])
def test_so3_matrix_maps_match_jax(name):
    R = np.asarray(jso3.exp(jnp.asarray(_w(2))))
    np.testing.assert_allclose(_np(getattr(so3, name)(_T(R))), _np(getattr(jso3, name)(jnp.asarray(R))), atol=2e-6)


def test_log_near_pi_and_yaw_near_pi():
    """Near-pi rotations (the compass-flip case): log and yaw agree with JAX."""
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = (axis * (np.pi - 1e-4)).astype(np.float32)
    yaw_pi = np.zeros((4, 3), np.float32)
    yaw_pi[:, 2] = [np.pi - 1e-3, -np.pi + 1e-3, np.pi - 1e-6, 3.0]
    for ws in (w, yaw_pi):
        R = np.asarray(jso3.exp(jnp.asarray(ws)))
        np.testing.assert_allclose(so3.log(_T(R)).numpy(), np.asarray(jso3.log(jnp.asarray(R))), atol=1e-3)
        np.testing.assert_allclose(so3.yaw(_T(R)).numpy(), np.asarray(jso3.yaw(jnp.asarray(R))), atol=2e-6)


def _rows(seed, n=32):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.normal(size=(n, 3)) * 0.5, rng.normal(size=(n, 3)) * 30.0], axis=1)
    return rows.astype(np.float32)


def test_se3_ops_match_jax():
    a, b = _rows(4), _rows(5)
    pa, pb = se3.from_rodrigues_xyz(_T(a)), se3.from_rodrigues_xyz(_T(b))
    ja, jb = jse3.from_rodrigues_xyz(jnp.asarray(a)), jse3.from_rodrigues_xyz(jnp.asarray(b))
    xi = np.random.default_rng(6).normal(size=(32, 6)).astype(np.float32) * 0.3
    pts = _rows(7)[:, 3:]
    pairs = [
        (se3.compose(pa, pb), jse3.compose(ja, jb)),
        (se3.between(pa, pb), jse3.between(ja, jb)),
        (se3.inverse(pa), jse3.inverse(ja)),
        (se3.expmap(_T(xi)), jse3.expmap(jnp.asarray(xi))),
        (se3.retract(pa, _T(xi)), jse3.retract(ja, jnp.asarray(xi))),
    ]
    for p, j in pairs:
        np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=2e-6)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), atol=5e-5)
    for p, j in [
        (se3.logmap(se3.expmap(_T(xi))), jse3.logmap(jse3.expmap(jnp.asarray(xi)))),
        (se3.to_rpyxyz(pa), jse3.to_rpyxyz(ja)),
        (se3.to_quat_xyzw_t(pa), jse3.to_quat_xyzw_t(ja)),
        (se3.transform_to(pa, _T(pts)), jse3.transform_to(ja, jnp.asarray(pts))),
    ]:
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=5e-5)


def test_between_jacobian_stays_float32():
    """Forward-mode Jacobians of a batched residual stay float32 (the port
    keeps the batch dimension real instead of vmapping per-problem 0-dim
    scalars, which torch's forward AD promotes to float64)."""
    a = se3.from_rodrigues_xyz(_T(_rows(8, 4)))
    b = se3.from_rodrigues_xyz(_T(_rows(9, 4)))

    def f(d):
        return between_residual(se3.retract(a, d), b, a)

    _, tangent = jvp(f, (torch.zeros(4, 6),), (torch.ones(4, 6),))
    assert tangent.dtype == torch.float32
    assert bool(torch.isfinite(tangent).all())


def test_geo_image_matches_jax_including_port_column_zero():
    rng = np.random.default_rng(10)
    n, m = 40, 64
    rows = np.zeros((n, 6), np.float32)
    rows[:, 2] = rng.normal(size=n) * 0.1 + np.pi - 1e-3  # heading near pi
    rows[:, 3] = np.arange(n) * 0.35
    rows[:, 4] = rng.normal(size=n)
    grs = (5.0 + np.arange(m // 2) * 0.5).astype(np.float32)
    geo = sonar.geo_image(_T(rows[:, 3:5]), _T(rows[:, 2]), _T(grs), m)
    jgeo = jsonar.geo_image(jnp.asarray(rows[:, 3:5]), jnp.asarray(rows[:, 2]), jnp.asarray(grs), m)
    np.testing.assert_allclose(geo.numpy(), np.asarray(jgeo), atol=5e-5)
    # port column 0 reads the clamped last ground-range entry and stays finite
    assert bool(torch.isfinite(geo[:, 0]).all())
    np.testing.assert_allclose(torch.linalg.norm(geo[:, 0] - _T(rows[:, 3:5]), dim=-1).numpy(), grs[-1], rtol=1e-5)


def test_sonar_helpers_match_jax():
    m = 64
    cols = np.arange(m)
    grs = (5.0 + np.arange(m // 2) * 0.5).astype(np.float32)
    alts = np.linspace(10, 12, 20).astype(np.float32)
    ping = np.arange(20) % 20
    col = (np.arange(20) * 3) % m
    np.testing.assert_array_equal(sonar.ground_range_index(_T(cols), m).numpy(),
                                  np.asarray(jsonar.ground_range_index(jnp.asarray(cols), m)))
    np.testing.assert_allclose(
        sonar.slant_range_at(_T(ping), _T(col), _T(alts), _T(grs), m).numpy(),
        np.asarray(jsonar.slant_range_at(jnp.asarray(ping), jnp.asarray(col), jnp.asarray(alts), jnp.asarray(grs), m)),
        atol=2e-6)
    np.testing.assert_array_equal(sonar.nadir_mask(_T(col), _T(col[::-1].copy()), m // 2, m // 2).numpy(),
                                  np.asarray(jsonar.nadir_mask(jnp.asarray(col), jnp.asarray(col[::-1]), m // 2, m // 2)))
    xy = _rows(11, 20)[:, 3:5]
    yaw = _rows(12, 20)[:, 2]
    np.testing.assert_allclose(
        sonar.project_landmark_geo(_T(xy), _T(yaw), _T(col), _T(grs), m).numpy(),
        np.asarray(jsonar.project_landmark_geo(jnp.asarray(xy), jnp.asarray(yaw), jnp.asarray(col), jnp.asarray(grs), m)),
        atol=5e-5)
