"""Parity of the port's preprocessing and feature detector with the JAX package.

Tolerances and why:

* normalize / mask: exact, on integer-valued images whose sums are exact in
  float32 in any order (on other images the frame-wide mean may differ in the
  last ulp between XLA's and torch's reduction order);
* one resize step on the same input: 1e-3 — the weights are rebuilt bit for
  bit and contracted in the order of JAX's einsum path, but XLA's and
  torch's GEMM kernels accumulate differently; measured up to 4e-4 on a
  fraction of the pixels at values up to 255.  The full pyramid compounds
  five such steps, held to 3e-3;
* blur 1e-4 (convolution summation order), orientation 1e-5 rad;
* keypoint positions: level 0 is bit-identical (it reads no resize); at least
  98% of the higher-level keypoints share their position (an ulp in a resized
  pixel can flip a corner that sits exactly at a threshold);
* SIFT descriptors (scale 512): 1e-3 on identical inputs and at level 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import port_cfg
from diasss_tpu.config import DetectorConfig, MaskConfig
from diasss_tpu.features import detector as jdet
from diasss_tpu.features import orient as jorient
from diasss_tpu.features import pyramid as jpyr
from diasss_tpu.features import sift as jsift
from diasss_tpu.frame import filtered_mask as jax_filtered_mask
from diasss_tpu.frame import normalize_sss as jax_normalize_sss
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.features import detector, orient, pyramid, sift
from diasss_tpu_torch.frame import filtered_mask, normalize_sss

CFG = DetectorConfig(n_features=400, desc_size_scale=8.0 / 31.0)


def _T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def waterfall():
    """A normalized synthetic waterfall (uint8) and its mask, from the JAX package."""
    raw = make_survey(n_lines=1, n_pings=260, n_bins=320, n_landmarks=30, seed=3).lines[0].image
    raw = jnp.asarray(raw, jnp.float32)
    return np.asarray(jax_normalize_sss(raw)), np.asarray(jax_filtered_mask(raw))


@pytest.fixture(scope="module")
def detections(waterfall):
    norm, mask = waterfall
    j = jdet.detect_features(jnp.asarray(norm), jnp.asarray(mask), CFG)
    t = detector.detect_features(_T(norm), _T(mask), port_cfg(CFG))
    return {f: np.asarray(getattr(j, f)) for f in j._fields}, {f: getattr(t, f).numpy() for f in t._fields}


@pytest.mark.parametrize("shape", [(64, 96), (300, 200)])
def test_normalize_and_mask_exact_on_integer_images(shape):
    rng = np.random.default_rng(shape[0])
    raw = rng.integers(0, 120, shape).astype(np.float32)
    raw[rng.integers(0, shape[0], 20), rng.integers(0, shape[1], 20)] = 250.0  # bright kills
    cfg = MaskConfig(side_pings=20)
    np.testing.assert_array_equal(normalize_sss(_T(raw)).numpy(), np.asarray(jax_normalize_sss(jnp.asarray(raw))))
    np.testing.assert_array_equal(filtered_mask(_T(raw), port_cfg(cfg)).numpy(),
                                  np.asarray(jax_filtered_mask(jnp.asarray(raw), cfg)))


def test_resize_step_and_pyramid(waterfall):
    img = waterfall[0].astype(np.float32)
    jl = jpyr.build_pyramid(jnp.asarray(img), 6, 1.2)
    tl = pyramid.build_pyramid(_T(img), 6, 1.2)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    for lvl in range(1, 6):
        one_step = pyramid.resize_linear(_T(jl[lvl - 1]), tuple(jl[lvl].shape)).numpy()
        np.testing.assert_allclose(one_step, np.asarray(jl[lvl]), atol=1e-3)
        np.testing.assert_allclose(tl[lvl].numpy(), np.asarray(jl[lvl]), atol=3e-3)


def test_blur_and_orientation(waterfall):
    img = waterfall[0].astype(np.float32)
    np.testing.assert_allclose(pyramid.gaussian_blur(_T(img)).numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(img))), atol=1e-4)
    kps = np.array([[40, 30], [0, 0], [319, 259], [150, 100], [400, 500]], np.float32)  # incl. clamped
    np.testing.assert_allclose(orient.ic_angles(_T(img), _T(kps)).numpy(),
                               np.asarray(jorient.ic_angles(jnp.asarray(img), jnp.asarray(kps))), atol=1e-5)


def test_sift_tables_equal():
    gx, gy = jsift._sample_grid_np()
    np.testing.assert_array_equal(sift.sample_grid_np()[0], gx)
    np.testing.assert_array_equal(sift.sample_grid_np()[1], gy)
    np.testing.assert_array_equal(sift.soft_assign_matrix_np(), jsift._soft_assign_matrices())


def test_sift_descriptors_on_identical_inputs(waterfall):
    img = np.asarray(jpyr.gaussian_blur(jnp.asarray(waterfall[0].astype(np.float32))))
    rng = np.random.default_rng(4)
    kps = np.stack([rng.uniform(0, 320, 64), rng.uniform(0, 260, 64)], 1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    size = np.full(64, 8.0, np.float32)
    ours = sift.sift_descriptors(_T(img), _T(kps), _T(ang), _T(size)).numpy()
    ref = np.asarray(jsift.sift_descriptors(jnp.asarray(img), jnp.asarray(kps), jnp.asarray(ang), jnp.asarray(size)))
    np.testing.assert_allclose(ours, ref, atol=1e-3)


def test_keypoint_selection_tie_order_matches_top_k():
    """Many equal scores: the stable sort reproduces lax.top_k's lower-index-first order."""
    rng = np.random.default_rng(5)
    score = rng.integers(0, 4, (90, 120)).astype(np.float32) * 10.0
    ours = detector._select_keypoints(_T(score), 150, 30, 6, 5)
    ref = jdet._select_keypoints(jnp.asarray(score), 150, 30, 6, 6, 5, 90, 120)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_level0_keypoints_bit_identical(detections):
    j, t = detections
    lv0 = j["level"] == 0
    assert j["valid"][lv0].sum() > 10
    np.testing.assert_array_equal(t["level"], j["level"])
    for f in ("xy", "response", "valid", "size"):
        np.testing.assert_array_equal(t[f][lv0], j[f][lv0])
    both = lv0 & j["valid"]
    np.testing.assert_allclose(t["angle"][both], j["angle"][both], atol=1e-5)
    np.testing.assert_allclose(t["desc"][both], j["desc"][both], atol=1e-3)


def test_all_levels_mostly_identical(detections):
    j, t = detections
    for lvl in range(1, CFG.n_levels):
        sel = j["level"] == lvl
        same = np.all(t["xy"][sel] == j["xy"][sel], axis=1) & (t["valid"][sel] == j["valid"][sel])
        assert same.mean() >= 0.98, (lvl, same.mean())


def test_stacked_layout_and_other_descriptors_raise():
    img = torch.zeros(64, 64)
    with pytest.raises(NotImplementedError, match="not-to-port"):
        detector.detect_features(img, stacked=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        detector.detect_features(img, cfg=port_cfg(DetectorConfig(descriptor="orb")))
