"""Parity of the port's orb and geo_patch descriptor families
(``features/orb_desc.py``, ``features/geopatch.py``) and of the robust
matcher with the Hamming metric's parity-dependent bounds, with the JAX
package.

Tolerances, and why:

* the ORB sampling pattern: bit-identical (the same numpy draw);
* ORB bits and Hamming distances: identical (comparisons of bilinear
  samples computed in the same float32 order, then an exact matmul of +-1);
* geo patches and both attaches: 1e-5 (bilinear samples, a mean and a
  norm summed in another order), the same validity mask;
* robust matching of ORB features, stacked and per pair: identical rows
  (integer outcomes of exact Hamming distances; the SCC draws come from
  ``JaxRng``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu.config import DetectorConfig, MatcherConfig
from diasss_tpu.features import detect_features as jax_detect
from diasss_tpu.features import geopatch as jgeopatch
from diasss_tpu.features import orb_desc as jorb
from diasss_tpu.features.detector import DetectedFeatures as JFeatures
from diasss_tpu.matching import robust as jrobust
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.features import geopatch, orb_desc
from diasss_tpu_torch.matching import robust

ORB_CLI = MatcherConfig(desc_metric="hamming", ratio_excl_radius=2.0, ratio_test=0.8, cross_check=True,
                        scc_mode="xy")
ORB_LOOSE = MatcherConfig(desc_metric="hamming", ratio_test=0.95, orb_dist_bound=110.0,
                          orb_dist_bound_cross=100.0, scc_mode="x")


def _T(a):
    return torch.as_tensor(np.array(a))


def test_orb_pattern_bit_identical():
    np.testing.assert_array_equal(orb_desc._pattern(), jorb._pattern())
    assert orb_desc._pattern().dtype == np.float32 and orb_desc.N_BITS == jorb.N_BITS


def test_orb_descriptors_and_hamming_identical():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (90, 120)).astype(np.float32)
    K = 64
    kps = np.stack([rng.uniform(0, 120, K), rng.uniform(0, 90, K)], 1).astype(np.float32)  # edges clamp
    ang = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    sizes = rng.uniform(8, 40, K).astype(np.float32)
    ref = np.asarray(jorb.orb_descriptors(jnp.asarray(img), jnp.asarray(kps), jnp.asarray(ang), jnp.asarray(sizes)))
    ours = orb_desc.orb_descriptors(_T(img), _T(kps), _T(ang), _T(sizes)).numpy()
    assert ours.shape == (K, 256) and set(np.unique(ours)) == {-1.0, 1.0}
    np.testing.assert_array_equal(ours, ref)
    ham = orb_desc.hamming_matrix(_T(ours[:40]), _T(ours[20:])).numpy()
    np.testing.assert_array_equal(ham, np.asarray(jorb.hamming_matrix(jnp.asarray(ref[:40]), jnp.asarray(ref[20:]))))
    assert (np.diag(ham[20:]) == 0).all() and ham.max() > 64


@pytest.fixture(scope="module")
def frames():
    return jax_and_port_frames(small_survey(n_lines=3, n_pings=200, n_bins=384, n_landmarks=150))


def _random_feats(jf, k, seed):
    rng = np.random.default_rng(seed)
    n, m = jf.norm.shape
    xy = np.stack([rng.integers(0, m, k), rng.integers(0, n, k)], 1).astype(np.float32)
    z = np.zeros(k, np.float32)
    return JFeatures(xy=jnp.asarray(xy), response=jnp.asarray(z), angle=jnp.asarray(z), size=jnp.asarray(z),
                     level=jnp.zeros(k, jnp.int32), desc=jnp.zeros((k, 1), jnp.float32),
                     valid=jnp.asarray(rng.uniform(size=k) > 0.1))


def test_geo_patch_descriptors_and_attaches_match_jax(frames):
    jf, tf = frames
    dcfg = DetectorConfig(descriptor="geo_patch")
    feats = [_random_feats(f, 150, s) for s, f in enumerate(jf)]
    tfeats = [to_torch(f, device="cpu") for f in feats]
    desc, ok = jgeopatch.geo_patch_descriptors(jf[0].norm, jf[0].geo, feats[0].xy)
    ours, ours_ok = geopatch.geo_patch_descriptors(tf[0].norm, tf[0].geo, tfeats[0].xy)
    np.testing.assert_array_equal(ours_ok.numpy(), np.asarray(ok))
    np.testing.assert_allclose(ours.numpy(), np.asarray(desc), atol=1e-5)
    assert int(ours_ok.sum()) > 100

    single = geopatch.attach_geo_patch_descriptors(tfeats[1], tf[1].norm, tf[1].geo, port_cfg(dcfg))
    ref_single = jgeopatch.attach_geo_patch_descriptors(feats[1], jf[1].norm, jf[1].geo, dcfg)
    batch = geopatch.attach_geo_patch_descriptors_batch(tfeats, [f.norm for f in tf], [f.geo for f in tf],
                                                        port_cfg(dcfg))
    ref_batch = jgeopatch.attach_geo_patch_descriptors_batch(feats, [f.norm for f in jf], [f.geo for f in jf], dcfg)
    for o, r in [(single, ref_single)] + list(zip(batch, ref_batch)):
        np.testing.assert_array_equal(o.valid.numpy(), np.asarray(r.valid))
        np.testing.assert_allclose(o.desc.numpy(), np.asarray(r.desc), atol=1e-5)
    np.testing.assert_array_equal(batch[1].desc.numpy(), single.desc.numpy())


@pytest.fixture(scope="module")
def orb_feats(frames):
    jf, _ = frames
    return [jax_detect(f.norm, f.mask, DetectorConfig(descriptor="orb", n_features=400)) for f in jf]


@pytest.mark.parametrize("cfg", [ORB_CLI, ORB_LOOSE], ids=["cli", "loose"])
def test_robust_matching_orb_identical_rows(frames, orb_feats, cfg):
    """Stacked over pairs of both id parities (bounds 80 across, 88 within
    by default), and one pair alone."""
    jf, tf = frames
    pairs = [(0, 1), (1, 2), (0, 2)]
    tfeats = [to_torch(f, device="cpu") for f in orb_feats]
    ref = jrobust.robust_matching_stacked(pairs, [0, 1, 2], orb_feats, [f.geo for f in jf],
                                          [f.raw.shape[0] for f in jf], cfg=cfg)
    ours = robust.robust_matching_stacked(pairs, [0, 1, 2], tfeats, [f.geo for f in tf],
                                          [int(f.raw.shape[0]) for f in tf], JaxRng(cfg.rng_seed), cfg=port_cfg(cfg))
    for key in pairs:
        np.testing.assert_array_equal(ours[key].rows_s, ref[key].rows_s)
        assert (ours[key].inliers_1, ours[key].inliers_2, ours[key].consistent) == \
            (ref[key].inliers_1, ref[key].inliers_2, ref[key].consistent)
    i, j = 0, 1
    one = robust.robust_matching(i, j, tfeats[i], tfeats[j], tf[i].geo, tf[j].geo, int(tf[i].raw.shape[0]),
                                 int(tf[j].raw.shape[0]), JaxRng(cfg.rng_seed), cfg=port_cfg(cfg))
    one_ref = jrobust.robust_matching(i, j, orb_feats[i], orb_feats[j], jf[i].geo, jf[j].geo, jf[i].raw.shape[0],
                                      jf[j].raw.shape[0], cfg=cfg)
    np.testing.assert_array_equal(one.rows_s, one_ref.rows_s)
    if cfg is ORB_LOOSE:
        assert sum(r.n_matches for r in ref.values()) >= 5

