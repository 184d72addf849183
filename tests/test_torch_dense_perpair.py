"""Parity of the port's per-pair dense matcher (``world_raster``,
``raster_shape``, ``dense_matching``, the host ``_smooth_filter``) with the
JAX package's, on a small drifting survey with a tie line (3 frames of
200 x 384, 500 keypoint slots).

Each frame is rasterized at its own fitted shape, which differs from the
stacked matcher's survey-common shape; the online stream matches this way.

Tolerances, and why:

* raster shape and origin, raster counts, the smoothness filter: identical
  (integer counts; float32 bounds; a sort);
* raster means: 1e-5 relative (sums of many float32 values);
* matches against the JAX package's per-pair matcher on its CPU default
  (the lattice branch, which the port does not take: its refinement scores
  are einsums summed in another order): at least 99% of the rows identical,
  counts within one match per pair.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity_helpers import jax_and_port_frames, port_cfg
from diasss_tpu.config import DenseMatchConfig, DetectorConfig
from diasss_tpu.features import detect_features as jax_detect
from diasss_tpu.matching import dense as jdense
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.matching import dense

DCFG = DetectorConfig(descriptor="geo_patch", n_features=500)
MCFG = DenseMatchConfig(search_radius=10.0)
RES = DCFG.geopatch_res


@pytest.fixture(scope="module")
def setup():
    survey = make_survey(n_lines=2, n_pings=200, n_bins=384, n_landmarks=120, n_tie_lines=1, drift_xy=0.006,
                         seed=7)
    jf, tf = jax_and_port_frames(survey)
    feats = [jax_detect(f.norm, f.mask, DCFG) for f in jf]
    return jf, tf, feats


@pytest.mark.parametrize("frame", [0, 2])
def test_world_raster_and_shape_match_jax(setup, frame):
    jf, tf, _ = setup
    ref = jdense.world_raster(jf[frame].norm, jf[frame].geo, RES)
    ours = dense.world_raster(tf[frame].norm, tf[frame].geo, RES)
    assert dense.raster_shape(tf[frame].geo, RES) == jdense.raster_shape(jf[frame].geo, RES) == ours.img.shape
    assert (ours.x0, ours.y0, ours.res) == (ref.x0, ref.y0, ref.res)
    np.testing.assert_array_equal(ours.cnt.numpy(), np.asarray(ref.cnt))
    for a, b in ((ours.img, ref.img), (ours.ping, ref.ping), (ours.col, ref.col)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # a shape override keeps the origin and rasterizes into the larger grid
    big = dense.world_raster(tf[frame].norm, tf[frame].geo, RES, shape=(ours.img.shape[0] + 64, ours.img.shape[1]))
    assert (big.x0, big.y0) == (ours.x0, ours.y0)
    np.testing.assert_array_equal(big.cnt[: ours.img.shape[0]].numpy(), ours.cnt.numpy())


def test_smooth_filter_host_wrapper_matches_jax():
    rng = np.random.default_rng(4)
    K = 200
    kp = rng.uniform(0, 80, (K, 2)).astype(np.float32)
    tgt = (kp + np.array([0.5, 1.0], np.float32) + rng.normal(0, 0.7, (K, 2))).astype(np.float32)
    ok = rng.uniform(size=K) > 0.4
    cfg = dataclasses.replace(MCFG, smooth_radius=10.0)
    for mask in (ok, np.zeros(K, bool)):
        ref = np.asarray(jdense._smooth_filter(kp, tgt, mask, cfg))
        ours = dense._smooth_filter(torch.as_tensor(kp), torch.as_tensor(tgt), torch.as_tensor(mask), port_cfg(cfg))
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert 0 < ref.sum() < K if mask.any() else not ref.any()


PAIRS = [(0, 1), (0, 2), (1, 2), (1, 0), (2, 0), (2, 1)]


def test_dense_matching_per_pair_matches_jax(setup):
    """Every ordered pair on rasters built once per frame (as the online
    stream does), the rows of all pairs together held to the JAX package's."""
    jf, tf, feats = setup
    rasters = [dense.world_raster(f.norm, f.geo, RES) for f in tf]
    tfeats = [to_torch(f, device="cpu") for f in feats]
    rows_o, rows_r = [], []
    for i, j in PAIRS:
        ref = jdense.dense_matching(i, j, feats[i], jf[i].norm, jf[i].geo, jf[j].norm, jf[j].geo, DCFG, MCFG)
        ours = dense.dense_matching(i, j, tfeats[i], tf[i].norm, tf[i].geo, tf[j].norm, tf[j].geo, port_cfg(DCFG),
                                    port_cfg(MCFG), raster_s=rasters[i], raster_t=rasters[j])
        assert ref[2] >= 10 and abs(ours[2] - ref[2]) <= 1, (i, j, ours[2], ref[2])
        np.testing.assert_array_equal(ours[1][:, 2:4], ours[0][:, 4:6])
        rows_o.append(ours[0])
        rows_r.append(ref[0])
    a, b = {tuple(r) for r in np.concatenate(rows_o)}, {tuple(r) for r in np.concatenate(rows_r)}
    assert len(a & b) >= 0.99 * len(b), (len(a & b), len(b))
    # the rasters are rebuilt when not passed in
    again = dense.dense_matching(2, 1, tfeats[2], tf[2].norm, tf[2].geo, tf[1].norm, tf[1].geo, port_cfg(DCFG),
                                 port_cfg(MCFG))
    np.testing.assert_array_equal(again[0], rows_o[-1])
