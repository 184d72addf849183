"""Parity of the port's matcher (geo-gated NN search, SCC, bidirectional
merge) with the JAX package.

Both sides get the same numpy inputs; the SCC hypotheses come from
``JaxRng``, which makes the JAX package's own ``jax.random`` calls.  Every
comparison is exact: the outputs are indices and counts, and the float
distances feeding them differ only in the last ulp (GEMM order), far from
any accept threshold on these inputs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import JaxRng, jax_and_port_frames, port_cfg, small_survey
from diasss_tpu.config import DetectorConfig, MatcherConfig
from diasss_tpu.features import detect_features as jax_detect
from diasss_tpu.matching import geosearch as jgeo
from diasss_tpu.matching import robust as jrobust
from diasss_tpu.matching import scc as jscc
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.matching import geosearch, robust, scc
from diasss_tpu_torch.rng import TorchRng

CONFIGS = {
    "detected_cli": MatcherConfig(ratio_excl_radius=2.0, ratio_test=0.6, sift_dist_bound=450.0,
                                  cross_check=True, scc_mode="xy"),
    "loose_x": MatcherConfig(ratio_test=0.9, sift_dist_bound=600.0, scc_mode="x"),
    "default": MatcherConfig(),
}


def _T(a):
    return torch.as_tensor(np.array(a))


def _nn_inputs(seed, k=120, kr=100):
    """Keypoints on a small patch of seabed with duplicated descriptors (ties)."""
    rng = np.random.default_rng(seed)
    gq = rng.uniform(0, 30, (k, 2)).astype(np.float32)
    gr = (gq[:kr] + rng.normal(0, 1.0, (kr, 2))).astype(np.float32)
    dq = rng.uniform(0, 60, (k, 128)).astype(np.float32)
    dr = (dq[:kr] + rng.normal(0, 8.0, (kr, 128))).astype(np.float32)
    dr[10] = dr[11]  # exact duplicate reference descriptors: a tie
    gr[10] = gr[11]
    vq = rng.uniform(size=k) > 0.1
    vr = rng.uniform(size=kr) > 0.1
    bbox = np.array([0, 28, 0, 28], np.float32)
    return gq, dq, vq, gr, dr, vr, bbox


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_nn_core_identical(name):
    cfg = CONFIGS[name]
    args = _nn_inputs(1)
    ref = jgeo.nn_core(*[jnp.asarray(a) for a in args], jnp.asarray(np.float32(cfg.sift_dist_bound)), cfg)
    ours = geosearch.nn_core(*[_T(a) for a in args], cfg.sift_dist_bound, port_cfg(cfg))
    assert (np.asarray(ref.corres) >= 0).sum() > 5
    np.testing.assert_array_equal(ours.corres.numpy(), np.asarray(ref.corres))
    np.testing.assert_array_equal(ours.n_candidates.numpy(), np.asarray(ref.n_candidates))
    single = geosearch.geo_nn_search(*[_T(a) for a in args], port_cfg(cfg))
    np.testing.assert_array_equal(single.corres.numpy(), np.asarray(jgeo.geo_nn_search(*[jnp.asarray(a) for a in args], cfg).corres))


@pytest.mark.parametrize("mode", ["x", "xy"])
def test_scc_filter_identical_on_same_samples(mode):
    cfg = MatcherConfig(scc_mode=mode, scc_max_iters=200)
    rng = np.random.default_rng(2)
    k, kr = 80, 70
    yq = rng.uniform(0, 300, k).astype(np.float32)
    yr = rng.uniform(0, 300, kr).astype(np.float32)
    xq = rng.uniform(0, 256, k).astype(np.float32)
    xr = rng.uniform(0, 256, kr).astype(np.float32)
    corres = np.where(rng.uniform(size=k) > 0.4, rng.integers(0, kr, k), -1).astype(np.int32)
    yr[corres[corres >= 0][:25]] = yq[corres >= 0][:25] + 7.0  # a consensus offset
    key = jax.random.split(jax.random.PRNGKey(cfg.rng_seed))[0]
    ref = jscc.scc_filter(jnp.asarray(yq), jnp.asarray(yr), jnp.asarray(corres), jnp.asarray(True),
                          jnp.asarray(300.0), key, cfg, kp_x_q=jnp.asarray(xq), kp_x_r=jnp.asarray(xr))
    ours = scc.scc_filter(_T(yq), _T(yr), _T(corres).long(), torch.tensor(True), torch.tensor(300.0),
                          JaxRng(cfg.rng_seed), port_cfg(cfg), kp_x_q=_T(xq), kp_x_r=_T(xr))
    np.testing.assert_array_equal(ours.corres.numpy(), np.asarray(ref.corres))
    assert int(ours.inlier_count) == int(ref.inlier_count)
    assert float(ours.model_x) == float(ref.model_x)


@pytest.fixture(scope="module")
def detected():
    survey = small_survey(n_pings=300, n_bins=512, n_landmarks=150)
    jf, tf = jax_and_port_frames(survey)
    dcfg = DetectorConfig(n_features=600)
    feats = [jax_detect(f.norm, f.mask, dcfg) for f in jf]
    return jf, tf, feats


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_robust_matching_stacked_identical_rows(detected, name):
    cfg = CONFIGS[name]
    jf, tf, feats = detected
    pairs = [(0, 1), (1, 2), (0, 2)]
    ref = jrobust.robust_matching_stacked(pairs, [0, 1, 2], feats, [f.geo for f in jf],
                                          [f.raw.shape[0] for f in jf], cfg=cfg)
    ours = robust.robust_matching_stacked(pairs, [0, 1, 2], [to_torch(f, device="cpu") for f in feats],
                                          [f.geo for f in tf], [int(f.raw.shape[0]) for f in tf],
                                          JaxRng(cfg.rng_seed), cfg=port_cfg(cfg))
    for key in pairs:
        assert ours[key].n_matches == ref[key].n_matches
        np.testing.assert_array_equal(ours[key].rows_s, ref[key].rows_s)
        np.testing.assert_array_equal(ours[key].rows_t, ref[key].rows_t)
        assert (ours[key].inliers_1, ours[key].inliers_2, ours[key].consistent) == \
            (ref[key].inliers_1, ref[key].inliers_2, ref[key].consistent)
    if name == "loose_x":
        assert sum(r.n_matches for r in ref.values()) >= 10


def test_robust_matching_per_pair_identical_rows(detected):
    cfg = CONFIGS["loose_x"]
    jf, tf, feats = detected
    ref = jrobust.robust_matching(1, 2, feats[1], feats[2], jf[1].geo, jf[2].geo, jf[1].raw.shape[0],
                                  jf[2].raw.shape[0], cfg=cfg)
    ours = robust.robust_matching(1, 2, to_torch(feats[1], device="cpu"), to_torch(feats[2], device="cpu"),
                                  tf[1].geo, tf[2].geo, int(tf[1].raw.shape[0]), int(tf[2].raw.shape[0]),
                                  JaxRng(cfg.rng_seed), cfg=port_cfg(cfg))
    assert ours.n_matches == ref.n_matches > 0
    np.testing.assert_array_equal(ours.rows_s, ref.rows_s)


@pytest.mark.parametrize("metric", ["hamming", "ncc"])
def test_other_metrics_raise_naming_roadmap(metric):
    """The hamming (ORB) and ncc (geo patch) metrics give the JAX
    package's matches: Hamming distances of +-1 bits under both parity
    bounds (with the ORB rule that a real second-best must exist), and
    1 - NCC of unit mean-free descriptors (dot products summed in another
    order: 1e-6)."""
    gq, dq, vq, gr, dr, vr, bbox = _nn_inputs(3)
    rng = np.random.default_rng(4)
    if metric == "hamming":
        flip = rng.uniform(size=dr.shape) < 0.15
        dq = np.where(rng.uniform(size=dq.shape) < 0.5, 1.0, -1.0).astype(np.float32)
        dr = np.where(flip, -dq[: len(dr)], dq[: len(dr)]).astype(np.float32)
        dr[10] = dr[11]  # a tie
        cfg = MatcherConfig(desc_metric=metric, ratio_test=0.9)
        cases = [(False, cfg.orb_dist_bound), (True, cfg.orb_dist_bound_cross)]
    else:
        dq = dq - dq.mean(1, keepdims=True)
        dq /= np.linalg.norm(dq, axis=1, keepdims=True)
        dr = dr - dr.mean(1, keepdims=True)
        dr /= np.linalg.norm(dr, axis=1, keepdims=True)
        cfg = MatcherConfig(desc_metric=metric, ncc_ratio=0.9)
        cases = [(False, 1.0 - cfg.ncc_min)]
    args = (gq, dq, vq, gr, dr, vr, bbox)
    for flip_parity, bound in cases:
        ref = jgeo.nn_core(*[jnp.asarray(a) for a in args], jnp.asarray(np.float32(bound)), cfg)
        ours = geosearch.nn_core(*[_T(a) for a in args], bound, port_cfg(cfg))
        assert (np.asarray(ref.corres) >= 0).sum() > 5
        np.testing.assert_array_equal(ours.corres.numpy(), np.asarray(ref.corres))
        np.testing.assert_array_equal(ours.n_candidates.numpy(), np.asarray(ref.n_candidates))
        np.testing.assert_allclose(ours.best_dist.numpy(), np.asarray(ref.best_dist), rtol=1e-6, atol=1e-6)
        single = geosearch.geo_nn_search(*[_T(a) for a in args], port_cfg(cfg), parity_flip=flip_parity)
        ref_single = jgeo.geo_nn_search(*[jnp.asarray(a) for a in args], cfg, flip_parity)
        np.testing.assert_array_equal(single.corres.numpy(), np.asarray(ref_single.corres))


def test_public_constructors_default_to_the_card():
    from diasss_tpu_torch.convert import to_torch
    from diasss_tpu_torch.frame import build_keyframe, build_keyframes_batch
    from diasss_tpu_torch.solvers.pose_graph import build_chain_graph

    for fn in (TorchRng, TorchRng.from_config, build_chain_graph, build_keyframe, build_keyframes_batch, to_torch):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_torch_rng_draws_only_matched_positions_and_is_seeded():
    mask = torch.zeros(3, 50, dtype=torch.bool)
    mask[0, [3, 17, 40]] = True
    mask[1, 49] = True
    a = TorchRng(1, 0, device="cpu").categorical_matched(mask, 500, 3)
    b = TorchRng(1, 0, device="cpu").categorical_matched(mask, 500, 3)
    assert a.shape == (3, 500, 3) and torch.equal(a, b)
    assert set(a[0].unique().tolist()) == {3, 17, 40}
    assert set(a[1].unique().tolist()) == {49}
    assert int(a[2].min()) >= 0 and int(a[2].max()) < 50  # no match: any in-range index
    n1, n2 = TorchRng(1, 5, device="cpu").normal((4, 6)), TorchRng(1, 5, device="cpu").normal((4, 6))
    assert n1.dtype == torch.float32 and torch.equal(n1, n2)
