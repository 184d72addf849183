"""Parity of the port's dense world-correlation matcher
(``diasss_tpu_torch/matching/dense.py``) with the JAX package's, on a small
drifting survey with a tie line (4 frames of 300 x 384, 500 keypoint slots).

Tolerances, and why:

* raster counts, window reads, the masked-median filter and argmax tie
  order: identical (integer counts, pure gathers, a sort and float32
  arithmetic done in the same order on both sides);
* raster means: 1e-5 relative (sums of many float32 values);
* patches: 1e-6 (the mean and the norm are reductions, summed in another
  order);
* ``qcorr_plain`` against the Pallas kernel in interpret mode: 2e-5, the JAX
  package's own tolerance for its scan against its kernel;
* ``_correlate`` against JAX's full-map path (``lattice=False``): scores
  within 1e-4 (integral images and patch statistics are summed in another
  order) and at least 99% of the matched cells identical, the rest near-ties;
* the matchers against JAX's default CPU path (the lattice branch, which the
  port does not take: its refinement scores are einsums over the windows,
  summed in another order): at least 95% of the match rows identical (118
  of 121 measured on this survey) and counts within 2%.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import jax_and_port_frames, port_cfg
from diasss_tpu.config import DenseMatchConfig, DetectorConfig
from diasss_tpu.features import detect_features as jax_detect
from diasss_tpu.matching import dense as jdense
from diasss_tpu.matching.dense_pallas import qcorr_pallas
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.convert import to_torch
from diasss_tpu_torch.matching import dense, dense_cuda

DCFG = DetectorConfig(descriptor="geo_patch", n_features=500)
MCFG = DenseMatchConfig(search_radius=10.0)
RES = DCFG.geopatch_res


def _T(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def setup():
    survey = make_survey(n_lines=3, n_pings=300, n_bins=384, n_landmarks=120, n_tie_lines=1, drift_xy=0.006,
                         seed=7)
    jf, tf = jax_and_port_frames(survey)
    feats = [jax_detect(f.norm, f.mask, DCFG) for f in jf]
    return jf, tf, feats


@pytest.fixture(scope="module")
def rasters(setup):
    jf, tf, _ = setup
    jr = [jdense.world_raster(f.norm, f.geo, RES) for f in jf]
    tr = [_port_raster(f) for f in tf]
    return jr, tr


def _port_raster(f, margin=2.0):
    """One frame's raster through the port's ``_rasterize``, at the shape and
    origin the JAX package's ``world_raster`` gives it."""
    bb = dense._geo_bounds_batch(f.geo[None]).numpy()
    H, W = dense._shape_from_bounds(*bb[0], RES, margin)
    x0, y0 = dense._origins(bb, margin)
    img, cnt, ping, col = dense._rasterize(f.norm[None], f.geo[None], torch.as_tensor(x0), torch.as_tensor(y0),
                                           RES, W, H)
    return SimpleNamespace(img=img[0], cnt=cnt[0], ping=ping[0], col=col[0], x0=float(x0[0]), y0=float(y0[0]))


def test_rasterize_counts_exact_means_close(rasters):
    jr, tr = rasters
    for a, b in zip(jr, tr):
        assert (a.x0, a.y0) == (b.x0, b.y0)
        assert tuple(b.img.shape) == a.img.shape
        np.testing.assert_array_equal(b.cnt.numpy(), np.asarray(a.cnt))
        assert b.cnt.max() >= 1
        for f in ("img", "ping", "col"):
            np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), rtol=1e-5, atol=1e-5)


def test_window_slices_exact_with_clamped_far_centres(rasters):
    jr, tr = rasters
    H, W = jr[0].img.shape
    ext, size = 9, 19
    cy = np.array([5, H // 2, 0, H - 1, -ext, H - 1 + ext, -3 * ext, H + 3 * ext, -1000, 40], np.int32)
    cx = np.array([7, W // 2, W - 1, 0, W - 1 + ext, -ext, W + 3 * ext, -3 * ext, 40, 5000], np.int32)
    jv, jc = jdense._window_slices(jr[0].img, jr[0].cnt, jnp.asarray(cy), jnp.asarray(cx), ext, size)
    tv, tc = dense._window_slices(tr[0].img[None], tr[0].cnt[None], _T(cy)[None], _T(cx)[None], ext, size)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))


def _geo_kp(jf, feats, f):
    g = np.asarray(jf[f].geo)
    xy = np.asarray(feats[f].xy)
    return g[np.clip(xy[:, 1].astype(np.int32), 0, g.shape[0] - 1),
             np.clip(xy[:, 0].astype(np.int32), 0, g.shape[1] - 1)]


def test_raster_patches(setup, rasters):
    jf, _, feats = setup
    jr, tr = rasters
    geo_kp = _geo_kp(jf, feats, 0)
    jd, jok = jdense._raster_patches(jr[0], jnp.asarray(geo_kp), DCFG.geopatch_half, MCFG.min_cover)
    td, tok = dense._raster_patches(tr[0].img[None], tr[0].cnt[None], _T([tr[0].x0], torch.float32),
                                    _T([tr[0].y0], torch.float32), RES, _T(geo_kp)[None], DCFG.geopatch_half,
                                    MCFG.min_cover)
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
    assert tok.sum() > 50
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), atol=1e-6)


def test_qcorr_plain_matches_pallas_interpret():
    K, k, T = 70, 17, 43
    S = T + k - 1
    rng = np.random.default_rng(3)
    Wv = rng.uniform(0, 1, (K, S, S)).astype(np.float32)
    Wh = (rng.uniform(size=(K, S, S)) > 0.1).astype(np.float32)
    Wvh = Wv * Wh
    q = rng.normal(0, 1, (K, k * k)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    A1, B1 = qcorr_pallas(jnp.asarray(Wvh), jnp.asarray(Wh), jnp.asarray(q), k, T, interpret=True)
    before = dense_cuda.launches
    A0, B0 = dense.qcorr(_T(Wvh), _T(Wh), _T(q), k, T)
    assert dense_cuda.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(A0.numpy(), np.asarray(A1), atol=2e-5)
    np.testing.assert_allclose(B0.numpy(), np.asarray(B1), atol=2e-5)


def test_qcorr_on_the_cpu_equals_one_plain_call_bit_for_bit(monkeypatch):
    """The CPU branch of ``qcorr`` runs the plain version over blocks of
    keypoints (rows are independent): the same maps as one call."""
    K, k, T = 23, 5, 9
    S = T + k - 1
    rng = np.random.default_rng(5)
    Wh = _T((rng.uniform(size=(K, S, S)) > 0.1).astype(np.float32))
    Wvh = _T(rng.uniform(0, 1, (K, S, S)).astype(np.float32)) * Wh
    q = _T(rng.normal(0, 1, (K, k * k)).astype(np.float32))
    A0, B0 = dense.qcorr_plain(Wvh, Wh, q, k, T)
    monkeypatch.setattr(dense, "CPU_QCORR_ROWS", 7)
    A, B = dense.qcorr(Wvh, Wh, q, k, T)
    assert torch.equal(A, A0) and torch.equal(B, B0)


def test_qcorr_plain_within_1e5_of_the_float64_sum():
    """Why the card's kernel is held to 2e-5 of ``qcorr_plain``: both sum the
    same 289 terms |q_g W_g| <= 1 in float32 (the kernel with fused
    multiply-adds), and each stays within 1e-5 of the float64 sum."""
    K, k, T = 40, 17, 43
    S = T + k - 1
    rng = np.random.default_rng(4)
    Wh = (rng.uniform(size=(K, S, S)) > 0.1).astype(np.float32)
    Wvh = rng.uniform(0, 1, (K, S, S)).astype(np.float32) * Wh
    q = rng.normal(0, 1, (K, k * k)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    A, B = dense.qcorr_plain(_T(Wvh), _T(Wh), _T(q), k, T)
    A64, B64 = dense.qcorr_plain(_T(Wvh).double(), _T(Wh).double(), _T(q).double(), k, T)
    err = max(float((A.double() - A64).abs().max()), float((B.double() - B64).abs().max()))
    assert 0.0 < err < 1e-5, err


@pytest.mark.parametrize("bad, exc", [
    (dict(Wvh=torch.zeros(2, 20, 20, dtype=torch.float64)), TypeError),
    (dict(q=torch.zeros(2, 16)), ValueError),
    (dict(T=5), ValueError),
    (dict(Wh=torch.zeros(2, 20, 21)), ValueError),
    (dict(Wvh=torch.zeros(2, 40, 20)[:, ::2]), ValueError),
])
def test_qcorr_wrapper_rejects_before_any_launch(bad, exc):
    args = dict(Wvh=torch.zeros(2, 20, 20), Wh=torch.zeros(2, 20, 20), q=torch.zeros(2, 9), k=3, T=18)
    args.update(bad)
    before = dense_cuda.launches
    with pytest.raises(exc):
        dense_cuda.qcorr_cuda(**args)
    with pytest.raises(exc):
        dense.qcorr(**args)
    assert dense_cuda.launches == before


def test_argmax_takes_the_first_maximum():
    rows = np.full((4, 9), -2.0, np.float32)
    rows[2, [3, 7]] = 0.5
    np.testing.assert_array_equal(torch.argmax(_T(rows), dim=-1).numpy(), np.asarray(jnp.argmax(rows, axis=-1)))
    assert torch.argmax(_T(rows), dim=-1).tolist() == [0, 0, 3, 0]


def test_correlate_matches_jax_full_map(setup, rasters):
    jf, _, feats = setup
    jr, tr = rasters
    geo_kp = _geo_kp(jf, feats, 0)
    # keypoints far outside the target raster: every offset invalid (all -2)
    geo_kp[:3] = np.array([[-1e4, -1e4], [1e4, 0.0], [0.0, 1e5]], np.float32)
    jd, jok = jdense._raster_patches(jr[0], jnp.asarray(geo_kp), DCFG.geopatch_half, MCFG.min_cover)
    jok = jok.at[:3].set(True)
    kw = dict(half=DCFG.geopatch_half, n_ring=int(np.ceil(MCFG.search_radius / RES)), step_cells=MCFG.step_cells,
              ncc_min=MCFG.ncc_min, ncc_ratio=0.9, min_cover=MCFG.min_cover)
    ref = jdense._correlate(jd, jok, jnp.asarray(geo_kp), jr[1], lattice=False, **kw)
    t = tr[1]
    ours = dense._correlate(_T(np.asarray(jd))[None], _T(np.asarray(jok))[None], _T(geo_kp)[None], t.img[None],
                            t.cnt[None], t.ping[None], t.col[None], _T([t.x0], torch.float32),
                            _T([t.y0], torch.float32), RES, **kw)
    same = np.all(ours.tgt_geo[0].numpy() == np.asarray(ref.tgt_geo), axis=1)
    assert same.mean() >= 0.99, same.mean()
    assert same[:3].all()
    np.testing.assert_allclose(ours.score[0].numpy()[same], np.asarray(ref.score)[same], atol=1e-4)
    np.testing.assert_array_equal(ours.tgt_ping[0].numpy()[same], np.asarray(ref.tgt_ping)[same])
    ok_same = ours.ok[0].numpy() == np.asarray(ref.ok)
    assert ok_same[same].mean() >= 0.99
    assert np.asarray(ref.ok).sum() > 20


def test_smooth_filter_exact_with_even_neighbour_counts():
    rng = np.random.default_rng(5)
    K = 300
    kp = rng.uniform(0, 120, (K, 2)).astype(np.float32)
    tgt = (kp + np.array([1.5, -0.5], np.float32) + rng.normal(0, 0.8, (K, 2))).astype(np.float32)
    ok = rng.uniform(size=K) > 0.3
    cfg = dataclasses.replace(MCFG, smooth_radius=12.0)
    ref = np.asarray(jdense._smooth_filter(kp, tgt, ok, cfg))

    def ours(ok_):
        return dense._smooth_filter_dev(_T(kp)[None], _T(tgt)[None], _T(ok_)[None], radius=cfg.smooth_radius,
                                        min_neighbors=cfg.smooth_min_neighbors, tol=cfg.smooth_tol)[0].numpy()

    np.testing.assert_array_equal(ours(ok), ref)
    d2 = ((kp[:, None] - kp[None]) ** 2).sum(-1)
    nn = ((d2 <= 144.0) & ok[None] & ~np.eye(K, dtype=bool)).sum(1)
    assert (nn % 2 == 0).sum() > 20 and 0 < ref.sum() < K
    assert not ours(np.zeros(K, bool)).any()


def _row_agreement(ours, ref):
    a = {tuple(r) for r in ours}
    b = {tuple(r) for r in ref}
    return len(a & b) / max(len(b), 1)


PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _stacked(tf, tfeats, pairs):
    return dense.dense_matching_stacked(pairs, [0, 1, 2, 3], tfeats, [f.norm for f in tf], [f.geo for f in tf],
                                        port_cfg(DCFG), port_cfg(MCFG))


@pytest.mark.parametrize("pair", [(0, 3), (1, 2)])
def test_dense_matching_stacked_single_pair_close_to_jax_per_pair(setup, pair):
    jf, tf, feats = setup
    i, j = pair
    ref = jdense.dense_matching(i, j, feats[i], jf[i].norm, jf[i].geo, jf[j].norm, jf[j].geo, DCFG, MCFG)
    tfeats = [to_torch(f, device="cpu") for f in feats]
    ours = _stacked(tf, tfeats, [pair])[pair]
    assert ref[2] >= 10
    assert abs(ours[2] - ref[2]) <= 0.02 * ref[2] + 1
    assert _row_agreement(ours[0], ref[0]) >= 0.95
    np.testing.assert_array_equal(ours[1][:, 2:4], ours[0][:, 4:6])
    # a pair's result does not depend on which other pairs share the batch
    np.testing.assert_array_equal(ours[0], _stacked(tf, tfeats, PAIRS)[pair][0])


def test_dense_matching_stacked_close_to_jax(setup):
    jf, tf, feats = setup
    ref = jdense.dense_matching_stacked(PAIRS, [0, 1, 2, 3], feats, [f.norm for f in jf], [f.geo for f in jf],
                                        DCFG, MCFG)
    tfeats = [to_torch(f, device="cpu") for f in feats]
    ours = _stacked(tf, tfeats, PAIRS)
    total = sum(ref[p][2] for p in PAIRS)
    assert total >= 100
    assert abs(sum(ours[p][2] for p in PAIRS) - total) <= 0.02 * total
    rows_o = np.concatenate([ours[p][0] for p in PAIRS])
    rows_r = np.concatenate([ref[p][0] for p in PAIRS])
    assert _row_agreement(rows_o, rows_r) >= 0.95
    # the data-parallel pair axis (ROADMAP A14) on a one-rank mesh: the same rows
    from diasss_tpu_torch.parallel.collectives import Mesh

    solo = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"), transport="gloo", ranks=(0,))
    meshed = dense.dense_matching_stacked(PAIRS, [0, 1, 2, 3], tfeats, [f.norm for f in tf], [f.geo for f in tf],
                                          port_cfg(DCFG), port_cfg(MCFG), mesh=solo)
    for p in PAIRS:
        np.testing.assert_array_equal(meshed[p][0], ours[p][0])
