"""Parity of the port's mosaic (``frame.normalize_columns``,
``mosaic.build_mosaic``, ``mosaic.save_mosaic_png``) with the JAX
package's, and the port's CLI with the marginals and the mosaic on.

Tolerances and why: on integer-valued waterfalls (what a sonar records) the
column sums are exact in float32 on both sides, so the normalized image is
identical, and the mosaic cells (means of identical uint8 values scattered
to identical cells) agree to 1e-5 with the same NaN pattern.  On
non-integer waterfalls the column sums round in a different order, and a
pixel on a rounding boundary may differ by one level.  The PNG bytes are
identical.
"""

import json

import numpy as np
import pytest
import torch

from torch_parity_helpers import jax_and_port_frames, small_survey
from diasss_tpu.frame import normalize_columns as jax_normalize_columns
from diasss_tpu.geometry import se3 as jse3
from diasss_tpu.mosaic import build_mosaic as jax_build_mosaic
from diasss_tpu.mosaic import save_mosaic_png as jax_save_mosaic_png
from diasss_tpu.pipeline import _estimated_geo as jax_estimated_geo
from diasss_tpu_torch.frame import normalize_columns
from diasss_tpu_torch.mosaic import build_mosaic, save_mosaic_png


@pytest.fixture(scope="module")
def survey():
    s = small_survey(n_lines=3, n_pings=150, n_bins=256, n_landmarks=40, seed=7)
    for line in s.lines:
        line.image[:] = np.round(line.image * 4.0)  # integer intensities
    return s


def test_normalize_columns_matches_jax(survey):
    for line in survey.lines:
        raw = line.image.astype(np.float32)
        ours = normalize_columns(torch.as_tensor(raw)).numpy()
        assert ours.dtype == np.uint8 and ours.max() == 255 and ours.min() == 0
        np.testing.assert_array_equal(ours, np.asarray(jax_normalize_columns(raw)))
        fractional = (raw / 4.0 + 0.1).astype(np.float32)
        diff = normalize_columns(torch.as_tensor(fractional)).numpy().astype(int) - np.asarray(
            jax_normalize_columns(fractional)).astype(int)
        assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size


@pytest.fixture(scope="module")
def frames(survey):
    return jax_and_port_frames(survey)


def _estimated_poses(survey):
    """Poses a little off the DR chain, as an estimate would be."""
    rows = np.concatenate([l.dr_poses for l in survey.lines]).astype(np.float32)
    rows[:, 3:5] += np.random.default_rng(0).normal(0, 0.3, (len(rows), 2)).astype(np.float32)
    return jse3.from_rodrigues_xyz(rows)


@pytest.mark.parametrize("estimated", [False, True])
def test_build_mosaic_matches_jax(survey, frames, estimated):
    jf, tf = frames
    jgeo = jax_estimated_geo(jf, _estimated_poses(survey)) if estimated else None
    tgeo = [torch.as_tensor(np.array(g)) for g in jgeo] if estimated else None
    ref, rx0, ry0, rres = jax_build_mosaic(jf, resolution=0.5, geo_list=jgeo)
    ours, x0, y0, res = build_mosaic(tf, resolution=0.5, geo_list=tgeo)
    assert (x0, y0, res) == (rx0, ry0, rres)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert 0.2 < np.isfinite(ours).mean() < 1.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_save_mosaic_png_bytes_identical(frames, tmp_path):
    mosaic, _, _, _ = build_mosaic(frames[1], resolution=0.5)
    save_mosaic_png(str(tmp_path / "port.png"), mosaic)
    jax_save_mosaic_png(str(tmp_path / "jax.png"), mosaic)
    data = (tmp_path / "port.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data == (tmp_path / "jax.png").read_bytes()


@pytest.fixture(scope="module")
def survey_dirs(tmp_path_factory):
    from diasss_tpu_torch.io import save_survey

    s = small_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=30, seed=2)
    out = tmp_path_factory.mktemp("survey")
    folders = save_survey(s, str(out))
    args = []
    for k in ("image", "pose", "altitude", "groundrange", "annotation"):
        args += [f"--{k}", folders[k]]
    return args + ["--gt", str(out / "gt-poses"), "--device", "cpu"]


@pytest.mark.parametrize("estimator", ["two_stage", "full_ba"])
def test_cli_reports_marginals_and_writes_the_mosaic(survey_dirs, tmp_path, estimator):
    from diasss_tpu_torch.cli import main

    metrics, out, png = tmp_path / "m.json", tmp_path / "out", tmp_path / "map.png"
    assert main(survey_dirs + ["--estimator", estimator, "--metrics", str(metrics), "--out", str(out),
                               "--mosaic", str(png)]) == 0
    m = json.loads(metrics.read_text())
    assert m["counters"] == {"eval_stacked_pairs": 1, "solver_direct_solves": 1} and "pose_marginals" in m["timings"]
    assert len(m["pose_sigma_mean"]) == 6 and all(v > 0 for v in m["pose_sigma_mean"])
    sig = np.loadtxt(out / "est_pose_sigmas_all.txt")
    assert sig.shape == (240, 6) and np.all(sig[0] == 0) and np.all(sig[1:] > 0)
    assert abs(m["pose_sigma_max_xy"] - np.sqrt(sig[1:, 3] ** 2 + sig[1:, 4] ** 2).max()) < 1e-6
    data = png.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
    assert main(survey_dirs + ["--estimator", estimator, "--metrics", str(metrics), "--no-marginals"]) == 0
    assert "pose_sigma_mean" not in json.loads(metrics.read_text())
