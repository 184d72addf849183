"""The port's native reader (``diasss_tpu_torch/native``), survey loader and
pipelined keyframe loader (``parallel/prefetch.py``) against the JAX
package's, on the same files: a 3-line survey written by the JAX package,
its middle line cropped to fewer bins.

Tolerance: none.  Both packages parse the same text the same way, so every
parsed array is identical (and of the same dtype as the JAX package's
reader of the same kind); the
pipelined loader's frames and inline features equal a plain build and
detection of the same lines.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity_helpers import crop_lines, port_cfg, small_survey
from diasss_tpu import io as jio
from diasss_tpu.config import DetectorConfig
from diasss_tpu.parallel.prefetch import load_keyframes_pipelined as jax_load_pipelined
from diasss_tpu_torch import _nvcc, io, native
from diasss_tpu_torch.features import detect_features
from diasss_tpu_torch.frame import build_keyframes_batch
from diasss_tpu_torch.io import loader
from diasss_tpu_torch.parallel.prefetch import build_keyframes_pipelined, load_keyframes_pipelined

KEYS = ("image", "pose", "altitude", "groundrange", "annotation")
DET = DetectorConfig(n_features=100)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    survey = crop_lines(small_survey(n_lines=3, n_pings=80, n_bins=128, n_landmarks=30), {1: 16})
    folders = jio.save_survey(survey, str(tmp_path_factory.mktemp("survey")))
    return survey, [folders[k] for k in KEYS]


def test_native_reader_is_built_from_the_ports_copy_into_the_build_dir():
    assert native.SOURCE.parent == Path(native.__file__).resolve().parent
    assert native.LIBRARY.parent == _nvcc.BUILD_DIR and native.LIBRARY.name == "libdiasss_io.so"
    assert native.available(), native.unavailable_reason()
    assert native.unavailable_reason() is None and native.LIBRARY.exists()


@pytest.mark.parametrize("use_native", [True, False])
def test_load_input_data_matches_both_jax_readers(files, use_native):
    _, folders = files
    ours = io.load_input_data(*folders, use_native=use_native)
    assert ours.reader == ("native" if use_native else "python (use_native=False)")
    for ref_native in (True, False):
        ref = jio.load_input_data(*folders, use_native=ref_native)
        for name in ref._fields:
            assert len(getattr(ours, name)) == len(getattr(ref, name)) == 3
            for a, b in zip(getattr(ours, name), getattr(ref, name)):
                # the JAX package's own two readers type the annotations
                # int64 (native) and int32 (Python): the port's follow each
                assert a.dtype == b.dtype or ref_native != use_native, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert [a.shape[1] for a in ours.images] == [128, 96, 128]


def test_an_unavailable_native_reader_falls_back_and_says_why(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "OSError: no g++")
    read_mat, read_txt, reader = loader._readers(True)
    assert reader == "python (native reader unavailable: OSError: no g++)"
    assert read_mat is loader.read_matrix and read_txt is loader._read_txt_column


def test_pipelined_load_matches_jax_and_a_plain_build(files):
    survey, folders = files
    ref_frames, _, ref_t = jax_load_pipelined(*folders)
    load = load_keyframes_pipelined(*folders, detector_cfg=port_cfg(DET), device="cpu")
    assert load.reader == "native"
    assert set(load.timings) == set(ref_t) == {"load_pipelined_wall", "load_host_parse"}
    assert len(load.frames) == len(load.feats) == 3
    for f, r in zip(load.frames, ref_frames):
        assert f.img_id == r.img_id
        for name in ("raw", "dr_poses", "altitudes", "ground_ranges"):
            np.testing.assert_array_equal(getattr(f, name).numpy(), np.asarray(getattr(r, name)), err_msg=name)
        np.testing.assert_array_equal(f.annos, np.asarray(r.annos))
    plain = build_keyframes_batch([(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos)
                                   for l in survey.lines], device="cpu")
    for f, p, feats in zip(load.frames, plain, load.feats):
        for name in ("raw", "norm", "mask", "geo"):
            assert torch.equal(getattr(f, name), getattr(p, name)), name
        ref = detect_features(p.norm, p.mask, port_cfg(DET))
        for a, b in zip(feats, ref):
            assert torch.equal(a, b)
    # the generic form: thunks of host arrays, no detection
    thunks = [lambda l=l: (l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    frames, feats = build_keyframes_pipelined(thunks, device="cpu")
    assert feats is None and all(torch.equal(a.geo, b.geo) for a, b in zip(frames, plain))


def test_pipelined_load_rejects_mismatched_folders(files, tmp_path):
    _, folders = files
    os.makedirs(tmp_path / "pose")
    with pytest.raises(ValueError, match="inconsistent file counts"):
        load_keyframes_pipelined(folders[0], str(tmp_path / "pose"), *folders[2:], device="cpu")
