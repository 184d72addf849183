"""The port's own copies of the JAX package's numpy-only modules
(``config``, ``pairs``, ``synthetic``, ``io``, ``dumps``, ``viz``, the native
reader's C++ source) against the originals.  Tolerance: none — the copies run the same numpy code, so every
value, array and written byte is identical.
"""

import dataclasses
import os
import types

import numpy as np
import pytest

from diasss_tpu import config as jconfig
from diasss_tpu import dumps as jdumps
from diasss_tpu import io as jio
from diasss_tpu import pairs as jpairs
from diasss_tpu import synthetic as jsyn
from diasss_tpu import viz as jviz
from diasss_tpu_torch import config, dumps, io, pairs, synthetic, viz


def _tree(cfg):
    """(class name, {field: subtree or value}) of a config dataclass."""
    return type(cfg).__name__, {f.name: _tree(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                                else getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("make", [
    lambda m: m.PipelineConfig(),
    lambda m: m.automatic_config(),
    lambda m: m.automatic_config(6.0),
    lambda m: m.pair_mode_config(),
    lambda m: m.DEFAULT,
])
def test_configs_equal_field_by_field(make):
    assert _tree(make(config)) == _tree(make(jconfig))


def test_every_config_class_is_copied():
    names = {n for n, v in vars(jconfig).items() if isinstance(v, type) and dataclasses.is_dataclass(v)}
    assert len(names) >= 10
    for n in names:
        assert [f.name for f in dataclasses.fields(getattr(config, n))] == \
               [f.name for f in dataclasses.fields(getattr(jconfig, n))], n


@pytest.mark.parametrize("kw", [
    dict(n_lines=2, n_pings=120, n_bins=128, n_landmarks=20, seed=0),
    dict(n_lines=3, n_pings=100, n_bins=128, n_landmarks=30, n_tie_lines=1, drift_xy=0.006, seed=7),
])
def test_make_survey_bit_identical(kw):
    a, b = synthetic.make_survey(**kw), jsyn.make_survey(**kw)
    assert len(a.lines) == len(b.lines) and a.floor_z == b.floor_z
    np.testing.assert_array_equal(a.landmarks, b.landmarks)
    for la, lb in zip(a.lines, b.lines):
        assert la.img_id == lb.img_id
        for f in ("gt_poses", "dr_poses", "altitudes", "ground_ranges", "image", "annos"):
            x, y = getattr(la, f), getattr(lb, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def survey():
    return jsyn.make_survey(n_lines=3, n_pings=100, n_bins=128, n_landmarks=30, n_tie_lines=1, seed=4)


@pytest.mark.parametrize("use_anno, capacity", [(True, None), (False, None), (True, 4)])
def test_get_kps_pairs_identical(survey, use_anno, capacity):
    l0, l1 = survey.lines[0], survey.lines[1]
    rows = l0.annos if use_anno else l0.annos[:, :6].astype(np.float64) + 0.25
    assert len(rows) > 4
    args = (rows, l1.img_id, l0.altitudes, l0.ground_ranges, l1.altitudes, l1.ground_ranges)
    a = pairs.get_kps_pairs(*args, use_anno=use_anno, capacity=capacity)
    b = jpairs.get_kps_pairs(*args, use_anno=use_anno, capacity=capacity)
    np.testing.assert_array_equal(a.pairs, b.pairs)
    np.testing.assert_array_equal(a.valid, b.valid)
    empty = pairs.get_kps_pairs(np.zeros((0, 7)), 1, *args[2:], use_anno=True)
    assert empty.pairs.shape == (1, 7) and not empty.valid.any()


def _read_tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_save_and_load_survey_identical(survey, tmp_path):
    fa = io.save_survey(survey, str(tmp_path / "port"))
    fb = jio.save_survey(survey, str(tmp_path / "jax"))
    assert _read_tree(tmp_path / "port") == _read_tree(tmp_path / "jax")
    keys = ("image", "pose", "altitude", "groundrange", "annotation")
    a = io.load_input_data(*[fa[k] for k in keys])
    b = jio.load_input_data(*[fb[k] for k in keys], use_native=False)
    assert a.reader == "native"
    for f in b._fields:
        assert len(getattr(a, f)) == len(getattr(b, f)) == 4
        for x, y in zip(getattr(a, f), getattr(b, f)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(io.read_matrix(os.path.join(fa["pose"], sorted(os.listdir(fa["pose"]))[0]),
                                                 "auv_pose"), survey.lines[0].dr_poses)


def test_write_reference_dumps_identical(tmp_path):
    rng = np.random.default_rng(0)
    valid = np.array([True, False, True, True])

    def lc():
        return types.SimpleNamespace(valid=valid, **{f: rng.normal(size=4) for f in (
            "ini_dist", "fnl_dist", "dr_range_e", "dr_plane_e", "est_range_e", "est_plane_e", "depth_est",
            "depth_drape")})

    def e1():
        return types.SimpleNamespace(n_pairs=3, ini_dists=rng.normal(size=3), fnl_dists=rng.normal(size=3))

    def e2():
        return types.SimpleNamespace(n_pairs=3, **{f: float(rng.normal()) for f in (
            "avg_range_dr", "avg_plane_dr", "avg_range_est", "avg_plane_est")},
            **{f: rng.normal(size=3) for f in ("range_dr_e", "plane_dr_e", "range_est_e", "plane_est_e")})

    keys = [(0, 1), (1, 2)]
    result = types.SimpleNamespace(pair_ids=keys, lc_results={k: lc() for k in keys}, eval1={k: e1() for k in keys},
                                   eval2={k: e2() for k in keys}, pose_sigmas=rng.uniform(size=(5, 6)))
    kps = {k: jpairs.KpsPairs(rng.normal(size=(4, 7)).astype(np.float32), valid) for k in keys}
    dumps.write_reference_dumps(str(tmp_path / "port"), result, kps)
    jdumps.write_reference_dumps(str(tmp_path / "jax"), result, kps)
    a, b = _read_tree(tmp_path / "port"), _read_tree(tmp_path / "jax")
    assert len(a) >= 15 and a == b


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 200, 3)])
def test_write_png_bytes_identical(tmp_path, shape):
    rgb = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.float64)
    viz.write_png(str(tmp_path / "port.png"), rgb)
    jviz.write_png(str(tmp_path / "jax.png"), rgb)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_prefetch_iter_copy_behaves_as_the_original():
    from diasss_tpu.parallel.prefetch import prefetch_iter as jax_prefetch_iter
    from diasss_tpu_torch.parallel.prefetch import prefetch_iter

    thunks = [lambda k=k: np.full(3, k * k) for k in range(7)]
    ours, ref = list(prefetch_iter(thunks, depth=2)), list(jax_prefetch_iter(thunks, depth=2))
    assert [a.tolist() for a in ours] == [b.tolist() for b in ref] == [[k * k] * 3 for k in range(7)]

    def broken():
        raise ValueError("unreadable line")

    for fn in (prefetch_iter, jax_prefetch_iter):
        with pytest.raises(ValueError, match="unreadable line"):
            list(fn([thunks[0], broken, thunks[1]]))


def test_match_rendering_bytes_identical(tmp_path):
    """``draw_matches_image`` (two frames of different widths) and
    ``show_annos`` write the same PNG bytes as the JAX package's."""
    rng = np.random.default_rng(5)
    img1 = rng.integers(0, 256, (40, 64)).astype(np.uint8)
    img2 = rng.integers(0, 256, (30, 48)).astype(np.uint8)
    pts1 = rng.uniform(-5, 70, (12, 2))
    pts2 = rng.uniform(-5, 50, (12, 2))
    for mod, name in ((viz, "port"), (jviz, "jax")):
        mod.draw_matches_image(img1, img2, pts1, pts2, str(tmp_path / f"{name}_m.png"), max_matches=10)
        annos = np.array([[0, 1, 5, 10, 7, 20, 0], [0, 2, 3, 3, 4, 4, 0], [0, 1, 30, 60, 25, 40, 0]])
        mod.show_annos(1, img1, img2, annos, str(tmp_path / f"{name}_a.png"))
    for kind in ("m", "a"):
        assert (tmp_path / f"port_{kind}.png").read_bytes() == (tmp_path / f"jax_{kind}.png").read_bytes()


def test_native_reader_source_identical_but_its_provenance_path():
    """The port's ``io_native.cpp`` is the JAX package's, byte for byte,
    except that its header comment names the reference's source file
    without the absolute path of the machine it was read on."""
    import diasss_tpu.native
    import diasss_tpu_torch.native

    ours, ref = diasss_tpu_torch.native.SOURCE, os.path.join(os.path.dirname(diasss_tpu.native.__file__),
                                                             "io_native.cpp")
    with open(ours, "rb") as a, open(ref, "rb") as b:
        a, b = a.read().split(b"\n"), b.read().split(b"\n")
    differ = [k for k, (x, y) in enumerate(zip(a, b)) if x != y]
    assert len(a) == len(b) > 100 and differ == [3]
    tail = b"src/util/util.cpp:86-128).  Multi-megabyte waterfall images"
    assert a[3] == b"// (the reference's " + tail and b[3].startswith(b"// (/") and b[3].endswith(b"reference/" + tail)
