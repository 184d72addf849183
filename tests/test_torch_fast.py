"""FAST-9: the port's plain versions against the JAX package, and the
dispatch and input checks of the CUDA kernel's wrapper (the kernel itself is
tested on the card by tests/test_torch_fast_cuda.py).

Tolerance: none.  Subtraction, min and max of float32 are exact and do not
depend on order, so every comparison is bit for bit — over the whole image
between the roll-based versions (with or without the frame mask and NMS),
and on ``[8:-8, 8:-8]`` against the Pallas kernel, which pads its halo
instead of wrapping (as tests/test_features.py holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers  # noqa: F401  (thread settings)
from diasss_tpu.features.detector import _frame_mask as jax_frame_mask
from diasss_tpu.features.fast import fast_score as jax_fast_score
from diasss_tpu.features.fast import nms3 as jax_nms3
from diasss_tpu.features.fast_pallas import fast_score_pallas
from diasss_tpu.features.pyramid import build_pyramid as jax_build_pyramid
from diasss_tpu.frame import normalize_sss as jax_normalize_sss
from diasss_tpu.synthetic import make_survey
from diasss_tpu_torch.features import fast, fast_cuda


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _corner_img():
    img = np.full((64, 80), 30.0, np.float32)
    img[20:44, 20:50] = 200.0
    img[5, 70] = 255.0
    return img


@pytest.mark.parametrize("threshold", [12.0, 7.0, 50.0])
@pytest.mark.parametrize("which", ["uniform", "corners"])
def test_plain_equals_jax_fast_score(which, threshold):
    img = _img((96, 130)) if which == "uniform" else _corner_img()
    ours = fast.fast_score_plain(torch.as_tensor(img), threshold).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_fast_score(jnp.asarray(img), threshold)))


def test_plain_equals_pallas_interpret_on_interior():
    img = _img((96, 256))
    ours = fast.fast_score_plain(torch.as_tensor(img), 12.0).numpy()
    pallas = np.asarray(fast_score_pallas(jnp.asarray(img), 12.0, tile=32, interpret=True))
    np.testing.assert_array_equal(ours[8:-8, 8:-8], pallas[8:-8, 8:-8])


def test_nms3_equals_jax():
    score = fast.fast_score_plain(torch.as_tensor(_img((64, 96), 1)), 7.0)
    score[10, 10] = score[10, 11] = 99.0  # a plateau: both survive (>=)
    np.testing.assert_array_equal(fast.nms3(score).numpy(), np.asarray(jax_nms3(jnp.asarray(score.numpy()))))


@pytest.mark.parametrize("which", ["waterfall pyramid", "corners"])
def test_two_threshold_plain_equals_jax_composition(which):
    """``fast_two_threshold_plain`` is the JAX detector's
    ``nms3(_frame_mask(fast_score(img, t), n, m))`` at both thresholds, bit for
    bit on the whole map of every level."""
    if which == "corners":
        levels = [_corner_img()]
    else:
        raw = make_survey(n_lines=1, n_pings=120, n_bins=160, n_landmarks=12, seed=5).lines[0].image
        norm = jax_normalize_sss(jnp.asarray(raw, jnp.float32))
        levels = [np.array(l) for l in jax_build_pyramid(norm, 3, 1.2)]
    ours = fast.fast_two_threshold_plain([torch.as_tensor(l) for l in levels], 20.0, 7.0)
    assert len(ours) == len(levels)
    for img, pair in zip(levels, ours):
        n, m = img.shape
        for t, got in zip((20.0, 7.0), pair):
            ref = np.asarray(jax_nms3(jax_frame_mask(jax_fast_score(jnp.asarray(img), t), n, m)))
            np.testing.assert_array_equal(got.numpy(), ref)
        assert int((pair[1] > 0).sum()) >= int((pair[0] > 0).sum()) > 0


def test_dispatch_takes_plain_version_on_cpu_without_a_launch():
    levels = [torch.as_tensor(_img((48, 64), 2)), torch.as_tensor(_img((40, 53), 3))]
    before = fast_cuda.launches
    got = fast.fast_two_threshold(levels, 12.0, 7.0)
    for pair, ref in zip(got, fast.fast_two_threshold_plain(levels, 12.0, 7.0)):
        for a, b in zip(pair, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fast_cuda.launches == before


CPU_LEVELS = [torch.zeros(8, 8)]  # valid levels, but on the CPU: the kernel runs on CUDA tensors only


@pytest.mark.parametrize("bad, err", [
    ([torch.zeros(8, 8, dtype=torch.float64)], TypeError),
    ([torch.zeros(8, 8, dtype=torch.uint8)], TypeError),
    ([torch.zeros(2, 8, 8)], ValueError),
    ([torch.zeros(8, 16)[:, ::2]], ValueError),
    (CPU_LEVELS, ValueError),
    (torch.zeros(8, 8), TypeError),  # one image, not a list of levels
    ([], ValueError),
    ([torch.zeros(8, 8)] * (fast.MAX_LEVELS + 1), ValueError),
    ([torch.zeros(8, 8), torch.zeros(0, 8)], ValueError),
])
def test_wrapper_rejects_bad_input_before_any_launch(bad, err):
    """The kernel's wrapper raises before launching; the dispatch checks CPU
    levels the same way, so it raises on all but the valid CPU levels."""
    before = fast_cuda.launches
    with pytest.raises(err):
        fast_cuda.fast9_two_threshold(bad, 12.0, 7.0)
    if bad is not CPU_LEVELS:
        with pytest.raises(err):
            fast.fast_two_threshold(bad, 12.0, 7.0)
    assert fast_cuda.launches == before
