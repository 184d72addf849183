"""FAST-9: the port's plain version against the JAX package, and the
dispatch and input checks of the CUDA kernel's wrapper (the kernel itself is
tested on the card by tests/test_torch_fast_cuda.py).

Tolerance: none.  Subtraction, min and max of float32 are exact and do not
depend on order, so every comparison is bit for bit — over the whole image
between the two roll-based versions, and on ``[8:-8, 8:-8]`` against the
Pallas kernel, which pads its halo instead of wrapping (as
tests/test_features.py holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_helpers  # noqa: F401  (thread settings)
from diasss_tpu.features.fast import fast_score as jax_fast_score
from diasss_tpu.features.fast import nms3 as jax_nms3
from diasss_tpu.features.fast_pallas import fast_score_pallas
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


def test_dispatch_takes_plain_version_on_cpu_without_a_launch():
    img = torch.as_tensor(_img((48, 64), 2))
    before = fast_cuda.launches
    np.testing.assert_array_equal(fast.fast_score(img, 12.0).numpy(), fast.fast_score_plain(img, 12.0).numpy())
    assert fast_cuda.launches == before


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(8, 8, dtype=torch.uint8), TypeError),
    (torch.zeros(2, 8, 8), ValueError),
    (torch.zeros(8, 16)[:, ::2], ValueError),
    (torch.zeros(8, 8), ValueError),  # a CPU tensor: the kernel runs on CUDA tensors only
])
def test_wrapper_rejects_bad_input_before_any_launch(bad, err):
    before = fast_cuda.launches
    with pytest.raises(err):
        fast_cuda.fast9_score(bad, 12.0)
    assert fast_cuda.launches == before
