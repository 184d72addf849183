"""The CUDA FAST-9 kernel (``diasss_tpu_torch/csrc/fast9.cu``) against its
plain torch version, on the card.  Skipped without a GPU: a CUDA kernel has
no CPU mode.

This file imports no JAX, so it runs on a GPU machine without it; there the
suite's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_fast_cuda.py

Tolerance: none, on the whole map of every level.  Subtraction, min, max and
comparisons of float32 are exact and order-free, and with the 3-px frame
zeroed before NMS no output depends on how either version treats the border
(the kernel reads zeros past it, the plain version wraps).
"""

import numpy as np
import pytest
import torch

from diasss_tpu_torch.features import fast, fast_cuda
from diasss_tpu_torch.features.pyramid import build_pyramid


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _uniform(shape, device, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", ["pyramid 600x512", "pyramid 400x512", "odd shapes", "4992x1280"])
def test_cuda_kernel_equals_plain_on_the_whole_map(cuda_device, levels):
    if levels.startswith("pyramid"):
        n, m = map(int, levels.split()[1].split("x"))
        imgs = [l.contiguous() for l in build_pyramid(_uniform((n, m), cuda_device), 6, 1.2)]
    elif levels == "odd shapes":
        imgs = [_uniform(s, cuda_device, seed=i) for i, s in enumerate([(241, 206), (37, 45), (6, 9), (1, 50),
                                                                         (33, 31)])]
    else:
        imgs = [_uniform((4992, 1280), cuda_device)]
    before = fast_cuda.launches
    out = fast_cuda.fast9_two_threshold(imgs, 12.0, 7.0)
    assert fast_cuda.launches == before + 1
    ref = fast.fast_two_threshold_plain(imgs, 12.0, 7.0)
    torch.cuda.synchronize()
    for (hi, lo), (hi0, lo0) in zip(out, ref):
        assert torch.equal(hi, hi0) and torch.equal(lo, lo0)
    assert any(int((lo > 0).sum()) > 0 for _, lo in out)
    again = fast.fast_two_threshold(imgs, 12.0, 7.0)
    assert all(torch.equal(a, b) for pa, pb in zip(again, out) for a, b in zip(pa, pb))
    assert fast_cuda.launches == before + 2


@pytest.mark.cuda
def test_cuda_wrapper_rejects_non_contiguous_wrong_dtype_and_mixed_devices(cuda_device):
    before = fast_cuda.launches
    with pytest.raises(ValueError):
        fast_cuda.fast9_two_threshold([torch.zeros(16, 32, device=cuda_device)[:, ::2]], 12.0, 7.0)
    with pytest.raises(TypeError):
        fast_cuda.fast9_two_threshold([torch.zeros(16, 16, dtype=torch.float16, device=cuda_device)], 12.0, 7.0)
    with pytest.raises(ValueError):
        fast.fast_two_threshold([torch.zeros(16, 16, device=cuda_device), torch.zeros(16, 16)], 12.0, 7.0)
    assert fast_cuda.launches == before
