"""The CUDA FAST-9 kernel (``diasss_tpu_torch/csrc/fast9.cu``) against its
plain torch version, on the card.  Skipped without a GPU: a CUDA kernel has
no CPU mode.

This file imports no JAX, so it runs on a GPU machine without it; there the
suite's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_fast_cuda.py

Tolerance: none on ``[3:-3, 3:-3]``.  Subtraction, min and max of float32 are
exact and order-free; only the 3-px frame differs (the kernel clamps its halo,
the plain version wraps) and the detector zeroes that frame.
"""

import numpy as np
import pytest
import torch

from diasss_tpu_torch.features import fast, fast_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(600, 512), (241, 206), (37, 45), (4992, 1280)])
def test_cuda_kernel_equals_plain_on_interior(cuda_device, shape):
    img = torch.as_tensor(np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32), device=cuda_device)
    for threshold in (12.0, 7.0):
        before = fast_cuda.launches
        out = fast_cuda.fast9_score(img, threshold)
        assert fast_cuda.launches == before + 1
        ref = fast.fast_score_plain(img, threshold)
        torch.cuda.synchronize()
        assert torch.equal(out[3:-3, 3:-3], ref[3:-3, 3:-3])
        assert torch.equal(fast.fast_score(img, threshold), out)
        assert fast_cuda.launches == before + 2


@pytest.mark.cuda
def test_cuda_wrapper_rejects_non_contiguous_and_wrong_dtype(cuda_device):
    before = fast_cuda.launches
    with pytest.raises(ValueError):
        fast_cuda.fast9_score(torch.zeros(16, 32, device=cuda_device)[:, ::2], 12.0)
    with pytest.raises(TypeError):
        fast_cuda.fast9_score(torch.zeros(16, 16, dtype=torch.float16, device=cuda_device), 12.0)
    assert fast_cuda.launches == before
