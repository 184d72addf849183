"""The CUDA q-correlation kernel (``diasss_tpu_torch/csrc/qcorr.cu``) against
its plain torch version, on the card.  Skipped without a GPU: a CUDA kernel
has no CPU mode.

This file imports no JAX, so it runs on a GPU machine without it; there the
suite's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_qcorr_cuda.py

Tolerance: max abs error 2e-5.  Both sum the same k*k terms per output cell
in the same ascending order, but the kernel takes each step as one fused
multiply-add where ``qcorr_plain`` rounds the product and the sum
separately.  Every term is |q_g W_g| <= 1 (windows in [0, 1], unit-norm q),
and each version stays within 1e-5 of the float64 sum over 289 steps
(tests/test_torch_dense.py holds ``qcorr_plain`` to that on the CPU).
"""

import numpy as np
import pytest
import torch

from diasss_tpu_torch.matching import dense, dense_cuda

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(K, k, T, device, seed=0):
    S = T + k - 1
    rng = np.random.default_rng(seed)
    Wv = torch.as_tensor(rng.uniform(0, 1, (K, S, S)), dtype=torch.float32, device=device)
    Wh = torch.as_tensor(rng.uniform(size=(K, S, S)) > 0.1, dtype=torch.float32, device=device)
    q = torch.as_tensor(rng.normal(0, 1, (K, k * k)), dtype=torch.float32, device=device)
    return (Wv * Wh).contiguous(), Wh, (q / q.norm(dim=1, keepdim=True)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("K, k, T", [(12000, 17, 43), (12000, 17, 19), (64, 17, 123), (5, 3, 7), (9, 5, 10),
                                     (7, 17, 1)])
def test_cuda_kernel_equals_plain(cuda_device, K, k, T):
    """Round 0 and the 8-cell re-match round of the automatic profile, a
    window of S = 139 (past 48 KB of shared memory), the generic path at two
    other patch sizes, and a single offset."""
    Wvh, Wh, q = _inputs(K, k, T, cuda_device)
    before = dense_cuda.launches
    A, B = dense_cuda.qcorr_cuda(Wvh, Wh, q, k, T)
    assert dense_cuda.launches == before + 1
    A0, B0 = dense.qcorr_plain(Wvh, Wh, q, k, T)
    torch.cuda.synchronize()
    err = max(float((A - A0).abs().max()), float((B - B0).abs().max()))
    assert err <= TOL, err
    A2, B2 = dense.qcorr(Wvh, Wh, q, k, T)
    assert torch.equal(A2, A) and torch.equal(B2, B)  # the kernel is deterministic
    assert dense_cuda.launches == before + 2


@pytest.mark.cuda
def test_cuda_wrapper_rejects_windows_past_shared_memory(cuda_device):
    Wvh, Wh, q = _inputs(2, 17, 184, cuda_device)  # S = 200
    before = dense_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        dense_cuda.qcorr_cuda(Wvh, Wh, q, 17, 184)
    with pytest.raises(ValueError):
        dense_cuda.qcorr_cuda(Wvh[:, ::2, ::2], Wh[:, ::2, ::2], q, 17, 84)
    assert dense_cuda.launches == before
