"""Wrapper of the hand-written CUDA q-correlation kernel (``csrc/qcorr.cu``).

Replaces the TPU kernel ``diasss_tpu/matching/dense_pallas.py:_qcorr_kernel``.
The source is compiled at first use by :mod:`.._nvcc` into
``build/diasss_tpu_torch/libqcorr.so`` and bound with ``ctypes`` through its
plain C entry point ``int qcorr(const float* wvh, const float* wh, const
float* q, float* a, float* b, int K, int S, int k, int T, void* stream)``.
The kernel keeps the port's keypoint-major ``(K, S, S)`` layout.

``launches`` counts kernel launches made through :func:`qcorr_cuda`; callers
(the chip smoke test) reset and read it to prove a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _nvcc

SOURCE = _nvcc.CSRC / "qcorr.cu"
LIBRARY = _nvcc.library(SOURCE)

launches = 0

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _nvcc.build(SOURCE)
            lib = ctypes.CDLL(str(LIBRARY))
            lib.qcorr.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.qcorr.restype = ctypes.c_int
            lib.qcorr_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.qcorr_smem_bytes.restype = ctypes.c_longlong
            lib.qcorr_smem_limit.argtypes = []
            lib.qcorr_smem_limit.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def check_inputs(Wvh: torch.Tensor, Wh: torch.Tensor, q: torch.Tensor, k: int, T: int) -> None:
    """Raise on anything the kernel does not take: float32 contiguous
    ``Wvh, Wh (K, S, S)`` with ``S == T + k - 1`` and ``q (K, k*k)``."""
    for name, x in (("Wvh", Wvh), ("Wh", Wh), ("q", q)):
        if x.dtype != torch.float32:
            raise TypeError(f"qcorr takes float32, got {name} {x.dtype}")
    if Wvh.dim() != 3 or Wvh.shape[1] != Wvh.shape[2] or Wh.shape != Wvh.shape:
        raise ValueError(f"qcorr takes Wvh, Wh of one shape (K, S, S), got {tuple(Wvh.shape)}, {tuple(Wh.shape)}")
    K, S = int(Wvh.shape[0]), int(Wvh.shape[1])
    if k < 1 or T < 1 or S != T + k - 1:
        raise ValueError(f"qcorr needs S == T + k - 1, got S={S}, T={T}, k={k}")
    if tuple(q.shape) != (K, k * k):
        raise ValueError(f"qcorr takes q of shape (K, k*k) = {(K, k * k)}, got {tuple(q.shape)}")
    if not (Wvh.is_contiguous() and Wh.is_contiguous() and q.is_contiguous()):
        raise ValueError("qcorr takes contiguous Wvh, Wh and q")


def qcorr_cuda(Wvh: torch.Tensor, Wh: torch.Tensor, q: torch.Tensor, k: int, T: int):
    """``(A, B)``, each (K, T, T), computed by the CUDA kernel on the current
    stream from CUDA tensors; raises on any other input, and when one
    keypoint's two windows do not fit the card's shared memory."""
    global launches
    check_inputs(Wvh, Wh, q, k, T)
    for name, x in (("Wvh", Wvh), ("Wh", Wh), ("q", q)):
        if x.device != Wvh.device or x.device.type != "cuda":
            raise ValueError(f"qcorr runs on CUDA tensors of one device, got {name} on {x.device}")
    K, S = int(Wvh.shape[0]), int(Wvh.shape[1])
    A = torch.empty((K, T, T), dtype=torch.float32, device=Wvh.device)
    B = torch.empty_like(A)
    if K == 0:
        return A, B
    lib = _load()
    with torch.cuda.device(Wvh.device):
        need, limit = lib.qcorr_smem_bytes(S, k), lib.qcorr_smem_limit()
        if need > limit:
            raise ValueError(f"qcorr windows of {K}x{S}x{S} (k={k}, T={T}) need {need} bytes of shared "
                             f"memory per keypoint, above the card's {limit}")
        stream = torch.cuda.current_stream(Wvh.device).cuda_stream
        rc = lib.qcorr(Wvh.data_ptr(), Wh.data_ptr(), q.data_ptr(), A.data_ptr(), B.data_ptr(),
                       K, S, k, T, stream)
    if rc != 0:
        raise RuntimeError(f"qcorr launch failed with cudaError {rc} (K={K}, S={S}, k={k}, T={T})")
    launches += 1
    return A, B
