"""Wrapper of the hand-written CUDA FAST-9 kernel (``csrc/fast9.cu``).

Replaces the TPU kernel ``diasss_tpu/features/fast_pallas.py:_fast_tile_kernel``.
The source is compiled at first use by :mod:`.._nvcc` into
``build/diasss_tpu_torch/libfast9.so`` and bound with ``ctypes`` through its
plain C entry point
``int fast9_score(const float*, float*, int n, int m, float thr, void* stream)``.

``launches`` counts kernel launches made through :func:`fast9_score`; callers
(the chip smoke test) reset and read it to prove a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _nvcc

SOURCE = _nvcc.CSRC / "fast9.cu"
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
            lib.fast9_score.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            lib.fast9_score.restype = ctypes.c_int
            _lib = lib
    return _lib


def fast9_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score map of a 2-D contiguous float32 CUDA tensor, computed by
    the CUDA kernel on the current stream.  Raises on any other input."""
    global launches
    if img.dtype != torch.float32:
        raise TypeError(f"fast9_score takes float32, got {img.dtype}")
    if img.dim() != 2:
        raise ValueError(f"fast9_score takes a 2-D image, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("fast9_score takes a contiguous image")
    if img.device.type != "cuda":
        raise ValueError(f"fast9_score runs on a CUDA tensor, got device {img.device}")
    n, m = img.shape
    if n > 65535 * 8:  # gridDim.y limit with 8-row blocks
        raise ValueError(f"fast9_score takes at most {65535 * 8} rows, got {n}")
    lib = _load()
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.fast9_score(img.data_ptr(), out.data_ptr(), n, m, float(threshold), stream)
    if rc != 0:
        raise RuntimeError(f"fast9_score launch failed with cudaError {rc}")
    launches += 1
    return out
