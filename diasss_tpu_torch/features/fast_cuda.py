"""Wrapper of the hand-written CUDA FAST-9 kernel (``csrc/fast9.cu``).

Replaces the TPU kernel ``diasss_tpu/features/fast_pallas.py:_fast_tile_kernel``.
The source is compiled at first use by :mod:`.._nvcc` into
``build/diasss_tpu_torch/libfast9.so`` and bound with ``ctypes`` through its
plain C entry point ``int fast9_two_threshold(int L, const long long* img,
const long long* out, const int* n, const int* m, float ini_t, float min_t,
void* stream)``: one launch computes every pyramid level of a frame at both
thresholds, with the FAST frame zeroed and 3x3 non-maximum suppression.

``launches`` counts kernel launches made through
:func:`fast9_two_threshold`; callers (the chip smoke test) reset and read it
to prove a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch

from .. import _nvcc
from .fast import check_levels

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
            lib.fast9_two_threshold.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            lib.fast9_two_threshold.restype = ctypes.c_int
            _lib = lib
    return _lib


def fast9_two_threshold(levels: Sequence[torch.Tensor], ini_t: float,
                        min_t: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per level ``(s_hi, s_lo)``: the FAST-9 score at ``ini_t`` and at
    ``min_t``, 3-px frame zeroed, 3x3 non-maximum suppressed; one kernel
    launch on the current stream for all levels of CUDA tensors.  Both maps
    of every level are views of one flat output.  Raises on any other
    input."""
    global launches
    check_levels(levels)
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"fast9_two_threshold runs on CUDA tensors, got device {dev}")
    sizes = [img.numel() for img in levels]
    flat = torch.empty(2 * sum(sizes), dtype=torch.float32, device=dev)
    planes = flat.split([2 * size for size in sizes])  # per level (s_hi, s_lo)
    L = len(levels)
    lib = _load()
    img_p = (ctypes.c_longlong * L)(*[img.data_ptr() for img in levels])
    out_p = (ctypes.c_longlong * L)(*[plane.data_ptr() for plane in planes])
    n_p = (ctypes.c_int * L)(*[int(img.shape[0]) for img in levels])
    m_p = (ctypes.c_int * L)(*[int(img.shape[1]) for img in levels])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fast9_two_threshold(L, img_p, out_p, n_p, m_p, float(ini_t), float(min_t), stream)
    if rc != 0:
        raise RuntimeError(f"fast9_two_threshold launch failed with cudaError {rc} "
                           f"(shapes {[tuple(img.shape) for img in levels]})")
    launches += 1
    return [tuple(plane.view(2, *img.shape).unbind(0)) for plane, img in zip(planes, levels)]
