"""Wrapper of the hand-written CUDA FAST-9 kernel (``csrc/fast9.cu``).

Replaces the TPU kernel ``diasss_tpu/features/fast_pallas.py:_fast_tile_kernel``.
The source is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/diasss_tpu_torch/libfast9.so`` under the repository root and bound with
``ctypes`` through its plain C entry point
``int fast9_score(const float*, float*, int n, int m, float thr, void* stream)``.

``launches`` counts kernel launches made through :func:`fast9_score`; callers
(the chip smoke test) reset and read it to prove a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fast9.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diasss_tpu_torch"
LIBRARY = BUILD_DIR / "libfast9.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0
build_log = ""  # nvcc's output of the last build (-Xptxas -v register/smem report)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; cannot build {SOURCE}")
    return str(path)


def build(force: bool = False) -> Path:
    """Compile ``fast9.cu`` into the shared library (skipped when it is newer
    than the source, unless ``force``).  Returns the library path."""
    global build_log
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=600)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{build_log}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
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
