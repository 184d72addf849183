"""Native C++ reader of the survey files, loaded through ctypes.

The port's copy of :mod:`diasss_tpu.native`.  ``io_native.cpp`` here is the
JAX package's source, byte for byte but for the path in one header comment;
it is compiled by ``g++`` at first use into
``build/diasss_tpu_torch/libdiasss_io.so`` under the repository root, beside
the CUDA libraries (:mod:`.._nvcc`), never into the package folder.  The pure-Python readers of :mod:`..io.opencv_xml` remain
the fallback: :func:`unavailable_reason` says why the native reader cannot
run, and the loader reports which reader ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._nvcc import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "io_native.cpp"
LIBRARY = BUILD_DIR / "libdiasss_io.so"
_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _build() -> None:
    """Compile :data:`SOURCE` into :data:`LIBRARY` (through a file of this
    process's own, renamed into place, so concurrent builds never load a
    half-written library); raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    out = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed: {out.stderr.strip()[:500]}")
    os.replace(tmp, LIBRARY)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.probe_cv_matrix.restype = ctypes.c_int
        lib.probe_cv_matrix.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_char)]
        lib.read_cv_matrix.restype = ctypes.c_long
        lib.read_cv_matrix.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_long]
        lib.read_txt_column.restype = ctypes.c_long
        lib.read_txt_column.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native reader cannot run (the build's or the load's error),
    or None when it can."""
    _load()
    return _error


_DT_NP = {b"d": np.float64, b"f": np.float32, b"i": np.int64, b"s": np.int16, b"u": np.uint8}


def read_matrix(path: str, key: str) -> np.ndarray:
    """Native OpenCV-XML matrix read; raises on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {_error}")
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    dt = ctypes.c_char()
    rc = lib.probe_cv_matrix(path.encode(), key.encode(), rows, cols, ctypes.byref(dt))
    if rc != 0:
        raise KeyError(f"probe failed ({rc}) for {key!r} in {path}")
    n = rows.value * cols.value
    buf = np.empty(n, np.float64)
    got = lib.read_cv_matrix(path.encode(), key.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got != n:
        raise ValueError(f"matrix size mismatch in {path}: read {got}, want {n}")
    out_dt = _DT_NP.get(dt.value, np.float64)
    return buf.reshape(rows.value, cols.value).astype(out_dt, copy=False)


def read_txt_column(path: str, max_vals: int = 1 << 22) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {_error}")
    buf = np.empty(max_vals, np.float64)
    got = lib.read_txt_column(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_vals)
    if got < 0:
        raise IOError(f"cannot read {path}")
    return buf[:got].copy()
