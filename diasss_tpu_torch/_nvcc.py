"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source has a plain C entry point and is compiled with ``nvcc`` for
``sm_90a`` into ``build/diasss_tpu_torch/lib<stem>.so`` under the repository
root, then bound with ``ctypes`` by its wrapper.  :func:`build` starts one
``nvcc`` per source, all together, and waits for them all.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "diasss_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library(source: Path) -> Path:
    """The shared library that :func:`build` makes from ``source``."""
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; cannot build the CUDA kernels")
    return str(path)


def build(*sources: Path, force: bool = False) -> Dict[Path, str]:
    """Compile every source whose library is missing or older than it (all of
    them with ``force``), one ``nvcc`` process each, started together.
    Returns ``{library: nvcc output}`` for the sources compiled (``-Xptxas
    -v`` reports each kernel's registers and shared memory); raises if any
    compile fails."""
    todo = [Path(s) for s in sources
            if force or not library(s).exists() or library(s).stat().st_mtime < Path(s).stat().st_mtime]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src in todo:
        tmp = library(src).with_suffix(f".{os.getpid()}.tmp.so")
        procs.append((src, tmp, subprocess.Popen([exe, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                 text=True)))
    logs, failed = {}, []
    for src, tmp, proc in procs:
        out, _ = proc.communicate(timeout=600)
        logs[library(src)] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}")
        else:
            os.replace(tmp, library(src))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs
