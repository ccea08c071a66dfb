"""
Build of the port's CUDA sources — the counterpart of pcr_tpu/native's lazy
g++ build (pcr_tpu/native/__init__.py:1-70).

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into ONE
shared library with a plain C interface, loaded through ctypes. The build
runs at first use, into `pcr_tpu_torch/_build/` (git-ignored), and the
library's file name carries a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads at once. Nothing here runs at
import time. There is no fallback: a missing `nvcc` or a failed build
raises, and the caller's CUDA tensors get no result rather than a wrong
path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load", "library_path", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "pcr_tpu_torch: nvcc not found (set CUDA_HOME); the CUDA "
            "kernels are built from pcr_tpu_torch/csrc at first use")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"pcr_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    r = subprocess.run(cmd, capture_output=True, text=True)
    # ptxas -v reports registers, shared memory and spills per kernel
    with open(out[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"pcr_tpu_torch: nvcc failed "
                           f"({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            _LIB = ctypes.CDLL(path)
        return _LIB
