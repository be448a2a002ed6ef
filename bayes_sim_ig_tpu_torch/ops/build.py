"""Builds the port's CUDA sources into shared libraries and loads them.

Each library is compiled by ``nvcc`` at first use into
``build/torch_kernels/`` at the root of the checkout, under a file name
keyed by a hash of its sources, csrc/'s headers and the flags, so an
edited source builds anew and an unchanged one is loaded as it is. The
sources expose plain C entry points, bound with ``ctypes`` (no PyTorch
headers: such a build takes seconds, not minutes).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
_LOCKS: dict = {}
# Seconds and compiler output of each build done by this process, by name.
BUILD_LOG: dict = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return found


def _lib_path(name: str, sources) -> str:
    """Keyed by the flags, the sources and every header in csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in [*sources, *headers]:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def load_library(name: str, sources) -> ctypes.CDLL:
    """Compiles ``sources`` (paths under csrc/) into lib ``name`` unless a
    build of the same sources exists, then loads it with ctypes. Threads
    asking for one library wait for a single build."""
    with _LOCKS.setdefault(name, threading.Lock()):
        if name not in _LIBS:
            _LIBS[name] = _load(name, sources)
        return _LIBS[name]


def _load(name: str, sources) -> ctypes.CDLL:
    sources = [os.path.join(CSRC_DIR, s) for s in sources]
    path = _lib_path(name, sources)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders never clash
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": proc.stderr.strip()}
    return ctypes.CDLL(path)
