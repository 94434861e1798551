"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from sources under ``sola_torch/csrc``
into ``sola_torch/_build/`` (git-ignored), keyed by a hash of the sources and
flags, and loaded with ``ctypes``. The sources have a plain C interface, so
no PyTorch header is compiled and a build takes seconds. A failed build
raises: no caller falls back to a plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# name -> {"seconds": build time (0.0 when loaded from the cache dir),
#          "log": nvcc's output (registers, shared memory, spills)}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into lib<name>, once per
    process and once per content hash on disk, and load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        paths = [os.path.join(CSRC_DIR, s) for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths:
            with open(p, "rb") as f:
                digest.update(f.read())
        so_path = os.path.join(BUILD_DIR,
                               f"lib{name}_{digest.hexdigest()[:16]}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.tmp.{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n{log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        build_info[name] = {"seconds": seconds, "log": log}
        _libs[name] = lib
        return lib
