"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from sources under ``sola_torch/csrc``
into ``sola_torch/_build/`` (git-ignored), keyed by a hash of the sources and
flags, and loaded with ``ctypes``. The sources have a plain C interface, so
no PyTorch header is compiled and a build takes seconds. ``build_all``
starts one ``nvcc`` per library at once, for callers that want every kernel
ready up front. A failed build raises: no caller falls back to a plain
version on a CUDA tensor.

Several processes may ask for one library at once (the ranks of a process
group started together on an unbuilt tree): a build holds an exclusive
lock on ``lib<name>.lock`` in the build dir from its check for the library
to the rename that publishes it, and ``nvcc`` writes a file of its own
that is renamed into place whole, so a process either builds or waits and
then loads the finished library. The operating system drops the lock with
its process, so a killed build leaves no stale lock.
"""

from __future__ import annotations

import ctypes
import fcntl
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
# every library of the package: name -> its sources under csrc/
LIBRARIES = {"flash_attn_fwd": ("flash_attn_fwd.cu",),
             "flash_attn_bwd": ("flash_attn_bwd.cu",),
             "ms_deform_attn_fwd": ("ms_deform_attn_fwd.cu",)}

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


def _so_path(name: str) -> tuple:
    """(sources, library path): the path is keyed by the flags, the sources
    and every header under csrc/ (which a source may include)."""
    paths = [os.path.join(CSRC_DIR, s) for s in LIBRARIES[name]]
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            digest.update(f.read())
    return paths, os.path.join(BUILD_DIR,
                               f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built: returns
    (so_path, tmp_path, Popen, start time, lock) or (so_path, None, None,
    0, None); the lock (an open file) is held until ``_complete``."""
    paths, so_path = _so_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    lock = open(os.path.join(BUILD_DIR, f"lib{name}.lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)  # waits for another process's build
    if os.path.exists(so_path):
        lock.close()
        return so_path, None, None, 0.0, None
    tmp = f"{so_path}.tmp.{os.getpid()}"
    try:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except BaseException:
        lock.close()
        raise
    return so_path, tmp, proc, time.perf_counter(), lock


def _complete(name: str, job) -> tuple:
    """Wait for ``job``'s nvcc, publish its library with an atomic rename
    and drop the lock: (so_path, seconds, nvcc's output)."""
    so_path, tmp, proc, t0, lock = job
    if proc is None:
        return so_path, 0.0, ""
    try:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} ({proc.returncode}):\n{log}")
        os.replace(tmp, so_path)
    finally:
        lock.close()
    return so_path, seconds, log


def _finish(name: str, job) -> ctypes.CDLL:
    so_path, seconds, log = _complete(name, job)
    lib = ctypes.CDLL(so_path)
    build_info[name] = {"seconds": seconds, "log": log}
    _libs[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Compile library ``name``'s sources (``LIBRARIES``) into lib<name>,
    once per process and once per content hash on disk, and load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        return _finish(name, _start(name))


def build_all() -> None:
    """Build and load every library not loaded yet, one nvcc process per
    library, all started together."""
    with _lock:
        jobs = {name: _start(name) for name in LIBRARIES if name not in _libs}
        errors = []
        for name, job in jobs.items():  # waits for every nvcc it started
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
