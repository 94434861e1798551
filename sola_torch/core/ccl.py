"""Connected-component labeling + small-region mask cleanup (host C++).

A copy of ``sola_tpu/core/ccl.py``: the stand-in for SAM2's CUDA
connected-components postprocessor (upstream ``postprocess_small_regions``;
the reference disables it on the grid-prompt path —
generate_prompts_grid.py:66 ``apply_postprocess=False`` — but the AMG API
surface supports ``min_mask_region_area > 0``). CCL is pointer-chasing, so
it stays on the host: a small C++ library compiled on first use
(sola_torch/native/ccl.cpp) with a NumPy/BFS fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "ccl.cpp")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _build_failed:
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_NATIVE_DIR, f"_libccl_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
               "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        except (subprocess.CalledProcessError, OSError):
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _build_failed = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sola_ccl_label.restype = ctypes.c_int64
    lib.sola_ccl_label.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.sola_ccl_remove_small.restype = ctypes.c_int64
    lib.sola_ccl_remove_small.argtypes = [u8p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int32]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lib_lock:
            if _lib is None:
                _lib = _build_lib()
    return _lib


def label(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connectivity labels of a (H, W) binary mask -> (labels int32, n).

    Background is 0; components are 1..n.
    """
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _get_lib()
    if lib is not None:
        labels = np.zeros((h, w), np.int32)
        n = lib.sola_ccl_label(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels, int(n)
    return _label_numpy(mask)


def _label_numpy(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """BFS fallback (no native toolchain)."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    n = 0
    for sy, sx in zip(*np.nonzero(mask & (labels == 0))):
        if labels[sy, sx]:
            continue
        n += 1
        stack = [(sy, sx)]
        labels[sy, sx] = n
        while stack:
            y, x = stack.pop()
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1),
                           (y, x + 1), (y - 1, x - 1), (y - 1, x + 1),
                           (y + 1, x - 1), (y + 1, x + 1)):
                if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                        and not labels[ny, nx]):
                    labels[ny, nx] = n
                    stack.append((ny, nx))
    return labels, n


def remove_small_regions(mask: np.ndarray, min_area: int,
                         mode: str) -> tuple[np.ndarray, bool]:
    """Upstream sam2.utils.amg.remove_small_regions semantics.

    mode "holes": fill background components smaller than ``min_area``;
    mode "islands": drop foreground components smaller than ``min_area``.
    Returns (mask, changed).
    """
    assert mode in ("holes", "islands"), mode
    out = np.ascontiguousarray(mask.astype(np.uint8)).copy()
    h, w = out.shape
    lib = _get_lib()
    if lib is not None:
        changed = lib.sola_ccl_remove_small(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            int(min_area), 0 if mode == "holes" else 1)
        return out.astype(bool), bool(changed)
    target = 0 if mode == "holes" else 1
    labels, n = _label_numpy((out == target).astype(np.uint8))
    areas = np.bincount(labels.reshape(-1), minlength=n + 1)
    small = [c for c in range(1, n + 1) if areas[c] < min_area]
    if mode == "islands" and len(small) == n and n > 0:
        small.remove(int(np.argmax(areas[1:])) + 1)  # keep the largest
    changed = False
    for comp in small:
        out[labels == comp] = 1 - target
        changed = True
    return out.astype(bool), changed
