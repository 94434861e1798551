"""COCO RLE codec: Python API over the native C++ library.

The SOLA pipeline stores every mask on disk as a COCO compressed-RLE dict
``{"size": [h, w], "counts": str}`` (reference: track_generation/utils.py:7-61,
seg_utils.py:64-106, dataloader.py:353-369). The reference leans on
pycocotools' C codec; here the codec is a small C++ shared library
(sola_torch/native/rle.cpp) compiled on first use, with a pure-NumPy fallback so
the package never hard-fails.

RLE is inherently sequential per mask, so it stays on the host; the batched
entry points fan frames out across threads so decode overlaps device compute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "rle.cpp")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native codec. Returns None on failure."""
    global _build_failed
    if _build_failed:
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_NATIVE_DIR, f"_librle_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            _SRC, "-o", tmp,
        ]
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
    lib.sola_rle_encode.restype = ctypes.c_long
    lib.sola_rle_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.sola_rle_decode.restype = ctypes.c_long
    lib.sola_rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sola_rle_area.restype = ctypes.c_long
    lib.sola_rle_area.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.sola_rle_decode_batch.restype = ctypes.c_long
    lib.sola_rle_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
    ]
    lib.sola_rle_encode_batch.restype = ctypes.c_long
    lib.sola_rle_encode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lib_lock:
            if _lib is None:
                _lib = _build_lib()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


# ---------------------------------------------------------------------------
# Pure-NumPy fallback (same format, used if the native build is unavailable).
# ---------------------------------------------------------------------------

def _np_counts_from_mask(mask: np.ndarray) -> list[int]:
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)  # column-major scan
    flat = (flat != 0).astype(np.int8)
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return counts


def _np_counts_to_string(cnts: Sequence[int]) -> str:
    out = []
    for i, x in enumerate(cnts):
        if i > 2:
            x = x - cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _np_string_to_counts(s: str) -> list[int]:
    cnts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _np_decode(s: str, h: int, w: int) -> np.ndarray:
    cnts = _np_string_to_counts(s)
    total = h * w
    flat = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for run in cnts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    if pos != total:
        raise ValueError(f"RLE decode length mismatch: {pos} != {total}")
    return flat.reshape(w, h).T  # column-major -> (h, w)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def encode(mask: np.ndarray) -> dict:
    """Encode a (H, W) binary mask into a COCO RLE dict with a str `counts`.

    Matches the reference's on-disk convention of utf-8 decoded counts
    (track_generation/utils.py:22).
    """
    mask = np.ascontiguousarray(np.asarray(mask), dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"encode expects (H, W), got {mask.shape}")
    h, w = mask.shape
    lib = _get_lib()
    if lib is None:
        counts = _np_counts_to_string(_np_counts_from_mask(mask))
        return {"size": [int(h), int(w)], "counts": counts}
    cap = 4 * h * w + 64
    buf = ctypes.create_string_buffer(cap)
    ptr = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.sola_rle_encode(ptr, h, w, buf, cap)
    if n < 0:
        raise RuntimeError("native RLE encode failed")
    return {"size": [int(h), int(w)], "counts": buf.raw[:n].decode("ascii")}


def decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE dict into a (H, W) uint8 mask.

    Accepts str or bytes counts (the reference tolerates both,
    dataloader.py:357-360).
    """
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    lib = _get_lib()
    if lib is None:
        return _np_decode(counts, h, w)
    out = np.zeros((h, w), dtype=np.uint8)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    raw = counts.encode("ascii")
    rc = lib.sola_rle_decode(raw, len(raw), h, w, ptr)
    if rc != 0:
        raise ValueError(f"native RLE decode failed (rc={rc})")
    return out


def area(rle: dict) -> int:
    """Foreground pixel count of an RLE mask without densifying."""
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    lib = _get_lib()
    if lib is None:
        cnts = _np_string_to_counts(counts)
        return int(sum(cnts[1::2]))
    raw = counts.encode("ascii")
    a = lib.sola_rle_area(raw, len(raw))
    if a < 0:
        raise ValueError("native RLE area failed")
    return int(a)


def encode_masklet(masklet: np.ndarray, n_threads: int = 0) -> list[dict]:
    """Encode a (T, H, W) masklet into a list of RLE dicts.

    Semantics of seg_utils.encode_rle_masklet (seg_utils.py:78-90), batched
    across frames in native threads.
    """
    masklet = np.ascontiguousarray(np.asarray(masklet), dtype=np.uint8)
    if masklet.ndim != 3:
        raise ValueError(f"encode_masklet expects (T, H, W), got {masklet.shape}")
    t, h, w = masklet.shape
    lib = _get_lib()
    if lib is None or t == 0:
        return [encode(m) for m in masklet]
    if n_threads <= 0:
        n_threads = min(t, os.cpu_count() or 1)
    cap = 4 * h * w * t + 64 * t
    buf = ctypes.create_string_buffer(cap)
    offsets = np.zeros(t + 1, dtype=np.int64)
    rc = lib.sola_rle_encode_batch(
        masklet.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w,
        buf, cap, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_threads)
    if rc < 0:
        raise RuntimeError("native batched RLE encode failed")
    raw = buf.raw
    return [
        {"size": [int(h), int(w)],
         "counts": raw[offsets[i]:offsets[i + 1]].decode("ascii")}
        for i in range(t)
    ]


def decode_masklet(rle_masklet: Sequence, n_threads: int = 0) -> np.ndarray:
    """Decode a list of per-frame RLEs into a (T, H, W) uint8 masklet.

    Non-dict entries (the dataset's "object absent this frame" sentinel)
    become all-zero frames, matching dataloader.rle_masklet_decode
    (dataloader.py:353-369). Frame size is taken from the first dict entry.
    """
    t = len(rle_masklet)
    h = w = 0
    for rle in rle_masklet:
        if isinstance(rle, dict):
            h, w = int(rle["size"][0]), int(rle["size"][1])
            break
    if h == 0:
        raise ValueError("decode_masklet: no dict entry with a size found")
    lib = _get_lib()
    if lib is None or t == 0:
        out = np.zeros((t, h, w), dtype=np.uint8)
        for i, rle in enumerate(rle_masklet):
            if isinstance(rle, dict):
                out[i] = decode(rle)
        return out
    if n_threads <= 0:
        n_threads = min(t, os.cpu_count() or 1)
    parts = []
    offsets = np.zeros(t + 1, dtype=np.int64)
    pos = 0
    for i, rle in enumerate(rle_masklet):
        offsets[i] = pos
        if isinstance(rle, dict):
            counts = rle["counts"]
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            b = counts.encode("ascii")
            parts.append(b)
            pos += len(b)
    offsets[t] = pos
    blob = b"".join(parts)
    out = np.zeros((t, h, w), dtype=np.uint8)
    rc = lib.sola_rle_decode_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), t, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if rc != 0:
        raise ValueError(f"native batched RLE decode failed (frame {-rc - 1})")
    return out
