"""COCO run-length encoding in NumPy, for the traffic the benchmark writes
and the outputs it reads back (the compressed string format of the
reference's ``pycocotools``; a copy of the port's NumPy codec)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
    mask = np.asarray(mask)
    return {"size": [int(mask.shape[0]), int(mask.shape[1])],
            "counts": _np_counts_to_string(_np_counts_from_mask(mask))}


def decode(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    return _np_decode(counts, int(rle["size"][0]), int(rle["size"][1]))
