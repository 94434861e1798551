"""Videos and grid prompts, the general generator of the track-generation
mixes (``traffic/*.json`` with ``"generator": "videos"``).

A video is ``height`` x ``width`` JPEG frames of textured noise with
``objects`` coloured ellipses, each moving inside its own cell of a grid, so
the objects never overlap. The i-th frame of ``prompt_frames`` prompts the
i-th group of ``prompts_per_frame`` objects by their masks on that frame (a
prompts JSON in the grid-prompts layout), so no two prompts cover the same
object and a track never dedups another object's prompt. Lengths
are drawn from the mix's ``frames`` list: every seed gets the same multiset
of lengths (the list repeated to ``n_videos``) in its own order.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.gen import rle

COLOURS = ((230, 60, 40), (50, 210, 90), (60, 80, 240), (240, 220, 60),
           (200, 60, 220), (60, 220, 220), (250, 150, 40), (140, 140, 140))


def _rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


def lengths(mix: dict, seed: int) -> list:
    pool = list(mix["frames"])
    n = int(mix["n_videos"])
    reps = (pool * (n // len(pool) + 1))[:n]
    return [int(x) for x in _rng(seed, 1).permutation(reps)]


def _object_tracks(rng, n_frames: int, h: int, w: int, n_obj: int):
    """Per object: centre path and radii, inside its own grid cell."""
    cols = int(np.ceil(np.sqrt(n_obj)))
    rows = int(np.ceil(n_obj / cols))
    ch, cw = h // rows, w // cols
    objs = []
    for j in range(n_obj):
        r, c = divmod(j, cols)
        ry = rng.uniform(0.18, 0.3) * ch
        rx = rng.uniform(0.18, 0.3) * cw
        amp_y = 0.5 * ch - ry - 2
        amp_x = 0.5 * cw - rx - 2
        ph = rng.uniform(0, 2 * np.pi, 2)
        speed = rng.uniform(0.05, 0.15, 2)
        t = np.arange(n_frames)
        cy = r * ch + 0.5 * ch + amp_y * np.sin(ph[0] + speed[0] * t)
        cx = c * cw + 0.5 * cw + amp_x * np.sin(ph[1] + speed[1] * t)
        objs.append((cy, cx, ry, rx))
    return objs


def _frame_and_masks(base, objs, t, want):
    """Frame ``t`` and the full-frame masks of the objects in ``want``;
    each ellipse is drawn over its bounding box only."""
    f = base.copy()
    h, w = f.shape[:2]
    masks = {}
    for j, (cy, cx, ry, rx) in enumerate(objs):
        y0, y1 = max(int(cy[t] - ry) - 1, 0), min(int(cy[t] + ry) + 2, h)
        x0, x1 = max(int(cx[t] - rx) - 1, 0), min(int(cx[t] + rx) + 2, w)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        m = ((yy - cy[t]) / ry) ** 2 + ((xx - cx[t]) / rx) ** 2 < 1.0
        f[y0:y1, x0:x1][m] = COLOURS[j % len(COLOURS)]
        if j in want:
            full = np.zeros((h, w), np.uint8)
            full[y0:y1, x0:x1] = m
            masks[j] = full
    return f, masks


def write_video(root: str, video_id: str, n_frames: int, mix: dict,
                seed: int, index: int) -> dict:
    from PIL import Image
    h, w = int(mix["height"]), int(mix["width"])
    rng = _rng(seed, 2, index)
    base = (rng.random((h, w, 3)) * 60 + 30).astype(np.uint8)
    objs = _object_tracks(rng, n_frames, h, w, int(mix["objects"]))
    frames_dir = os.path.join(root, "JPEGImages", video_id)
    os.makedirs(frames_dir, exist_ok=True)
    per = int(mix["prompts_per_frame"])
    prompted = {int(f): range(i * per, (i + 1) * per)
                for i, f in enumerate(mix["prompt_frames"])}
    prompts = []
    for t in range(n_frames):
        frame, masks = _frame_and_masks(base, objs, t,
                                        set(prompted.get(t, ())))
        Image.fromarray(frame).save(
            os.path.join(frames_dir, f"{t:05d}.jpg"), quality=90)
        for j in prompted.get(t, ()):
            m = masks[j]
            prompts.append({"segmentation": rle.encode(m),
                            "stability_score": 0.97, "area": int(m.sum()),
                            "area_ratio": float(m.mean()), "frame_idx": t,
                            "prompt_id": len(prompts)})
    prompt_path = os.path.join(root, "prompts", f"{video_id}.json")
    os.makedirs(os.path.dirname(prompt_path), exist_ok=True)
    with open(prompt_path, "w") as f:
        json.dump({"video_id": video_id, "bin_size": int(mix["bin_size"]),
                   "prompt_masks": prompts}, f)
    return {"video_id": video_id, "frames_dir": frames_dir,
            "prompt_path": prompt_path, "n_frames": n_frames,
            "n_prompts": len(prompts)}


def generate(root: str, mix: dict, seed: int, threads: int = 4) -> dict:
    """{"warmup": video, "videos": [video, ...]} written under ``root``."""
    jobs = [("warmup", int(mix["warmup_frames"]), 0)]
    jobs += [(f"v{i:03d}", n, i + 1)
             for i, n in enumerate(lengths(mix, seed))]
    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(
            lambda j: write_video(root, j[0], j[1], mix, seed, j[2]), jobs))
    return {"warmup": out[0], "videos": out[1:]}
