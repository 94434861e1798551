"""Videos with GT masklets in the MeViS train layout, the general generator
of the GT-track mixes (``traffic/*.json`` with ``"generator":
"mevis_gt_videos"``).

Writes ``<root>/datasets/mevis/train/JPEGImages/<video>/*.jpg``,
``meta_expressions.json`` (one expression per GT object) and
``mask_dict.json`` (each GT object's per-frame RLE, null where it is
absent). ``group`` lists videos as [frames, GT objects, of them
re-appearing]; the mix is ``n_groups`` groups, each holding the group's
videos in an order drawn from the seed, so every seed and every group (a
pack, where the group is as long as the pack) does the same work. Each
object moves in its own grid cell and appears in the first quarter of the
video; a re-appearing one leaves the frame for a stretch and comes back,
so it has two appearance onsets.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.gen import rle
from benchmark.gen.videos import COLOURS, _object_tracks, _rng


def videos(mix: dict, seed: int) -> list:
    """(frames, GT objects, re-appearing objects) of each video of the mix:
    ``n_groups`` times the ``group``, each time in a new order."""
    group = [tuple(int(x) for x in v) for v in mix["group"]]
    rng = _rng(seed, 1)
    return [group[i] for _ in range(int(mix["n_groups"]))
            for i in rng.permutation(len(group))]


def _presence(rng, n_frames: int, reappear: bool) -> np.ndarray:
    """Frames an object is visible on: from an onset in the first quarter,
    with a gap in the middle for a re-appearing object."""
    present = np.zeros(n_frames, bool)
    start = int(rng.integers(0, max(n_frames // 4, 1)))
    present[start:] = True
    if reappear:
        a = int(rng.integers(start + 2, start + 2 + n_frames // 4))
        present[a:a + max(n_frames // 6, 2)] = False
    return present


def write_video(root: str, video_id: str, spec: tuple, mix: dict,
                seed: int, index: int, first_anno: int) -> dict:
    from PIL import Image
    h, w = int(mix["height"]), int(mix["width"])
    n_frames, n_obj, n_back = spec
    rng = _rng(seed, 3, index)
    base = (rng.random((h, w, 3)) * 60 + 30).astype(np.uint8)
    cells = max(int(v[1]) for v in mix["group"])
    objs = _object_tracks(rng, n_frames, h, w, cells)[:n_obj]
    back = set(rng.permutation(n_obj)[:n_back].tolist())
    present = [_presence(rng, n_frames, j in back) for j in range(n_obj)]
    frames_dir = os.path.join(root, "datasets", "mevis", "train",
                              "JPEGImages", video_id)
    os.makedirs(frames_dir, exist_ok=True)
    rles = [[] for _ in range(n_obj)]
    for t in range(n_frames):
        f = base.copy()
        for j, (cy, cx, ry, rx) in enumerate(objs):
            if not present[j][t]:
                rles[j].append(None)
                continue
            y0, y1 = max(int(cy[t] - ry) - 1, 0), min(int(cy[t] + ry) + 2, h)
            x0, x1 = max(int(cx[t] - rx) - 1, 0), min(int(cx[t] + rx) + 2, w)
            yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
            m = ((yy - cy[t]) / ry) ** 2 + ((xx - cx[t]) / rx) ** 2 < 1.0
            f[y0:y1, x0:x1][m] = COLOURS[j % len(COLOURS)]
            full = np.zeros((h, w), np.uint8)
            full[y0:y1, x0:x1] = m
            rles[j].append(rle.encode(full))
        Image.fromarray(f).save(os.path.join(frames_dir, f"{t:05d}.jpg"),
                                quality=90)
    annos = {str(first_anno + j): rles[j] for j in range(n_obj)}
    expressions = {str(j): {"exp": f"object {j} of {video_id}",
                            "anno_id": [first_anno + j]}
                   for j in range(n_obj)}
    return {"video_id": video_id, "n_frames": n_frames,
            "frames_dir": frames_dir, "annos": annos,
            "expressions": expressions}


def generate(root: str, mix: dict, seed: int, threads: int = 4) -> dict:
    """{"warmup": [video, ...], "videos": [video, ...], "data_dir": the
    split's directory}; the meta and mask dict hold every video."""
    jobs = [(f"warm{i}", (int(mix["warmup_frames"]),
                          *(int(x) for x in mix["group"][i][1:])), i)
            for i in range(int(mix["warmup_videos"]))]
    jobs += [(f"v{i:03d}", spec, 100 + i)
             for i, spec in enumerate(videos(mix, seed))]
    step = max(int(v[1]) for v in mix["group"])
    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(lambda kj: write_video(
            root, kj[1][0], kj[1][1], mix, seed, kj[1][2], kj[0] * step),
            enumerate(jobs)))
    split = os.path.join(root, "datasets", "mevis", "train")
    meta = {"videos": {v["video_id"]: {
        "frames": [f"{i:05d}" for i in range(v["n_frames"])],
        "expressions": v["expressions"]} for v in out}}
    mask_dict = {k: r for v in out for k, r in v["annos"].items()}
    with open(os.path.join(split, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(split, "mask_dict.json"), "w") as f:
        json.dump(mask_dict, f)
    n_warm = int(mix["warmup_videos"])
    return {"warmup": out[:n_warm], "videos": out[n_warm:],
            "data_dir": split}
