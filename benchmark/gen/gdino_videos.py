"""Videos and referring expressions in the MeViS valid layout, the
generator of the text-prompted mixes (``traffic/*.json`` with
``"generator": "gdino_videos"``).

Writes ``<root>/datasets/mevis/valid/JPEGImages/<video>/*.jpg`` and
``meta_expressions.json``. ``videos`` lists each video as [frames,
expressions]; its frames (textured noise with ``objects`` coloured
ellipses, each moving in its own grid cell) and its expressions (``words``
words each, drawn from a list of nouns, colours, verbs and places) come
from the mix's ``content_seed``, so every run sees the same videos and
expressions. The window walks them in the order ``cycle`` gives (indices
into ``videos``), from a starting point the run's seed draws: a window
holds 3 or 4 videos, and the cycle alternates videos whose tracks are
dense and sparse (their object-frames a second on the card differ by up
to 1.6x), so that every starting point does about the same work. The
cycle is set by hand from the videos' measured rates (the mix's
``cycle_why`` gives them): how many tracks a video gets follows the
configuration's weights and box gate, so when those or the mix's content
change, the cell's per-video object-frames (its ``units:`` line) are to
be read again and the cycle set anew. ``warmup`` is one more video of
that shape, run before the window.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.gen.videos import _frame_and_masks, _object_tracks, _rng

WORDS = ("the a man woman dog cat bird horse car bike ball red blue green "
         "white black small large left right moving walking running "
         "turning standing jumping slowly quickly first second last near "
         "far front behind next to in on of with toward away from tree "
         "road field water who is that".split())


def expressions(rng, n: int, words) -> dict:
    lo, hi = int(words[0]), int(words[1])
    return {str(i): {"exp": " ".join(rng.choice(WORDS, int(k)).tolist()),
                     "anno_id": []}
            for i, k in enumerate(rng.integers(lo, hi + 1, n))}


def write_video(split: str, video_id: str, spec, mix: dict, index: int
                ) -> dict:
    from PIL import Image
    h, w = int(mix["height"]), int(mix["width"])
    n_frames, n_expr = int(spec[0]), int(spec[1])
    rng = _rng(int(mix["content_seed"]), 4, index)
    base = (rng.random((h, w, 3)) * 60 + 30).astype(np.uint8)
    objs = _object_tracks(rng, n_frames, h, w, int(mix["objects"]))
    frames_dir = os.path.join(split, "JPEGImages", video_id)
    os.makedirs(frames_dir, exist_ok=True)
    for t in range(n_frames):
        frame, _ = _frame_and_masks(base, objs, t, set())
        Image.fromarray(frame).save(
            os.path.join(frames_dir, f"{t:05d}.jpg"), quality=90)
    return {"video_id": video_id, "n_frames": n_frames,
            "frames_dir": frames_dir,
            "expressions": expressions(rng, n_expr, mix["words"])}


def generate(root: str, mix: dict, seed: int, threads: int = 4) -> dict:
    """{"warmup": video, "videos": [video, ...] in the cycle's order from
    the seed's starting point, "data_dir": the split's directory}."""
    split = os.path.join(root, "datasets", "mevis", "valid")
    jobs = [("warmup", mix["warmup"], 0)]
    jobs += [(f"v{i:03d}", spec, i + 1)
             for i, spec in enumerate(mix["videos"])]
    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(
            lambda j: write_video(split, j[0], j[1], mix, j[2]), jobs))
    cycle = [int(i) for i in mix["cycle"]]
    start = int(_rng(seed, 1).integers(len(cycle)))
    videos = [out[1 + i] for i in cycle[start:] + cycle[:start]]
    meta = {"videos": {v["video_id"]: {
        "frames": [f"{t:05d}" for t in range(v["n_frames"])],
        "expressions": v["expressions"]} for v in out}}
    with open(os.path.join(split, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    return {"warmup": out[0], "videos": videos, "data_dir": split}
