"""A MeViS-layout training corpus, the general generator of the selection
training mixes (``traffic/*.json`` with ``"generator": "mevis_corpus"``).

Writes ``<root>/datasets/mevis/train/{meta_expressions,mask_dict}.json`` and
the reference track format under ``<root>/sam2_tracks/{gt_tracks,
grid_tracks}/mevis/train/{sam2_masklets,sam2_object_tokens}/<video>/``: per
track a masklet JSON (an RLE list, the prompt type, and its IoU, precision
and recall against each GT object) and a (frames, 256) float32 token array.

Sizes come from the mix: each video's (tracks, frames) pair is drawn from
the grid ``tracks`` x ``frames``, every seed getting the same multiset of
pairs (the grid repeated to ``n_videos``) in its own order; 1 to
``gt_objects`` GT objects each have one GT track (IoU 1 with itself); the
other tracks are grid tracks with IoUs drawn from ``iou_beta``; a video has
``expressions`` expressions, each naming one or two GT objects with
``words`` random words.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.gen import rle

WORDS = ("the left right big small red blue green dog cat man woman car "
         "bike person moving running standing turning walking first last "
         "behind front towards away slowly quickly white black bird horse "
         "ball jumping sitting near far top bottom middle two three who "
         "which that is are on in of to from").split()


def _rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


def video_sizes(mix: dict, seed: int) -> list:
    grid = [(int(n), int(t)) for n in mix["tracks"] for t in mix["frames"]]
    n = int(mix["n_videos"])
    reps = (grid * (n // len(grid) + 1))[:n]
    order = _rng(seed, 1).permutation(len(reps))
    return [reps[i] for i in order]


def _write_track(base: str, video_id: str, anno_id: int, n_frames: int,
                 metrics: dict, tokens: np.ndarray, empty_rle: dict) -> None:
    mdir = os.path.join(base, "sam2_masklets", video_id)
    tdir = os.path.join(base, "sam2_object_tokens", video_id)
    os.makedirs(mdir, exist_ok=True)
    os.makedirs(tdir, exist_ok=True)
    info = {"anno_id": anno_id, "rle": [empty_rle] * n_frames,
            "prompt_type": "SAM2 AMG MASK", **metrics}
    with open(os.path.join(mdir, f"{anno_id:05d}.json"), "w") as f:
        json.dump(info, f)
    np.save(os.path.join(tdir, f"{anno_id:05d}.npy"), tokens)


def _video(root: str, mix: dict, seed: int, index: int, sizes: tuple,
           first_anno: int) -> dict:
    n_tracks, n_frames = sizes
    rng = _rng(seed, 2, index)
    video_id = f"vid{index:05d}"
    n_gt = int(rng.integers(1, int(mix["gt_objects"]) + 1))
    gt_ids = list(range(first_anno, first_anno + n_gt))
    a, b = mix["iou_beta"]
    empty = rle.encode(np.zeros(mix["mask_hw"], np.uint8))
    tracks = []
    for root_type, count in (("gt_tracks", n_gt),
                             ("grid_tracks", n_tracks - n_gt)):
        base = os.path.join(root, "sam2_tracks", root_type, "mevis", "train")
        for k in range(count):
            if root_type == "gt_tracks":
                iou = {str(g): (1.0 if i == k else 0.0)
                       for i, g in enumerate(gt_ids)}
            else:
                iou = {str(g): float(rng.beta(a, b)) for g in gt_ids}
            metrics = {"iou": iou, "precision": dict(iou), "recall": dict(iou)}
            tokens = rng.standard_normal((n_frames, 256), np.float32)
            _write_track(base, video_id, k, n_frames, metrics, tokens, empty)
            tracks.append({"root_type": root_type, "anno_id": k,
                           "iou": iou, "token_path": os.path.join(
                               base, "sam2_object_tokens", video_id,
                               f"{k:05d}.npy")})
    lo, hi = mix["expressions"]
    expressions = {}
    for e in range(int(rng.integers(lo, hi + 1))):
        n_ref = 1 if n_gt == 1 else int(rng.integers(1, 3))
        refs = sorted(int(x) for x in rng.choice(gt_ids, n_ref,
                                                 replace=False))
        wl, wh = mix["words"]
        words = rng.choice(WORDS, int(rng.integers(wl, wh + 1)))
        expressions[str(e)] = {"exp": f"{video_id} " + " ".join(words),
                               "anno_id": refs}
    return {"video_id": video_id, "n_frames": n_frames, "tracks": tracks,
            "expressions": expressions}


def generate(root: str, mix: dict, seed: int, threads: int = 4) -> dict:
    """Write the corpus; returns {"dataset": the config's dataset section,
    "videos": {video id: its tracks, frames and expressions}}."""
    sizes = video_sizes(mix, seed)
    first = np.cumsum([0] + [int(mix["gt_objects"])] * len(sizes))
    with ThreadPoolExecutor(threads) as pool:
        vids = list(pool.map(lambda i: _video(root, mix, seed, i, sizes[i],
                                              int(first[i])),
                             range(len(sizes))))
    split = os.path.join(root, "datasets", "mevis", "train")
    os.makedirs(split, exist_ok=True)
    meta = {"videos": {v["video_id"]: {
        "frames": [f"{i:05d}" for i in range(v["n_frames"])],
        "expressions": v["expressions"]} for v in vids}}
    with open(os.path.join(split, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(split, "mask_dict.json"), "w") as f:
        json.dump({}, f)
    dataset = {"data_root": os.path.join(root, "datasets"),
               "track_root": os.path.join(root, "sam2_tracks"),
               "num_workers": int(mix["num_workers"]),
               "train": {"data_name": "mevis", "data_type": "train",
                         "sam2_output_dirs": "gt_tracks,grid_tracks",
                         "batch_size": 1}}
    return {"dataset": dataset, "videos": {v["video_id"]: v for v in vids}}
