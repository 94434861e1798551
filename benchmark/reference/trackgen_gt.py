"""Plain reference of GT-prompted track generation for one video.

Each GT object of the video (in its expressions' order) is seeded at every
appearance onset (the first frame of each run of frames where its mask is
non-empty); each seed is tracked alone, from a fresh state, forward and
backward, by the frozen SAM2 copy (plain attention) at the program's object
batch, and its masklet is its logits above 0. Tracks are numbered by one
running counter over objects and seeds. The GT masks come from the raw
``mask_dict.json``, decoded here; the frames from the video's JPEGs; the
weights from the benchmark's builder, drawn anew from the seed.
``lower=True`` is the control, as in ``reference/trackgen.py``; with
``feature_frame`` the encoder's output of that frame comes back too.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from benchmark.gen import rle
from benchmark.reference import attention
from benchmark.reference.trackgen import (_frames, _lower_bf16_layers,
                                          _predictor, frame_feature)


def gt_masklets(data_dir: str, video_id: str) -> dict:
    with open(os.path.join(data_dir, "meta_expressions.json")) as f:
        meta = json.load(f)
    with open(os.path.join(data_dir, "mask_dict.json")) as f:
        mask_dict = json.load(f)
    out = {}
    for expr in meta["videos"][video_id]["expressions"].values():
        for anno in expr["anno_id"]:
            if anno in out:
                continue
            frames = mask_dict[str(anno)]
            shape = next(r["size"] for r in frames if r is not None)
            out[anno] = np.stack([
                rle.decode(r) if r is not None
                else np.zeros(shape, np.uint8) for r in frames]
            ).astype(np.float32)
    return out


def onsets(masklet: np.ndarray) -> list:
    present = masklet.reshape(masklet.shape[0], -1).sum(axis=1) > 0
    seeds, prev = [], False
    for t, p in enumerate(present):
        if p and not prev:
            seeds.append({"frame_idx": t, "mask": masklet[t]})
        prev = bool(p)
    return seeds


def _track(pred, state, seed: dict, n_frames: int):
    pred.reset_state(state)
    masklet = [None] * n_frames
    _, _, logits = pred.add_new_mask(state, seed["frame_idx"], 0,
                                     seed["mask"])
    masklet[seed["frame_idx"]] = (np.asarray(logits[0]) > 0).astype(np.uint8)
    for reverse in (False, True):
        for f, _, logits in pred.propagate_in_video(state, reverse=reverse):
            masklet[f] = (np.asarray(logits[0, 0]) > 0).astype(np.uint8)
    toks = pred.get_output_tokens(state)
    return (np.stack(masklet, axis=0),
            np.stack([np.asarray(toks[f][0], np.float32)
                      for f in range(n_frames)], axis=0))


@torch.no_grad()
def run_video(state_dict: dict, size: str, frames_dir: str, data_dir: str,
              video_id: str, obj_batch: int, lower: bool = False,
              feature_frame: Optional[int] = None) -> dict:
    """``tracks``, {out id: (masklet, tokens)} of every seed of the video,
    and ``feature`` (``reference/trackgen.py``'s ``frame_feature``) of
    ``feature_frame``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, attention.LOWER["fp8_attention"])
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    attention.LOWER["fp8_attention"] = lower
    try:
        pred = _predictor(state_dict, size, obj_batch)
        if lower:
            _lower_bf16_layers(pred.model)
        frames = _frames(frames_dir)
        feature = (None if feature_frame is None
                   else frame_feature(pred, frames[feature_frame]))
        state = pred.init_state(frames)
        tracks, out_id = {}, 0
        for masklet in gt_masklets(data_dir, video_id).values():
            for seed in onsets(masklet):
                tracks[out_id] = _track(pred, state, seed, len(frames))
                out_id += 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         attention.LOWER["fp8_attention"]) = saved
    return {"tracks": tracks, "feature": feature}
