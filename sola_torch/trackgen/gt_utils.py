"""GT masklet loading + prompt-seed selection for track generation.

Covers the reference's seg_utils GT paths (seg_utils.py:8-61 MeViS mask_dict,
:29-49 YTVOS palette PNGs) and defines ``get_prompt_masks`` — called but
never defined in the reference (generate_tokens_GT_mevis.py:98, SURVEY.md
§2.5): given a GT masklet, choose the frames to seed SAM2 with. The rule
here: the first frame of every contiguous appearance segment, so objects
that vanish and re-appear get re-seeded at each onset.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sola_torch.core import mask_ops, rle
from sola_torch.utils import profiling


def get_masklet(anno_id, mask_dict: dict) -> np.ndarray:
    """Decode one anno's RLE masklet ((T, H, W) float), absent frames zero."""
    return rle.decode_masklet(mask_dict[str(anno_id)]).astype(np.float32)


@profiling.spanned("trackgen.gt_masks")
def get_masklets(video_id: str, meta: dict, mask_dict: dict) -> dict:
    """All GT masklets referenced by a MeViS video's expressions."""
    out = {}
    for expr_meta in meta["videos"][video_id]["expressions"].values():
        for anno_id in expr_meta["anno_id"]:
            if anno_id not in out:
                out[anno_id] = get_masklet(anno_id, mask_dict)
    return out


@profiling.spanned("trackgen.gt_masks")
def get_masklets_ytbvos(masklet_dir: str, reshape: bool = False) -> dict:
    """Palette-PNG annotations -> {obj_id_str: (T, H, W) float}; empty
    objects dropped (seg_utils.py:29-49)."""
    from PIL import Image
    paths = sorted(os.listdir(masklet_dir))
    frames = [np.array(Image.open(os.path.join(masklet_dir, p)).convert("P"))
              for p in paths]
    stacked = np.stack(frames, axis=0)
    out = {}
    for obj_id in np.unique(stacked):
        # the reference sweeps ids 1..255 INCLUSIVE (seg_utils.py:38
        # range(1, 256)) — id 255 is a real object there, not a void label
        if obj_id == 0:
            continue
        masklet = (stacked == obj_id).astype(np.float32)
        if masklet.sum() == 0:
            continue
        if reshape:
            masklet = np.asarray(mask_ops.reshape_masklet_auto(masklet))
        out[str(int(obj_id))] = masklet
    return out


def get_prompt_masks(masklet: np.ndarray,
                     max_seeds: Optional[int] = None) -> list[dict]:
    """Appearance-onset prompt seeds for a (T, H, W) GT masklet.

    Returns [{"frame_idx": int, "mask": (H, W)}] — one seed at the first
    frame of each contiguous non-empty run (capped at ``max_seeds``).
    """
    present = masklet.reshape(masklet.shape[0], -1).sum(axis=1) > 0
    seeds = []
    prev = False
    for t, p in enumerate(present):
        if p and not prev:
            seeds.append({"frame_idx": t, "mask": masklet[t]})
        prev = bool(p)
    if max_seeds is not None:
        seeds = seeds[:max_seeds]
    return seeds


def get_area_threshs_from_sample(prompt_mask_infos: dict, n_area_bins: int,
                                 n_prompts: int) -> list[float]:
    """Quantile area-ratio thresholds from sampled prompts
    (seg_utils.py:163-173; unused by the reference pipeline but part of its
    API surface): sort all area ratios descending, take every
    (n_prompts // n_area_bins)-th as a bin edge, append 0.0."""
    step = max(n_prompts // n_area_bins, 1)
    ratios = [info["area_ratio"]
              for frame_infos in prompt_mask_infos.values()
              for info in frame_infos]
    ratios = sorted(ratios, reverse=True)
    threshs = ratios[step - 1::step]
    threshs.append(0.0)
    return threshs


def metrics_vs_gt(masklet_small: np.ndarray, gt_masklets: dict) -> dict:
    """Per-GT precision/recall/IoU dicts in the masklet-JSON schema
    (generate_tokens_grid.py:252-264). ``masklet_small`` may be a device
    tensor or a host array."""
    out = {"precision": {}, "recall": {}, "iou": {}}
    for gt_id, gt in gt_masklets.items():
        p, r, i = mask_ops.mask_metrics(masklet_small, gt)
        out["precision"][str(gt_id)] = float(p)
        out["recall"][str(gt_id)] = float(r)
        out["iou"][str(gt_id)] = float(i)
    return out
