"""Synthetic MeViS-layout dataset generator for tests and benches.

Creates a tiny dataset on disk in the exact formats the pipeline consumes
(meta_expressions.json + mask_dict.json + sam2_tracks artifacts + optional
JPEGImages), with controlled structure: each video contains moving squares;
each expression refers to one of them; one generated track per GT object
matches it exactly (IoU 1.0) plus distractor tracks, so an oracle selector
achieves J&F = 1.0 — the integration-test fixture of SURVEY.md §4.3.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sola_torch.core import rle
from sola_torch.data import tracks as tracks_lib


def square_masklet(t: int, h: int, w: int, x0: int, y0: int, size: int,
                   dx: int, dy: int, appear: int = 0,
                   vanish: int | None = None) -> np.ndarray:
    """A (t, h, w) masklet of a moving square, absent outside [appear, vanish)."""
    masklet = np.zeros((t, h, w), np.uint8)
    vanish = t if vanish is None else vanish
    for i in range(t):
        if not (appear <= i < vanish):
            continue
        x = np.clip(x0 + dx * i, 0, w - size)
        y = np.clip(y0 + dy * i, 0, h - size)
        masklet[i, y:y + size, x:x + size] = 1
    return masklet


def tokens_for_masklet(masklet: np.ndarray, dim: int = 256,
                       seed: int = 0) -> np.ndarray:
    """Deterministic (T, dim) object tokens derived from per-frame centroids,
    so tracks of the same object have correlated tokens."""
    t = masklet.shape[0]
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((dim,)).astype(np.float32)
    toks = np.zeros((t, dim), np.float32)
    for i in range(t):
        ys, xs = np.nonzero(masklet[i])
        if len(ys) == 0:
            toks[i] = 0.1 * base
        else:
            cy, cx = ys.mean() / masklet.shape[1], xs.mean() / masklet.shape[2]
            phase = np.linspace(0, 2 * np.pi, dim, dtype=np.float32)
            toks[i] = base + np.sin(phase * (1 + cy)) + np.cos(phase * (1 + cx))
    return toks


def generate(root: str, n_videos: int = 2, n_frames: int = 24, h: int = 64,
             w: int = 96, n_objects: int = 2, n_distractors: int = 2,
             data_name: str = "mevis", data_type: str = "valid_u",
             track_output_dir: str = "grid_tracks",
             write_frames: bool = False, seed: int = 0) -> dict:
    """Build the dataset; returns {"data_root", "track_root", "configs"}."""
    rng = np.random.default_rng(seed)
    data_root = os.path.join(root, "datasets")
    track_root = os.path.join(root, "sam2_tracks")
    split_dir = os.path.join(data_root, data_name, data_type)
    os.makedirs(split_dir, exist_ok=True)

    meta: dict = {"videos": {}}
    mask_dict: dict = {}
    anno_counter = 0
    for v in range(n_videos):
        video_id = f"video_{v:03d}"
        frames = [f"{i:05d}" for i in range(n_frames)]
        expressions = {}
        gt_masklets = {}
        for o in range(n_objects):
            anno_id = anno_counter
            anno_counter += 1
            masklet = square_masklet(
                n_frames, h, w,
                x0=int(rng.integers(0, w // 2)),
                y0=int(rng.integers(0, h // 2)),
                size=int(rng.integers(8, 16)),
                dx=int(rng.integers(-2, 3)), dy=int(rng.integers(-2, 3)))
            gt_masklets[anno_id] = masklet
            mask_dict[str(anno_id)] = [
                rle.encode(m) if m.any() else None for m in masklet]
            expressions[f"{o}"] = {
                "exp": f"the object number {o} moving in video {v}",
                "anno_id": [anno_id],
            }
        meta["videos"][video_id] = {"frames": frames,
                                    "expressions": expressions}

        # tracks: one exact match per GT object + distractors
        track_id = 0
        for anno_id, masklet in gt_masklets.items():
            metrics = _metrics_vs_gt(masklet, gt_masklets)
            tracks_lib.save_track(
                track_root, track_output_dir, data_name, data_type, video_id,
                track_id, rle.encode_masklet(masklet), "SAM2 AMG MASK",
                tokens_for_masklet(masklet, seed=anno_id),
                metrics=metrics)
            track_id += 1
        for dtr in range(n_distractors):
            masklet = square_masklet(
                n_frames, h, w,
                x0=int(rng.integers(0, w - 8)), y0=int(rng.integers(0, h - 8)),
                size=int(rng.integers(4, 8)),
                dx=int(rng.integers(-1, 2)), dy=int(rng.integers(-1, 2)))
            metrics = _metrics_vs_gt(masklet, gt_masklets)
            tracks_lib.save_track(
                track_root, track_output_dir, data_name, data_type, video_id,
                track_id, rle.encode_masklet(masklet), "SAM2 AMG MASK",
                tokens_for_masklet(masklet, seed=1000 + v * 100 + dtr),
                metrics=metrics)
            track_id += 1

        if write_frames:
            frames_dir = os.path.join(split_dir, "JPEGImages", video_id)
            os.makedirs(frames_dir, exist_ok=True)
            from PIL import Image
            for i, frame in enumerate(frames):
                img = np.zeros((h, w, 3), np.uint8)
                for anno_id, masklet in gt_masklets.items():
                    color = 50 + (anno_id * 97) % 200
                    img[masklet[i] > 0] = (color, 255 - color, 128)
                Image.fromarray(img).save(
                    os.path.join(frames_dir, f"{frame}.jpg"))

    with open(os.path.join(split_dir, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(split_dir, "mask_dict.json"), "w") as f:
        json.dump(mask_dict, f)

    configs = {
        "data_root": data_root,
        "track_root": track_root,
        "num_workers": 2,
        "valid": {
            "data_name": data_name,
            "data_type": data_type,
            "sam2_output_dirs": track_output_dir,
            "batch_size": 1,
        },
        "train": {
            "data_name": data_name,
            "data_type": data_type,
            "sam2_output_dirs": track_output_dir,
            "batch_size": 1,
        },
        "test": {
            "data_name": data_name,
            "data_type": data_type,
            "sam2_output_dirs": track_output_dir,
            "batch_size": 1,
        },
    }
    return {"data_root": data_root, "track_root": track_root,
            "configs": configs}


def _metrics_vs_gt(masklet: np.ndarray, gt_masklets: dict) -> dict:
    """Per-GT iou/precision/recall in the masklet-JSON format
    (generate_tokens_grid.py:252-264 output schema).

    Pure NumPy on purpose: a device mask-ops version would cost a device
    round trip per (track, gt) pair."""
    out = {"iou": {}, "precision": {}, "recall": {}}
    a = masklet.astype(bool)  # (T, H, W)
    n_pred = a.sum(axis=(1, 2)).astype(np.float64)
    for gt_id, gt in gt_masklets.items():
        b = gt.astype(bool)
        inter = np.logical_and(a, b).sum(axis=(1, 2)).astype(np.float64)
        n_gt = b.sum(axis=(1, 2)).astype(np.float64)
        union = n_pred + n_gt - inter
        # per-frame metrics + mean, exact mask_metrics conventions
        iou = np.where(union == 0, 1.0, inter / np.maximum(union, 1.0))
        prec = np.where(n_pred == 0, 1.0, inter / np.maximum(n_pred, 1.0))
        prec = np.where((n_pred > 0) & (n_gt == 0), 0.0, prec)
        rec = np.where(n_gt == 0, 1.0, inter / np.maximum(n_gt, 1.0))
        rec = np.where((n_gt > 0) & (n_pred == 0), 0.0, rec)
        out["iou"][str(gt_id)] = float(iou.mean())
        out["precision"][str(gt_id)] = float(prec.mean())
        out["recall"][str(gt_id)] = float(rec.mean())
    return out
