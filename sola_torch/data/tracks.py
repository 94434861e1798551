"""The ``sam2_tracks`` on-disk track format: readers, writers, label index.

Layout (unchanged from the reference so artifacts interoperate,
generate_tokens_grid.py:280-282 / generate_tokens_gdino.py:301-304 /
dataloader.py:119-127):

    <track_root>/<output_dir>/<data_name>/<data_type>/
        sam2_masklets/<video_id>[/<expression_id>]/NNNNN.json
        sam2_object_tokens/<video_id>[/<expression_id>]/NNNNN.npy

The ``<expression_id>`` level exists iff "gdino" is in the output dir name.
Masklet JSON: {"anno_id": int, "rle": [per-frame RLE], "prompt_type": str,
optional "iou"/"precision"/"recall": {gt_anno_id: float}}.

Performance: the reference re-parses every multi-MB masklet JSON each epoch
just to read its scalar labels (dataloader.py:134-137 — the I/O hot loop,
SURVEY.md §3.1). Here a tiny ``labels_index.json`` sidecar is written next to
``sam2_masklets`` on first read, so steady-state training touches only the
token ``.npy`` files and a few-KB index per video.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

from sola_torch.data.meta import NO_OBJECT_ID, Sample

INDEX_NAME = "labels_index.json"


def is_per_expression(output_dir: str) -> bool:
    """gdino track roots nest one directory deeper (dataloader.py:122-127)."""
    return "gdino" in output_dir


def track_dirs(track_root: str, output_dir: str, data_name: str,
               data_type: str, video_id: str,
               expression_id: Optional[str] = None) -> tuple[str, str]:
    base = os.path.join(track_root, output_dir, data_name, data_type)
    if is_per_expression(output_dir):
        assert expression_id is not None
        tail = os.path.join(video_id, expression_id)
    else:
        tail = video_id
    return (os.path.join(base, "sam2_masklets", tail),
            os.path.join(base, "sam2_object_tokens", tail))


@dataclasses.dataclass
class TrackRecord:
    """Selection-relevant view of one track (no dense masks)."""
    sam2_anno_id: int
    prompt_type: str
    root_type: str
    masklet_path: str
    token_path: str
    iou: dict
    precision: dict
    recall: dict


def _index_entry(info: dict, masklet_path: str) -> dict:
    return {
        "anno_id": info["anno_id"],
        "prompt_type": info["prompt_type"],
        "file": os.path.basename(masklet_path),
        "iou": info.get("iou", {}),
        "precision": info.get("precision", {}),
        "recall": info.get("recall", {}),
    }


def load_track_records(track_root: str, output_dir: str, data_name: str,
                       data_type: str, video_id: str,
                       expression_id: Optional[str] = None,
                       use_index: bool = True) -> list[TrackRecord]:
    """All tracks of one video (or (video, expression) for gdino roots),
    sorted by filename like the reference (dataloader.py:129-130)."""
    masklet_dir, token_dir = track_dirs(track_root, output_dir, data_name,
                                        data_type, video_id, expression_id)
    root_type = os.path.basename(output_dir.rstrip("/"))
    # the index lives in the TOKEN dir: the reference dataloader listdirs
    # sam2_masklets/ and json-loads every entry (dataloader.py:129-137), so
    # a sidecar there would break reference consumers of our artifacts
    # (caught by tests/test_reference_parity.py); the token dir is only ever
    # read by exact filename
    index_path = os.path.join(token_dir, INDEX_NAME)
    entries = None
    if use_index and os.path.exists(index_path):
        try:
            with open(index_path, "r") as f:
                entries = json.load(f)
        except (json.JSONDecodeError, OSError):
            entries = None
    if entries is None:
        files = sorted(p for p in os.listdir(masklet_dir)
                       if p.endswith(".json") and p != INDEX_NAME)
        entries = []
        for fname in files:
            path = os.path.join(masklet_dir, fname)
            with open(path, "r") as f:
                info = json.load(f)
            entries.append(_index_entry(info, path))
        if use_index:
            tmp = index_path + f".tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(entries, f)
                os.replace(tmp, index_path)
            except OSError:
                pass
    records = []
    for e in entries:
        stem = os.path.splitext(e["file"])[0]
        records.append(TrackRecord(
            sam2_anno_id=e["anno_id"],
            prompt_type=e["prompt_type"],
            root_type=root_type,
            masklet_path=os.path.join(masklet_dir, e["file"]),
            token_path=os.path.join(token_dir, f"{stem}.npy"),
            iou=e["iou"],
            precision=e["precision"],
            recall=e["recall"],
        ))
    return records


def best_gt_labels(record: TrackRecord,
                   anno_ids: Sequence[int]) -> tuple[float, float, float, int]:
    """Best-IoU GT anno's (iou, recall, precision, gt_anno_id) for a track
    (dataloader.py:140-150); zeros/NO_OBJECT_ID when no GT."""
    iou, recall, precision, gt_anno_id = 0.0, 0.0, 0.0, NO_OBJECT_ID
    if anno_ids and anno_ids[0] >= 0:
        for anno_id in anno_ids:
            m_iou = record.iou.get(str(anno_id), 0.0)
            if m_iou > iou:
                iou = m_iou
                recall = record.recall.get(str(anno_id), 0.0)
                precision = record.precision.get(str(anno_id), 0.0)
                gt_anno_id = anno_id
    return iou, recall, precision, gt_anno_id


def load_sample_tracks(sample: Sample, track_root: str,
                       sam2_output_dirs: Sequence[str], data_name: str,
                       data_type: str, load_tokens: bool = True) -> dict:
    """Everything the selection model needs for one (video, expression).

    Mirrors AlignDataset.__getitem__ (dataloader.py:103-200): walks the track
    roots in order, concatenates tracks, picks best-IoU GT labels per track,
    loads the (T, 256) token arrays.
    """
    tokens, ious, recalls, precisions = [], [], [], []
    root_types, prompt_types, sam2_ids, gt_ids = [], [], [], []
    for output_dir in sam2_output_dirs:
        records = load_track_records(
            track_root, output_dir, data_name, data_type, sample.video_id,
            sample.expression_id if is_per_expression(output_dir) else None)
        for rec in records:
            iou, recall, precision, gt_id = best_gt_labels(rec, sample.anno_ids)
            ious.append(iou)
            recalls.append(recall)
            precisions.append(precision)
            gt_ids.append(gt_id)
            sam2_ids.append(rec.sam2_anno_id)
            root_types.append(rec.root_type)
            prompt_types.append(rec.prompt_type)
            if load_tokens:
                tokens.append(np.load(rec.token_path))
    if load_tokens:
        assert tokens, f"no tracks found for {sample.video_id}/{sample.expression_id}"
        object_tokens = np.stack(tokens, axis=0).astype(np.float32)
    else:
        object_tokens = None
    labels = None
    if sample.has_gt:
        labels = {
            "iou": np.asarray(ious, np.float32),
            "recall": np.asarray(recalls, np.float32),
            "precision": np.asarray(precisions, np.float32),
        }
    return {
        "video_id": sample.video_id,
        "expression_id": sample.expression_id,
        "expression": sample.expression,
        "anno_ids": list(sample.anno_ids),
        "frames": list(sample.frames),
        "object_tokens": object_tokens,
        "labels": labels,
        "root_type": root_types,
        "prompt_type": prompt_types,
        "sam2_anno_id": sam2_ids,
        "gt_anno_id": gt_ids,
    }


# ---------------------------------------------------------------------------
# Writer side (used by trackgen and the synthetic dataset generator)
# ---------------------------------------------------------------------------

def save_track(track_root: str, output_dir: str, data_name: str,
               data_type: str, video_id: str, anno_id: int,
               rle_masklet: list, prompt_type: str,
               tokens: np.ndarray,
               expression_id: Optional[str] = None,
               metrics: Optional[dict] = None) -> None:
    """Write one track in the reference layout
    (generate_tokens_grid.py:280-282)."""
    masklet_dir, token_dir = track_dirs(track_root, output_dir, data_name,
                                        data_type, video_id, expression_id)
    os.makedirs(masklet_dir, exist_ok=True)
    os.makedirs(token_dir, exist_ok=True)
    info = {"anno_id": anno_id, "rle": rle_masklet, "prompt_type": prompt_type}
    if metrics:
        info.update(metrics)
    # atomic writes: a killed shard never leaves a truncated artifact
    json_path = os.path.join(masklet_dir, f"{anno_id:05d}.json")
    tmp = json_path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, json_path)
    npy_path = os.path.join(token_dir, f"{anno_id:05d}.npy")
    tmp = npy_path + f".tmp.{os.getpid()}.npy"
    np.save(tmp, np.asarray(tokens, np.float32))
    os.replace(tmp, npy_path)
    # a new track invalidates any existing label index (both the token-dir
    # location and the legacy masklet-dir one, which older runs wrote)
    for index_path in (os.path.join(token_dir, INDEX_NAME),
                       os.path.join(masklet_dir, INDEX_NAME)):
        if os.path.exists(index_path):
            os.remove(index_path)
