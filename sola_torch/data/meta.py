"""Dataset metadata parsing (MeViS / Ref-YTVOS / Ref-DAVIS).

On-disk formats are those the reference consumes (dataloader.py:202-238):

* MeViS: ``<root>/mevis/<split>/meta_expressions.json`` with
  ``videos[video_id] = {"frames": [...], "expressions": {expr_id: {"exp",
  "anno_id"}}}`` and ``mask_dict.json`` mapping anno_id -> per-frame RLE list.
* Ref-YTVOS / Ref-DAVIS: ``<root>/<name>/meta_expressions/<split>/
  meta_expressions.json``; expressions carry ``obj_id`` instead of
  ``anno_id``, and GT masks are palette PNGs under
  ``<root>/<name>/<split>/Annotations/<video>``.

Every dataset keeps its frames under ``<root>/<name>/<split>/JPEGImages``.
The track-generation CLIs take every one of these paths from here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

NO_OBJECT_ID = -1

DATA_TYPES = {
    "mevis": ["train", "valid", "valid_u"],
    "ref-ytbvos": ["train", "valid", "test"],
    "ref-davis": ["train", "valid"],
}


@dataclasses.dataclass(frozen=True)
class Sample:
    """One (video, expression) pair."""
    video_id: str
    expression_id: str
    expression: str
    anno_ids: tuple[int, ...]
    frames: tuple[str, ...]

    @property
    def has_gt(self) -> bool:
        return self.anno_ids[0] >= 0

    @property
    def n_frames(self) -> int:
        return len(self.frames)


def meta_path(data_root: str, data_name: str, data_type: str) -> str:
    if data_name == "mevis":
        return os.path.join(data_root, data_name, data_type,
                            "meta_expressions.json")
    elif data_name in ("ref-ytbvos", "ref-davis"):
        return os.path.join(data_root, data_name, "meta_expressions",
                            data_type, "meta_expressions.json")
    raise ValueError(f"Invalid data_name: {data_name}")


def load_meta(data_root: str, data_name: str, data_type: str) -> dict:
    with open(meta_path(data_root, data_name, data_type), "r") as f:
        return json.load(f)


def read_mask_dict(data_root: str, data_name: str, data_type: str) -> dict:
    """A split's ``mask_dict.json``, whatever the split (the token CLIs
    read it on request; FileNotFoundError where the split has none)."""
    path = os.path.join(data_root, data_name, data_type, "mask_dict.json")
    with open(path, "r") as f:
        return json.load(f)


def load_mask_dict(data_root: str, data_name: str,
                   data_type: str) -> Optional[dict]:
    """MeViS GT RLE dict; present for train/valid_u only (dataloader.py:208-210)."""
    if data_name == "mevis" and data_type in ("train", "valid_u"):
        return read_mask_dict(data_root, data_name, data_type)
    return None


def frames_dir(data_root: str, data_name: str, data_type: str,
               video_id: str) -> str:
    """A video's frame images, ``<root>/<name>/<split>/JPEGImages/<video>``
    for every dataset; an empty ``video_id`` gives the split's frame root."""
    return os.path.join(data_root, data_name, data_type, "JPEGImages",
                        video_id)


def annotations_dir(data_root: str, data_name: str, data_type: str,
                    video_id: str) -> str:
    """A Ref-YTVOS / Ref-DAVIS video's palette-PNG GT masks."""
    return os.path.join(data_root, data_name, data_type, "Annotations",
                        video_id)


def build_samples(meta: dict, data_name: str) -> list[Sample]:
    """Flatten meta into (video, expression) samples (dataloader.py:211-236)."""
    samples = []
    for video_id, video_meta in meta["videos"].items():
        for expr_id, expr_meta in video_meta["expressions"].items():
            if data_name == "mevis":
                anno_ids = tuple(expr_meta.get("anno_id", [NO_OBJECT_ID]))
            elif data_name in ("ref-ytbvos", "ref-davis"):
                anno_ids = (int(expr_meta.get("obj_id", NO_OBJECT_ID)),)
            else:
                raise ValueError(f"Invalid data_name: {data_name}")
            samples.append(Sample(
                video_id=video_id,
                expression_id=expr_id,
                expression=expr_meta["exp"],
                anno_ids=anno_ids,
                frames=tuple(video_meta["frames"]),
            ))
    return samples


def video_frames(meta: dict, video_id: str) -> list[str]:
    return meta["videos"][video_id]["frames"]
