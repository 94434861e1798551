"""Dataset + padded batching: the host-side input pipeline.

``AlignDataset`` mirrors the reference dataset's responsibilities
(dataloader.py:87-372): sample enumeration from meta_expressions, track/token
loading with GT-label selection, and the eval-time masklet services
(GT caching, OR-merging of selected SAM2 masklets).

A copy of ``sola_tpu/data/dataset.py`` (plus ``Loader.set_epoch``), with
its differences from the reference:
* samples are padded to static (n_tracks, n_frames) bucket shapes with
  explicit masks, so MANY (video, expression) pairs batch into one step
  (the reference is pinned to batch_size=1 by ragged shapes);
* a thread-pool prefetcher overlaps JSON/RLE/npy host work with device steps
  (replaces torch DataLoader workers, dataloader.py:38-46);
* RLE decode goes through the native C++ codec (sola_torch.core.rle).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from sola_torch.core import rle
from sola_torch.data import meta as meta_lib
from sola_torch.data import tracks as tracks_lib


def _round_up(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


DEFAULT_TRACK_BUCKETS = (8, 16, 32, 64, 96, 128)
DEFAULT_FRAME_BUCKETS = (16, 32, 64, 128, 256, 512)


class AlignDataset:
    """Track-selection dataset over precomputed sam2_tracks artifacts."""

    NO_OBJECT_ID = meta_lib.NO_OBJECT_ID

    def __init__(self, configs: dict):
        self.data_name = configs["data_name"]
        self.data_type = configs["data_type"]
        self.data_root = configs["data_root"]
        self.track_root = configs["track_root"]
        self.sam2_output_dirs = [
            d for d in configs["sam2_output_dirs"].split(",") if d]
        self.meta = meta_lib.load_meta(self.data_root, self.data_name,
                                       self.data_type)
        self.mask_dict = meta_lib.load_mask_dict(self.data_root,
                                                 self.data_name,
                                                 self.data_type)
        self.samples = meta_lib.build_samples(self.meta, self.data_name)
        self._video_id: Optional[str] = None
        self._gt_cache: dict = {}
        # host sample LRU: samples are immutable on disk, and the reference
        # re-reads every token .npy each epoch (dataloader.py:162 — the
        # train-input hot loop). Steady-state epochs here serve from RAM.
        # Bytes-bounded; 0 disables.
        from collections import OrderedDict
        self._sample_cache: "OrderedDict[int, dict]" = OrderedDict()
        self._sample_cache_bytes = 0
        self.sample_cache_max_bytes = int(
            configs.get("host_cache_bytes", 4 << 30))
        import threading
        self._cache_lock = threading.Lock()  # get_sample runs on a pool

    def __len__(self) -> int:
        return len(self.samples)

    def get_sample(self, idx: int) -> dict:
        with self._cache_lock:
            cached = self._sample_cache.get(idx)
            if cached is not None:
                self._sample_cache.move_to_end(idx)
                return cached
        sample = self.samples[idx]
        out = tracks_lib.load_sample_tracks(
            sample, self.track_root, self.sam2_output_dirs, self.data_name,
            self.data_type)
        nbytes = out["object_tokens"].nbytes if (
            out["object_tokens"] is not None) else 0
        if self.sample_cache_max_bytes > 0:
            with self._cache_lock:
                self._sample_cache[idx] = out
                self._sample_cache_bytes += nbytes
                while (self._sample_cache_bytes
                       > self.sample_cache_max_bytes
                       and len(self._sample_cache) > 1):
                    _, old = self._sample_cache.popitem(last=False)
                    if old["object_tokens"] is not None:
                        self._sample_cache_bytes -= \
                            old["object_tokens"].nbytes
        if sample.has_gt:
            allowed = {
                ("mevis", "train"), ("mevis", "valid_u"),
                ("ref-ytbvos", "train"), ("ref-davis", "train"),
                ("ref-davis", "valid"),
            }
            assert (self.data_name, self.data_type) in allowed, (
                f"Invalid data_name/type: {self.data_name}/{self.data_type}")
        else:
            allowed = {("mevis", "valid"), ("ref-ytbvos", "valid")}
            assert (self.data_name, self.data_type) in allowed, (
                f"Invalid data_name/type: {self.data_name}/{self.data_type}")
        return out

    def get_frames(self, video_id: str) -> list[str]:
        return meta_lib.video_frames(self.meta, video_id)

    # ------------------------------------------------------------------
    # Eval-time masklet services (dataloader.py:241-369)
    # ------------------------------------------------------------------

    def set_video(self, video_id: str) -> None:
        """Cache decoded GT masklets for a video (dataloader.py:241-276)."""
        if self._video_id == video_id:
            return
        self._video_id = video_id
        self._gt_cache = {}
        if self.data_name == "mevis":
            assert self.mask_dict is not None, "no mask_dict for this split"
            for expr_meta in self.meta["videos"][video_id][
                    "expressions"].values():
                for gt_anno_id in expr_meta["anno_id"]:
                    key = str(gt_anno_id)
                    if key not in self._gt_cache:
                        self._gt_cache[key] = rle.decode_masklet(
                            self.mask_dict[key])
        elif self.data_name == "ref-davis":
            from PIL import Image
            anno_dir = os.path.join(self.data_root, "ref-davis",
                                    self.data_type, "Annotations", video_id)
            frames = sorted(os.listdir(anno_dir))
            first = np.array(Image.open(
                os.path.join(anno_dir, frames[0])).convert("P"))
            object_ids = np.unique(first)
            object_ids = object_ids[(object_ids != 0) & (object_ids != 255)]
            stacked = np.stack([
                np.array(Image.open(os.path.join(anno_dir, f)).convert("P"))
                for f in frames], axis=0)
            # NOTE: the reference reuses one buffer for every object id here,
            # so all its cached ref-davis masklets alias the last object
            # (dataloader.py:265-274) — a bug we do not replicate.
            for object_id in object_ids:
                self._gt_cache[int(object_id)] = (
                    stacked == object_id).astype(np.uint8)
        else:
            raise ValueError(f"Invalid data_name: {self.data_name}")

    def get_gt_masklet(self, video_id: str,
                       expression_id: str) -> Optional[np.ndarray]:
        """OR-merge GT annos of one expression (dataloader.py:278-303)."""
        assert self._video_id == video_id, (
            f"set_video({video_id}) must run first (current: {self._video_id})")
        expr_meta = self.meta["videos"][video_id]["expressions"][expression_id]
        if self.data_name == "ref-davis":
            gt_anno_ids = expr_meta["obj_id"]
        else:
            gt_anno_ids = expr_meta["anno_id"]
        merged = None
        for gt_anno_id in gt_anno_ids:
            if str(gt_anno_id) in self._gt_cache:
                masklet = self._gt_cache[str(gt_anno_id)]
            elif int(gt_anno_id) in self._gt_cache:
                masklet = self._gt_cache[int(gt_anno_id)]
            else:
                masklet = rle.decode_masklet(self.mask_dict[str(gt_anno_id)])
            merged = masklet if merged is None else np.logical_or(
                merged, masklet)
        return merged

    def get_sam2_masklet(self, video_id: str, expression_id: str,
                         preds: np.ndarray, root_types: list,
                         prompt_types: list,
                         sam2_anno_ids: list) -> Optional[np.ndarray]:
        """OR-merge masklets of positively-predicted tracks; zeros when none
        selected (dataloader.py:305-351). Only selected tracks' JSONs are
        read and decoded (the reference re-reads every track)."""
        merged = None
        idx = 0
        fallback_shape = None
        for output_dir in self.sam2_output_dirs:
            records = tracks_lib.load_track_records(
                self.track_root, output_dir, self.data_name, self.data_type,
                video_id,
                expression_id if tracks_lib.is_per_expression(output_dir)
                else None)
            for rec in records:
                assert rec.root_type == root_types[idx], (
                    f"root_type mismatch: {rec.root_type} != {root_types[idx]}")
                assert rec.prompt_type == prompt_types[idx]
                assert rec.sam2_anno_id == sam2_anno_ids[idx]
                if preds[idx] > 0:
                    with open(rec.masklet_path, "r") as f:
                        info = json.load(f)
                    masklet = rle.decode_masklet(info["rle"])
                    merged = masklet if merged is None else np.logical_or(
                        merged, masklet).astype(np.uint8)
                elif fallback_shape is None:
                    with open(rec.masklet_path, "r") as f:
                        info = json.load(f)
                    h, w = info["rle"][0]["size"]
                    fallback_shape = (len(info["rle"]), h, w)
                idx += 1
        if merged is None and fallback_shape is not None:
            merged = np.zeros(fallback_shape, dtype=np.uint8)
        return merged


# ---------------------------------------------------------------------------
# Padded batching
# ---------------------------------------------------------------------------

def pad_and_collate(samples: list[dict],
                    track_buckets: Sequence[int] = DEFAULT_TRACK_BUCKETS,
                    frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                    object_token_dim: int = 256,
                    materialize_tokens: bool = True,
                    row_cache: Optional[dict] = None) -> dict:
    """Collate ragged samples into one padded batch with masks.

    All samples in the batch share the padded (n_max, t_max) bucket; the
    batcher groups by bucket so recompiles are bounded by
    |track_buckets| x |frame_buckets| shapes.

    ``materialize_tokens=False`` skips building the stacked
    ``object_tokens`` array and sets it to None — the batch then carries
    ``object_token_rows`` (per-sample padded arrays) only. With the
    device-resident token cache (data/device_cache.py) the rows are never
    touched on a cache hit, so steady-state batches cost zero token-bytes
    of host copying. ``row_cache`` (keyed by (video, expression, shape))
    reuses padded rows across epochs.
    """
    b = len(samples)
    n_max = _round_up(max(s["object_tokens"].shape[0] for s in samples),
                      track_buckets)
    t_max = _round_up(max(s["object_tokens"].shape[1] for s in samples),
                      frame_buckets)
    track_mask = np.zeros((b, n_max), bool)
    frame_lengths = np.zeros((b,), np.int32)
    labels = {k: np.zeros((b, n_max), np.float32)
              for k in ("iou", "recall", "precision")}
    has_labels = all(s["labels"] is not None for s in samples)
    rows: list = []
    for i, s in enumerate(samples):
        n, t, _ = s["object_tokens"].shape
        n = min(n, n_max)
        t = min(t, t_max)
        key = (s["video_id"], s["expression_id"], n_max, t_max)
        row = row_cache.get(key) if row_cache is not None else None
        if row is None:
            row = np.zeros((n_max, t_max, object_token_dim), np.float32)
            row[:n, :t] = s["object_tokens"][:n, :t]
            if row_cache is not None:
                row_cache[key] = row
        rows.append(row)
        track_mask[i, :n] = True
        frame_lengths[i] = t
        if has_labels:
            for k in labels:
                labels[k][i, :n] = s["labels"][k][:n]
    object_tokens = np.stack(rows, axis=0) if materialize_tokens else None
    return {
        "object_tokens": object_tokens,
        "object_token_rows": rows,
        "track_mask": track_mask,
        "frame_lengths": frame_lengths,
        "labels": labels if has_labels else None,
        "n_tracks": np.array([min(s["object_tokens"].shape[0], n_max)
                              for s in samples], np.int32),
        "video_id": [s["video_id"] for s in samples],
        "expression_id": [s["expression_id"] for s in samples],
        "expression": [s["expression"] for s in samples],
        "anno_ids": [s["anno_ids"] for s in samples],
        "root_type": [s["root_type"] for s in samples],
        "prompt_type": [s["prompt_type"] for s in samples],
        "sam2_anno_id": [s["sam2_anno_id"] for s in samples],
        "gt_anno_id": [s["gt_anno_id"] for s in samples],
    }


class Loader:
    """Bucketed, prefetching batch iterator over an AlignDataset.

    Groups samples whose padded shapes share a bucket, shuffles bucket-wise
    for training, and prefetches sample loading on a thread pool so host I/O
    overlaps device compute.
    """

    def __init__(self, dataset: AlignDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 42,
                 num_workers: int = 4,
                 track_buckets: Sequence[int] = DEFAULT_TRACK_BUCKETS,
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                 materialize_tokens: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.track_buckets = track_buckets
        self.frame_buckets = frame_buckets
        # False: batches carry per-sample padded token rows only (see
        # pad_and_collate) — set by the train loop when the device token
        # cache makes the stacked host array dead weight
        self.materialize_tokens = materialize_tokens
        self._row_cache: dict = {}
        self._row_cache_bytes = 0
        self.row_cache_max_bytes = int(
            getattr(dataset, "sample_cache_max_bytes", 4 << 30))
        self._epoch = 0

    def _collate(self, bucket: list[dict]) -> dict:
        use_cache = self.row_cache_max_bytes > 0
        n_before = len(self._row_cache)
        out = pad_and_collate(bucket, self.track_buckets,
                              self.frame_buckets,
                              materialize_tokens=self.materialize_tokens,
                              row_cache=self._row_cache
                              if use_cache else None)
        if use_cache and len(self._row_cache) > n_before:
            row_bytes = out["object_token_rows"][0].nbytes
            self._row_cache_bytes += (
                len(self._row_cache) - n_before) * row_bytes
            if self._row_cache_bytes > self.row_cache_max_bytes:
                # simple full reset on overflow: rows re-pad lazily and
                # correctness is unaffected (bound >> working set in the
                # common case; a dataset larger than the bound cycles)
                self._row_cache = {}
                self._row_cache_bytes = 0
        return out

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Make the next iteration use epoch ``epoch``'s shuffle (seed +
        epoch), as an uninterrupted run would: a resumed run calls it."""
        self._epoch = epoch

    def _order(self) -> list[int]:
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idxs)
        return idxs

    def __iter__(self) -> Iterator[dict]:
        idxs = self._order()
        self._epoch += 1
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures = {i: pool.submit(self.dataset.get_sample, i)
                       for i in idxs[:2 * self.num_workers]}
            submitted = 2 * self.num_workers
            pending: dict[tuple[int, int], list[dict]] = {}
            for pos, i in enumerate(idxs):
                if submitted < len(idxs):
                    j = idxs[submitted]
                    futures[j] = pool.submit(self.dataset.get_sample, j)
                    submitted += 1
                sample = futures.pop(i).result()
                n = _round_up(sample["object_tokens"].shape[0],
                              self.track_buckets)
                t = _round_up(sample["object_tokens"].shape[1],
                              self.frame_buckets)
                bucket = pending.setdefault((n, t), [])
                bucket.append(sample)
                if len(bucket) >= self.batch_size:
                    yield self._collate(bucket)
                    pending[(n, t)] = []
            for bucket in pending.values():
                if bucket:
                    yield self._collate(bucket)


def get_loader_dict(configs: dict, only_eval: bool = False,
                    only_inference: bool = False,
                    batch_size_override: Optional[int] = None) -> dict:
    """Reference entry point (dataloader.py:12-36): dict of Loaders."""
    assert not (only_eval and only_inference)
    for split in ("train", "valid", "test"):
        if split in configs:
            configs[split]["data_root"] = configs["data_root"]
            configs[split]["track_root"] = configs["track_root"]
            configs[split]["num_workers"] = configs.get("num_workers", 4)

    def make(split: str) -> Loader:
        c = configs[split]
        return Loader(
            AlignDataset(c),
            batch_size=batch_size_override or c.get("batch_size", 1),
            # "shuffle" override: trajectory-parity tests disable it so the
            # sample order matches the reference's unshuffled iteration
            shuffle=bool(c.get("shuffle", c["data_type"] == "train")),
            num_workers=c.get("num_workers", 4),
        )

    if only_eval:
        return {"valid": make("valid")}
    if only_inference:
        return {"test": make("test")}
    return {"train": make("train"), "valid": make("valid")}
