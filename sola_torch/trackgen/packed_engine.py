"""Packed track-generation scheduler: N videos share one propagation batch.

Counterpart of ``sola_tpu/trackgen/packed_engine.py``. Drives the same
greedy/dedup state machine as ``engine.generate_tracks`` (reference
semantics: generate_tokens_grid.py:148-282), but each round packs the next
same-frame prompt batch of every in-flight video into one
``PackedPropagator`` round: slots the sequential path would leave empty
carry other videos' objects. Within a video the round order is the
sequential engine's (batch -> track -> dedup -> next batch), so per-video
results match the sequential path; only the sharing of the card changes.

Grid tracking batches hold at most 4 same-frame prompts (2 for videos over
200 frames), and a propagation step costs the same however many of its
slots carry objects, so a pack width of 8 fills slots the sequential path
leaves idle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from sola_torch.core.mask_ops import resize_nearest_np
from sola_torch.trackgen import engine
from sola_torch.trackgen.sam2.packed import (PackedFeatures, PackedPropagator,
                                             SlotPlan)


@dataclasses.dataclass
class VideoJob:
    """One video's tracking work inside a pack."""
    video_id: str
    state: object                        # InferenceState (features encoded)
    prompts: list                        # list[engine.PromptMask]
    n_frames: int
    on_track: Optional[Callable] = None
    batch_size: int = 4
    miou_thresh: float = 0.7
    n_max_tracks: int = 64
    large_video_threshold: int = 200
    large_video_batch: int = 2
    scan_all_for_same_frame: bool = True
    # mutable progress
    n_tracked: int = 0
    n_filtered: int = 0
    start_time: float = 0.0
    census: Optional[dict] = None

    @property
    def limit(self) -> int:
        return (self.large_video_batch
                if self.n_frames > self.large_video_threshold
                else self.batch_size)


def _census(j: VideoJob) -> dict:
    return engine.census_dict(
        j.prompts, elapsed=time.time() - j.start_time, n_frames=j.n_frames,
        n_tracked=j.n_tracked, n_filtered=j.n_filtered,
        batch_size=j.batch_size)


def generate_tracks_packed(predictor, jobs: Sequence[VideoJob],
                           log: Callable[[str], None] = lambda s: None
                           ) -> list:
    """Track every job to completion; returns per-job censuses (the dict
    of ``engine.generate_tracks``). ``predictor`` is the pack-shared
    ``SAM2VideoPredictor``; its ``obj_batch`` is the pack width."""
    prop = PackedPropagator(predictor)
    pack = PackedFeatures.build([j.state for j in jobs])
    b = predictor.obj_batch
    size = predictor.cfg.image_size

    for j in jobs:
        j.start_time = time.time()
        j.n_tracked = sum(1 for p in j.prompts if p.status == 1)
        j.n_filtered = sum(1 for p in j.prompts if p.status == 2)

    n_round = 0
    while True:
        # one pending batch per in-flight job this round
        requests = []
        for vi, j in enumerate(jobs):
            if j.census is not None or j.n_tracked >= j.n_max_tracks:
                continue
            batch, frame_idx = engine.select_batch(
                j.prompts, limit=j.limit, n_tracked=j.n_tracked,
                n_max_tracks=j.n_max_tracks,
                scan_all_for_same_frame=j.scan_all_for_same_frame)
            if frame_idx is None:
                continue
            j.n_tracked += len(batch)
            requests.append((vi, int(frame_idx), batch))
        if not requests:
            break
        n_round += 1

        # slot-pack the requests; a batch never splits across rounds, which
        # keeps the sequential dedup order. Longest video first: a round
        # runs as many steps as its longest slot, so packing similar
        # lengths together leaves fewer idle steps. Each video sends at
        # most one request a round, so its own order is unaffected.
        requests.sort(key=lambda r: -jobs[r[0]].n_frames)
        groups, cur, used = [], [], 0
        for req in requests:
            k = len(req[2])
            assert k <= b, f"batch of {k} exceeds pack width {b}"
            if used + k > b:
                groups.append(cur)
                cur, used = [], 0
            cur.append(req)
            used += k
        if cur:
            groups.append(cur)

        for group in groups:
            video = np.full((b,), -1, np.int64)
            cond = np.zeros((b,), np.int64)
            length = np.ones((b,), np.int64)
            cond_masks = np.zeros((b, size, size), np.float32)
            slot_of = {}                        # prompt_id per video -> slot
            s = 0
            for vi, frame_idx, batch in group:
                for p in batch:
                    video[s] = vi
                    cond[s] = frame_idx
                    length[s] = jobs[vi].n_frames
                    cond_masks[s] = _resize_prompt(p.segmentation, size)
                    slot_of[(vi, p.prompt_id)] = s
                    s += 1
            log(f"round {n_round}: packed {s}/{b} slots from "
                f"{[jobs[vi].video_id for vi, _, _ in group]}")
            out = prop.run_round(
                pack, SlotPlan(video=video, cond=cond, length=length),
                cond_masks)

            # distribute results per job, in request order (the sequential
            # engine's order within each video)
            for vi, frame_idx, batch in group:
                j = jobs[vi]
                slots = [slot_of[(vi, p.prompt_id)] for p in batch]
                masklets = {p.prompt_id: [out["masks"][s][f]
                                          for f in range(j.n_frames)]
                            for p, s in zip(batch, slots)}
                smalls = {p.prompt_id: out["smalls"][s]
                          for p, s in zip(batch, slots)}
                tokens_by_frame = {
                    f: np.stack([out["tokens"][s][f] for s in slots])
                    for f in range(j.n_frames)}
                results = engine.finalize_batch(batch, masklets,
                                                tokens_by_frame, j.n_frames,
                                                small_masklets=smalls)
                j.n_filtered += engine.dedup_and_emit(
                    results, j.prompts, j.miou_thresh, j.on_track)

        for j in jobs:
            if j.census is None and (
                    j.n_tracked >= j.n_max_tracks
                    or not any(p.status == 0 for p in j.prompts)):
                j.census = _census(j)

    for j in jobs:
        if j.census is None:
            j.census = _census(j)
    return [j.census for j in jobs]


def _resize_prompt(mask: np.ndarray, size: int) -> np.ndarray:
    """Full-res prompt -> (size, size) binary, as
    ``SAM2VideoPredictor.add_new_mask`` does it."""
    mask = np.asarray(mask)
    if mask.shape != (size, size):
        mask = resize_nearest_np(np.asarray(mask, np.float32), (size, size))
    return (mask > 0.5).astype(np.float32)
