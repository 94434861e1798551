"""Track-generation engine: greedy batching, bidirectional propagation,
IoU dedup, track census.

The shared state machine behind both grid and gdino token generation
(generate_tokens_grid.py:148-282 / generate_tokens_gdino.py:169-304):

* prompt statuses: 0 untracked, 1 tracked, 2 filtered (deduped), 3 not used;
* greedy same-frame batches of up to ``batch_size`` prompts (2 for videos
  longer than 200 frames), capped by ``n_max_tracks``;
* per batch: reset state -> add masks -> propagate forward + reverse in
  the predictor's masks mode (logits thresholded at 0 on the device) ->
  harvest per-frame object tokens and the device-resident small masklets;
* dedup: any untracked prompt whose mask IoU against a new masklet's frame
  (at the <=960x540 canonical size, nearest-resampled prompt) exceeds
  ``miou_thresh`` is filtered;
* returns a census compatible with the reference's runtime_info entries.

``generate_tracks`` drives one video on a ``SAM2VideoPredictor`` (grid's
per-video route); ``packed_engine`` drives the same state machine over
``PackedPropagator`` rounds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

import torch

from sola_torch.core import mask_ops
from sola_torch.utils import profiling


@dataclasses.dataclass
class PromptMask:
    prompt_id: int
    frame_idx: int
    segmentation: np.ndarray           # (H, W) uint8 full-res prompt mask
    status: int = 0                     # 0/1/2/3 as above
    filtered_by: Optional[int] = None
    filtered_iou: Optional[float] = None


@dataclasses.dataclass
class TrackResult:
    prompt_id: int
    masklet: np.ndarray                 # (T, H, W) uint8 full resolution
    masklet_small: np.ndarray           # (T, h, w) float at <=960x540 rule
    tokens: np.ndarray                  # (T, token_dim)


def _resize_nearest(mask: np.ndarray, hw: tuple) -> np.ndarray:
    # host-side; bit-identical to jax.image.resize(..., 'nearest') without
    # the per-mask device upload+fetch round trip
    return mask_ops.resize_nearest_np(
        np.asarray(mask, np.float32), tuple(hw))


def _batched_dedup_ious(masklet_small, prompts: list,
                        hw: tuple) -> np.ndarray:
    """IoU of each prompt's mask against the new masklet at the prompt's
    frame, for all remaining prompts in one batched computation on the
    masklet's device."""
    small = []
    for p in prompts:
        if getattr(p, "_small", None) is None or p._small.shape != hw:
            p._small = _resize_nearest(p.segmentation, hw)
        small.append(p._small)
    masklet_small = torch.as_tensor(masklet_small)
    masks = torch.from_numpy(np.stack(small, axis=0)).to(
        masklet_small.device)
    idx = torch.tensor([p.frame_idx for p in prompts],
                       device=masklet_small.device)
    return profiling.fetch(mask_ops.mask_iou(masklet_small[idx], masks))


def select_batch(prompts: Sequence[PromptMask], *, limit: int,
                 n_tracked: int, n_max_tracks: int,
                 scan_all_for_same_frame: bool) -> tuple:
    """Greedy same-frame batch selection (generate_tokens_grid.py:165-186 /
    generate_tokens_gdino.py:178-202). Marks selected prompts status=1 and
    returns (batch, frame_idx); ([], None) when nothing is selectable."""
    batch: list[PromptMask] = []
    frame_idx = None
    for p in prompts:
        if p.status != 0:
            continue
        if frame_idx is None:
            frame_idx = p.frame_idx
        elif p.frame_idx != frame_idx:
            if scan_all_for_same_frame:
                continue
            break
        batch.append(p)
        p.status = 1
        if len(batch) >= limit:
            break
        if n_tracked + len(batch) >= n_max_tracks:
            break
    return batch, frame_idx


@profiling.spanned("trackgen.dedup")
def finalize_batch(batch: Sequence[PromptMask], masklets: dict,
                   tokens_by_frame: dict, n_frames: int,
                   small_masklets: dict) -> list:
    """Assemble TrackResults for a tracked batch: stacked full-res masklet,
    canonical <=960x540 resize, per-frame token matrix.

    ``small_masklets``: {prompt_id: (T, sh, sw) device tensor}, the
    canonical resize kept on the device by the predictor or the packed
    round."""
    assert len(tokens_by_frame) == n_frames, (
        f"tokens missing for frames: have {len(tokens_by_frame)} of "
        f"{n_frames}")
    results = []
    for i, p in enumerate(batch):
        frames = masklets[p.prompt_id]
        assert all(m is not None for m in frames), \
            f"masklet frames missing for prompt {p.prompt_id}"
        masklet = np.stack(frames, axis=0)
        toks = np.stack(
            [np.asarray(tokens_by_frame[f][i])
             for f in range(n_frames)], axis=0)
        results.append(TrackResult(p.prompt_id, masklet,
                                   small_masklets[p.prompt_id], toks))
    return results


def dedup_and_emit(results: Sequence[TrackResult],
                   prompts: Sequence[PromptMask], miou_thresh: float,
                   on_track: Optional[Callable[[TrackResult], None]]) -> int:
    """Filter remaining prompts against each new masklet (one batched IoU
    per track) and emit the track; returns newly-filtered count."""
    n_filtered = 0
    for result in results:
        with profiling.span("trackgen.dedup"):
            small_hw = result.masklet_small.shape[1:]
            remaining = [p for p in prompts if p.status == 0]
            if remaining:
                ious = _batched_dedup_ious(result.masklet_small, remaining,
                                           small_hw)
                for p, iou in zip(remaining, ious):
                    if iou > miou_thresh:
                        p.status = 2
                        p.filtered_by = result.prompt_id
                        p.filtered_iou = float(iou)
                        n_filtered += 1
        if on_track is not None:
            on_track(result)
    return n_filtered


def census_dict(prompts: Sequence[PromptMask], *, elapsed: float,
                n_frames: int, n_tracked: int, n_filtered: int,
                batch_size: int) -> dict:
    by_status = lambda s: [p.prompt_id for p in prompts if p.status == s]
    return {
        "time": elapsed,
        "n_frames": n_frames,
        "n_tracked": n_tracked,
        "n_filtered": n_filtered,
        "n_not_used": len(by_status(3)),
        "n_total": len(prompts),
        "batch_size": batch_size,
        "tracked_prompt_ids": by_status(1),
        "filtered_prompt_ids": by_status(2),
        "not_used_prompt_ids": by_status(3),
        "not_tracked_prompt_ids": by_status(0),
        "fps": n_frames / elapsed if elapsed > 0 else 0.0,
    }


@profiling.spanned("trackgen.track")
def generate_tracks(
    predictor,
    state,
    prompts: Sequence[PromptMask],
    *,
    n_frames: int,
    batch_size: int = 4,
    miou_thresh: float = 0.7,
    n_max_tracks: int = 64,
    large_video_threshold: int = 200,
    large_video_batch: int = 2,
    on_track: Optional[Callable[[TrackResult], None]] = None,
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """Run the full tracking loop; calls ``on_track`` for each new track.

    Grid flavor: each batch scans the whole prompt list for same-frame
    prompts (generate_tokens_grid.py:165-186); the gdino flavor, which
    stops at the first frame mismatch, runs through ``packed_engine``.
    """
    start_time = time.time()
    limit = large_video_batch if n_frames > large_video_threshold \
        else batch_size
    n_tracked = sum(1 for p in prompts if p.status == 1)
    n_filtered = sum(1 for p in prompts if p.status == 2)
    n_iter = 0

    while n_tracked < n_max_tracks:
        # --- greedy same-frame batch ---
        batch, frame_idx = select_batch(
            prompts, limit=limit, n_tracked=n_tracked,
            n_max_tracks=n_max_tracks,
            scan_all_for_same_frame=True)
        if frame_idx is None:
            break
        n_tracked += len(batch)
        n_iter += 1
        log(f"iter {n_iter}: frame {frame_idx}, prompts "
            f"{[p.prompt_id for p in batch]} | tracked {n_tracked} | "
            f"filtered {n_filtered}")

        # --- track the batch ---
        predictor.reset_state(state)
        masklets = {p.prompt_id: [None] * n_frames for p in batch}
        for p in batch:
            predictor.add_new_mask(state, int(frame_idx), p.prompt_id,
                                   p.segmentation)
        # binary masks thresholded on the device: no per-frame dense float
        # logits for this loop to re-threshold
        for reverse in (False, True):
            for out_frame_idx, _, masks in predictor.propagate_in_video(
                    state, reverse=reverse, output_mode="masks"):
                for i, p in enumerate(batch):
                    masklets[p.prompt_id][out_frame_idx] = masks[i]

        tokens_by_frame = predictor.get_output_tokens(state)
        dev = predictor.get_small_masklets(state)  # (T, n, sh, sw) bool
        smalls = {p.prompt_id: dev[:, i] for i, p in enumerate(batch)}
        results = finalize_batch(batch, masklets, tokens_by_frame, n_frames,
                                 small_masklets=smalls)

        # --- dedup remaining prompts against the new masklets (one batched
        # IoU per track over all remaining prompts) ---
        n_filtered += dedup_and_emit(results, prompts, miou_thresh, on_track)

    return census_dict(prompts, elapsed=time.time() - start_time,
                       n_frames=n_frames, n_tracked=n_tracked,
                       n_filtered=n_filtered, batch_size=batch_size)


def mark_not_used(prompts: Sequence[PromptMask], bin_size: int,
                  stability_scores: Optional[Sequence[float]] = None,
                  stability_score_thresh: Optional[float] = None) -> int:
    """Mark prompts on non-multiple-of-bin frames (and, for the gdino flavor,
    low-stability prompts) as status 3 (generate_tokens_grid.py:134-139,
    generate_tokens_gdino.py:162-164). Returns the count."""
    n = 0
    for i, p in enumerate(prompts):
        bad_bin = (p.frame_idx % bin_size) != 0
        bad_stab = (stability_score_thresh is not None
                    and stability_scores is not None
                    and stability_scores[i] < stability_score_thresh)
        if bad_bin or bad_stab:
            p.status = 3
            n += 1
    return n
