"""Video-predictor protocol + deterministic fake for orchestration tests.

The protocol is defined by how the reference's generation loops drive SAM2
(generate_tokens_grid.py:142-237): ``init_state`` / ``reset_state`` /
``add_new_mask`` / ``propagate_in_video(reverse=...)`` plus per-frame object
tokens. ``SAM2VideoPredictor`` (sola_torch.trackgen.sam2.video) implements it
for real; ``FakeVideoPredictor`` here implements it with synthetic dynamics
(translate the prompt mask by a fixed velocity) so the batching / dedup /
census machinery is testable without checkpoints or accelerators
(SURVEY.md §4.2).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol

import numpy as np


class VideoPredictorProtocol(Protocol):
    def init_state(self, frames, video_path=None): ...
    def reset_state(self, state) -> None: ...
    def add_new_mask(self, state, frame_idx, obj_id, mask): ...
    def propagate_in_video(self, state, reverse=False) -> Iterator: ...
    def get_output_tokens(self, state) -> dict: ...


@dataclasses.dataclass
class FakeState:
    num_frames: int
    hw: tuple
    prompts: dict = dataclasses.field(default_factory=dict)
    obj_ids: list = dataclasses.field(default_factory=list)
    tokens: dict = dataclasses.field(default_factory=dict)


class FakeVideoPredictor:
    """Propagates each prompt mask by translating it ``velocity`` px/frame;
    object tokens encode (frame, centroid) deterministically."""

    def __init__(self, velocity=(2, 0), token_dim: int = 256):
        self.velocity = velocity
        self.token_dim = token_dim

    def init_state(self, frames=None, video_path=None, num_frames=None,
                   hw=None):
        if frames is not None:
            num_frames = len(frames)
            hw = frames[0].shape[:2]
        return FakeState(num_frames=num_frames, hw=hw)

    def reset_state(self, state: FakeState) -> None:
        state.prompts = {}
        state.obj_ids = []
        state.tokens = {}

    def add_new_mask(self, state: FakeState, frame_idx: int, obj_id: int,
                     mask: np.ndarray):
        mask = (np.asarray(mask) > 0.5).astype(np.float32)
        state.prompts.setdefault(int(frame_idx), {})[int(obj_id)] = mask
        if obj_id not in state.obj_ids:
            state.obj_ids.append(obj_id)
        return frame_idx, list(state.obj_ids), (mask[None] * 20.0 - 10.0)

    def _mask_at(self, state: FakeState, obj_id: int,
                 frame_idx: int) -> np.ndarray:
        cond_idx = min(state.prompts.keys())
        base = state.prompts[cond_idx].get(obj_id)
        if base is None:
            return np.zeros(state.hw, np.float32)
        dt = frame_idx - cond_idx
        dy, dx = self.velocity[1] * dt, self.velocity[0] * dt
        return np.roll(np.roll(base, dy, axis=0), dx, axis=1)

    def propagate_in_video(self, state: FakeState, reverse: bool = False):
        cond_idx = min(state.prompts.keys())
        rng = (range(cond_idx, -1, -1) if reverse
               else range(cond_idx, state.num_frames))
        for frame_idx in rng:
            logits = np.stack([
                self._mask_at(state, obj_id, frame_idx) * 20.0 - 10.0
                for obj_id in state.obj_ids], axis=0)[:, None]
            toks = np.stack([
                self._token(state, obj_id, frame_idx)
                for obj_id in state.obj_ids], axis=0)
            state.tokens[frame_idx] = toks
            yield frame_idx, list(state.obj_ids), logits

    def _token(self, state: FakeState, obj_id: int,
               frame_idx: int) -> np.ndarray:
        mask = self._mask_at(state, obj_id, frame_idx)
        ys, xs = np.nonzero(mask)
        cy = ys.mean() / state.hw[0] if len(ys) else 0.0
        cx = xs.mean() / state.hw[1] if len(xs) else 0.0
        phase = np.linspace(0, 2 * np.pi, self.token_dim)
        return (np.sin(phase * (1 + cy)) + np.cos(phase * (1 + cx))
                + 0.01 * obj_id).astype(np.float32)

    def get_output_tokens(self, state: FakeState) -> dict:
        return dict(state.tokens)
