"""SAM2 video predictor: the tracking protocol on fixed-shape state.

Counterpart of ``sola_tpu/trackgen/sam2/video.py``; implements the protocol
the reference's generation loops drive (init_state / reset_state /
add_new_mask / propagate_in_video / per-frame ``obj_ptr`` harvesting,
generate_tokens_grid.py:142-237):

* the memory is fixed-shape device tensors: conditioning slots, a
  recent-memory ring keyed by absolute frame index, a 16-slot
  object-pointer bank, and the forward pass's seed buffer that re-seeds the
  ring for the reverse pass. The predictor holds them, allocated once and
  updated in place (``track_step.TrackStep``), and lends them to the state
  whose batch it tracks: a batch's passes run before the next batch's
  conditioning;
* frame features are encoded once per video into stacked device tensors
  shared by every propagation pass;
* a pass is a Python loop over exactly its frames (the JAX package's
  ``lax.scan`` over padded, fixed-length segments), each frame one step of
  ``track_step``, the packed path's step with every slot on the pass's
  frame, replayed from a CUDA graph on a CUDA device;
* the object axis is a batch dimension of ``obj_batch`` slots.

Compute runs in ``compute_dtype`` (bf16 by default, the reference's autocast
for SAM2, generate_tokens_grid.py:84-88) with fp32 softmax statistics, except
the image encoder after its patch embedding, which runs in fp32 on
bf16-rounded weights as in the JAX package (``cast_for_compute``).
Outputs are low-res mask logits resized to the video resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from sola_torch.core import mask_ops
from sola_torch.core.mask_ops import resize_bilinear
from sola_torch.trackgen.sam2 import track_step
from sola_torch.trackgen.sam2.image_encoder import normalize_image
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.track_step import Banks, TrackStep
from sola_torch.utils import profiling

_OUTPUT_CHUNK = 16  # frames resized to video resolution per call


def cast_for_compute(model: SAM2Model, compute_dtype) -> SAM2Model:
    """Cast ``model`` in place to ``compute_dtype`` with the JAX package's
    precision: its predictor casts every parameter to ``compute_dtype``, but
    Hiera adds an fp32 position embedding after the patch embedding, which
    promotes the rest of the image encoder (Hiera's blocks, the FPN neck and
    the conv_s0/conv_s1 projections) to fp32 compute on the rounded weights.
    Those modules get their rounded weights back in fp32 here (exact)."""
    model.to(compute_dtype)
    if compute_dtype != torch.float32:
        encoder = model.image_encoder
        encoder.float()
        encoder.trunk.patch_embed.to(compute_dtype)
        model.sam_mask_decoder.conv_s0.float()
        model.sam_mask_decoder.conv_s1.float()
    return model


@torch.no_grad()
def encode_raw(model: SAM2Model, raw: torch.Tensor, compute_dtype) -> dict:
    """(n, H, W, 3) uint8 device frames -> encode_image features: linear
    resize to the model size, back to uint8 (truncating), normalize, and
    the image in ``compute_dtype``."""
    s = model.cfg.image_size
    x = resize_bilinear(raw.permute(0, 3, 1, 2).float(), (s, s))
    x = normalize_image(x.permute(0, 2, 3, 1).to(torch.uint8))
    return model.encode_image(x.to(compute_dtype))


@dataclasses.dataclass
class InferenceState:
    num_frames: int
    obj_batch: int
    features: dict               # stacked tensors: pix/s0/s1 (T, h, w, c)
    pos: torch.Tensor            # (h, w, d) sine PE (frame-independent)
    orig_hw: tuple
    banks: Optional[Banks] = None   # the predictor's, while it banks us
    prompts: dict = dataclasses.field(default_factory=dict)
    output_tokens: dict = dataclasses.field(default_factory=dict)
    obj_ids: list = dataclasses.field(default_factory=list)
    # host-cached cond-frame outputs keyed (frame_idx, output_mode): the
    # reverse pass re-yields the output the forward pass fetched
    cond_host: dict = dataclasses.field(default_factory=dict)
    seed_frames: Optional[np.ndarray] = None
    # device-resident canonical small masklets of "masks"-mode passes:
    # list of (frame_idxs, (n, n_obj, sh, sw) bool)
    small_parts: Optional[list] = None


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Model, obj_batch: int = 4,
                 feature_dtype=torch.bfloat16, encode_chunk: int = 4,
                 compute_dtype=torch.bfloat16):
        """``model`` is cast in place to ``compute_dtype``. Frame features
        are stored in ``feature_dtype``; ``encode_chunk`` frames are encoded
        per image-encoder call."""
        self.model = cast_for_compute(model, compute_dtype).eval()
        self.cfg: SAM2Config = model.cfg
        self.device = next(model.parameters()).device
        self.obj_batch = obj_batch
        self.feature_dtype = feature_dtype
        self.compute_dtype = compute_dtype
        self.encode_chunk = encode_chunk
        self._steps: dict = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if track_step.usable(self.device) else None)

    def track_step(self, b: Optional[int] = None) -> TrackStep:
        """The propagation step of ``b`` slots (``obj_batch`` by default)
        with its banks, buffers and graphs, made once; the steps of every
        slot count share one graph memory pool."""
        b = self.obj_batch if b is None else b
        if b not in self._steps:
            self._steps[b] = TrackStep(self, b, self._graph_pool)
        return self._steps[b]

    # ------------------------------------------------------------------
    # Protocol
    # ------------------------------------------------------------------

    @torch.no_grad()
    @profiling.spanned("trackgen.encode")
    def init_state(self, frames: Optional[Sequence[np.ndarray]],
                   video_path: Optional[str] = None) -> InferenceState:
        """frames: list of (H, W, 3) uint8 arrays, or ``video_path`` to a
        JPEG directory. Encodes every frame once into stacked device
        features shared by all propagation passes."""
        if video_path is not None:
            with profiling.span("trackgen.decode"):
                frames = _load_frames(video_path)
        orig_hw = tuple(frames[0].shape[:2])
        t = len(frames)
        parts: dict = {"pix": [], "s0": [], "s1": []}
        pos = None
        for start in range(0, t, self.encode_chunk):
            raw = torch.from_numpy(
                np.stack(frames[start:start + self.encode_chunk], axis=0)
            ).to(self.device)
            f = encode_raw(self.model, raw, self.compute_dtype)
            for k in parts:
                parts[k].append(f[k].to(self.feature_dtype))
            if pos is None:
                pos = f["pos"][0]
        features = {k: torch.cat(v, dim=0) for k, v in parts.items()}
        return InferenceState(num_frames=t, obj_batch=self.obj_batch,
                              features=features, pos=pos, orig_hw=orig_hw)

    def reset_state(self, state: InferenceState) -> None:
        state.banks = None
        state.prompts = {}
        state.output_tokens = {}
        state.obj_ids = []
        state.seed_frames = None
        state.small_parts = None
        state.cond_host = {}

    @profiling.spanned("trackgen.cond")
    def add_new_mask(self, state: InferenceState, frame_idx: int,
                     obj_id: int, mask: np.ndarray):
        """Register a mask prompt; returns (frame_idx, obj_ids, mask_logits)
        with the input mask as +-10 logits (SAM2's
        use_mask_input_as_output_without_sam semantics)."""
        s = self.cfg.image_size
        mask = np.asarray(mask)
        orig_mask = (mask > 0.5).astype(np.float32)
        if mask.shape != (s, s):
            mask = mask_ops.resize_nearest_np(np.asarray(mask, np.float32),
                                              (s, s))
        mask = (mask > 0.5).astype(np.float32)
        state.prompts.setdefault(int(frame_idx), {})[int(obj_id)] = mask
        # a new prompt invalidates any cached cond output for this frame
        state.cond_host = {k: v for k, v in state.cond_host.items()
                           if k[0] != int(frame_idx)}
        if obj_id not in state.obj_ids:
            state.obj_ids.append(obj_id)
        if orig_mask.shape == state.orig_hw:
            out_logits = orig_mask[None] * 20.0 - 10.0
        else:
            out_logits = resize_bilinear(
                torch.from_numpy(mask)[None] * 20.0 - 10.0,
                state.orig_hw).numpy()
        return frame_idx, list(state.obj_ids), out_logits

    # ------------------------------------------------------------------

    def _prompt_masks(self, state: InferenceState,
                      frame_idx: int) -> torch.Tensor:
        """(obj_batch, S, S) uint8 device prompt masks of one frame."""
        s = self.cfg.image_size
        masks = np.zeros((self.obj_batch, s, s), np.uint8)
        for slot, obj_id in enumerate(state.obj_ids[:self.obj_batch]):
            m = state.prompts.get(frame_idx, {}).get(obj_id)
            if m is not None:
                masks[slot] = m > 0.5
        return torch.from_numpy(masks).to(self.device)

    @torch.no_grad()
    @profiling.spanned("trackgen.cond")
    def _run_cond_frames(self, state: InferenceState) -> None:
        """Consolidate every prompted frame into a conditioning slot of the
        emptied banks: mask-as-output, memory encode and the bank writes."""
        steps = self.track_step()
        steps.reset()
        for slot, frame_idx in enumerate(
                sorted(state.prompts.keys())[:self.cfg.max_cond_frames]):
            frames = torch.full((self.obj_batch,), frame_idx,
                                dtype=torch.long, device=self.device)
            state.output_tokens[frame_idx] = steps.condition(
                state.features, frames, self._prompt_masks(state, frame_idx),
                frames, slot)
        steps.holder = id(state)
        state.banks = steps.banks

    def _reseed_ring(self, state: InferenceState) -> None:
        """Reverse pass: the recent ring holds the forward pass's first
        post-cond memories (empty when no forward pass ran)."""
        b = self.obj_batch
        ran = state.seed_frames is not None
        self.track_step().reseed(
            np.full(b, min(state.prompts), np.int64),
            np.full(b, state.num_frames if ran else 0, np.int64))

    def _masks_out(self, lo: torch.Tensor, hw: tuple, small_hw: tuple):
        """(n, n_obj, 4h, 4w) logits -> full-res uint8 host masks and the
        device-resident canonical small masks (binary -> linear resize ->
        > 0.5, the reshape_masklet rule)."""
        m = resize_bilinear(lo.float(), hw) > 0.0
        small = resize_bilinear(m.float(), small_hw) > 0.5
        return profiling.fetch(m.to(torch.uint8)), small

    @torch.no_grad()
    def propagate_in_video(self, state: InferenceState,
                           reverse: bool = False,
                           start_frame_idx: Optional[int] = None,
                           output_mode: str = "logits") -> Iterator[tuple]:
        """Yields (frame_idx, obj_ids, outputs) for every frame of the pass,
        the conditioning frame included, like upstream.

        ``output_mode``: "logits" — (n_obj, 1, H, W) fp32 +-10 logits,
        upstream's contract (consumers binarize at 0); "masks" —
        (n_obj, H, W) uint8 binary masks, the track-generation path, which
        also keeps canonical small masklets on the device; "none" — no
        outputs and no tokens, compute only."""
        cfg = self.cfg
        if not state.prompts:
            return
        cond_idx = min(state.prompts.keys())
        steps = self.track_step()
        if state.banks is None:
            self._run_cond_frames(state)
        elif steps.holder != id(state):
            raise RuntimeError(
                "the predictor's banks hold another batch since this state's "
                "conditioning: reset_state and add its prompts again")

        start = start_frame_idx if start_frame_idx is not None else cond_idx
        if reverse:
            frame_idxs = list(range(start - 1, -1, -1))
        else:
            frame_idxs = list(range(start + 1, state.num_frames))
        n_obj = len(state.obj_ids)
        oh, ow = state.orig_hw
        small_hw = mask_ops.reshape_hw(oh, ow)

        # conditioning-frame output: the consolidated prompt, fetched once
        # per batch and re-yielded by the second pass
        if output_mode == "none":
            yield cond_idx, list(state.obj_ids), None
        elif output_mode == "masks":
            if state.small_parts is None:
                state.small_parts = []
            cached = state.cond_host.get((cond_idx, "masks"))
            if cached is None:
                lo = (self._prompt_masks(state, cond_idx)[:n_obj].float()
                      * 20.0 - 10.0)[None]
                host, small = self._masks_out(lo, (oh, ow), small_hw)
                state.small_parts.append(([cond_idx], small))
                cached = host[0]
                state.cond_host[(cond_idx, "masks")] = cached
            yield cond_idx, list(state.obj_ids), cached
        else:
            cached = state.cond_host.get((cond_idx, "logits"))
            if cached is None:
                lo = (self._prompt_masks(state, cond_idx)[:n_obj].float()
                      * 20.0 - 10.0)
                cached = profiling.fetch(resize_bilinear(lo, (oh, ow)))
                state.cond_host[(cond_idx, "logits")] = cached
            yield cond_idx, list(state.obj_ids), cached[:, None]
        if not frame_idxs:
            return

        if reverse:
            self._reseed_ring(state)
        # every slot on the pass's frame; the loop visits exactly the
        # pass's frames, so every slot writes at every step
        b = self.obj_batch
        frames = np.repeat(np.asarray(frame_idxs, np.int64)[:, None], b, 1)
        sched = track_step.schedule(cfg, frames, frames,
                                    np.ones(frames.shape, bool),
                                    np.full(b, cond_idx, np.int64))
        lows, ptrs = steps.run_pass(
            state.features, sched, np.full(len(frame_idxs), min(n_obj, b)),
            reverse, collect=output_mode != "none")
        if not reverse:
            stride, r = max(cfg.memory_stride, 1), cfg.num_recent
            state.seed_frames = np.asarray(
                [cond_idx + stride * (i + 1) for i in range(r)
                 if cond_idx + stride * (i + 1) < state.num_frames],
                np.int64)

        if output_mode == "none":
            for fidx in frame_idxs:
                yield fidx, list(state.obj_ids), None
            return
        toks = profiling.fetch(ptrs.float())
        low_res = lows[:, :n_obj]
        for s in range(0, len(frame_idxs), _OUTPUT_CHUNK):
            e = min(s + _OUTPUT_CHUNK, len(frame_idxs))
            host, small = self._masks_out(low_res[s:e], (oh, ow), small_hw)
            if output_mode == "masks":
                state.small_parts.append((frame_idxs[s:e], small))
            for j in range(e - s):
                fidx = frame_idxs[s + j]
                state.output_tokens[fidx] = toks[s + j]
                if output_mode == "masks":
                    yield fidx, list(state.obj_ids), host[j]
                else:
                    # consumers binarize at 0: +-10 logits rebuilt from
                    # the device-thresholded masks
                    logits = host[j].astype(np.float32) * 20.0 - 10.0
                    yield fidx, list(state.obj_ids), logits[:, None]

    def get_small_masklets(self, state: InferenceState) -> torch.Tensor:
        """(T, n_obj, sh, sw) bool DEVICE tensor of canonical <=960x540
        small masklets from the "masks"-mode passes; needs every frame seen
        once (forward and reverse pass both run)."""
        parts = state.small_parts or []
        if not parts:
            raise RuntimeError("no masks-mode propagation has run")
        fidx = np.concatenate([np.asarray(p[0]) for p in parts])
        if len(fidx) != state.num_frames or not (
                np.sort(fidx) == np.arange(state.num_frames)).all():
            raise RuntimeError(f"small masklets cover {len(fidx)} of "
                               f"{state.num_frames} frames")
        all_small = torch.cat([p[1] for p in parts], dim=0)
        perm = np.zeros(state.num_frames, np.int64)
        perm[fidx] = np.arange(len(fidx))
        return all_small[torch.from_numpy(perm).to(all_small.device)]

    def get_output_tokens(self, state: InferenceState) -> dict:
        """frame_idx -> (n_obj, d) fp32 obj_ptr array (host)."""
        n_obj = len(state.obj_ids)
        out = {}
        for f, tok in state.output_tokens.items():
            if torch.is_tensor(tok):
                tok = profiling.fetch(tok.float())
            out[f] = np.asarray(tok)[:n_obj].astype(np.float32)
        return out


def _load_frames(video_path: str) -> list:
    import os

    from PIL import Image
    names = sorted(os.listdir(video_path))
    return [np.asarray(Image.open(os.path.join(video_path, n)).convert("RGB"))
            for n in names]
