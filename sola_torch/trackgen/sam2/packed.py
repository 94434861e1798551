"""Cross-video packed propagation: (video, object) slots in one batch.

Counterpart of ``sola_tpu/trackgen/sam2/packed.py``. The sequential
predictor tracks one video at a time with up to ``obj_batch`` objects per
propagation pass; a video whose next same-frame prompt batch has 2 objects
runs the whole SAM2 memory stack at 2 of 4 slots. The per-slot state
(memory banks, frame schedules, conditioning frames) is already carried per
slot, so slots of different videos can share one pass. This module widens
the propagation batch axis from (object,) to (video, object):

* ``PackedFeatures`` concatenates the packed videos' encoded frame features
  along the frame axis (one gather index space);
* each step gathers per-slot frame features (``feats[gidx]``) instead of
  broadcasting one frame to all slots; frame indices, conditioning anchors
  and bank writes are per-slot vectors;
* schedules are host-built numpy: slot s tracks frames ``cond_s+1..T_s-1``
  (forward) and ``cond_s-1..0`` (reverse); the pass runs as many steps as
  its longest slot, and a slot past its own frames is inactive: its bank
  writes are gated off and its outputs dropped.

No op mixes slots, so a slot's results match the sequential predictor's
whatever its neighbours carry (tests/test_torch_packed.py). The passes are
Python loops over exactly the longest slot's steps, as in the sequential
predictor, so there is no scan-length padding and no frame-axis bucket.
Both paths run one step (``track_step.TrackStep``) on the predictor's banks,
replayed from CUDA graphs on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from sola_torch.core import mask_ops
from sola_torch.trackgen.sam2 import track_step
from sola_torch.trackgen.sam2.video import InferenceState, SAM2VideoPredictor
from sola_torch.utils import profiling

_OUTPUT_ROWS = 64    # tracked (frame, slot) masks resized per call


@dataclasses.dataclass
class PackedFeatures:
    """Concatenated frame features of a pack of videos (one gather space).

    ``offsets[v] + local_frame`` is the global gather index of entry v's
    frame."""
    feats: dict                   # pix/s0/s1: (sum T, h, w, c)
    offsets: np.ndarray           # (n_entries,) int
    lengths: np.ndarray           # (n_entries,) int
    orig_hws: list                # per entry (H, W)

    @classmethod
    def build(cls, states: Sequence[InferenceState]) -> "PackedFeatures":
        """Entries sharing one ``InferenceState`` object (several
        expressions of one video) share one feature region: the buffer
        holds each unique state once, and a pack of one unique state uses
        its features in place."""
        uniq: dict = {}
        which = []
        for s in states:
            if id(s) not in uniq:
                uniq[id(s)] = (len(uniq), s)
            which.append(uniq[id(s)][0])
        ustates = [s for _, s in sorted(uniq.values(), key=lambda t: t[0])]
        ulen = np.asarray([s.num_frames for s in ustates], np.int64)
        uoff = np.concatenate([[0], np.cumsum(ulen)[:-1]]).astype(np.int64)
        if len(ustates) == 1:
            feats = dict(ustates[0].features)
        else:
            feats = {k: torch.cat([s.features[k] for s in ustates], dim=0)
                     for k in ("pix", "s0", "s1")}
        which = np.asarray(which)
        return cls(feats=feats, offsets=uoff[which], lengths=ulen[which],
                   orig_hws=[s.orig_hw for s in states])


@dataclasses.dataclass
class SlotPlan:
    """One packed propagation round's slot layout."""
    video: np.ndarray             # (b,) pack entry index (-1 = padding)
    cond: np.ndarray              # (b,) conditioning frame (0 for padding)
    length: np.ndarray            # (b,) that slot's video length (1 pad)


@dataclasses.dataclass
class _Pass:
    """Host schedule of one pass direction, and its outputs."""
    gidx: np.ndarray              # (L, b) global feature index
    fidx: np.ndarray              # (L, b) frame index in the slot's video
    active: np.ndarray            # (L, b) the slot tracks this step
    lows: Optional[torch.Tensor] = None   # (L, b, 4h, 4w)
    ptrs: Optional[torch.Tensor] = None   # (L, b, d)


def gate(active: np.ndarray) -> np.ndarray:
    """Which slots may write their banks at a step: exactly the active
    ones (a slot past its own frames repeats its last frame, and a push
    from such a step stores a memory the sequential predictor never
    makes)."""
    return active


class PackedPropagator:
    """Bidirectional propagation for slots spanning several videos.

    Wraps an existing ``SAM2VideoPredictor`` (same model, dtypes and
    device); its ``obj_batch`` is the pack width. Each round gives, per
    slot, full-resolution binary masks for every frame of the slot's
    video, per-frame object tokens and the device-resident canonical small
    masklet."""

    def __init__(self, predictor: SAM2VideoPredictor):
        self.pred = predictor
        self.cfg = predictor.cfg
        self.b = predictor.obj_batch
        self.device = predictor.device
        self.steps = predictor.track_step(self.b)

    # ------------------------------------------------------------------

    @torch.no_grad()
    @profiling.spanned("trackgen.cond")
    def cond_init(self, feats: dict, gidx: torch.Tensor,
                  masks: torch.Tensor, cond: np.ndarray):
        """Empty the banks and consolidate each slot's conditioning frame:
        mask-as-output on its own frame's features, the memory encode and
        the initial bank writes. Padding slots run on zero masks and keep
        ``cond_valid[:, 0]`` set, so memory attention never sees a fully
        masked row. Returns the cond obj_ptr (b, d)."""
        self.steps.reset()
        cond_t = torch.from_numpy(cond.astype(np.int64)).to(self.device)
        return self.steps.condition(feats, gidx, masks, cond_t)

    # ------------------------------------------------------------------

    def _schedule(self, plan: SlotPlan, reverse: bool,
                  offsets: np.ndarray):
        """(L, b) gidx / fidx / active numpy schedule of one pass
        direction, L the longest slot's step count (None when no slot has
        work)."""
        if reverse:
            lens = plan.cond.copy()                      # frames cond-1..0
        else:
            lens = plan.length - 1 - plan.cond           # cond+1..T-1
        lens = np.maximum(lens, 0) * (plan.video >= 0)
        steps = int(lens.max()) if self.b else 0
        if steps == 0:
            return None
        t = np.arange(steps)[:, None]
        if reverse:
            fidx = plan.cond[None, :] - 1 - t
        else:
            fidx = plan.cond[None, :] + 1 + t
        active = (t < lens[None, :]) & (plan.video[None, :] >= 0)
        fidx = np.clip(fidx, 0, np.maximum(plan.length - 1, 0)[None, :])
        vid = np.maximum(plan.video, 0)
        gidx = offsets[vid][None, :] + fidx
        return _Pass(gidx=gidx.astype(np.int64), fidx=fidx.astype(np.int64),
                     active=active)

    @torch.no_grad()
    @profiling.spanned("trackgen.round")
    def run_round(self, pack: PackedFeatures, plan: SlotPlan,
                  cond_masks: np.ndarray) -> dict:
        """One packed round: consolidate conditioning frames, propagate
        forward then reverse, and collect per-slot outputs.

        ``cond_masks``: (b, S, S) float prompt masks (zeros for padding
        slots). Returns {"masks": {slot: {frame: (H, W) uint8}},
        "tokens": {slot: {frame: (d,) float32}}, "smalls": {slot: (T, sh,
        sw) bool device tensor}}. The round's final banks stay in
        ``self.steps.banks`` until the next round."""
        dev = self.device
        vid = np.maximum(plan.video, 0)
        cond = plan.cond.astype(np.int64)
        cond_gidx = torch.from_numpy(
            (pack.offsets[vid] + cond).astype(np.int64)).to(dev)
        # one uint8 upload shared by the cond pass and the collect phase
        cond_u8 = torch.from_numpy(
            (np.asarray(cond_masks) > 0.5).astype(np.uint8)).to(dev)
        cond_ptr = self.cond_init(pack.feats, cond_gidx, cond_u8, cond)
        lengths = plan.length.astype(np.int64)

        passes = {}
        for reverse in (False, True):
            if reverse:
                # keep the cond and pointer banks of the forward pass;
                # re-seed each slot's recent ring from its post-cond
                # memories
                self.steps.reseed(cond, lengths)
            sched = self._schedule(plan, reverse, pack.offsets)
            if sched is None:
                continue
            rows = track_step.schedule(self.cfg, sched.gidx, sched.fidx,
                                       gate(sched.active), cond)
            sched.lows, sched.ptrs = self.steps.run_pass(
                pack.feats, rows, sched.active.sum(axis=1), reverse)
            passes[reverse] = sched
        return self._collect(pack, plan, passes, cond_u8, cond_ptr)

    def _collect(self, pack: PackedFeatures, plan: SlotPlan, passes: dict,
                 cond_u8: torch.Tensor, cond_ptr: torch.Tensor) -> dict:
        """Per-slot outputs by the sequential predictor's rule
        (``SAM2VideoPredictor._masks_out``): a linear resize of +-10 logits
        > 0 for the full-resolution mask, small = its resize > 0.5 at the
        canonical <=960x540 size, kept on the device. Slots are grouped by
        output resolution, so each group resizes in batches."""
        pred = self.pred
        slots_on = [s for s in range(self.b) if plan.video[s] >= 0]
        masks = {s: {} for s in slots_on}
        tokens = {s: {} for s in slots_on}
        small_rows = {s: {} for s in slots_on}

        cond_np = profiling.fetch(cond_ptr.float())
        for s in slots_on:
            tokens[s][int(plan.cond[s])] = cond_np[s]
        for sched in passes.values():
            ptr_np = profiling.fetch(sched.ptrs.float())
            for t, s in zip(*np.nonzero(sched.active)):
                tokens[s][int(sched.fidx[t, s])] = ptr_np[t, s]

        groups: dict = {}
        for s in slots_on:
            groups.setdefault(tuple(pack.orig_hws[plan.video[s]]),
                              []).append(s)
        for (oh, ow), slots in groups.items():
            small_hw = mask_ops.reshape_hw(oh, ow)
            sel = torch.tensor(slots, device=self.device)
            # the conditioning frame: the prompt mask round-tripped through
            # the model input size, as the sequential predictor yields it
            lo = (cond_u8[sel].float() * 20.0 - 10.0)[None]
            host, small = pred._masks_out(lo, (oh, ow), small_hw)
            for j, s in enumerate(slots):
                f = int(plan.cond[s])
                masks[s][f] = host[0, j]
                small_rows[s][f] = small[0, j]
            for sched in passes.values():
                lows = sched.lows                       # (L, b, 4h, 4w)
                t_idx, s_idx = np.nonzero(sched.active[:, slots])
                s_glob = np.asarray(slots)[s_idx]
                for c in range(0, len(t_idx), _OUTPUT_ROWS):
                    tt = t_idx[c:c + _OUTPUT_ROWS]
                    ss = s_glob[c:c + _OUTPUT_ROWS]
                    rows = lows[torch.from_numpy(tt).to(self.device),
                                torch.from_numpy(ss).to(self.device)]
                    host, small = pred._masks_out(rows[:, None], (oh, ow),
                                                  small_hw)
                    for i, (t, s) in enumerate(zip(tt, ss)):
                        f = int(sched.fidx[t, s])
                        masks[s][f] = host[i, 0]
                        small_rows[s][f] = small[i, 0]
        smalls = {s: torch.stack([small_rows[s][f]
                                  for f in range(int(plan.length[s]))])
                  for s in slots_on}
        return {"masks": masks, "tokens": tokens, "smalls": smalls}
