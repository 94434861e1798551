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
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from sola_torch.core import mask_ops
from sola_torch.trackgen.sam2.common import sine_position_encoding
from sola_torch.trackgen.sam2.video import (Banks, InferenceState,
                                            SAM2VideoPredictor)
from sola_torch.utils import profiling

_FAR = -10 ** 6      # frame index of an empty bank slot (video.py's)
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
    lows: list = dataclasses.field(default_factory=list)   # (b, 4h, 4w)
    ptrs: list = dataclasses.field(default_factory=list)   # (b, d)


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
        self.model = predictor.model
        self.cfg = predictor.cfg
        self.b = predictor.obj_batch
        self.cdt = predictor.compute_dtype
        self.device = predictor.device

    # ------------------------------------------------------------------

    def _gather(self, feats: dict, gidx: torch.Tensor) -> list:
        """pix / s0 / s1 of each slot's own frame."""
        return [feats[k][gidx].to(self.cdt) for k in ("pix", "s0", "s1")]

    @torch.no_grad()
    @profiling.spanned("trackgen.cond")
    def cond_init(self, feats: dict, gidx: torch.Tensor,
                  masks: torch.Tensor, cond: np.ndarray):
        """Consolidate each slot's conditioning frame: mask-as-output on
        its own frame's features, the memory encode and the initial bank
        writes. Padding slots run on zero masks and keep ``cond_valid[:,
        0]`` set, so memory attention never sees a fully masked row.
        Returns (banks, cond obj_ptr (b, d))."""
        cfg = self.cfg
        pix, s0, s1 = self._gather(feats, gidx)
        out = self.model.mask_as_output(pix, s0, s1, masks.float())
        mem = self.model.encode_memory(pix, out["high_res_masks"][:, 0])
        banks = self.pred._empty_banks()
        banks.cond_mem[:, 0] = mem.to(self.cdt)
        banks.cond_valid[:, 0] = True
        rows = torch.arange(self.b, device=self.device)
        cond_t = torch.from_numpy(cond.astype(np.int64)).to(self.device)
        pslot = cond_t % cfg.max_obj_ptrs
        banks.obj_ptrs[rows, pslot] = out["obj_ptr"].to(self.cdt)
        banks.ptr_frame[rows, pslot] = cond_t
        banks.ptr_valid[rows, pslot] = True
        return banks, out["obj_ptr"]

    @torch.no_grad()
    @profiling.spanned("trackgen.step")
    def step(self, feats: dict, banks: Banks, seed_buf: torch.Tensor,
             x: dict, reverse: bool):
        """One tracked step of every slot, each on its own frame
        ``x["fidx"][s]``: condition on the banks, decode, encode the new
        memory and push it and the object pointer into the banks of the
        slots the schedule lets write. ``x`` holds this step's (b,) device
        vectors of ``_device_schedule``. Returns (low-res logits (b, 4h,
        4w) bf16, obj_ptr (b, d))."""
        cfg, model, cdt, dev = self.cfg, self.model, self.cdt, self.device
        b, r = self.b, cfg.num_recent
        stride = max(cfg.memory_stride, 1)
        pix, s0, s1 = self._gather(feats, x["gidx"])
        pos = sine_position_encoding(pix.shape[1], pix.shape[2],
                                     pix.shape[3], device=dev)
        pos = pos.to(cdt)[None].expand(pix.shape)

        f = x["fidx"]
        fcol = f[:, None]
        tpos = (fcol - banks.recent_frame).abs()
        rec_ok = banks.recent_valid & (tpos >= 1) & (tpos <= r * stride)
        ptr_ok = banks.ptr_valid & (
            (fcol - banks.ptr_frame).abs() < cfg.max_obj_ptrs)
        if reverse:
            rec_ok &= banks.recent_frame >= fcol
            ptr_ok &= banks.ptr_frame >= fcol
        else:
            rec_ok &= banks.recent_frame <= fcol
            ptr_ok &= banks.ptr_frame <= fcol
        tpos = torch.div(tpos + stride - 1, stride,
                         rounding_mode="floor").clamp(1, r)
        conditioned = model.condition_features(
            pix, pos, banks.cond_mem, banks.cond_valid, banks.recent_mem,
            rec_ok, tpos, banks.obj_ptrs, ptr_ok)
        coords = torch.zeros((b, 1, 2), dtype=cdt, device=dev)
        labels = torch.full((b, 1), -1, dtype=torch.long, device=dev)
        out = model.sam_heads(conditioned, s0, s1, coords, labels, None,
                              cfg.multimask_output_for_tracking,
                              suppress_empty_obj=True)
        mem = model.encode_memory(conditioned,
                                  out["high_res_masks"][:, 0]).to(cdt)
        ptr_new = out["obj_ptr"].to(cdt)

        # per-slot bank writes: each slot writes one bank entry, kept as it
        # was where the schedule's gate says no (no host round trip)
        rows = torch.arange(b, device=dev)

        def put(bank, idx, on, new):
            on = on.reshape(on.shape + (1,) * (new.dim() - 1))
            bank[rows, idx] = torch.where(on, new, bank[rows, idx])

        put(banks.recent_mem, x["slot"], x["push"], mem)
        put(banks.recent_frame, x["slot"], x["push"], f)
        banks.recent_valid[rows, x["slot"]] |= x["push"]
        put(banks.obj_ptrs, x["pslot"], x["write"], ptr_new)
        put(banks.ptr_frame, x["pslot"], x["write"], f)
        banks.ptr_valid[rows, x["pslot"]] |= x["write"]
        if not reverse:
            # stash the memories of the first R (stride-aligned) post-cond
            # frames to re-seed the ring for the reverse pass
            cur = seed_buf[x["sslot"], rows]
            seed_buf[x["sslot"], rows] = torch.where(
                x["seed"][:, None, None, None], mem, cur)
        return (out["low_res_masks"][:, 0].to(torch.bfloat16),
                out["obj_ptr"])

    def reseed(self, banks: Banks, seed_buf: torch.Tensor,
               cond_min: np.ndarray, lengths: np.ndarray) -> None:
        """Reverse pass: each slot's recent ring holds the forward pass's
        first post-cond memories of its own video (the per-slot form of
        the sequential predictor's ``_reseed_ring``)."""
        stride = max(self.cfg.memory_stride, 1)
        r = self.cfg.num_recent
        banks.recent_mem.zero_()
        banks.recent_frame.fill_(_FAR)
        banks.recent_valid.zero_()
        for i in range(r):
            f = cond_min + stride * (i + 1)
            ok = np.nonzero(f < lengths)[0]
            if not ok.size:
                continue
            rows = torch.from_numpy(ok).to(self.device)
            slot = torch.from_numpy((f[ok] // stride) % r).to(self.device)
            banks.recent_mem[rows, slot] = seed_buf[i][rows]
            banks.recent_frame[rows, slot] = torch.from_numpy(
                f[ok]).to(self.device)
            banks.recent_valid[rows, slot] = True

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

    def _device_schedule(self, sched: _Pass, cond: np.ndarray) -> dict:
        """The (L, b) per-step vectors of one pass on the device, in one
        upload: feature and frame indices, and each bank write's entry and
        gate (ring push, pointer write, forward seed stash)."""
        cfg = self.cfg
        r, stride = cfg.num_recent, max(cfg.memory_stride, 1)
        fidx = sched.fidx
        rel = fidx - cond[None, :]
        write = gate(sched.active)
        host = {"gidx": sched.gidx, "fidx": fidx,
                "slot": (fidx // stride) % r,
                "push": write & (rel % stride == 0),
                "pslot": fidx % cfg.max_obj_ptrs,
                "write": write,
                "sslot": np.clip(rel // stride - 1, 0, r - 1),
                "seed": write & (rel >= 1) & (rel <= r * stride)
                & (rel % stride == 0)}
        stacked = torch.from_numpy(np.stack(
            [v.astype(np.int64) for v in host.values()])).to(self.device)
        return {k: (stacked[i] != 0) if host[k].dtype == bool
                else stacked[i] for i, k in enumerate(host)}

    @torch.no_grad()
    @profiling.spanned("trackgen.round")
    def run_round(self, pack: PackedFeatures, plan: SlotPlan,
                  cond_masks: np.ndarray, collect: bool = True) -> dict:
        """One packed round: consolidate conditioning frames, propagate
        forward then reverse, and collect per-slot outputs.

        ``cond_masks``: (b, S, S) float prompt masks (zeros for padding
        slots). Returns {"masks": {slot: {frame: (H, W) uint8}},
        "tokens": {slot: {frame: (d,) float32}}, "smalls": {slot: (T, sh,
        sw) bool device tensor}}. ``collect=False`` skips the outputs and
        returns {"banks": the final Banks}, the propagation compute
        alone."""
        cfg, b, dev = self.cfg, self.b, self.device
        vid = np.maximum(plan.video, 0)
        cond = plan.cond.astype(np.int64)
        cond_gidx = torch.from_numpy(
            (pack.offsets[vid] + cond).astype(np.int64)).to(dev)
        # one uint8 upload shared by the cond pass and the collect phase
        cond_u8 = torch.from_numpy(
            (np.asarray(cond_masks) > 0.5).astype(np.uint8)).to(dev)
        banks, cond_ptr = self.cond_init(pack.feats, cond_gidx, cond_u8,
                                         cond)
        h = cfg.feat_hw
        seed_buf = torch.zeros((cfg.num_recent, b, h, h, cfg.mem_dim),
                               dtype=self.cdt, device=dev)
        lengths = plan.length.astype(np.int64)

        passes = {}
        for reverse in (False, True):
            if reverse:
                # keep the cond and pointer banks of the forward pass;
                # re-seed the recent ring from its post-cond memories
                self.reseed(banks, seed_buf, cond, lengths)
            sched = self._schedule(plan, reverse, pack.offsets)
            if sched is None:
                continue
            dev_sched = self._device_schedule(sched, cond)
            n_on = sched.active.sum(axis=1)
            for t in range(sched.gidx.shape[0]):
                lo, ptr = self.step(pack.feats, banks, seed_buf,
                                    {k: v[t] for k, v in dev_sched.items()},
                                    reverse)
                profiling.count("trackgen.slots", b)
                profiling.count("trackgen.slots_active", int(n_on[t]))
                if collect:
                    sched.lows.append(lo)
                    sched.ptrs.append(ptr)
            passes[reverse] = sched
        if not collect:
            return {"banks": banks}
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
            ptr_np = profiling.fetch(torch.stack(sched.ptrs).float())
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
                lows = torch.stack(sched.lows)          # (L, b, 4h, 4w)
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
