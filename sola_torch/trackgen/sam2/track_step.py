"""SAM2's propagation step, one for the sequential and the packed paths,
replayed from CUDA graphs on a CUDA device.

A step tracks each of ``b`` object slots one frame on: it conditions the
slot's frame features on the slot's memory banks, decodes the mask and the
object pointer, encodes the new memory and writes it, and the pointer, into
the banks where the pass's schedule lets the slot write. Every per-slot
choice is a row of the pass's schedule (``schedule``), uploaded once a
pass, so a step has one shape for a given ``b`` and direction whatever its
frames, videos or prompts. The sequential predictor's pass is the schedule
whose slots all sit on the pass's frame; a packed round's slots each follow
their own video.

``TrackStep`` holds, for one predictor and slot count, everything a step
reads and writes at a fixed address: the banks and the forward pass's seed
buffer (reset and written in place by the conditioning and the re-seed),
the three gathered feature maps, one (8, b) schedule row, and the sine
position encoding and the prompt-free coords and labels, built once. A step
gathers its slots' frame features and copies its schedule row into those
buffers (the features change from video to video), then runs the body.

On a CUDA device the body is a CUDA graph per direction: the first step of
a direction runs the body eagerly on a side stream, which warms every
library call up and is that step's result, and then captures it; every
later step replays the graph. The graphs of a predictor share one memory
pool: they never run at once, and each replay's outputs are copied out
before the next. A replay runs the eager body's kernels in the same order
on the same buffers. On the CPU the body runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sola_torch.trackgen.sam2.common import sine_position_encoding
from sola_torch.utils import profiling
from sola_torch.utils.cuda_graphs import capture

FAR = -10 ** 6  # frame index of an empty bank slot
_FEATS = ("pix", "s0", "s1")
# the rows of a pass's schedule, each (b,) a step: feature and frame index,
# ring entry and push gate, pointer entry and write gate, seed-stash entry
# and gate
ROWS = ("gidx", "fidx", "slot", "push", "pslot", "write", "sslot", "seed")
_GATES = ("push", "write", "seed")


@dataclasses.dataclass
class Banks:
    """Memory of one batch of objects; every tensor's axis 0 is the object
    slot."""
    cond_mem: torch.Tensor       # (B, C, h, w, mem)
    cond_valid: torch.Tensor     # (B, C) bool
    recent_mem: torch.Tensor     # (B, R, h, w, mem)
    recent_frame: torch.Tensor   # (B, R) long
    recent_valid: torch.Tensor   # (B, R) bool
    obj_ptrs: torch.Tensor       # (B, P, d)
    ptr_frame: torch.Tensor      # (B, P) long
    ptr_valid: torch.Tensor      # (B, P) bool


def schedule(cfg, gidx: np.ndarray, fidx: np.ndarray, write: np.ndarray,
             cond: np.ndarray) -> np.ndarray:
    """(L, 8, b) int64: each step's row of ``ROWS`` from the (L, b) feature
    and frame indices, the slots allowed to write and the (b,) conditioning
    frames. With memory stride s only every s-th frame from the
    conditioning frame enters the ring; the forward pass stashes the
    memories of the first R of them to re-seed the ring for the reverse
    pass."""
    r, stride = cfg.num_recent, max(cfg.memory_stride, 1)
    rel = fidx - cond[None, :]
    rows = [gidx, fidx, (fidx // stride) % r, write & (rel % stride == 0),
            fidx % cfg.max_obj_ptrs, write,
            np.clip(rel // stride - 1, 0, r - 1),
            write & (rel >= 1) & (rel <= r * stride) & (rel % stride == 0)]
    return np.stack([np.asarray(v, np.int64) for v in rows], axis=1)


def usable(device: torch.device) -> bool:
    """Whether steps on ``device`` replay CUDA graphs: on a CUDA device."""
    return device.type == "cuda"


class TrackStep:
    """The propagation step of ``b`` slots of one predictor, with its banks,
    buffers and graphs (``SAM2VideoPredictor.track_step``)."""

    def __init__(self, predictor, b: int, pool=None):
        cfg = predictor.cfg
        self.cfg, self.model, self.b = cfg, predictor.model, b
        self.cdt = cdt = predictor.compute_dtype
        self.device = dev = predictor.device
        h, d = cfg.feat_hw, cfg.d_model

        def z(*shape, dtype=cdt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.banks = Banks(
            cond_mem=z(b, cfg.max_cond_frames, h, h, cfg.mem_dim),
            cond_valid=z(b, cfg.max_cond_frames, dtype=torch.bool),
            recent_mem=z(b, cfg.num_recent, h, h, cfg.mem_dim),
            recent_frame=z(b, cfg.num_recent, dtype=torch.long),
            recent_valid=z(b, cfg.num_recent, dtype=torch.bool),
            obj_ptrs=z(b, cfg.max_obj_ptrs, d),
            ptr_frame=z(b, cfg.max_obj_ptrs, dtype=torch.long),
            ptr_valid=z(b, cfg.max_obj_ptrs, dtype=torch.bool))
        self.seed_buf = z(cfg.num_recent, b, h, h, cfg.mem_dim)
        self.inputs = None           # pix / s0 / s1, made at the first gather
        self.row = z(len(ROWS), b, dtype=torch.long)
        self.rows = torch.arange(b, device=dev)
        self.pos = sine_position_encoding(h, h, d, device=dev).to(cdt)[
            None].expand(b, h, h, d)
        self.coords = z(b, 1, 2)
        self.labels = torch.full((b, 1), -1, dtype=torch.long, device=dev)
        self.pool = pool
        self.stream = None
        self.graphs: dict = {}       # key -> (graph, its static outputs)
        self.holder = None           # id of the sequential state banked
        self.reset()

    # ------------------------------------------------------------------
    # The banks
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Empty banks and seed buffer, in place."""
        for f in dataclasses.fields(self.banks):
            t = getattr(self.banks, f.name)
            if f.name.endswith("_frame"):
                t.fill_(FAR)
            else:
                t.zero_()
        self.seed_buf.zero_()
        self.holder = None

    def gather(self, feats: dict, gidx: torch.Tensor) -> list:
        """pix / s0 / s1 of each slot's frame ``feats[k][gidx]`` in the
        compute dtype, into the step's input buffers."""
        if self.inputs is None:
            self.inputs = [torch.empty((self.b,) + feats[k].shape[1:],
                                       dtype=self.cdt, device=self.device)
                           for k in _FEATS]
        for k, buf in zip(_FEATS, self.inputs):
            if feats[k].dtype == buf.dtype:
                torch.index_select(feats[k], 0, gidx, out=buf)
            else:
                buf.copy_(feats[k].index_select(0, gidx))
        return self.inputs

    @torch.no_grad()
    def condition(self, feats: dict, gidx: torch.Tensor, masks: torch.Tensor,
                  frames: torch.Tensor, slot: int = 0) -> torch.Tensor:
        """Consolidate one prompted frame of each slot into conditioning
        slot ``slot``: mask-as-output on the frame's features, the memory
        encode and the bank writes. ``gidx`` / ``frames``: (b,) device
        feature and frame indices; ``masks``: (b, S, S) uint8 prompts.
        Returns the frame's obj_ptr (b, d)."""
        pix, s0, s1 = self.gather(feats, gidx)
        out = self.model.mask_as_output(pix, s0, s1, masks.float())
        mem = self.model.encode_memory(pix, out["high_res_masks"][:, 0])
        banks, rows = self.banks, self.rows
        banks.cond_mem[:, slot] = mem.to(self.cdt)
        banks.cond_valid[:, slot] = True
        pslot = frames % self.cfg.max_obj_ptrs
        banks.obj_ptrs[rows, pslot] = out["obj_ptr"].to(self.cdt)
        banks.ptr_frame[rows, pslot] = frames
        banks.ptr_valid[rows, pslot] = True
        return out["obj_ptr"]

    def reseed(self, cond: np.ndarray, lengths: np.ndarray) -> None:
        """Reverse pass: each slot's recent ring holds the forward pass's
        first post-cond memories of its own video, those of frames before
        the slot's ``lengths``; the rest of the ring is empty."""
        cfg, banks = self.cfg, self.banks
        stride, r = max(cfg.memory_stride, 1), cfg.num_recent
        banks.recent_mem.zero_()
        banks.recent_frame.fill_(FAR)
        banks.recent_valid.zero_()
        for i in range(r):
            f = cond + stride * (i + 1)
            ok = np.nonzero(f < lengths)[0]
            if not ok.size:
                continue
            rows = torch.from_numpy(ok).to(self.device)
            slot = torch.from_numpy((f[ok] // stride) % r).to(self.device)
            banks.recent_mem[rows, slot] = self.seed_buf[i][rows]
            banks.recent_frame[rows, slot] = torch.from_numpy(
                f[ok]).to(self.device)
            banks.recent_valid[rows, slot] = True

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _body(self, reverse: bool) -> tuple:
        """One step on the buffers: condition on the banks, decode, encode
        the new memory and write it and the object pointer where the row's
        gates say so; the forward pass also stashes the seeds. Returns
        (low-res logits (b, 4h, 4w) bf16, obj_ptr (b, d))."""
        cfg, model, cdt, banks = self.cfg, self.model, self.cdt, self.banks
        r, stride = cfg.num_recent, max(cfg.memory_stride, 1)
        x = dict(zip(ROWS, self.row))
        for k in _GATES:
            x[k] = x[k] != 0
        pix, s0, s1 = self.inputs

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
        # temporal-position index in memory-stride units
        tpos = torch.div(tpos + stride - 1, stride,
                         rounding_mode="floor").clamp(1, r)
        conditioned = model.condition_features(
            pix, self.pos, banks.cond_mem, banks.cond_valid,
            banks.recent_mem, rec_ok, tpos, banks.obj_ptrs, ptr_ok)
        out = model.sam_heads(conditioned, s0, s1, self.coords, self.labels,
                              None, cfg.multimask_output_for_tracking,
                              suppress_empty_obj=True)
        mem = model.encode_memory(conditioned,
                                  out["high_res_masks"][:, 0]).to(cdt)
        ptr_new = out["obj_ptr"].to(cdt)

        # per-slot bank writes: each slot writes one bank entry, kept as it
        # was where the row's gate says no
        rows = self.rows

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
            cur = self.seed_buf[x["sslot"], rows]
            self.seed_buf[x["sslot"], rows] = torch.where(
                x["seed"][:, None, None, None], mem, cur)
        return (out["low_res_masks"][:, 0].to(torch.bfloat16),
                out["obj_ptr"])

    def _capture(self, key: tuple) -> tuple:
        """This step eagerly on the side stream, then the body's graph for
        ``key``; returns the eager step's outputs. The capture is confined
        to this thread: a prefetcher may be encoding on another."""
        current = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self._body(key[0])
            graph = torch.cuda.CUDAGraph()
            with capture(graph, self.pool, mode="thread_local"):
                static = self._body(key[0])
        current.wait_stream(self.stream)
        for t in out:
            t.record_stream(current)
        self.graphs[key] = (graph, static)
        return out

    @torch.no_grad()
    @profiling.spanned("trackgen.step")
    def step(self, feats: dict, row: torch.Tensor, reverse: bool) -> tuple:
        """One step of the slots on the schedule row ``row`` ((8, b), a step
        of a pass's uploaded ``schedule``). Returns (low-res logits (b, 4h,
        4w) bf16, obj_ptr (b, d)); a replay's are the graph's outputs,
        which the next step overwrites."""
        profiling.count("trackgen.steps")
        self.gather(feats, row[0])
        self.row.copy_(row)
        if not usable(self.device):
            return self._body(reverse)
        key = (reverse, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        if key not in self.graphs:
            profiling.count("trackgen.graph_captures")
            return self._capture(key)
        graph, out = self.graphs[key]
        graph.replay()
        profiling.count("trackgen.graph_replays")
        return out

    def run_pass(self, feats: dict, sched: np.ndarray, n_on: np.ndarray,
                 reverse: bool, collect: bool = True) -> tuple:
        """Every step of one pass of the (L, 8, b) ``schedule`` ``sched``,
        uploaded once; ``n_on`` (L,) counts each step's tracking slots.
        Returns the steps' (lows (L, b, 4h, 4w) bf16, ptrs (L, b, d)), or
        (None, None) without ``collect``."""
        dev_sched = torch.from_numpy(sched).to(self.device)
        lows = ptrs = None
        for t in range(len(sched)):
            lo, ptr = self.step(feats, dev_sched[t], reverse)
            profiling.count("trackgen.slots", self.b)
            profiling.count("trackgen.slots_active", int(n_on[t]))
            if collect:
                if lows is None:
                    lows = lo.new_empty((len(sched),) + lo.shape)
                    ptrs = ptr.new_empty((len(sched),) + ptr.shape)
                lows[t].copy_(lo)
                ptrs[t].copy_(ptr)
        return lows, ptrs
