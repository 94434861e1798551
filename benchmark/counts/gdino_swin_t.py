"""Operations of text-prompted track generation with GroundingDINO
SwinT-OGC and SAM2 hiera-L, and the deformable sampling kernel's bytes,
from the configuration and the traffic's shapes.

GroundingDINO's dense operations are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the meta device at the configured sizes, one forward per (expression
chunk rows, text tokens); its deformable sampling calls are taken out of
that count and counted here: 2 FLOPs for each of the 4 corners of every
(query, head, level, point) and channel, and bytes as ``chip_smoke.py``'s
bound counts them: the values, the sampling locations, the attention
weights and the output, each once (a gather's FLOPs sit far below the
card's balance point, so bytes bound it). SAM2's image encodes and box
heads (the box prompts) and its video encode and tracks come from
``counts/sam2_hiera_l.py``; a track is charged its slot's share of an
``obj_batch``-slot step, as in the GT-packed cell.
"""

from __future__ import annotations

import contextlib
import functools
import json

from benchmark.counts import peaks

FP32_GATHER_FLOPS = 67e12    # fp32 FMA rate outside the tensor cores
ITEMSIZE = 4


def deform_work(b: int, lq: int, s: int, heads: int, levels: int,
                points: int, head_dim: int, itemsize: int = ITEMSIZE):
    """(flops, bytes) of one deformable sampling call: ``b`` batch rows,
    ``lq`` queries over ``s`` value rows of heads x head_dim channels."""
    c = heads * head_dim
    samples = b * lq * heads * levels * points
    nbytes = (itemsize * b * s * c + 4 * 2 * samples + 4 * samples
              + itemsize * b * lq * c)
    return 2.0 * 4 * samples * head_dim, float(nbytes)


def deform_least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / FP32_GATHER_FLOPS, nbytes / peaks.PEAK_BYTES)


@contextlib.contextmanager
def _capture_deform(calls: list):
    """Route the reference's deformable sampling to a recorder that
    returns an empty output, so FlopCounterMode does not count it."""
    import torch

    from benchmark.reference.gdino import model as gm

    def record(value, shapes, loc, weights):
        b, lq, heads, levels, points, _ = loc.shape
        calls.append((b, lq, int(value.shape[1]), heads, levels, points,
                      int(value.shape[2]) // heads))
        return torch.empty(b, lq, value.shape[2], device=value.device)

    saved = gm.deform_sample
    gm.deform_sample = record
    try:
        yield
    finally:
        gm.deform_sample = saved


@functools.lru_cache(maxsize=None)
def _forward(config_json: str, size: str, rows: int, tokens: int):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.models.gdino_swin_t import gdino_config
    from benchmark.reference.gdino.model import GroundingDINO
    cfg = gdino_config(json.loads(config_json), size)
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    meta = dict(device="meta")
    h, w = cfg.size_target, cfg.size_max
    calls: list = []
    with _capture_deform(calls), FlopCounterMode(display=False) as fc:
        model(torch.empty(1, h, w, 3, **meta),
              torch.ones(1, h, w, dtype=torch.bool, **meta),
              torch.zeros(rows, tokens, dtype=torch.long, **meta),
              torch.ones(rows, tokens, dtype=torch.bool, **meta),
              torch.ones(rows, tokens, tokens, dtype=torch.bool, **meta),
              torch.zeros(rows, tokens, dtype=torch.long, **meta))
    return float(fc.get_total_flops()), tuple(calls)


def grounding_work(config: dict, size: str, rows: int, tokens: int) -> dict:
    """One GroundingDINO forward on ``rows`` texts of ``tokens`` tokens:
    {"flops": fp32 FLOPs, "deform": [(flops, bytes) per sampling call]}."""
    dense, calls = _forward(json.dumps(config, sort_keys=True), size, rows,
                            tokens)
    deform = [deform_work(*c) for c in calls]
    return {"flops": dense + sum(f for f, _ in deform), "deform": deform}


@functools.lru_cache(maxsize=None)
def box_head_flops(size: str) -> float:
    """SAM2's prompt encoder and mask decoder on one box (fp32)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.models.sam2_hiera_l import sam2_config
    from benchmark.reference.sam2.model import SAM2Model
    with torch.device("meta"):
        model = SAM2Model(sam2_config(size))
    cfg = model.cfg
    s, h, d = cfg.image_size, cfg.feat_hw, cfg.d_model
    meta = dict(device="meta")
    with FlopCounterMode(display=False) as fc:
        model.sam_heads(torch.empty(1, h, h, d, **meta),
                        torch.empty(1, 4 * h, 4 * h, d // 8, **meta),
                        torch.empty(1, 2 * h, 2 * h, d // 4, **meta),
                        torch.empty(1, 2, 2, **meta),
                        torch.zeros(1, 2, dtype=torch.long, **meta), None,
                        False)
    return float(fc.get_total_flops())


def video_work(config: dict, unit: dict, size: str = "large") -> dict:
    """One video's operations {"flops": {dtype: n}}, the deformable
    kernel's least time ``deform_least_s`` and the flash attention's
    ``attention_least_s`` (a track's share of its batch's calls), from the
    unit's shapes:
    ``chunks`` (rows, tokens) of each binned frame's forwards,
    ``binned_frames``, ``boxes``, ``frames`` and ``track_frames``."""
    from benchmark.counts import sam2_hiera_l
    obj_batch = int(config["tokens"]["obj_batch"])
    fp32, least = 0.0, 0.0
    for rows, tokens in unit["chunks"]:
        g = grounding_work(config, size, rows, tokens)
        fp32 += g["flops"] * unit["binned_frames"]
        least += unit["binned_frames"] * sum(
            deform_least_seconds(f, b) for f, b in g["deform"])
    images = sam2_hiera_l.video_work(unit["binned_frames"], [], size,
                                     obj_batch)["flops"]
    fp32 += images["fp32"] + unit["boxes"] * box_head_flops(size)
    bf16 = images["bf16"]
    enc = sam2_hiera_l.video_work(unit["frames"], [], size, obj_batch)
    fp32 += enc["flops"]["fp32"]
    bf16 += enc["flops"]["bf16"]
    attention = list(sam2_hiera_l.video_work(
        unit["binned_frames"], [], size, obj_batch)["attention"])
    attention += enc["attention"]
    for n, frames in unit["track_frames"]:
        for f in frames:
            w = sam2_hiera_l.video_work(n, [f], size, obj_batch)
            bf16 += w["track_flops"]["bf16"] / obj_batch
            encodes = len(sam2_hiera_l.video_work(n, [], size,
                                                  obj_batch)["attention"])
            attention += [(fl / obj_batch, nb / obj_batch, dt)
                          for fl, nb, dt in w["attention"][encodes:]]
    return {"flops": {"fp32": fp32, "bf16": bf16}, "deform_least_s": least,
            "attention_least_s": sum(peaks.bound_seconds(fl, nb, dt)
                                     for fl, nb, dt in attention)}
