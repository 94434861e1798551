"""Operations of SAM2 hiera-L's track-generation work, from the
configuration and the traffic's shapes.

The dense operations (projections, convolutions, the mask decoder's small
attentions) are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference's modules on the meta device at the configured sizes:
nothing runs and nothing of the program is read. The attention calls that
the port routes to its flash kernel (Hiera's global blocks, the memory
attention) are taken out of that count and counted by
``counts/attention.py`` over the keys their masks leave, which a memory
bank simulation gives per tracking step (the port's bank rules: a 6-frame
recent ring and a 16-slot pointer bank keyed by frame index, the reverse
pass reseeded from the forward pass's first post-conditioning frames).
"""

from __future__ import annotations

import contextlib
import functools

from benchmark.counts import attention as attn_counts

_FLASH_SITES = ("benchmark.reference.sam2.hiera",
                "benchmark.reference.sam2.memory")


@contextlib.contextmanager
def _capture_attention(calls: list):
    """Route the flash sites' attention to a recorder that returns an empty
    output, so FlopCounterMode does not count it."""
    import importlib

    import torch

    def record(q, k, v, key_mask=None, **_):
        calls.append((tuple(q.shape), int(k.shape[2]), key_mask is not None,
                      "bf16" if q.dtype == torch.bfloat16 else "fp32"))
        return torch.empty_like(q)

    mods = [importlib.import_module(m) for m in _FLASH_SITES]
    saved = [m.fused_attention for m in mods]
    for m in mods:
        m.fused_attention = record
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.fused_attention = f


def _model(size: str):
    import torch

    from benchmark.models.sam2_hiera_l import sam2_config
    from benchmark.reference.sam2.model import SAM2Model
    with torch.device("meta"):
        return SAM2Model(sam2_config(size))


def _count(fn):
    """(flops by module prefix, attention calls) of ``fn()`` on meta."""
    from torch.utils.flop_counter import FlopCounterMode
    calls: list = []
    with _capture_attention(calls), FlopCounterMode(display=False) as fc:
        fn()
    return fc, calls


@functools.lru_cache(maxsize=None)
def parts(size: str = "large", obj_batch: int = 4) -> dict:
    """Per-unit operations: ``encode`` one frame, ``cond`` one conditioning
    frame of a batch, ``step`` one tracked frame of a batch (dense part),
    each {dtype: flops}, and the attention calls of each."""
    import torch
    model = _model(size)
    cfg = model.cfg
    s, h, b = cfg.image_size, cfg.feat_hw, obj_batch
    d, mem = cfg.d_model, cfg.mem_dim
    meta = dict(device="meta")

    fc, enc_calls = _count(lambda: model.encode_image(
        torch.empty(1, s, s, 3, **meta)))
    total = fc.get_total_flops()
    patch = sum(fc.get_flop_counts().get(
        "SAM2Model.image_encoder.trunk.patch_embed.proj", {}).values())
    if not patch:
        patch = sum(fc.get_flop_counts().get(
            "ImageEncoder.trunk.patch_embed.proj", {}).values())
    encode = {"fp32": float(total - patch), "bf16": float(patch)}

    model.to(torch.bfloat16)   # the port tracks in bf16
    bf = dict(device="meta", dtype=torch.bfloat16)
    pix = torch.empty(b, h, h, d, **bf)
    s0 = torch.empty(b, 4 * h, 4 * h, d // 8, **bf)
    s1 = torch.empty(b, 2 * h, 2 * h, d // 4, **bf)

    def cond():
        out = model.mask_as_output(pix, s0, s1,
                                   torch.empty(b, s, s, **meta))
        model.encode_memory(pix, out["high_res_masks"][:, 0])

    fc, cond_calls = _count(cond)
    cond_f = {"bf16": float(fc.get_total_flops())}

    r, p = cfg.num_recent, cfg.max_obj_ptrs

    def step():
        pos = torch.empty(b, h, h, d, **bf)
        conditioned = model.condition_features(
            pix, pos, torch.empty(b, cfg.max_cond_frames, h, h, mem, **bf),
            torch.ones(b, cfg.max_cond_frames, dtype=torch.bool, **meta),
            torch.empty(b, r, h, h, mem, **bf),
            torch.ones(b, r, dtype=torch.bool, **meta),
            torch.ones(b, r, dtype=torch.long, **meta),
            torch.empty(b, p, d, **bf),
            torch.ones(b, p, dtype=torch.bool, **meta))
        coords = torch.zeros((b, 1, 2), **bf)
        labels = torch.full((b, 1), -1, dtype=torch.long, **meta)
        out = model.sam_heads(conditioned, s0, s1, coords, labels, None,
                              cfg.multimask_output_for_tracking,
                              suppress_empty_obj=True)
        model.encode_memory(conditioned, out["high_res_masks"][:, 0])

    fc, step_calls = _count(step)
    step_f = {"bf16": float(fc.get_total_flops())}
    return {"encode": encode, "encode_attention": enc_calls,
            "cond": cond_f, "cond_attention": cond_calls,
            "step": step_f, "step_attention": step_calls,
            "hw": h * h, "tok_per_ptr": d // mem, "num_recent": r,
            "max_obj_ptrs": p, "cond_slots": cfg.max_cond_frames}


def bank_valid(n_frames: int, cond: int, num_recent: int = 6,
               max_ptrs: int = 16) -> list:
    """(valid memory frames, valid pointers) of each tracked frame of one
    batch conditioned on frame ``cond``: forward to the end, then reverse
    to frame 0, by the port's bank rules (memory stride 1)."""
    out = []
    ring: dict = {}
    ptrs = {cond % max_ptrs: cond}

    def visit(f, reverse):
        def ahead(x):
            return x >= f if reverse else x <= f
        n_rec = sum(1 for x in ring.values()
                    if 1 <= abs(f - x) <= num_recent and ahead(x))
        n_ptr = sum(1 for x in ptrs.values()
                    if abs(f - x) < max_ptrs and ahead(x))
        out.append((n_rec, n_ptr))
        ring[f % num_recent] = f
        ptrs[f % max_ptrs] = f

    for f in range(cond + 1, n_frames):
        visit(f, False)
    ring = {(x % num_recent): x for x in range(cond + 1, min(
        cond + 1 + num_recent, n_frames))}
    for f in range(cond - 1, -1, -1):
        visit(f, True)
    return out


def _attention_items(calls, valid_keys=None):
    """(flops, bytes, dtype) of each captured flash call; a masked call (the
    memory cross-attention) takes ``valid_keys`` per entry."""
    items = []
    for (b, h, lq, d), lk, masked, dt in calls:
        valid = [valid_keys if masked else lk] * b
        f, nb = attn_counts.forward_work(b, h, lq, lk, d, valid, dt,
                                         masked=masked)
        items.append((f, nb, dt))
    return items


def video_work(n_frames: int, cond_frames: list, size: str = "large",
               obj_batch: int = 4) -> dict:
    """Operations of one video: every frame encoded, and one batch of
    ``obj_batch`` objects tracked from each frame of ``cond_frames``.
    Returns {"flops": {dtype: n}, "encode_flops": ..., "track_flops": ...,
    "attention": [(flops, bytes, dtype)]}."""
    pt = parts(size, obj_batch)
    enc = {k: v * n_frames for k, v in pt["encode"].items()}
    attn = _attention_items(pt["encode_attention"]) * n_frames
    track = {"bf16": 0.0}
    for c in cond_frames:
        track["bf16"] += pt["cond"]["bf16"]
        attn += _attention_items(pt["cond_attention"])
        for n_rec, n_ptr in bank_valid(n_frames, c, pt["num_recent"],
                                       pt["max_obj_ptrs"]):
            track["bf16"] += pt["step"]["bf16"]
            keys = (pt["hw"] * (pt["cond_slots"] + n_rec)
                    + pt["tok_per_ptr"] * n_ptr)
            items = _attention_items(pt["step_attention"], keys)
            attn += items
            track["bf16"] += sum(f for f, _, _ in items)
    enc_attn = sum(f for f, _, _ in _attention_items(
        pt["encode_attention"])) * n_frames
    enc["fp32"] += enc_attn
    flops = {"fp32": enc["fp32"], "bf16": enc["bf16"] + track["bf16"]}
    return {"flops": flops, "encode_flops": enc, "track_flops": track,
            "attention": attn}
