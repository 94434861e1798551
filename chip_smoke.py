"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero, and no result line prints):

1. Environment: the card's name and power limit, torch and CUDA versions,
   both TF32 flags (set explicitly), and the kernel build time.
2. Kernels: builds every CUDA kernel of the port from the sources in this
   checkout (one nvcc per kernel, all at once), and holds the flash
   kernel against its plain PyTorch
   version on the card at the shapes and types the main path gives it
   (bf16 in memory attention, fp32 at Hiera's global blocks, whose shape
   is checked in bf16 too) and at check shapes in both types (ragged
   head dims, a partial 128-row block, a zero-filled last key tile, masks
   that empty alternate key tiles or all but the last, one batch*head),
   and shows the limits reject a wrong key tile;
   times kernel, plain version, one library call (a yardstick the port
   never calls) and the bound (the least time the card could take).
3. The main path: SAM2 hiera-L (full width, seeded random weights) built by
   tokens_grid's own predictor factory, ``init_state`` + ``run_video`` on 2
   synthetic 12-frame 480x854 videos; checks the written masklets and
   tokens, the census, and that the flash kernel launched at both call
   sites (Hiera's global blocks during the encode, memory attention during
   propagation); then measures how far the bf16-compute encoder's features
   lie from an fp32 model's.
4. A small reference: the same tokens_grid run at SAM2Config.tiny_test on
   the card (fp32, fused thresholds lowered so the kernel runs) against the
   CPU, which runs the kernel's plain version; and the encoder's bf16
   drift at that size.
5. The deformable sampling kernel against its plain version on the card, at
   GroundingDINO's encoder (E = 1 and 4 expressions over the 800x1333
   canvas's four levels) and decoder (E = 4 x 900 queries) shapes in fp32
   and bf16, plus check-only shapes for every branch of the kernel (several
   queries a warp with a ragged last warp, a warp per 32 slots of a wider
   query, 4-, 2- and 1-channel vectors, queries wholly outside the maps, whose
   output must be exactly 0); shows the limits reject a one-pixel shift and
   a dropped point; times kernel, plain version and bound (no single
   PyTorch call computes this function), and gives the rate at which the
   kernel gathers value rows.
6. The GroundingDINO path: Swin-T + BERT-base (GDINOConfig defaults) and
   SAM2 hiera-L with seeded random weights, prompts_gdino.main then
   tokens_gdino.main on a synthetic 12-frame 480x854 video with 3
   expressions; checks the prompt JSON's schema, a tracked prompt per
   expression, the written masklets and tokens, and the kernels' launches
   by call site (deformable: encoder and decoder, 6 + 6 per forward; flash:
   SAM2 image encode, video encode, propagation).
7. A small reference for that path: both stages at GDINOConfig.tiny_test
   and SAM2Config.tiny_test on the card (fp32) against the CPU.
8. The training attention kernels against their plain versions at the
   selection model's three call sites (obj_attn, motion_attn,
   object2lang_attn; fp32, full width, the path's masks), a bf16 check
   shape and three backward check shapes (keys spanning several chunks,
   D 256 in bf16, a batch entry with no valid key): the forward at dropout
   0 and 0.1, the fused backward (dQ, dK, dV) without and with dropout,
   masked keys' gradients exactly zero; shows the limits reject three
   wrong backward results; times each kernel (by call and alone), its
   plain version, a library yardstick and the bound.
9. Selection training at full width through ``sola_torch.train.loop.train``
   (SelectionConfig defaults with the Pallas attention route, a seeded
   random RoBERTa-large, configs/mevis/default.yaml's train values) on a
   synthetic corpus at bench.py's train shapes, 2 epochs: checks log.txt,
   that both checkpoints load strictly and the weights moved, and the
   two kernels' launches at each call site; warm steps/s, pairs/s, peak
   memory and one profiled step.
10. A small reference for training: a tiny config trained 2 epochs on the
   card and on the CPU; log.txt numbers within a tolerance and equal
   confusion counts; a third card run with dS planted without its -delta
   must break that agreement.
11. The grid path from video to J&F: 2 synthetic 12-frame 480x854 videos
   as JPEGs in a MeViS valid_u layout; prompts_grid.main at SAM2 hiera-L
   (32 x 32 points, 256 a chunk, bin 4; IoU and stability gates set from
   the random model's scores on the first frame), tokens_grid.main on its
   prompt JSONs, then cli.eval and cli.inference with a seeded random
   SelectionConfig() checkpoint, random RoBERTa-large and the flash
   attention route. Checks the prompt JSONs, tracks, J&F JSONs and PNGs,
   and the flash launches (3 per binned frame in the AMG, some in eval);
   prompt frames/s with a warm AMG frame's breakdown, object-fps, eval and
   inference seconds, peak memory.
12. A small reference for that path at SAM2Config.tiny_test: the AMG's
   records on the card against the CPU, generate_many against generate
   and the overflow fallback against the single pass on the card
   (exactly), and the eval JSONs and PNGs on the card against the CPU.

The second-to-last line is a JSON object listing every ported kernel; the
line before it is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# H100 SXM datasheet peaks for the inputs' type: bf16 on the tensor cores;
# float32 as 3xTF32 on the tensor cores, 495 / 3 = 165 TFLOP/s. fp32 work
# can be done at full fp32 accuracy that way (the flash forward's fp32 path
# does it), so the least time for it is set by that rate and not by the
# 67 TFLOP/s of fp32 FMAs outside the tensor cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 165e12}
PEAK_BYTES = 3.35e12          # HBM3
FP32_FMA_FLOPS = 67e12        # fp32 FMAs outside the tensor cores (the gather)
# Kernel against its plain version, per shape: the largest error within one
# ulp of the largest |out| in the output's type (bf16 rounds the output and
# P before PV; fp32 allows 128 fp32 ulps for 3xTF32 and the summation
# order), and the RMS error a small share of the output's RMS, so that a
# few mishandled keys (0.1% of a row's keys move its output by about 3% of
# its RMS) fail even where the largest error would hide them.
OUT_MAX_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}
OUT_RMS_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-4               # fp32 lse near log(Lk) ~ 10: ~100 fp32 ulps
# keys per tile of the flash forward (kKeyTile and kKeyTile32 in
# csrc/flash_attn_fwd.cu), the unit of its masked-tile skip
KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}
T_FRAMES, H_VID, W_VID = 12, 480, 854


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_instance(library: str, line: str) -> str:
    """A readable name for the kernel instance a ptxas "Compiling entry
    function" line names: kernel<type, head dims, dropout>."""
    import re
    m = re.search(r"'(_Z\S+)'", line)
    sym = m.group(1) if m else line
    kern = next((k for k in ("flash_fwd_wgmma_kernel", "flash_fwd_tf32_kernel",
                             "flash_bwd_kernel",
                             "ms_deform_fwd_kernel")
                 if k in sym), library)
    args = ["bf16" if "bfloat16" in sym else "float"]
    d = re.search(r"Li(\d+)E", sym)
    if d and kern == "ms_deform_fwd_kernel":
        args.append(f"{d.group(1)} channels a lane")
    elif d:
        args.append(f"D<={d.group(1)}")
    if "Lb1E" in sym:
        args.append("dropout")
    return f"{kern}<{', '.join(args)}>:"


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ops(calls, part: str = "") -> list:
    """(name, us) of the device ops whose name holds ``part`` while each
    callable of ``calls`` runs once under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and part in e.name]


def profiled_ms(make_calls, iters: int, part: str = "",
                traces: int = 3) -> tuple:
    """(device ms a call, records of the fullest trace) of the device ops
    whose name holds ``part`` while the ``iters`` callables of
    ``make_calls()`` run, over ``traces`` torch.profiler traces. A trace
    can drop records (on an H100, traces of 20 one-kernel calls often held
    18 or 19 and once 7, a trace of one call could hold none, and a trace
    of SDPA's backward lost enough of its main kernel to sum to half its
    time), and a record can carry a wrong duration (the mean of three
    traces once read 0.41 ms for a kernel that took 0.33 by CUDA events),
    so each op name counts its median duration over all the traces times
    its launches a call: the most records of that name in one trace over
    ``iters``, rounded up. (None, 0) if no trace holds such an op."""
    durations, most, records = {}, {}, 0
    for _ in range(traces):
        ops = profiled_ops(make_calls(), part)
        records = max(records, len(ops))
        counts = {}
        for name, us in ops:
            durations.setdefault(name, []).append(us)
            counts[name] = counts.get(name, 0) + 1
        for name, n in counts.items():
            most[name] = max(most.get(name, 0), n)
    if not durations:
        return None, 0
    return sum(statistics.median(d) * -(-most[name] // iters)
               for name, d in durations.items()) / 1e3, records


def device_ms(fn, iters: int, part: str):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``part``, over ``iters`` calls, from torch.profiler: the kernels alone,
    without the host time between launches that cuda_ms also counts when a
    call is shorter than its host work. None if the profiler records no
    such kernel."""
    fn()
    torch.cuda.synchronize()
    return profiled_ms(lambda: [fn] * iters, iters, part)[0]


# ---------------------------------------------------------------------------
# phase 2: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def memory_cross_mask(b: int, gen) -> torch.Tensor:
    """(B, 28,736) key mask of memory cross-attention: 7 frame slots of 4096
    spatial keys then 16 pointers x 4 tokens; 3 of the 7 slots and half the
    pointers invalid, key 0 valid (model.condition_features's rule)."""
    slots = torch.ones(b, 7, dtype=torch.bool)
    slots[:, 4:] = False
    ptrs = torch.rand(b, 16, generator=gen) < 0.5
    mask = torch.cat([slots.repeat_interleave(4096, 1),
                      ptrs.repeat_interleave(4, 1)], dim=1)
    mask[:, 0] = True
    return mask.cuda()


def attention_cases(gen):
    """(name, site, dtype, b, h, lq, lk, d, mask) at the main path's shapes
    and types: memory attention runs in bf16; Hiera's global blocks run in
    fp32 (the encoder computes in fp32 after its patch embedding, as in the
    JAX package), and are checked in bf16 too."""
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [("memory_cross", "memory", bf16, 4, 1, 4096, 28736, 256,
              memory_cross_mask(4, gen)),
             ("memory_self", "memory", bf16, 4, 1, 4096, 4096, 256, None),
             ("hiera_l_global", "hiera", fp32, 4, 8, 4096, 4096, 72, None),
             # the image predictor's batch-1 encode (the AMG, gdino prompts)
             ("hiera_l_global_b1", "hiera", fp32, 1, 8, 4096, 4096, 72,
              None),
             ("hiera_l_global_bf16", "check", bf16, 4, 8, 4096, 4096, 72,
              None)]
    for d in (56, 96):
        m = torch.rand(2, 130, generator=gen) > 0.3
        m[:, 0] = True
        cases.append((f"ragged_d{d}", "check", bf16, 2, 2, 100, 130, d,
                      m.cuda()))
    lead = torch.rand(2, 300, generator=gen) > 0.5
    lead[:, :200] = False  # the kernel skips these key tiles
    cases.append(("masked_lead_tiles", "check", bf16, 2, 2, 100, 300, 72,
                  lead.cuda()))
    full = torch.ones(2, 130, dtype=torch.bool)
    full[1] = False  # every key of batch entry 1 masked
    cases.append(("fully_masked_row", "check", bf16, 2, 2, 100, 130, 72,
                  full.cuda()))
    # in both types: a partial 128-row block (Lq 100) over a last key tile
    # that TMA zero-fills (Lk 130); key tiles valid, three empty, valid, ...,
    # and for one batch entry only the ragged last tile; one batch*head
    for dtype, tag in ((bf16, "bf16"), (fp32, "fp32")):
        for d in (72, 256):
            cases.append((f"partial_block_d{d}_{tag}", "check", dtype, 2, 2,
                          100, 130, d, None))
        cases.append((f"alternating_tiles_{tag}", "check", dtype, 2, 2, 200,
                      583, 256, alternating_tile_mask(dtype, 583, gen)))
        cases.append((f"one_head_{tag}", "check", dtype, 1, 1, 100, 130, 72,
                      None))
    return cases


def alternating_tile_mask(dtype, lk: int, gen) -> torch.Tensor:
    """(2, lk) mask over the kernel's key tiles of ``dtype``: entry 0 has
    valid keys in tiles 0, 4, 8, ... and none in the others; entry 1 only
    in the ragged last tile."""
    tile = KEY_TILE[dtype]
    mask = torch.zeros(2, lk, dtype=torch.bool)
    for t0 in range(0, lk, 4 * tile):
        keys = torch.rand(min(tile, lk - t0), generator=gen) > 0.5
        keys[0] = True
        mask[0, t0:t0 + len(keys)] = keys
    last = (lk - 1) // tile * tile
    mask[1, last:] = torch.rand(lk - last, generator=gen) > 0.5
    mask[1, lk - 1] = True
    return mask.cuda()


def keys_taking_part(b, lk, mask) -> int:
    """Keys that take part, summed over the batch entries: an entry's valid
    keys (a masked key adds exactly zero and its K and V rows are never
    needed), or all Lk for an entry with none (a fully masked row averages
    all keys)."""
    if mask is None:
        return b * lk
    valid = mask.sum(dim=1)
    return int(torch.where(valid > 0, valid, torch.full_like(valid, lk)).sum())


def attention_work(b, h, lq, lk, d, mask, itemsize):
    """(flops, bytes) the function needs on these inputs: 4 FLOPs per
    (query, key that takes part, d); Q read and O written once, K and V
    read once over the keys that take part, lse written and the mask read
    once."""
    keys = keys_taking_part(b, lk, mask)
    flops = 4.0 * h * lq * d * keys
    nbytes = (itemsize * (2 * b * h * lq * d + 2 * h * keys * d)
              + 4 * b * h * lq + (0 if mask is None else b * lk))
    return flops, nbytes


def out_errors(out, ref, dtype):
    """(max error, its limit, RMS error, its limit) of ``out`` against the
    fp32 ``ref``."""
    diff = out.float() - ref
    return (diff.abs().max().item(),
            OUT_MAX_REL[dtype] * ref.abs().max().item(),
            diff.square().mean().sqrt().item(),
            OUT_RMS_REL[dtype] * ref.square().mean().sqrt().item())


def check_flash_kernel(fa, gen) -> dict:
    import torch.nn.functional as F
    rows = []
    for name, site, dtype, b, h, lq, lk, d, mask in attention_cases(gen):
        q, k, v = (torch.randn(b, h, n, d, generator=gen).cuda().to(dtype)
                   for n in (lq, lk, lk))
        out, lse = fa.fused_attention_lse(q, k, v, mask)
        torch.cuda.synchronize()
        ref, ref_lse = fa.attention_reference(q, k, v, mask)
        ref = ref.float()
        err, tol, rms_err, rms_tol = out_errors(out, ref, dtype)
        ref_max = ref.abs().max().item()
        ref_rms = ref.square().mean().sqrt().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= tol and rms_err <= rms_tol and lse_err <= LSE_ATOL
                and torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version: out max "
                f"{err} (tol {tol}), out rms {rms_err} (tol {rms_tol}), "
                f"lse {lse_err} (tol {LSE_ATOL})")
        # the limits must reject a kernel that gets one 64-key tile wrong:
        # its mask inverted, or, unmasked, the tile dropped
        wrong = torch.ones(b, lk, dtype=torch.bool, device=q.device)
        if mask is None:
            wrong[:, 64:128] = False
        else:
            wrong = mask.clone()
            wrong[:, -64:] = ~wrong[:, -64:]
        w_err, _, w_rms, _ = out_errors(
            fa.attention_reference(q, k, v, wrong)[0], ref, dtype)
        if w_err <= tol and w_rms <= rms_tol:
            raise AssertionError(f"{name}: the limits accept a wrong tile "
                                 f"(max {w_err}, rms {w_rms})")
        big = lq * lk >= 1 << 24
        iters = 5 if big else 20
        ms = cuda_ms(lambda: fa.fused_attention_lse(q, k, v, mask), iters)
        plain_ms = cuda_ms(lambda: fa.attention_reference(q, k, v, mask),
                           3 if big else 10)
        attn_mask = None if mask is None else mask[:, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask), iters)
        flops, nbytes = attention_work(b, h, lq, lk, d, mask, q.element_size())
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"shape": name, "site": site, "dtype": str(dtype), "b": b,
               "h": h, "lq": lq, "lk": lk, "d": d,
               "masked": mask is not None, "max_abs_err": err,
               "max_abs_tol": tol, "rms_err": rms_err, "rms_tol": rms_tol,
               "ref_max_abs": ref_max, "ref_rms": ref_rms,
               "wrong_tile_max_abs_err": w_err, "wrong_tile_rms_err": w_rms,
               "lse_max_abs_err": lse_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / ms / 1e9}
        rows.append(row)
        log(f"  {name:>19} {str(dtype)[6:]} b={b} h={h} lq={lq} lk={lk} "
            f"d={d} masked={row['masked']}: out max err {err:.3g} (tol "
            f"{tol:.3g}, max |ref| {ref_max:.3g}), rms err {rms_err:.3g} "
            f"(tol {rms_tol:.3g}, rms ref {ref_rms:.3g}; a wrong tile "
            f"gives max {w_err:.3g} rms {w_rms:.3g}), lse err "
            f"{lse_err:.3g} (tol {LSE_ATOL}); kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), "
            f"{row['tflops']:.1f} TFLOP/s")
        del q, k, v, out, lse, ref, ref_lse
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phase 5: the deformable sampling kernel against its plain version
# ---------------------------------------------------------------------------

# GroundingDINO's level shapes on its 800x1333 canvas (Swin-T strides 8, 16,
# 32 and the extra stride-64 conv): no side is a multiple of any tile
GDINO_LEVELS = ((100, 167), (50, 84), (25, 42), (13, 21))


def deform_inputs(gen, b, lq, levels, heads, head_dim, points, dtype,
                  encoder: bool, outside: int = 0):
    """Values, locations and weights as the path hands them to the kernel:
    encoder queries sample near their own position (their reference point
    plus a few pixels of offset), decoder queries near random boxes; one
    location in eight is drawn over [-0.2, 1.2], so corners fall outside
    the map. Weights are softmaxed over levels x points. With ``outside``,
    every location of the queries in ``outside_queries`` lies right of
    every map (x in [1.3, 2], all four corners out)."""
    n_lv = len(levels)
    s = sum(h * w for h, w in levels)
    value = torch.randn(b, s, heads * head_dim, generator=gen)
    if encoder:
        refs = []
        for h, w in levels:
            gy, gx = torch.meshgrid((torch.arange(h) + 0.5) / h,
                                    (torch.arange(w) + 0.5) / w,
                                    indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        ref = torch.cat(refs)[:lq]
    else:
        ref = torch.rand(lq, 2, generator=gen)
    px = torch.tensor([[1.0 / w, 1.0 / h] for h, w in levels])
    loc = (ref[None, :, None, None, None, :]
           + 2.0 * torch.randn(b, lq, heads, n_lv, points, 2, generator=gen)
           * px[None, None, None, :, None, :])
    wild = torch.rand(b, lq, heads, n_lv, points, 1, generator=gen) < 0.125
    loc = torch.where(wild, torch.rand(loc.shape, generator=gen) * 1.4 - 0.2,
                      loc)
    if outside:
        out_q = outside_queries(lq, outside)
        loc[:, out_q, ..., 0] = 1.3 + 0.7 * torch.rand(
            loc[:, out_q, ..., 0].shape, generator=gen)
    wgt = torch.softmax(torch.randn(b, lq, heads, n_lv * points,
                                    generator=gen), -1).reshape(
        b, lq, heads, n_lv, points)
    return (value.cuda().to(dtype), loc.cuda(), wgt.cuda().to(dtype))


def outside_queries(lq: int, every: int) -> list:
    """The queries deform_inputs puts wholly outside the maps: every
    ``every``-th one and the last."""
    return sorted(set(range(every - 1, lq, every)) | {lq - 1})


def deform_cases():
    """(name, site, dtype, b, lq, levels, heads, head_dim, points, encoder,
    outside) at the main path's shapes: the encoder's self-attention over
    every position of the canvas (E = 1 and E = 4 expressions) and the
    decoder's 900 queries (E = 4), fp32 (the CLI default) and bf16
    (--bf16); then check-only shapes for the kernel's other branches: a
    query's heads x vectors below 32 lanes (several queries a warp, a
    ragged last warp), above 32 (8 heads x 64: two warps), head dims that
    take 4-, 2- and 1-channel vectors (20, 6, 13), more than 32 level x
    point terms, and queries with every location outside the maps."""
    lq_enc = sum(h * w for h, w in GDINO_LEVELS)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        tag = "" if dtype == f32 else "_bf16"
        cases += [(f"encoder_e1{tag}", "encoder", dtype, 1, lq_enc,
                   GDINO_LEVELS, 8, 32, 4, True, 0),
                  (f"encoder_e4{tag}", "encoder", dtype, 4, lq_enc,
                   GDINO_LEVELS, 8, 32, 4, True, 0),
                  (f"decoder_e4{tag}", "decoder", dtype, 4, 900,
                   GDINO_LEVELS, 8, 32, 4, False, 0)]
    small = ((23, 37), (12, 19), (6, 10))
    cases += [("ragged_d16", "check", f32, 2, 333, small, 2, 16, 3, False, 0),
              ("ragged_d48_bf16", "check", bf16, 2, 333, small, 3, 48, 3,
               False, 0),
              ("terms_40", "check", f32, 2, 300, small + ((3, 5),), 4, 32, 10,
               False, 0),
              ("heads8_d64", "check", f32, 2, 300, small, 8, 64, 4, False,
               0),
              ("ragged_d20", "check", f32, 2, 333, small, 2, 20, 3, False, 0),
              ("ragged_d20_bf16", "check", bf16, 2, 333, small, 2, 20, 3,
               False, 0),
              ("ragged_d6", "check", f32, 2, 333, small, 3, 6, 3, False, 0),
              ("ragged_d13_bf16", "check", bf16, 2, 333, small, 2, 13, 3,
               False, 0),
              ("outside_d16_bf16", "check", bf16, 2, 333, small, 2, 16, 3,
               False, 7)]
    return cases


def gathered_rows(loc, wgt, levels) -> int:
    """Value rows (of head_dim channels) the kernel loads: the corners whose
    weight attn_w * corner_w is not 0 (a zero-weight corner is skipped)."""
    from sola_torch.trackgen.gdino.deformable import corner_terms
    rows = 0
    for lvl, (h, w) in enumerate(levels):
        _, cw = corner_terms(loc[:, :, :, lvl], h, w)
        rows += int(((cw * wgt[:, :, :, lvl, :, None].float()) != 0).sum())
    return rows


def check_deform_kernel(gen) -> dict:
    from sola_torch.ops import deformable_interp as di
    from sola_torch.trackgen.gdino.deformable import ms_deform_attn_core
    rows = []
    for (name, site, dtype, b, lq, levels, heads, hd, points, encoder,
         outside) in deform_cases():
        value, loc, wgt = deform_inputs(gen, b, lq, levels, heads, hd,
                                        points, dtype, encoder, outside)
        out = di.ms_deform_attn(value, loc, wgt, levels)
        torch.cuda.synchronize()
        ref = ms_deform_attn_core(value, loc, wgt, levels).float()
        err, tol, rms_err, rms_tol = out_errors(out, ref, dtype)
        if not (err <= tol and rms_err <= rms_tol
                and torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version: max "
                f"{err} (tol {tol}), rms {rms_err} (tol {rms_tol})")
        if outside and out[:, outside_queries(lq, outside)].any():
            raise AssertionError(f"{name}: queries sampling only outside "
                                 f"the maps give a nonzero output")
        # the limits must reject a wrong kernel output: level 0's samples
        # shifted by one pixel in x, or point 0's weight dropped
        w0 = levels[0][1]
        shifted = loc.clone()
        shifted[:, :, :, 0, :, 0] += 1.0 / w0
        dropped = wgt.clone()
        dropped[:, :, :, :, 0] = 0
        wrong = {}
        for what, (l_, w_) in (("shift", (shifted, wgt)),
                               ("drop", (loc, dropped))):
            e, _, r, _ = out_errors(ms_deform_attn_core(value, l_, w_,
                                                        levels), ref, dtype)
            if e <= tol and r <= rms_tol:
                raise AssertionError(f"{name}: the limits accept a wrong "
                                     f"output ({what}: max {e}, rms {r})")
            wrong[what] = (e, r)
        ms = cuda_ms(lambda: di.ms_deform_attn(value, loc, wgt, levels), 20)
        kernel_ms = device_ms(
            lambda: di.ms_deform_attn(value, loc, wgt, levels), 20,
            "ms_deform")
        plain_ms = cuda_ms(lambda: ms_deform_attn_core(value, loc, wgt,
                                                       levels), 5)
        # bytes: each input read once at the type the path hands it over,
        # the output written once; 2 FLOPs per gathered element are far
        # below the card's balance point, so bytes bound it
        nbytes = (value.numel() * value.element_size()
                  + loc.numel() * loc.element_size()
                  + wgt.numel() * wgt.element_size()
                  + out.numel() * out.element_size())
        flops = 2.0 * 4 * b * lq * heads * len(levels) * points * hd
        # what the kernel gathers out of L2 / L1: a row of head_dim
        # channels for each corner of nonzero weight
        gathered = gathered_rows(loc, wgt, levels) * hd * value.element_size()
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / FP32_FMA_FLOPS * 1e3
        row = {"shape": name, "site": site, "dtype": str(dtype), "b": b,
               "lq": lq, "levels": [list(hw) for hw in levels],
               "heads": heads, "head_dim": hd, "points": points,
               "max_abs_err": err, "max_abs_tol": tol, "rms_err": rms_err,
               "rms_tol": rms_tol,
               "ref_max_abs": ref.abs().max().item(),
               "ref_rms": ref.square().mean().sqrt().item(),
               "wrong_shift_max_rms": wrong["shift"],
               "wrong_drop_max_rms": wrong["drop"],
               "ms": ms, "device_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "gb_per_s": nbytes / ms / 1e6, "gathered_bytes": gathered,
               "gathered_gb_per_s": gathered / (kernel_ms or ms) / 1e6}
        rows.append(row)
        log(f"  {name:>16} {str(dtype)[6:]} b={b} lq={lq} heads={heads} "
            f"d={hd} L={len(levels)} P={points}: max err {err:.3g} (tol "
            f"{tol:.3g}), rms err {rms_err:.3g} (tol {rms_tol:.3g}); a "
            f"1-px shift gives max/rms {wrong['shift'][0]:.3g}/"
            f"{wrong['shift'][1]:.3g}, a dropped point "
            f"{wrong['drop'][0]:.3g}/{wrong['drop'][1]:.3g}; kernel_ms "
            f"{ms:.4f} (kernel alone {kernel_ms or float('nan'):.4f}) "
            f"plain_ms {plain_ms:.4f} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), "
            f"{row['gb_per_s']:.0f} GB/s of unique bytes, "
            f"{row['gathered_gb_per_s']:.0f} GB/s gathered (kernel alone)")
        del value, loc, wgt, out, ref
    torch.cuda.empty_cache()
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phases 6 and 7: the GroundingDINO path, prompts_gdino -> tokens_gdino
# ---------------------------------------------------------------------------

GD_BIN = 4
GD_EXPRESSIONS = {"0": {"exp": "the red box moving right", "anno_id": [0]},
                  "1": {"exp": "a green ellipse", "anno_id": [1]},
                  "2": {"exp": "the blue square moving up", "anno_id": [2]}}
PROMPT_KEYS = {"segmentation", "stability_score", "score", "area",
               "area_ratio", "frame_idx", "pred_bbox", "pred_phrase",
               "token_score", "expression_id", "metrics", "prompt_id"}


class SiteCounter:
    """How much a kernel wrapper's launch counter grew while given modules
    ran their forwards, by call site. The wrapper alone counts; the hooks
    only read its counter before and after each forward."""

    def __init__(self, counter_module):
        self.mod = counter_module
        self.counts = {}
        self._starts = []

    def watch(self, site: str, modules) -> None:
        self.counts.setdefault(site, 0)
        for m in modules:
            m.register_forward_pre_hook(
                lambda *_: self._starts.append(self.mod.launches))
            m.register_forward_hook(lambda *_, site=site: self._add(site))

    def _add(self, site: str) -> None:
        self.counts[site] += self.mod.launches - self._starts.pop()

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.counts, 0)


def deform_sites(grounding) -> SiteCounter:
    """The deformable kernel's launches at GroundingDINO's encoder and
    decoder (each MSDeformAttn module of either)."""
    from sola_torch.ops import deformable_interp as di
    from sola_torch.trackgen.gdino.deformable import MSDeformAttn
    sites = SiteCounter(di)
    for site in ("encoder", "decoder"):
        sites.watch(site, [m for n, m in grounding.model.named_modules()
                           if isinstance(m, MSDeformAttn)
                           and n.startswith(f"model.{site}.")])
    return sites


def write_workspace(root: str, vid: str, frames, masks) -> None:
    """A MeViS-layout valid_u split of one video: lossless PNG frames,
    meta_expressions.json with GD_EXPRESSIONS, and mask_dict.json holding
    each object's per-frame RLE (the GT the prompt stage tags IoU with)."""
    from PIL import Image

    from sola_torch.core import rle
    data_dir = os.path.join(root, "datasets", "mevis", "valid_u")
    frames_dir = os.path.join(data_dir, "JPEGImages", vid)
    os.makedirs(frames_dir)
    for t, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(frames_dir, f"{t:05d}.png"))
    with open(os.path.join(data_dir, "meta_expressions.json"), "w") as f:
        json.dump({"videos": {vid: {
            "frames": [f"{t:05d}" for t in range(len(frames))],
            "expressions": GD_EXPRESSIONS}}}, f)
    annos = {a for e in GD_EXPRESSIONS.values() for a in e["anno_id"]}
    with open(os.path.join(data_dir, "mask_dict.json"), "w") as f:
        json.dump({str(a): [rle.encode(m[a]) for m in masks] for a in annos},
                  f)


def box_gate(grounding, frame, keep: int) -> float:
    """A box threshold that keeps about ``keep`` boxes per expression on
    ``frame``: random weights score almost every query above the CLI's
    0.2. Halfway between the keep-th and the next score, and the least of
    these over the expressions, so each keeps at least ``keep``."""
    texts = [e["exp"] for e in GD_EXPRESSIONS.values()]
    gates = []
    for preds in grounding.get_boxes_many(frame, texts, box_threshold=-1.0):
        s = sorted((max(p["token_score"]) for p in preds), reverse=True)
        gates.append(0.5 * (s[keep - 1] + s[keep]))
    return min(gates)


def stability_gate(info: dict) -> float:
    """A stability threshold that lets about half of each expression's
    prompts reach propagation (random weights give low stability scores):
    halfway between the two middle scores, the least over the
    expressions."""
    gates = []
    for e in GD_EXPRESSIONS:
        s = sorted(p["stability_score"] for p in info["prompt_masks"]
                   if p["expression_id"] == e)
        k = len(s) // 2
        gates.append(s[0] if k == 0 else 0.5 * (s[k - 1] + s[k]))
    return min(gates)


def check_prompt_json(info: dict, vid: str, n_frames: int, hw) -> dict:
    """The prompt JSON's schema and invariants; returns the box count of
    each (frame, expression)."""
    from sola_torch.core import rle
    pms = info["prompt_masks"]
    if info["video_id"] != vid or info["bin_size"] != GD_BIN or not pms:
        raise AssertionError(f"prompt JSON head: {info['video_id']} "
                             f"{info['bin_size']} {len(pms)} prompts")
    counts = {}
    for i, p in enumerate(pms):
        annos = {str(a) for a in
                 GD_EXPRESSIONS[p["expression_id"]]["anno_id"]}
        m = rle.decode(p["segmentation"])
        if (set(p) != PROMPT_KEYS or p["prompt_id"] != i
                or p["frame_idx"] % GD_BIN or p["frame_idx"] >= n_frames
                or m.shape != tuple(hw) or m.sum() != p["area"]
                or not np.isfinite(p["pred_bbox"]).all()
                or len(p["pred_bbox"]) != 4 or set(p["metrics"]) != annos
                or not all(0.0 <= v["iou"] <= 1.0
                           for v in p["metrics"].values())):
            raise AssertionError(f"prompt {i} breaks the schema: "
                                 f"{ {k: v for k, v in p.items() if k != 'segmentation'} }")
        key = f"{p['frame_idx']}/{p['expression_id']}"
        counts[key] = counts.get(key, 0) + 1
    areas = [p["area"] for p in pms]
    if areas != sorted(areas, reverse=True):
        raise AssertionError("prompts are not sorted by area")
    if {p["expression_id"] for p in pms} != set(GD_EXPRESSIONS):
        raise AssertionError(f"an expression has no prompt: {counts}")
    return counts


def check_gdino_tracks(root: str, vid: str, census: dict, n_frames: int,
                       hw, d_model: int) -> dict:
    """Every expression tracked at least one prompt, and its written
    masklets and tokens match its census; returns the tracks."""
    from sola_torch.core import rle
    from sola_torch.data import tracks
    out = {}
    for e in GD_EXPRESSIONS:
        c = census[e]
        if not 1 <= c["n_tracked"] <= c["n_total"]:
            raise AssertionError(f"expression {e} census: {c}")
        recs = tracks.load_track_records(
            os.path.join(root, "sam2_tracks"), "gdino_tracks", "mevis",
            "valid_u", vid, expression_id=e, use_index=False)
        if sorted(r.sam2_anno_id for r in recs) != sorted(
                c["tracked_prompt_ids"]):
            raise AssertionError(f"expression {e}: written tracks differ "
                                 f"from the census")
        for rec in recs:
            with open(rec.masklet_path) as f:
                masklet = rle.decode_masklet(json.load(f)["rle"])
            toks = np.load(rec.token_path)
            if (masklet.shape != (n_frames, *hw)
                    or toks.shape != (n_frames, d_model)
                    or not np.isfinite(toks).all()):
                raise AssertionError(f"expression {e} track "
                                     f"{rec.sam2_anno_id}: masklet "
                                     f"{masklet.shape}, tokens {toks.shape}")
            out[(e, rec.sam2_anno_id)] = (masklet, toks)
    return out


def _cli_argv(root: str, device: str) -> list:
    return ["--data_root", root, "--output_root", root, "--data_type",
            "valid_u", "--bin_size", str(GD_BIN), "--device", device]


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def prompt_json_path(root: str, vid: str) -> str:
    return os.path.join(root, "sam2_prompts", "gdino_prompts", "mevis",
                        "valid_u", f"{vid}.json")


def prompts_stage(root: str, vid: str, frames, masks, grounding, image_pred,
                  device: str, box_thr: float):
    """prompts_gdino.main over a fresh one-video workspace, the given
    models behind its generator factory: (prompt JSON, seconds)."""
    from sola_torch.trackgen import prompts_gdino
    write_workspace(root, vid, frames, masks)
    t0 = time.perf_counter()
    prompts_gdino.main(
        _cli_argv(root, device) + ["--box_threshold", repr(box_thr)],
        generator_factory=lambda: prompts_gdino.PromptGenerator(
            grounding, image_pred, box_threshold=box_thr))
    _sync(device)
    seconds = time.perf_counter() - t0
    with open(prompt_json_path(root, vid)) as f:
        return json.load(f), seconds


def tokens_stage(root: str, vid: str, video_pred, device: str,
                 stab_thr: float):
    """tokens_gdino.main on the workspace's prompt JSON, the given
    predictor behind its factory: (the video's census, seconds)."""
    from sola_torch.trackgen import tokens_gdino
    t0 = time.perf_counter()
    tokens_gdino.main(_cli_argv(root, device) + [
        "--batch_size", "4", "--stability_score_thresh", repr(stab_thr)],
        predictor_factory=lambda: video_pred)
    _sync(device)
    seconds = time.perf_counter() - t0
    with open(os.path.join(root, "sam2_tracks", "gdino_tracks", "mevis",
                           "valid_u", "runtime_info.json")) as f:
        return json.load(f)[vid], seconds


def host_ms(fn, iters: int = 3) -> float:
    """Mean wall ms of ``fn`` over ``iters`` runs, each ended by a
    synchronize, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_forward(fn, kernels_of=(("deform", "ms_deform"),)) -> dict:
    """One warm run of ``fn`` under torch.profiler: the device's busy time
    (the union of its kernels' intervals) against the host's wall time of
    the run, and for each (label, name part) of ``kernels_of`` the time of
    the kernels whose name holds that part and its share of the busy time,
    and the 8 kernel names that take the most time. None where the profiler
    records no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    if not kernels:
        return {"wall_ms": wall_us / 1e3, "busy_ms": None,
                "idle_share": None, "kernels": 0,
                **{f"{label}_ms": None for label, _ in kernels_of}}
    busy, end = 0.0, -1.0
    for s, e, _ in kernels:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for s, e, n in kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us, "kernels": len(kernels),
           "top_kernels_ms": sorted(by_name.items(), key=lambda x: -x[1])[:8]}
    for label, part in kernels_of:
        t = sum(e - s for s, e, n in kernels if part in n)
        out[f"{label}_ms"] = t / 1e3
        out[f"{label}_share_of_busy"] = t / busy
        out[f"{label}_launches"] = sum(part in n for _, _, n in kernels)
    return out


def gdino_breakdown(grounding, image_pred, frame) -> dict:
    """Where a binned frame's time goes, warm, at the path's shapes: the
    GroundingDINO forward over the 3 expressions (padded to 4), the SAM2
    image encode, and the box -> mask decode of 12 boxes; and one
    profiled forward."""
    texts = [e["exp"] for e in GD_EXPRESSIONS.values()]
    boxes = np.array([[40 + 60 * i, 30 + 30 * (i % 4), 200 + 50 * i,
                       200 + 20 * (i % 5)] for i in range(12)], np.float32)

    def forward():
        grounding.enqueue_boxes(frame, texts)

    image_pred.set_image(frame)
    out = {"gdino_forward_ms": host_ms(forward),
           "sam2_image_encode_ms": host_ms(lambda: image_pred.set_image(
               frame)),
           "box_to_mask_12_ms": host_ms(lambda: image_pred.predict_packed(
               box=boxes)),
           "gdino_forward_profile": profile_forward(forward)}
    return out


def run_gdino_path(fa, di) -> dict:
    """Phase 6: GroundingDINO Swin-T + BERT-base (GDINOConfig defaults) and
    SAM2 hiera-L, seeded random weights, built by the CLIs' own loaders;
    prompts_gdino -> tokens_gdino on a synthetic 480x854 video."""
    from sola_torch.trackgen import tokens_grid
    from sola_torch.trackgen.gdino.model import load_grounding_dino
    from sola_torch.trackgen.sam2.convert import load_sam2_image_predictor
    sam2_ckpt = "pretrained_models/sam2_hiera_large.pt"  # absent: random
    t0 = time.perf_counter()
    grounding = load_grounding_dino(
        "pretrained_models/groundingdino_swint_ogc.pth", device="cuda")
    image_pred = load_sam2_image_predictor(sam2_ckpt, device="cuda")
    video_pred = tokens_grid._default_predictor_factory(
        sam2_ckpt, obj_batch=4, device="cuda")()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gcfg = grounding.cfg
    log(f"  GroundingDINO: Swin embed {gcfg.swin.embed_dim} depths "
        f"{gcfg.swin.depths}, text {gcfg.text.num_layers} x "
        f"{gcfg.text.hidden_size}, d_model {gcfg.d_model}, "
        f"{gcfg.enc_layers}+{gcfg.dec_layers} layers, {gcfg.num_queries} "
        f"queries, {sum(p.numel() for p in grounding.model.parameters()) / 1e6:.1f}M"
        f" params; SAM2 image {image_pred.cfg.image_size} px, video "
        f"obj_batch {video_pred.obj_batch}; built in {build_s:.1f} s")
    dsites = deform_sites(grounding)
    fsites = SiteCounter(fa)
    fsites.watch("image_encode", [image_pred.model.image_encoder])
    fsites.watch("video_encode", [video_pred.model.image_encoder])
    vid = "synthetic_gdino"
    frames, masks = synthetic_video(5)
    # the probe warms GroundingDINO up; one box -> mask call warms SAM2's
    # image predictor, so the path below is timed warm
    box_thr = box_gate(grounding, frames[0], keep=3)
    image_pred.set_image(frames[0])
    image_pred.predict_packed(box=np.array([[100, 80, 260, 200]],
                                           np.float32))
    root = os.path.join(OUT_DIR, "gdino")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = di.launches = 0  # the path's counts start here
    dsites.reset()
    fsites.reset()
    info, prompts_s = prompts_stage(root, vid, frames, masks, grounding,
                                    image_pred, "cuda", box_thr)
    stab_thr = stability_gate(info)
    census, tokens_s = tokens_stage(root, vid, video_pred, "cuda", stab_thr)
    launches = {"flash_attn_fwd": fa.launches,
                "ms_deform_attn_fwd": di.launches}  # read right after
    deform, flash = dict(dsites.counts), dict(fsites.counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    counts = check_prompt_json(info, vid, T_FRAMES, (H_VID, W_VID))
    check_gdino_tracks(root, vid, census, T_FRAMES, (H_VID, W_VID),
                       video_pred.cfg.d_model)
    binned = len(range(0, T_FRAMES, GD_BIN))
    chunks = binned * -(-len(GD_EXPRESSIONS) // grounding.max_expr_batch)
    want = {"encoder": gcfg.enc_layers * chunks,
            "decoder": gcfg.dec_layers * chunks}
    flash["propagation"] = launches["flash_attn_fwd"] - sum(flash.values())
    if (deform != want
            or sum(deform.values()) != launches["ms_deform_attn_fwd"]
            or min(flash.values()) <= 0):
        raise AssertionError(f"kernel launches: deformable {deform} "
                             f"(want {want}) of "
                             f"{launches['ms_deform_attn_fwd']}, flash "
                             f"{flash}")
    tracked = sum(c["n_tracked"] for c in census.values())
    track_s = sum(c["time"] for c in census.values())
    row = {"box_threshold": box_thr,
           "stability_score_thresh": stab_thr,
           "boxes_per_frame_expression": counts,
           "n_prompts": len(info["prompt_masks"]),
           "census": {e: {k: c[k] for k in ("n_tracked", "n_filtered",
                                             "n_not_used", "n_total")}
                      for e, c in census.items()},
           "prompts_main_s": prompts_s,
           "prompt_frames_per_s": binned / prompts_s,
           "tokens_main_s": tokens_s,
           "tracking_s": track_s,
           "object_fps": tracked * T_FRAMES / track_s,
           "launches": launches, "deform_launches": deform,
           "flash_launches": flash, "peak_memory_gb": peak_gb,
           "build_s": build_s,
           "breakdown": gdino_breakdown(grounding, image_pred, frames[0])}
    log(f"  box_threshold {box_thr:.6f} (keeps >= 3 boxes per "
        f"expression on frame 0), stability_score_thresh "
        f"{stab_thr:.6f}; boxes per frame/expression "
        f"{counts}")
    log(f"  prompts_gdino.main: {binned} binned frames x "
        f"{len(GD_EXPRESSIONS)} expressions in {prompts_s:.2f} s "
        f"({row['prompt_frames_per_s']:.3f} frames/s, reading the frames "
        f"included); tokens_gdino.main {tokens_s:.2f} s, tracking "
        f"{track_s:.2f} s ({row['object_fps']:.2f} object-fps over "
        f"{tracked} tracks); census {row['census']}")
    log(f"  launches: deformable {deform} (want {want}), flash "
        f"{flash}; peak memory {peak_gb:.2f} GB; card {smi_line()}")
    bd = row["breakdown"]
    prof = bd["gdino_forward_profile"]
    log(f"  per binned frame, warm: GroundingDINO forward (E 3 -> 4) "
        f"{bd['gdino_forward_ms']:.2f} ms, SAM2 image encode "
        f"{bd['sam2_image_encode_ms']:.2f} ms, 12 boxes -> masks "
        f"{bd['box_to_mask_12_ms']:.2f} ms; one profiled forward: "
        + ("not measured (the profiler recorded no device kernel)"
           if prof["busy_ms"] is None else
           f"wall {prof['wall_ms']:.2f} ms, device busy "
           f"{prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f})"
           f", deformable kernel {prof['deform_ms']:.2f} ms "
           f"({prof['deform_share_of_busy']:.3f} of busy), "
           f"{prof['kernels']} kernels"))
    del grounding, image_pred, video_pred
    torch.cuda.empty_cache()
    return row


def _small_frames():
    """6 frames of 48x64 (they upscale on both axes to SAM2's 64, as
    MeViS's 480x854 do to 1024) with three moving boxes, and their masks."""
    rng = np.random.default_rng(3)
    frames, masks = [], []
    for t in range(6):
        f = (rng.random((48, 64, 3)) * 40).astype(np.uint8)
        objs = [np.zeros((48, 64), np.uint8) for _ in range(3)]
        objs[0][8:24, 6 + 3 * t:22 + 3 * t] = 1
        objs[1][28:44, 44 - 3 * t:58 - 3 * t] = 1
        objs[2][30 - 2 * t:40 - 2 * t, 24:34] = 1
        for color, m in zip(((220, 80, 40), (40, 200, 90), (60, 80, 240)),
                            objs):
            f[m > 0] = color
        frames.append(f)
        masks.append(objs)
    return frames, masks


def compare_prompt_json(got: dict, ref: dict) -> dict:
    """``got`` against ``ref``: the same prompts (paired by frame,
    expression and nearest box) with the same phrases; returns the largest
    differences of boxes, scores and masks."""
    from sola_torch.core import rle
    pg, pr = got["prompt_masks"], ref["prompt_masks"]
    if (got["video_id"], got["bin_size"], len(pg)) != (
            ref["video_id"], ref["bin_size"], len(pr)):
        raise AssertionError(f"prompt JSONs differ: {len(pg)} prompts "
                             f"against {len(pr)}")
    errs = dict.fromkeys(("box_px", "token_score", "score", "stability",
                          "mask_pixels"), 0.0)
    used = set()
    for a in pr:
        cands = [(np.abs(np.subtract(b["pred_bbox"], a["pred_bbox"])).max(),
                  i) for i, b in enumerate(pg) if i not in used
                 and (b["frame_idx"], b["expression_id"])
                 == (a["frame_idx"], a["expression_id"])]
        if not cands:
            raise AssertionError(f"no prompt pairs with ref prompt "
                                 f"{a['prompt_id']}")
        dist, i = min(cands)
        used.add(i)
        b = pg[i]
        if b["pred_phrase"] != a["pred_phrase"]:
            raise AssertionError(f"phrases differ: {b['pred_phrase']!r} "
                                 f"against {a['pred_phrase']!r}")
        for key, e in (("box_px", dist),
                       ("token_score", np.abs(np.subtract(
                           b["token_score"], a["token_score"])).max()),
                       ("score", abs(b["score"] - a["score"])),
                       ("stability", abs(b["stability_score"]
                                         - a["stability_score"])),
                       ("mask_pixels", (rle.decode(b["segmentation"])
                                        != rle.decode(a["segmentation"])
                                        ).mean())):
            errs[key] = max(errs[key], float(e))
    return errs


# card against CPU at tiny size, fp32 with TF32 off: boxes and scores only
# differ by summation order; stability is a ratio of low-res pixel counts
# (16 x 16 at tiny size), so one pixel at the +-1 logit edge moves it by
# about 1/256; a mask logit at 0 may round either way
SMALL_TOL = {"box_px": 1e-3, "token_score": 1e-4, "score": 1e-4,
             "stability": 1e-2, "mask_pixels": 5e-3, "tokens": 1e-3,
             "masklet_pixels": 1e-2}


def run_gdino_small_reference(fa, di) -> dict:
    """Phase 7: both stages at GDINOConfig.tiny_test and
    SAM2Config.tiny_test on the card (fp32, the flash kernel's size
    thresholds lowered so it runs) and on the CPU, which runs the kernels'
    plain versions. The prompt JSONs must agree; the CPU's thresholds and
    prompt JSON then feed both tracking runs, whose censuses must be
    equal and whose tracks must agree."""
    from sola_torch.trackgen.gdino.model import (GDINOConfig,
                                                 load_grounding_dino)
    from sola_torch.trackgen.sam2.convert import (build_sam2,
                                                  load_sam2_image_predictor)
    from sola_torch.trackgen.sam2.model import SAM2Config
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    frames, masks = _small_frames()
    vid, hw = "small_gdino", frames[0].shape[:2]

    runs, box_thr, stab_thr, ref_info = {}, None, None, None
    for device in ("cpu", "cuda"):
        grounding = load_grounding_dino(None, cfg=GDINOConfig.tiny_test(),
                                        device=device, seed=1)
        image_pred = load_sam2_image_predictor(
            None, cfg=SAM2Config.tiny_test(64), device=device, seed=3,
            compute_dtype=torch.float32)
        fused_everywhere(image_pred.model)
        video_pred = SAM2VideoPredictor(
            fused_everywhere(build_sam2(cfg=SAM2Config.tiny_test(64), seed=3,
                                        device=device)),
            obj_batch=4, feature_dtype=torch.float32,
            compute_dtype=torch.float32)
        if box_thr is None:
            box_thr = box_gate(grounding, frames[0], keep=3)
        before = (fa.launches, di.launches)
        root = os.path.join(OUT_DIR, f"gdino_small_{device}")
        info, _ = prompts_stage(root, vid, frames, masks, grounding,
                                image_pred, device, box_thr)
        if ref_info is None:
            ref_info, stab_thr = info, stability_gate(info)
        else:  # the CPU's prompts feed this tracking run too
            with open(prompt_json_path(root, vid), "w") as f:
                json.dump(ref_info, f)
        census, _ = tokens_stage(root, vid, video_pred, device, stab_thr)
        runs[device] = {
            "info": info, "census": census,
            "launches": (fa.launches - before[0], di.launches - before[1]),
            "tracks": check_gdino_tracks(root, vid, census, len(frames), hw,
                                         video_pred.cfg.d_model)}
    cpu, card = runs["cpu"], runs["cuda"]
    if min(card["launches"]) == 0 or max(cpu["launches"]) != 0:
        raise AssertionError(f"small reference launches (flash, deformable):"
                             f" card {card['launches']}, cpu "
                             f"{cpu['launches']}")
    check_prompt_json(card["info"], vid, len(frames), hw)
    errs = compare_prompt_json(card["info"], cpu["info"])
    strip = lambda c: {k: v for k, v in c.items() if k not in ("time", "fps")}
    if ({e: strip(c) for e, c in card["census"].items()}
            != {e: strip(c) for e, c in cpu["census"].items()}
            or sorted(card["tracks"]) != sorted(cpu["tracks"])):
        raise AssertionError(f"censuses differ: card {card['census']} cpu "
                             f"{cpu['census']}")
    errs["tokens"] = max(float(np.abs(card["tracks"][k][1]
                                      - cpu["tracks"][k][1]).max())
                         for k in cpu["tracks"])
    errs["masklet_pixels"] = max(float((card["tracks"][k][0]
                                        != cpu["tracks"][k][0]).mean())
                                 for k in cpu["tracks"])
    bad = {k: (v, SMALL_TOL[k]) for k, v in errs.items() if v > SMALL_TOL[k]}
    if bad:
        raise AssertionError(f"card vs cpu beyond tolerance: {bad}")
    n_tracked = {e: c["n_tracked"] for e, c in cpu["census"].items()}
    log(f"  tiny_test on the card vs the CPU (fp32, kernel route; launches "
        f"flash/deformable {card['launches']}): "
        f"{len(cpu['info']['prompt_masks'])} prompts agree, censuses equal "
        f"(tracked {n_tracked}), largest differences {errs} (limits "
        f"{SMALL_TOL})")
    return {"errors": errs, "limits": SMALL_TOL, "box_threshold": box_thr,
            "stability_score_thresh": stab_thr, "n_tracked": n_tracked,
            "card_launches": card["launches"]}


def synthetic_video(seed: int):
    """12 frames of moving shapes on textured noise, and the 3 objects'
    masks per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H_VID, :W_VID]
    base = (rng.random((H_VID, W_VID, 3)) * 60).astype(np.uint8)
    frames, masks = [], []
    for t in range(T_FRAMES):
        f = base.copy()
        objs = [
            (yy >= 80 + 4 * t) & (yy < 200 + 4 * t)
            & (xx >= 100 + 15 * t) & (xx < 260 + 15 * t),
            ((yy - 300) ** 2 / 70 ** 2 + (xx - 600 + 10 * t) ** 2 / 110 ** 2)
            < 1.0,
            (yy >= 330 - 6 * t) & (yy < 430 - 6 * t)
            & (xx >= 40 + 5 * t) & (xx < 140 + 5 * t),
        ]
        for color, m in zip(((230, 60, 40), (50, 210, 90), (60, 80, 240)),
                            objs):
            f[m] = color
        frames.append(f)
        masks.append([m.astype(np.uint8) for m in objs])
    return frames, masks


def write_prompts(path: str, video_id: str, masks, rle) -> int:
    """~6 MeViS-layout grid prompts: the 3 objects on frames 0 and 4."""
    prompts = []
    for frame_idx in (0, 4):
        for obj in range(3):
            m = masks[frame_idx][obj]
            prompts.append({"segmentation": rle.encode(m),
                            "stability_score": 0.97, "area": int(m.sum()),
                            "area_ratio": float(m.mean()),
                            "frame_idx": frame_idx,
                            "prompt_id": len(prompts)})
    with open(path, "w") as f:
        json.dump({"video_id": video_id, "bin_size": 4,
                   "prompt_masks": prompts}, f)
    return len(prompts)


def check_tracks(track_root: str, video_id: str, census: dict, tracks,
                 rle, d_model: int) -> None:
    for key in ("n_tracked", "n_filtered", "n_not_used", "n_total"):
        if not isinstance(census[key], int) or census[key] < 0:
            raise AssertionError(f"census {key}: {census[key]}")
    if census["n_frames"] != T_FRAMES or census["n_tracked"] < 1:
        raise AssertionError(f"census: {census}")
    if (census["n_tracked"] + census["n_filtered"] + census["n_not_used"]
            + len(census["not_tracked_prompt_ids"]) != census["n_total"]):
        raise AssertionError(f"census does not add up: {census}")
    records = tracks.load_track_records(track_root, "grid_tracks", "mevis",
                                        "valid_u", video_id, use_index=False)
    if sorted(r.sam2_anno_id for r in records) != sorted(
            census["tracked_prompt_ids"]):
        raise AssertionError("written tracks differ from the census")
    areas = []
    for rec in records:
        with open(rec.masklet_path) as f:
            masklet = rle.decode_masklet(json.load(f)["rle"])
        toks = np.load(rec.token_path)
        if masklet.shape != (T_FRAMES, H_VID, W_VID):
            raise AssertionError(f"masklet shape {masklet.shape}")
        if toks.shape != (T_FRAMES, d_model) or not np.isfinite(toks).all():
            raise AssertionError(f"tokens {toks.shape} finite="
                                 f"{np.isfinite(toks).all()}")
        areas.append(float(masklet.mean()))
    return float(np.mean(areas))


def run_main_path(fa) -> dict:
    from sola_torch.core import rle
    from sola_torch.data import tracks
    from sola_torch.trackgen import tokens_grid
    track_root = os.path.join(OUT_DIR, "sam2_tracks")
    out_root = os.path.join(track_root, "grid_tracks", "mevis", "valid_u")
    t0 = time.perf_counter()
    # tokens_grid's own factory; the default checkpoint path is absent, so
    # SAM2 hiera-L gets seeded random weights
    predictor = tokens_grid._default_predictor_factory(
        "pretrained_models/sam2_hiera_large.pt", obj_batch=4,
        device="cuda")()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = predictor.cfg
    log(f"  predictor: hiera embed {cfg.image_encoder.hiera.embed_dim}, "
        f"stages {cfg.image_encoder.hiera.stages}, image {cfg.image_size}, "
        f"memory layers {cfg.memory_attention.num_layers} x d_model "
        f"{cfg.memory_attention.d_model}, obj_batch {predictor.obj_batch}, "
        f"{sum(p.numel() for p in predictor.model.parameters()) / 1e6:.1f}M "
        f"params, built in {build_s:.1f} s")
    videos = []
    for i in range(2):
        vid = f"synthetic{i}"
        frames, masks = synthetic_video(i)
        path = os.path.join(OUT_DIR, f"{vid}.json")
        n_prompts = write_prompts(path, vid, masks, rle)
        videos.append((vid, frames, path, n_prompts))

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0  # the main path's count starts here
    per_video = []
    hiera_launches = memory_launches = 0
    for vid, frames, path, n_prompts in videos:
        before = fa.launches
        t0 = time.perf_counter()
        state = predictor.init_state(frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        mid = fa.launches
        t0 = time.perf_counter()
        census = tokens_grid.run_video(
            predictor, vid, None, path, out_root, "mevis", "valid_u",
            bin_size=4, batch_size=4, state=state, log=lambda s: None)
        torch.cuda.synchronize()
        prop_s = time.perf_counter() - t0
        hiera_launches += mid - before
        memory_launches += fa.launches - mid
        area = check_tracks(track_root, vid, census, tracks, rle,
                            cfg.d_model)
        row = {"video": vid, "prompts": n_prompts, "mask_area": area,
               "encode_s": enc_s,
               "encode_fps": T_FRAMES / enc_s, "run_video_s": prop_s,
               "object_fps": census["n_tracked"] * T_FRAMES / prop_s,
               "census": {k: census[k] for k in (
                   "n_tracked", "n_filtered", "n_not_used", "n_total")},
               "hiera_launches": mid - before,
               "memory_launches": fa.launches - mid}
        per_video.append(row)
        log(f"  {vid}: encode {enc_s:.2f} s ({row['encode_fps']:.2f} "
            f"frames/s), run_video {prop_s:.2f} s ({row['object_fps']:.2f} "
            f"object-fps), census {row['census']}, mean masklet area "
            f"{area:.3f} (random weights), launches hiera "
            f"{row['hiera_launches']} memory {row['memory_launches']}")
    launches = fa.launches  # read right after the main path
    if hiera_launches == 0 or memory_launches == 0:
        raise AssertionError(f"flash kernel launches: hiera "
                             f"{hiera_launches}, memory {memory_launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  main path: {launches} kernel launches (hiera {hiera_launches}, "
        f"memory {memory_launches}), peak memory {peak_gb:.2f} GB")
    drift = encoder_drift(predictor, videos[0][1][:predictor.encode_chunk],
                          seed=0)
    del predictor
    torch.cuda.empty_cache()
    return {"launches": launches, "hiera_launches": hiera_launches,
            "memory_launches": memory_launches, "videos": per_video,
            "peak_memory_gb": peak_gb, "predictor_build_s": build_s,
            "encoder_drift": drift}


def encoder_drift(predictor, frames, seed: int) -> dict:
    """The bf16-compute predictor's encoder features (bf16 weights, bf16
    patch embedding, fp32 after it) against an fp32 model's from the same
    seed, on the same frames: the precision the encode frames/s is
    bought at."""
    from sola_torch.trackgen.sam2.convert import build_sam2
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor, encode_raw
    ref_pred = SAM2VideoPredictor(
        build_sam2(cfg=predictor.cfg, seed=seed, device="cuda"),
        feature_dtype=torch.float32, compute_dtype=torch.float32)
    raw = torch.from_numpy(np.stack(frames)).cuda()
    ours = encode_raw(predictor.model, raw, predictor.compute_dtype)
    ref = encode_raw(ref_pred.model, raw, ref_pred.compute_dtype)
    drift = {}
    for key in ("s0", "s1", "pix"):
        d, r = ours[key].float() - ref[key], ref[key]
        drift[key] = {"max_abs": d.abs().max().item(),
                      "rms": d.square().mean().sqrt().item(),
                      "ref_rms": r.square().mean().sqrt().item()}
        if not torch.isfinite(ours[key]).all():
            raise AssertionError(f"encoder features {key} not finite")
    log(f"  encoder drift, bf16 compute vs fp32, {len(frames)} frames at "
        f"{predictor.cfg.image_size} px: "
        + ", ".join(f"{k} max {v['max_abs']:.3g} rms {v['rms']:.3g} (ref "
                    f"rms {v['ref_rms']:.3g})" for k, v in drift.items()))
    del ref_pred
    return drift


# ---------------------------------------------------------------------------
# phase 4: small reference, card against CPU
# ---------------------------------------------------------------------------

def run_small_reference(fa) -> dict:
    from sola_torch.core import rle
    from sola_torch.data import tracks
    from sola_torch.trackgen import tokens_grid
    from sola_torch.trackgen.sam2.convert import build_sam2
    from sola_torch.trackgen.sam2.model import SAM2Config
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    s, t = 64, 6
    rng = np.random.default_rng(7)
    frames = []
    for i in range(t):
        f = (rng.random((s, s, 3)) * 40).astype(np.uint8)
        f[10:28, 6 + 3 * i:20 + 3 * i] = (220, 80, 40)
        f[38:56, 50 - 3 * i:62 - 3 * i] = (40, 200, 90)
        frames.append(f)
    a = np.zeros((s, s), np.uint8)
    a[10:28, 6:20] = 1
    b = np.zeros((s, s), np.uint8)
    b[38:56, 50:62] = 1
    prompt_path = os.path.join(OUT_DIR, "small.json")
    with open(prompt_path, "w") as f:
        json.dump({"video_id": "small", "bin_size": 4, "prompt_masks": [
            {"segmentation": rle.encode(m), "frame_idx": 0, "prompt_id": i}
            for i, m in enumerate((a, b))]}, f)
    results = {}
    for device in ("cuda", "cpu"):
        model = fused_everywhere(build_sam2(cfg=SAM2Config.tiny_test(s),
                                            seed=3, device=device))
        pred = SAM2VideoPredictor(model, obj_batch=2,
                                  feature_dtype=torch.float32,
                                  compute_dtype=torch.float32)
        root = os.path.join(OUT_DIR, f"small_{device}")
        before = fa.launches
        census = tokens_grid.run_video(
            pred, "small", None, prompt_path,
            os.path.join(root, "grid_tracks", "mevis", "valid_u"), "mevis",
            "valid_u", batch_size=2, state=pred.init_state(frames),
            log=lambda x: None)
        recs = tracks.load_track_records(root, "grid_tracks", "mevis",
                                         "valid_u", "small", use_index=False)
        out = {}
        for rec in recs:
            with open(rec.masklet_path) as f:
                out[rec.sam2_anno_id] = (
                    rle.decode_masklet(json.load(f)["rle"]),
                    np.load(rec.token_path))
        # raw activations too (tokens and masks can saturate at random
        # weights): encoder features, memory-conditioned features and
        # decoder logits before the empty-object suppression
        raw = {"pix": pred.init_state(frames).features["pix"]}
        cfg = model.cfg
        r = np.random.default_rng(11)
        hh, dm, mm = cfg.feat_hw, cfg.d_model, cfg.mem_dim

        def arr(*shape):
            return torch.from_numpy(
                r.standard_normal(shape).astype(np.float32)).to(device)

        nb = 2
        with torch.no_grad():
            raw["cond"] = model.condition_features(
                arr(nb, hh, hh, dm), arr(nb, hh, hh, dm),
                arr(nb, 1, hh, hh, mm), torch.ones(nb, 1, dtype=torch.bool,
                                                   device=device),
                arr(nb, cfg.num_recent, hh, hh, mm),
                torch.ones(nb, cfg.num_recent, dtype=torch.bool,
                           device=device),
                torch.arange(1, cfg.num_recent + 1,
                             device=device).repeat(nb, 1),
                arr(nb, cfg.max_obj_ptrs, dm),
                torch.ones(nb, cfg.max_obj_ptrs, dtype=torch.bool,
                           device=device))
            raw["low_res"] = model.sam_heads(
                raw["cond"], arr(nb, 4 * hh, 4 * hh, dm // 8),
                arr(nb, 2 * hh, 2 * hh, dm // 4),
                torch.zeros(nb, 1, 2, device=device),
                torch.full((nb, 1), -1, device=device))["low_res_masks"]
        raw = {k: v.float().cpu().numpy() for k, v in raw.items()}
        results[device] = (census, out, fa.launches - before, raw)
    (gc, gt, g_launch, graw), (cc, ct, c_launch, craw) = (results["cuda"],
                                                          results["cpu"])
    if g_launch == 0 or c_launch != 0:
        raise AssertionError(f"small reference launches: cuda {g_launch}, "
                             f"cpu {c_launch}")
    strip = lambda c: {k: v for k, v in c.items() if k not in ("time", "fps")}
    if strip(gc) != strip(cc) or sorted(gt) != sorted(ct):
        raise AssertionError(f"census differs: card {gc} cpu {cc}")
    errs = {"tokens": max(float(np.abs(gt[p][1] - ct[p][1]).max())
                          for p in gt)}
    errs.update({k: float(np.abs(graw[k] - craw[k]).max()) for k in graw})
    pix = max(float((gt[p][0] != ct[p][0]).mean()) for p in gt)
    if max(errs.values()) > 1e-3 or pix > 1e-2:
        raise AssertionError(f"card vs cpu: max abs errs {errs}, "
                             f"masklet pixels differing {pix}")
    log(f"  tiny_test on the card vs the CPU (fp32, kernel route): census "
        f"equal ({gc['n_tracked']} tracked), max abs errs {errs} (tol "
        f"1e-3), masklet pixels differing {pix:.3g} (tol 1e-2)")
    bf16_pred = SAM2VideoPredictor(
        build_sam2(cfg=SAM2Config.tiny_test(s), seed=3, device="cuda"))
    drift = encoder_drift(bf16_pred, frames[:4], seed=3)
    return {"max_abs_err": errs, "pixels_differing": pix,
            "encoder_drift": drift}


# ---------------------------------------------------------------------------
# phase 8: the training attention kernels against their plain versions
# ---------------------------------------------------------------------------

# the selection model at full width (SelectionConfig defaults): 1024-d, 8
# heads of 128; batch 8 of 64 track slots (40 valid) x 8 frames after the
# motion encoder; 96 padded words + 32 negatives
SEL_B, SEL_N, SEL_T, SEL_HEADS, SEL_D, SEL_WORDS, SEL_NEG = (8, 64, 8, 8,
                                                             128, 96, 32)
SEL_RATE, SEL_SEED = 0.1, 0x2545F491


def selection_attention_cases(gen):
    """(name, site, dtype, b, lq, lk, mask) of the three call sites of an
    AlignmentLayer, with the masks the path makes: track slots 40 of 64
    valid (obj_attn, per frame), frame lengths of 5 to 8 (motion_attn, per
    track), and 6 to 20 real words of the 96 plus the 32 negatives
    (object2lang_attn); and object2lang_attn in bf16 as a check shape."""
    tracks = torch.zeros(SEL_B, SEL_N, dtype=torch.bool)
    tracks[:, :40] = True
    frames = (torch.arange(SEL_T)[None]
              < torch.randint(5, SEL_T + 1, (SEL_B,), generator=gen)[:, None])
    words = (torch.arange(SEL_WORDS)[None]
             < torch.randint(6, 21, (SEL_B,), generator=gen)[:, None])
    lang = torch.cat([words, torch.ones(SEL_B, SEL_NEG, dtype=torch.bool)],
                     dim=1)
    fp32 = torch.float32
    return [
        ("obj_attn", "obj_attn", fp32, SEL_B * SEL_T, SEL_N, SEL_N,
         tracks.repeat_interleave(SEL_T, dim=0).cuda()),
        ("motion_attn", "motion_attn", fp32, SEL_B * SEL_N, SEL_T, SEL_T,
         frames.repeat_interleave(SEL_N, dim=0).cuda()),
        ("object2lang_attn", "object2lang_attn", fp32, SEL_B,
         SEL_N * SEL_T, SEL_WORDS + SEL_NEG, lang.cuda()),
        ("object2lang_attn_bf16", "check", torch.bfloat16, SEL_B,
         SEL_N * SEL_T, SEL_WORDS + SEL_NEG, lang.cuda())]


def backward_check_cases(gen):
    """(name, dtype, b, h, lq, lk, d, mask) of the shapes that reach the
    parts of the fused backward that the selection sites do not: no mask,
    with keys that span several chunks (dQ through the fp32 workspace,
    several query tiles), D 256 in bf16 with a ragged mask (32-slot chunks,
    two of them), and a batch entry with no valid key (every key takes
    part)."""
    ragged = (torch.rand(2, 90, generator=gen) < 0.7)
    ragged[:, 0] = True
    tracks = torch.zeros(SEL_B * SEL_T, SEL_N, dtype=torch.bool)
    tracks[:, :40] = True
    tracks[3] = False
    return [
        ("many_keys", torch.float32, 2, 8, 300, 200, 64, None),
        ("d256_bf16", torch.bfloat16, 2, 8, 70, 90, 256, ragged.cuda()),
        ("no_valid_key", torch.float32, SEL_B * SEL_T, SEL_HEADS, SEL_N,
         SEL_N, SEL_D, tracks.cuda())]


def backward_cases(gen):
    """(name, site, dtype, b, h, lq, lk, d, mask) of phase 8: the selection
    shapes at the model's heads and head dim, then the backward check
    shapes."""
    cases = [(name, site, dtype, b, SEL_HEADS, lq, lk, SEL_D, mask)
             for name, site, dtype, b, lq, lk, mask
             in selection_attention_cases(gen)]
    return cases + [(name, "check", dtype, b, h, lq, lk, d, mask)
                    for name, dtype, b, h, lq, lk, d, mask
                    in backward_check_cases(gen)]


def sdpa_backwards(q, k, v, attn_mask, rate, do, n: int) -> list:
    """n callables, each torch.autograd.grad through its own forward of
    scaled_dot_product_attention, which runs here: a trace around the
    callables holds the backwards' device ops alone."""
    import torch.nn.functional as F
    calls = []
    for _ in range(n):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                             dropout_p=rate)
        calls.append(lambda o=out, x=leaves: torch.autograd.grad(o, x, do))
    torch.cuda.synchronize()
    return calls


def sdpa_bwd_device_ms(q, k, v, attn_mask, rate, do, iters: int) -> tuple:
    """SDPA's backward alone: (device ms per call, records of the fullest
    trace), every device op of the backward counted (profiled_ms)."""
    args = (q, k, v, attn_mask, rate, do)
    sdpa_backwards(*args, 1)[0]()
    return profiled_ms(lambda: sdpa_backwards(*args, iters), iters)


def sdpa_bwd_kernels(q, k, v, attn_mask, rate, do) -> list:
    """Names of the device ops of SDPA's backward on these inputs (which
    of its backends ran), from a trace of five backwards, since a trace of
    one can lose its records."""
    return sorted({name[:120] for name, _ in profiled_ops(
        sdpa_backwards(q, k, v, attn_mask, rate, do, 5))})


def grad_limits_fail(grads, refs, dtype) -> list:
    """The gradients among (dq, dk, dv) that break the limits against the
    fp32 references: [(name, max err, limit, rms err, limit)]."""
    bad = []
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        err, tol, rms, rms_tol = out_errors(g, r.float(), dtype)
        if not (err <= tol and rms <= rms_tol
                and torch.isfinite(g.float()).all()):
            bad.append((name, err, tol, rms, rms_tol))
    return bad


def bwd_work(b, h, lq, lk, d, mask, itemsize) -> tuple:
    """(FLOPs, bytes) of the fused backward on these inputs: 10 FLOPs per
    (query, key that takes part, d) for S, dP, dQ, dK and dV; Q and dO read
    and dQ written once, K and V read once over the keys that take part
    (a masked key's dK and dV rows are zeros, written without them), dK and
    dV written once over all Lk rows, lse, delta and the mask read once."""
    keys = keys_taking_part(b, lk, mask)
    qo_bytes = b * h * lq * d * itemsize   # q, do, dq: one each
    kv_read = h * keys * d * itemsize      # k, v: one each
    kv_write = b * h * lk * d * itemsize   # dk, dv: one each
    return (10.0 * h * lq * d * keys, 3 * qo_bytes + 2 * kv_read
            + 2 * kv_write + 2 * 4 * b * h * lq
            + (0 if mask is None else b * lk))


def bound(flops, nbytes, dtype) -> tuple:
    """(least ms, what bounds it) at the card's peaks."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_flash_training_kernels(fa, gen) -> dict:
    """Forward at rates 0 and 0.1, and the fused backward without and with
    dropout, against the plain versions at the selection shapes and the
    backward check shapes; the limits must reject three wrong backward
    results (the mask of seed + 1, dS without -delta, dV from the
    undropped P). Times each kernel (CUDA events over calls, and the
    backward alone by torch.profiler), its plain version, its bound and a
    library yardstick (SDPA's forward by call; SDPA's backward alone by
    torch.profiler, like the kernel, and by call as forward + backward -
    forward)."""
    import torch.nn.functional as F
    rows = []
    for name, site, dtype, b, h, lq, lk, d, mask in backward_cases(gen):
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen).cuda().to(dtype)
                       for n in (lq, lk, lk, lq))
        g, rh, kh = fa.bwd_plan(h, lq, lk, d)
        row = {"shape": name, "site": site, "dtype": str(dtype), "b": b,
               "h": h, "lq": lq, "lk": lk, "d": d,
               "valid_keys": b * lk if mask is None else int(mask.sum()),
               "plan": {"heads_a_block": g, "rows_a_head": rh,
                        "key_slots_a_head": kh, "dq_workspace": lk > kh}}
        for rate in (0.0, SEL_RATE):
            seed = SEL_SEED if rate else None
            tag = "drop" if rate else "nodrop"
            out, lse = fa._launch(q, k, v, mask, rate, seed)
            delta = fa.bwd_delta(out, do)
            args = (q, k, v, mask, do, lse, delta, rate, seed)
            dq, dk, dv = fa._launch_bwd_kernel(*args)
            torch.cuda.synchronize()
            ref, ref_lse = fa.attention_reference(q, k, v, mask, rate, seed)
            err, tol, rms, rms_tol = out_errors(out, ref.float(), dtype)
            lse_err = (lse - ref_lse).abs().max().item()
            if not (err <= tol and rms <= rms_tol and lse_err <= LSE_ATOL
                    and torch.isfinite(out.float()).all()):
                raise AssertionError(
                    f"{name} rate {rate}: forward disagrees with its plain "
                    f"version: max {err} (tol {tol}), rms {rms} (tol "
                    f"{rms_tol}), lse {lse_err}")
            refs = fa.attention_bwd_reference(q, k, v, mask, out, lse, do,
                                              rate, seed)
            bad = grad_limits_fail((dq, dk, dv), refs, dtype)
            if bad:
                raise AssertionError(f"{name} rate {rate}: backward "
                                     f"disagrees with its plain version: "
                                     f"{bad}")
            # masked keys of a batch entry with a valid key: exactly zero
            # dK and dV (an entry with none lets every key take part)
            kmask = None if mask is None else (
                ~mask & mask.any(dim=1, keepdim=True))[
                :, None, :, None].expand(b, h, lk, d)
            if kmask is not None and kmask.any() and (
                    dk.float()[kmask].abs().max() != 0
                    or dv.float()[kmask].abs().max() != 0):
                raise AssertionError(f"{name}: masked keys get a gradient")
            row[f"fwd_{tag}"] = {"max_abs_err": err, "max_abs_tol": tol,
                                 "rms_err": rms, "rms_tol": rms_tol,
                                 "lse_max_abs_err": lse_err}
            for gname, gr, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                e, t, r_err, r_tol = out_errors(gr, r.float(), dtype)
                row[f"{gname}_{tag}"] = {"max_abs_err": e, "max_abs_tol": t,
                                         "rms_err": r_err, "rms_tol": r_tol}
        # three wrong backward results the limits must reject (dropout on)
        wrong = {
            "mask_of_seed_plus_1": fa.attention_bwd_reference(
                q, k, v, mask, out, lse, do, rate, seed + 1),
            "ds_without_delta": fa.attention_bwd_reference(
                q, k, v, mask, torch.zeros_like(out), lse, do, rate, seed),
            "dv_from_undropped_p": refs[:2] + fa.attention_bwd_reference(
                q, k, v, mask, out, lse, do)[2:]}
        row["wrong_rejected_by"] = {}
        for what, grads in wrong.items():
            caught = grad_limits_fail(grads, refs, dtype)
            if not caught:
                raise AssertionError(f"{name}: the limits accept a wrong "
                                     f"backward ({what})")
            row["wrong_rejected_by"][what] = [c[0] for c in caught]
        # times at the training forward's rate
        attn_mask = None if mask is None else mask[:, None, None, :]
        fwd_ms = cuda_ms(lambda: fa._launch(q, k, v, mask, rate, seed), 20)
        fwd_nodrop_ms = cuda_ms(lambda: fa._launch(q, k, v, mask), 20)
        bwd_ms = cuda_ms(lambda: fa._launch_bwd_kernel(*args), 20)
        bwd_device_ms, bwd_records = profiled_ms(
            lambda: [lambda: fa._launch_bwd_kernel(*args)] * 20, 20,
            "flash_bwd_")  # 20 records: one launch a call
        if bwd_device_ms is None:
            raise AssertionError(f"{name}: the profiler recorded no "
                                 f"flash_bwd_ kernel")
        plain_fwd_ms = cuda_ms(lambda: fa.attention_reference(
            q, k, v, mask, rate, seed), 5)
        plain_bwd_ms = cuda_ms(lambda: fa.attention_bwd_reference(
            q, k, v, mask, out, lse, do, rate, seed), 5)
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=rate), 20)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=attn_mask,
                dropout_p=rate).backward(do)

        sdpa_bwd_by_call_ms = max(cuda_ms(sdpa_fwd_bwd, 20) - sdpa_fwd_ms,
                                  0.0)
        sdpa_bwd_ms, sdpa_bwd_records = sdpa_bwd_device_ms(
            q, k, v, attn_mask, rate, do, 20)
        item = q.element_size()
        flops_fwd, bytes_fwd = attention_work(b, h, lq, lk, d, mask, item)
        work = {"fwd": (flops_fwd, bytes_fwd),
                "bwd": bwd_work(b, h, lq, lk, d, mask, item)}
        row["fwd_nodrop_ms"] = fwd_nodrop_ms  # the validation pass's
        times = {"fwd": (fwd_ms, plain_fwd_ms, sdpa_fwd_ms),
                 "bwd": (bwd_ms, plain_bwd_ms, sdpa_bwd_ms)}
        for kern, (flops, nbytes) in work.items():
            ms, plain, lib = times[kern]
            least, by = bound(flops, nbytes, dtype)
            row[kern] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": least, "bound_by": by,
                         "gflops": flops / ms / 1e6}
        row["bwd"].update(device_ms=bwd_device_ms,
                          device_records=bwd_records,
                          library_by_call_ms=sdpa_bwd_by_call_ms,
                          library_records=sdpa_bwd_records,
                          library_kernels=sdpa_bwd_kernels(
                              q, k, v, attn_mask, rate, do))
        rows.append(row)
        drop = row["fwd_drop"]
        log(f"  {name:>21} {str(dtype)[6:]} bh={b}x{h} lq={lq} lk={lk} "
            f"d={d} plan {row['plan']}: fwd max err {drop['max_abs_err']:.3g}"
            f" (tol {drop['max_abs_tol']:.3g}); dq/dk/dv max err "
            + "/".join(f"{row[g + '_drop']['max_abs_err']:.3g}"
                       for g in ("dq", "dk", "dv"))
            + " (tol " + "/".join(f"{row[g + '_drop']['max_abs_tol']:.3g}"
                                  for g in ("dq", "dk", "dv"))
            + f"); wrong results rejected by {row['wrong_rejected_by']}")
        log(f"    fwd at rate 0: kernel {fwd_nodrop_ms:.4f} ms")
        for kern in ("fwd", "bwd"):
            r = row[kern]
            kernel, library = f"{r['ms']:.4f} ms", f"{r['library_ms']:.4f} ms"
            if kern == "bwd":
                kernel = f"{r['device_ms']:.4f} ms alone ({kernel} by call)"
                library = (f"{library} alone ({r['library_by_call_ms']:.4f}"
                           f" ms by call)")
            log(f"    {kern:>3} at rate {rate}: kernel {kernel}, plain "
                f"{r['plain_ms']:.4f} ms, library {library}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['gflops']:.1f} GFLOP/s")
        del (q, k, v, do, out, lse, delta, args, dq, dk, dv, refs, wrong,
             qg, kg, vg)
    torch.cuda.empty_cache()
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phases 9 and 10: selection training through the port's train entry
# ---------------------------------------------------------------------------

ATTN_SITES = ("obj_attn", "motion_attn", "object2lang_attn")
# bench.py's train shapes: 16 videos x 4 expressions, 40 tracks (4 objects +
# 36 distractors, bucket 64), 64 frames, batch 8; 4 validation videos
TRAIN_VIDEOS, VALID_VIDEOS, OBJECTS, DISTRACTORS, FRAMES, BATCH = (
    16, 4, 4, 36, 64, 8)


class TrainSiteCounter:
    """The two flash kernels' launches by call site while a model trains:
    forward launches between a site module's forward pre-hook and hook,
    backward launches between its backward pre-hook and hook. The wrappers
    alone count; the hooks only read their counters."""

    def __init__(self, fa):
        self.fa = fa
        self.counts = {s: {"fwd": 0, "bwd": 0} for s in ATTN_SITES}
        self._fwd, self._bwd = [], []

    def watch(self, model) -> None:
        fa = self.fa
        for layer in model.object_lang_align_layers:
            for site in ATTN_SITES:
                m = getattr(layer, site)
                m.register_forward_pre_hook(
                    lambda *_: self._fwd.append(fa.launches))
                m.register_forward_hook(lambda *_, s=site: self._add_fwd(s))
                m.register_full_backward_pre_hook(
                    lambda *_: self._bwd.append(fa.bwd_launches))
                m.register_full_backward_hook(
                    lambda *_, s=site: self._add_bwd(s))

    def _add_fwd(self, site: str) -> None:
        self.counts[site]["fwd"] += self.fa.launches - self._fwd.pop()

    def _add_bwd(self, site: str) -> None:
        self.counts[site]["bwd"] += self.fa.bwd_launches - self._bwd.pop()


def selection_corpus(root: str, n_train: int, n_valid: int, n_frames: int,
                     n_objects: int, n_distractors: int, batch: int) -> dict:
    """A synthetic MeViS-layout corpus (train and valid_u splits) from the
    port's generator; returns the config's dataset section."""
    from sola_torch.data import synthetic
    for split, n, seed in (("train", n_train, 0), ("valid_u", n_valid, 1)):
        gen = synthetic.generate(root, n_videos=n, n_frames=n_frames,
                                 n_objects=n_objects,
                                 n_distractors=n_distractors,
                                 data_type=split, seed=seed)
    dataset = {"data_root": gen["data_root"], "track_root": gen["track_root"],
               "num_workers": 4}
    for split, data_type in (("train", "train"), ("valid", "valid_u")):
        dataset[split] = {"data_name": "mevis", "data_type": data_type,
                          "sam2_output_dirs": "grid_tracks",
                          "batch_size": batch}
    return dataset


def parse_train_log(path: str) -> tuple:
    """(floats, TP/FP/FN/TN counts, epochs) of a log.txt."""
    import re
    text = open(path).read()
    return ([float(x) for x in re.findall(r"-?\d+\.\d+|nan|inf", text)],
            [int(x) for x in re.findall(r"(?:TP|FP|FN|TN): (\d+)", text)],
            re.findall(r"^EPOCH (\d+)$", text, re.M))


def run_selection_training(fa) -> dict:
    """Phase 9: selection training at full width through
    ``sola_torch.train.loop.train`` with configs/mevis/default.yaml's
    values, the Pallas attention route and a random RoBERTa-large."""
    from sola_torch import config as config_lib
    from sola_torch.data.dataset import get_loader_dict
    from sola_torch.models.selection import SelectionConfig, SelectionModel
    from sola_torch.models.text import CachingTextEncoder, build_text_encoder
    from sola_torch.train import loop
    from sola_torch.train import state as state_lib
    root = os.path.join(OUT_DIR, "selection")
    t0 = time.perf_counter()
    dataset = selection_corpus(os.path.join(root, "data"), TRAIN_VIDEOS,
                               VALID_VIDEOS, FRAMES, OBJECTS, DISTRACTORS,
                               BATCH)
    corpus_s = time.perf_counter() - t0
    configs = config_lib.load_config("mevis/default", overrides={
        "model.use_pallas_attention": True,
        "model.text_encoder": "roberta_random", "train.n_epochs": 2,
        "results.output_dir": os.path.join(root, "TRAIN")})
    configs["dataset"] = dataset
    cfg = SelectionConfig.from_dict(configs["model"])
    t0 = time.perf_counter()
    text = CachingTextEncoder(build_text_encoder(configs["model"], "cuda"))
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    log(f"  corpus {TRAIN_VIDEOS}+{VALID_VIDEOS} videos in {corpus_s:.1f} s;"
        f" text encoder: RoBERTa-large {text.inner.cfg.num_layers} x "
        f"{text.inner.cfg.hidden_size} (seeded random, frozen) in "
        f"{text_s:.1f} s; model {cfg}")

    sites = TrainSiteCounter(fa)
    initial = {}
    build_model = loop.build_model

    def build_and_watch(*args, **kwargs):  # the hooks only read counters
        model = build_model(*args, **kwargs)
        initial.update({k: v.detach().clone()
                        for k, v in model.state_dict().items()})
        sites.watch(model)
        return model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = 0
    loop.build_model = build_and_watch
    try:
        t0 = time.perf_counter()
        model = loop.train(configs, text_encoder=text, log_fn=log,
                           device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        loop.build_model = build_model
    launches = {"flash_attn_fwd": fa.launches,
                "flash_attn_bwd": fa.bwd_launches}  # read right after
    by_site = copy.deepcopy(sites.counts)  # the timed steps below add on
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    out_dir = os.path.join(root, "TRAIN", configs["exp_name"], "mevis")
    floats, counts, epochs = parse_train_log(os.path.join(out_dir, "log.txt"))
    if (epochs != ["001", "002"] or len(counts) != 8
            or not np.isfinite(floats).all()):
        raise AssertionError(f"log.txt: epochs {epochs}, counts {counts}, "
                             f"numbers {floats}")
    for epoch in (1, 2):
        fresh = SelectionModel(cfg)
        fresh.load_state_dict(torch.load(os.path.join(
            out_dir, f"epoch_{epoch}.pth"), weights_only=True), strict=True)
    final = model.state_dict()
    still = [k for k, _ in model.named_parameters()
             if torch.equal(final[k], initial[k])]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    steps = (TRAIN_VIDEOS * OBJECTS // BATCH) * 2
    valid_batches = (VALID_VIDEOS * OBJECTS // BATCH) * 2
    want = {"fwd": cfg.n_layers * (steps + valid_batches),
            "bwd": cfg.n_layers * steps}
    if (any(by_site[s] != want for s in ATTN_SITES)
            or launches["flash_attn_fwd"] != 3 * want["fwd"]
            or launches["flash_attn_bwd"] != 3 * want["bwd"]):
        raise AssertionError(f"kernel launches by site {by_site} "
                             f"(want {want} each), totals {launches}")

    # warm steps on one batch of the path's shape, then one profiled step
    raw = next(iter(get_loader_dict(configs["dataset"])["train"]))
    batch = loop.prepare_batch(raw, text, configs["train"], "cuda")
    optimizer = state_lib.make_optimizer(model.parameters(), lr=5e-6)
    gen = torch.Generator().manual_seed(0)
    step = lambda: loop.train_step(model, optimizer, batch,  # noqa: E731
                                   configs["train"], gen)
    step_ms = host_ms(step, iters=5)
    prof = profile_forward(step, kernels_of=(
        ("flash_fwd", "flash_fwd_"),  # the wgmma and tf32 kernels
        ("flash_bwd", "flash_bwd_")))
    row = {"config": dataclasses.asdict(cfg), "corpus_s": corpus_s,
           "text_encoder_s": text_s, "train_s": train_s, "steps": steps,
           "launches": launches, "launches_by_site": by_site,
           "peak_memory_gb": peak_gb, "warm_step_ms": step_ms,
           "steps_per_s": 1e3 / step_ms,
           "pairs_per_s": BATCH * 1e3 / step_ms, "log": floats,
           "confusion": counts, "profile": prof}
    log(f"  train(): 2 epochs, {steps} steps + {valid_batches} validation "
        f"batches in {train_s:.2f} s (data loading, text encodes and "
        f"checkpoints included); log {floats[:4]}..., TP/FP/FN/TN "
        f"{counts[-4:]}; launches {launches}, by site {by_site}; "
        f"peak memory {peak_gb:.2f} GB; card {smi_line()}")
    log(f"  warm train step (batch {BATCH}, 64 track slots x 64 frames): "
        f"{step_ms:.2f} ms = {row['steps_per_s']:.2f} steps/s = "
        f"{row['pairs_per_s']:.2f} (video, expression) pairs/s; one "
        "profiled step: " + (
            "not measured (the profiler recorded no device kernel)"
            if prof["busy_ms"] is None else
            f"wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}),"
            f" {prof['kernels']} kernels; flash fwd "
            f"{prof['flash_fwd_ms']:.3f} ms ({prof['flash_fwd_share_of_busy']:.3f}),"
            f" bwd {prof['flash_bwd_ms']:.3f} ms "
            f"({prof['flash_bwd_share_of_busy']:.3f}) of busy"))
    del model, text, optimizer, batch
    torch.cuda.empty_cache()
    drop_bulk(root)
    return row


def drop_bulk(root: str) -> None:
    """Remove a training workspace's corpus and checkpoints once checked
    (hundreds of MB), keeping its log.txt."""
    shutil.rmtree(os.path.join(root, "data"), ignore_errors=True)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pth"):
                os.remove(os.path.join(dirpath, f))


# card against CPU, fp32 with TF32 off: the 4-decimal log numbers of epoch 1
# agree to a last digit; AdamW turns summation-order differences into up to
# 5e-4 by epoch 2 on an H100. A backward kernel fault (dS without -delta)
# moves them by ~3, which this limit must still reject
SMALL_TRAIN_ATOL = 2e-3


def run_selection_small_reference(fa) -> dict:
    """Phase 10: a tiny selection config (lang 64, 1 layer, no dropout,
    Pallas route) trained 2 epochs on the card and on the CPU from the same
    seeded weights and hash table: the log.txt numbers within
    SMALL_TRAIN_ATOL and equal TP/FP/FN/TN. A third run on the card with a
    planted fault in the backward kernel's input (delta = 0, so dS lacks
    its -delta) must break that agreement."""
    from sola_torch.models.text import HashTextEncoder
    from sola_torch.train.loop import train
    root = os.path.join(OUT_DIR, "selection_small")
    dataset = selection_corpus(os.path.join(root, "data"), 3, 2, 16, 2, 2, 2)
    model = {"object_token_dim": 256, "lang_token_dim": 64, "n_layers": 1,
             "n_negative": 4, "dropout_p": 0.0, "attn_dropout_p": 0.0,
             "n_groups": 8, "n_groups_module": 8,
             "use_pallas_attention": True}
    honest_delta = fa.bwd_delta
    runs = {}
    for name, device in (("cuda", "cuda"), ("cpu", "cpu"),
                         ("cuda_ds_without_delta", "cuda")):
        configs = {"exp_name": "small", "model": model,
                   "train": {"n_epochs": 2, "pred_threshold": 0.5,
                             "temperature": 0.07, "alignment_weight": 0.3,
                             "lr": 1e-4, "lr_factor": 0.5, "lr_patience": 0,
                             "grad_clip_norm": 1.0, "positive_metric": "iou",
                             "positive_threshold": 0.7,
                             "positive_weight": 1.5},
                   "dataset": copy.deepcopy(dataset),
                   "results": {"output_dir": os.path.join(root, name)}}
        before = (fa.launches, fa.bwd_launches)
        if name == "cuda_ds_without_delta":
            fa.bwd_delta = lambda out, do: torch.zeros_like(
                honest_delta(out, do))
        try:
            train(configs, text_encoder=HashTextEncoder(
                hidden_size=64, vocab_size=128, device=device),
                log_fn=lambda *a: None, device=device)
            _sync(device)
        finally:
            fa.bwd_delta = honest_delta
        runs[name] = parse_train_log(os.path.join(
            root, name, "small", "mevis", "log.txt")) + (
            tuple(a - b for a, b in zip((fa.launches, fa.bwd_launches),
                                        before)),)

    def log_err(a, b):
        return (float(np.abs(np.subtract(a[0], b[0])).max())
                if len(a[0]) == len(b[0]) else float("inf"))

    card, cpu, fault = (runs["cuda"], runs["cpu"],
                        runs["cuda_ds_without_delta"])
    if min(card[3]) == 0 or max(cpu[3]) != 0 or min(fault[3]) == 0:
        raise AssertionError(f"small training launches (fwd, bwd): card "
                             f"{card[3]}, cpu {cpu[3]}, fault {fault[3]}")
    err, fault_err = log_err(card, cpu), log_err(fault, cpu)
    if card[1] != cpu[1] or card[2] != cpu[2] or not err <= SMALL_TRAIN_ATOL:
        raise AssertionError(f"card vs cpu training: log numbers differ by "
                             f"{err} (tol {SMALL_TRAIN_ATOL}), counts "
                             f"{card[1]} vs {cpu[1]}")
    if fault_err <= SMALL_TRAIN_ATOL and fault[1] == cpu[1]:
        raise AssertionError(f"the limit accepts training with dS without "
                             f"-delta: log numbers within {fault_err}")
    drop_bulk(root)
    log(f"  tiny training on the card vs the CPU (2 epochs, Pallas route, "
        f"launches fwd/bwd {card[3]}): log numbers within {err:.3g} (tol "
        f"{SMALL_TRAIN_ATOL}), TP/FP/FN/TN equal {card[1]}; with dS without "
        f"-delta planted the log differs by {fault_err:.4g} (rejected)")
    return {"max_abs_log_err": err, "tol": SMALL_TRAIN_ATOL,
            "confusion": card[1], "card_launches": card[3], "log": card[0],
            "ds_without_delta_max_abs_log_err": fault_err}


# ---------------------------------------------------------------------------
# phases 11 and 12: the grid path from video to J&F, prompts_grid ->
# tokens_grid -> eval / inference
# ---------------------------------------------------------------------------

GRID_BIN = 4
# per video: expression "0" refers to object 0, "1" to object 2
GRID_EXPRESSIONS = {"0": ("the red box moving right", 0),
                    "1": ("the blue square moving up", 2)}
AMG_KEEP = 24                 # proposals the first frame's gates pass
SAM2_CKPT = "pretrained_models/sam2_hiera_large.pt"  # absent: random
GRID_PROMPT_KEYS = {"segmentation", "stability_score", "area", "area_ratio",
                    "frame_idx", "prompt_id"}


def write_grid_corpus(root: str, videos) -> None:
    """A MeViS-layout valid_u split: JPEG frames, meta_expressions.json with
    GRID_EXPRESSIONS for each video, and mask_dict.json with each object's
    per-frame RLE (3 objects a video, anno ids counted across videos)."""
    from PIL import Image

    from sola_torch.core import rle
    data_dir = os.path.join(root, "datasets", "mevis", "valid_u")
    meta, mask_dict = {"videos": {}}, {}
    for v, (vid, frames, masks) in enumerate(videos):
        frames_dir = os.path.join(data_dir, "JPEGImages", vid)
        os.makedirs(frames_dir)
        for t, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(frames_dir, f"{t:05d}.jpg"))
        base = 3 * v
        meta["videos"][vid] = {
            "frames": [f"{t:05d}" for t in range(len(frames))],
            "expressions": {e: {"exp": text, "anno_id": [base + obj]}
                            for e, (text, obj) in GRID_EXPRESSIONS.items()}}
        for obj in range(3):
            mask_dict[str(base + obj)] = [rle.encode(m[obj]) for m in masks]
    with open(os.path.join(data_dir, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(data_dir, "mask_dict.json"), "w") as f:
        json.dump(mask_dict, f)


def gap_gate(values, lo_q: float, hi_q: float) -> float:
    """Midpoint of the widest gap between neighbouring distinct values from
    the ``lo_q`` to the ``hi_q`` quantile of the distinct values: no value
    sits near it."""
    v = np.unique(np.asarray(values, np.float64))
    v = v[max(int(lo_q * len(v)), 0):int(hi_q * len(v)) + 1]
    if len(v) < 2:
        raise AssertionError(f"no gap between quantiles {lo_q} and {hi_q}")
    i = int(np.argmax(np.diff(v)))
    return float(0.5 * (v[i] + v[i + 1]))


def probe_scores(pred, frames, side: int) -> tuple:
    """(IoUs, stabilities) of every proposal over the side x side grid on
    each frame, 256 points at a time."""
    from sola_torch.trackgen.sam2.amg import build_point_grid
    ious, stabs = [], []
    for frame in frames:
        h, w = frame.shape[:2]
        pred.set_image(frame)
        pts = build_point_grid(side) * np.asarray([w, h], np.float32)
        for i in range(0, len(pts), 256):
            iou, stab, _ = pred.propose(pts[i:i + 256, None])
            ious.append(iou.ravel())
            stabs.append(stab.ravel())
    return np.concatenate(ious), np.concatenate(stabs)


class FallbackCounter:
    """Counts the AMG's overflow fallbacks, each of which encodes its frame
    again (3 more flash launches at hiera-L)."""

    def __init__(self, amg):
        self.n = 0
        inner = amg._generate_multi_dispatch

        def counted(*args, **kwargs):
            self.n += 1
            return inner(*args, **kwargs)
        amg._generate_multi_dispatch = counted


def check_grid_prompt_json(info: dict, vid: str, n_frames: int, hw) -> int:
    """The grid prompt JSON's schema and invariants; returns its prompt
    count."""
    from sola_torch.core import rle
    pms = info["prompt_masks"]
    if info["video_id"] != vid or info["bin_size"] != GRID_BIN or not pms:
        raise AssertionError(f"prompt JSON head: {info['video_id']} "
                             f"{info['bin_size']} {len(pms)} prompts")
    for i, p in enumerate(pms):
        m = rle.decode(p["segmentation"])
        if (set(p) != GRID_PROMPT_KEYS or p["prompt_id"] != i
                or p["frame_idx"] % GRID_BIN or p["frame_idx"] >= n_frames
                or m.shape != tuple(hw) or m.sum() != p["area"]
                or not 0.0 <= p["stability_score"] <= 1.0
                or abs(p["area_ratio"] - p["area"] / m.size) > 1e-9):
            raise AssertionError(f"prompt {i} breaks the schema: "
                                 f"{ {k: v for k, v in p.items() if k != 'segmentation'} }")
    areas = [p["area"] for p in pms]
    if areas != sorted(areas, reverse=True):
        raise AssertionError("prompts are not sorted by area")
    return len(pms)


def amg_breakdown(amg, frame) -> dict:
    """Where a warm AMG frame's time goes at the path's shapes: the encode,
    the whole-grid propose/filter, the finalize of the survivors' prefix,
    and the host phase (NMS, the kept masks' fetch, the records); a whole
    ``generate``; and one profiled ``generate``."""
    from sola_torch.trackgen.sam2.amg import build_point_grid
    pred = amg.predictor
    h, w = frame.shape[:2]
    coords = build_point_grid(amg.points_per_side) * np.asarray(
        [w, h], np.float32)

    def propose():
        return pred.propose_filter(
            coords[:, None], amg.stability_score_offset,
            amg.pred_iou_thresh, amg.stability_score_thresh,
            chunk=amg.points_per_batch, k_max=amg.max_survivors)

    out = {"encode_ms": host_ms(lambda: pred.set_image(frame)),
           "propose_filter_ms": host_ms(propose)}
    proposal = propose()
    low, n_valid = proposal[1], int(proposal[-1])
    k_fin = min(low.shape[0], max(64, 1 << max(n_valid - 1, 0).bit_length()))
    out["survivors"] = n_valid
    out["finalize_ms"] = host_ms(lambda: pred.finalize_masks_dispatch(
        low, h, w, k_fin=k_fin))
    host = []
    for _ in range(3):
        fin = amg._dispatch_finalize(amg._enqueue(frame))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amg._finish(fin)
        host.append((time.perf_counter() - t0) * 1e3)
    out["host_ms"] = statistics.median(host)
    out["generate_ms"] = host_ms(lambda: amg.generate(frame))
    out["generate_profile"] = profile_forward(
        lambda: amg.generate(frame), kernels_of=(("flash_fwd", "flash_fwd_"),))
    return out


def grid_configs(root: str, exp_name: str, model: dict) -> str:
    """configs/mevis/default.yaml over the phase's corpus and tracks (the
    valid and test splits both valid_u, grid_tracks only), written next to
    them; returns the YAML's path."""
    import yaml

    from sola_torch import config as config_lib
    configs = config_lib.load_config("mevis/default")
    configs["exp_name"] = exp_name
    configs["model"].update(model)
    split = {"data_name": "mevis", "data_type": "valid_u",
             "sam2_output_dirs": "grid_tracks", "batch_size": 1}
    configs["dataset"] = {
        "data_root": os.path.join(root, "datasets"),
        "track_root": os.path.join(root, "sam2_tracks"), "num_workers": 2,
        "train": dict(split), "valid": dict(split), "test": dict(split)}
    configs["results"] = {k: os.path.join(root, v) for k, v in (
        ("output_dir", "TRAIN"), ("eval_output_dir", "EVAL"),
        ("test_output_dir", "INFERENCE"))}
    path = os.path.join(root, f"{exp_name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(configs, f)
    return path


def save_selection_checkpoint(yaml_path: str, seed: int) -> None:
    """A seeded random selection model of the YAML's config as
    ``epoch_0.pth`` in its train output dir."""
    from sola_torch import config as config_lib
    from sola_torch.models.selection import SelectionConfig
    from sola_torch.train.loop import build_model
    configs = config_lib.load_config(yaml_path)
    model = build_model(SelectionConfig.from_dict(configs["model"]), "cpu",
                        seed=seed)
    out = config_lib.train_output_dir(configs)
    os.makedirs(out, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(out, "epoch_0.pth"))


def eval_outputs(yaml_path: str, device: str, extra=()) -> dict:
    """Both eval CLIs at epoch 0 on ``device``: their wall seconds and
    flash launches, the two eval JSONs and the inference PNGs' digests."""
    import hashlib

    from sola_torch import config as config_lib
    from sola_torch.cli import eval as eval_cli
    from sola_torch.cli import inference as inference_cli
    from sola_torch.ops import flash_attention as fa
    argv = ["--config", yaml_path, "--eval_weight_epoch", "0",
            "--device", device, *extra]
    out = {}
    for name, main in (("eval", eval_cli.main),
                       ("inference", inference_cli.main)):
        _sync(device)
        fa.launches = 0  # this CLI's count starts here
        t0 = time.perf_counter()
        main(argv)
        _sync(device)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = fa.launches  # read right after
    configs = config_lib.load_config(yaml_path)
    eval_dir = config_lib.eval_output_dir(configs, 0.5, 0)
    for key, name in (("metrics", "valid_u_metrics_0epoch.json"),
                      ("jf", "valid_u_JF_metrics_0epoch.json")):
        with open(os.path.join(eval_dir, name)) as f:
            out[key] = json.load(f)
    png_dir = config_lib.inference_output_dir(configs, 0.5, 0)
    out["pngs"] = {}
    for d, _, files in os.walk(png_dir):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out["pngs"][os.path.relpath(os.path.join(d, name),
                                            png_dir)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def check_jf(out: dict, n_expressions: int) -> None:
    jf = out["jf"]
    vals = [e[k] for v in jf.values() for e in v.values()
            for k in ("J", "F", "JF")]
    vals += [out["metrics"][k] for k in ("mean_J", "mean_F", "mean_JF")]
    if (sum(len(v) for v in jf.values()) != n_expressions
            or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in vals)):
        raise AssertionError(f"J&F JSON: {jf}")


def run_grid_main_path(fa) -> dict:
    """Phase 11: the grid path from video to J&F at SAM2 hiera-L and
    SelectionConfig(): prompts_grid.main (32 x 32 points, 256 a chunk,
    bin 4) -> tokens_grid.main -> cli.eval and cli.inference with the
    flash attention route, on 2 synthetic 12-frame 480x854 videos."""
    from sola_torch.core import rle
    from sola_torch.data import tracks
    from sola_torch.trackgen import prompts_grid, tokens_grid
    from sola_torch.trackgen.sam2.amg import SAM2AutomaticMaskGenerator
    from sola_torch.trackgen.sam2.convert import load_sam2_image_predictor
    root = os.path.join(OUT_DIR, "grid")
    videos = []
    for i in range(2):
        frames, masks = synthetic_video(10 + i)
        videos.append((f"grid{i}", frames, masks))
    write_grid_corpus(root, videos)
    t0 = time.perf_counter()
    image_pred = load_sam2_image_predictor(SAM2_CKPT, device="cuda")
    video_pred = tokens_grid._default_predictor_factory(
        SAM2_CKPT, obj_batch=4, device="cuda")()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the gates' probe warms the image predictor up
    # gates from the first frame's scores (the probe warms the predictor
    # up): stability in the top sixth to third of its distinct values, IoU
    # then passing AMG_KEEP / 2 to 2 x AMG_KEEP distinct values of those
    ious, stabs = probe_scores(image_pred, videos[0][1][:1], 32)
    stab_t = gap_gate(stabs, 2 / 3, 5 / 6)
    passing = np.unique(ious[stabs > stab_t])
    iou_t = gap_gate(passing, 1 - 2 * AMG_KEEP / len(passing),
                     1 - AMG_KEEP / 2 / len(passing))
    amg = SAM2AutomaticMaskGenerator(image_pred, points_per_side=32,
                                     points_per_batch=256,
                                     pred_iou_thresh=iou_t,
                                     stability_score_thresh=stab_t)
    fallbacks = FallbackCounter(amg)
    argv = ["--data_root", root, "--output_root", root, "--bin_size",
            str(GRID_BIN), "--device", "cuda"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0  # prompts_grid's count starts here
    t0 = time.perf_counter()
    prompts_grid.main(argv, amg_factory=lambda: amg)
    torch.cuda.synchronize()
    prompts_s = time.perf_counter() - t0
    amg_launches = fa.launches  # read right after
    binned = len(videos) * len(range(0, T_FRAMES, GRID_BIN))
    # one launch per global attention block per encode: 3 at hiera-L
    per_encode = len(image_pred.cfg.image_encoder.hiera.global_att_blocks)
    if amg_launches != per_encode * (binned + fallbacks.n):
        raise AssertionError(f"flash launches in the AMG: {amg_launches}, "
                             f"want {per_encode} x ({binned} binned frames "
                             f"+ {fallbacks.n} fallbacks)")
    n_prompts = {}
    for vid, _, _ in videos:
        with open(os.path.join(root, "sam2_prompts", "grid_prompts", "mevis",
                               "valid_u", f"{vid}.json")) as f:
            n_prompts[vid] = check_grid_prompt_json(json.load(f), vid,
                                                    T_FRAMES, (H_VID, W_VID))

    fa.launches = 0  # tokens_grid's count starts here
    t0 = time.perf_counter()
    tokens_grid.main(argv + ["--batch_size", "4", "--save_prec_rec_iou"],
                     predictor_factory=lambda: video_pred)
    torch.cuda.synchronize()
    tokens_s = time.perf_counter() - t0
    tokens_launches = fa.launches
    with open(os.path.join(root, "sam2_tracks", "grid_tracks", "mevis",
                           "valid_u", f"runtime_info_{GRID_BIN}.json")) as f:
        census = json.load(f)
    for vid, _, _ in videos:
        check_tracks(os.path.join(root, "sam2_tracks"), vid, census[vid],
                     tracks, rle, video_pred.cfg.d_model)
    tracked = sum(c["n_tracked"] for c in census.values())
    track_s = sum(c["time"] for c in census.values())
    if tokens_launches == 0:
        raise AssertionError("no flash launch in tokens_grid")

    yaml_path = grid_configs(root, "grid_main_path",
                             {"text_encoder": "roberta_random"})
    save_selection_checkpoint(yaml_path, seed=0)
    ev = eval_outputs(yaml_path, "cuda",
                      extra=("--model.use_pallas_attention", "true"))
    n_expr = len(videos) * len(GRID_EXPRESSIONS)
    check_jf(ev, n_expr)
    if ev["eval_launches"] <= 0 or len(ev["pngs"]) != T_FRAMES * n_expr:
        raise AssertionError(f"eval launches {ev['eval_launches']}, "
                             f"{len(ev['pngs'])} PNGs (want "
                             f"{T_FRAMES * n_expr})")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bd = amg_breakdown(amg, videos[0][1][0])
    prof = bd["generate_profile"]
    row = {"pred_iou_thresh": iou_t, "stability_score_thresh": stab_t,
           "binned_frames": binned, "fallbacks": fallbacks.n,
           "prompts": n_prompts, "prompts_main_s": prompts_s,
           "prompt_frames_per_s": binned / prompts_s,
           "tokens_main_s": tokens_s, "tracking_s": track_s,
           "object_fps": tracked * T_FRAMES / track_s,
           "census": {v: {k: c[k] for k in ("n_tracked", "n_filtered",
                                             "n_not_used", "n_total")}
                      for v, c in census.items()},
           "launches": {"prompts_grid": amg_launches,
                        "tokens_grid": tokens_launches,
                        "eval": ev["eval_launches"],
                        "inference": ev["inference_launches"]},
           "eval_s": ev["eval_s"], "inference_s": ev["inference_s"],
           "metrics": {k: ev["metrics"][k] for k in (
               "mean_J", "mean_F", "mean_JF", "tp", "fp", "fn", "tn")},
           "pngs": len(ev["pngs"]), "peak_memory_gb": peak_gb,
           "build_s": build_s, "breakdown": bd}
    log(f"  AMG gates from frame 0's scores: pred_iou_thresh {iou_t:.6f}, "
        f"stability_score_thresh {stab_t:.6f}; prompts {n_prompts}")
    log(f"  prompts_grid.main: {binned} binned frames in {prompts_s:.2f} s "
        f"({row['prompt_frames_per_s']:.3f} frames/s, reading the frames "
        f"included; {fallbacks.n} overflow fallbacks), flash launches "
        f"{amg_launches} ({per_encode} a frame); tokens_grid.main "
        f"{tokens_s:.2f} s, "
        f"tracking {track_s:.2f} s ({row['object_fps']:.2f} object-fps "
        f"over {tracked} tracks), census {row['census']}")
    log(f"  cli.eval {ev['eval_s']:.2f} s (flash launches "
        f"{ev['eval_launches']}), cli.inference {ev['inference_s']:.2f} s "
        f"({ev['inference_launches']}); {row['metrics']}; {len(ev['pngs'])}"
        f" PNGs; peak memory {peak_gb:.2f} GB; card {smi_line()}")
    log(f"  AMG frame, warm ({bd['survivors']} survivors): encode "
        f"{bd['encode_ms']:.2f} ms, propose/filter "
        f"{bd['propose_filter_ms']:.2f} ms, finalize {bd['finalize_ms']:.2f}"
        f" ms, NMS + fetch + records {bd['host_ms']:.2f} ms; generate "
        f"{bd['generate_ms']:.2f} ms; one profiled generate: " + (
            "not measured (the profiler recorded no device kernel)"
            if prof["busy_ms"] is None else
            f"wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f})"
            f", flash fwd {prof['flash_fwd_ms']:.3f} ms "
            f"({prof['flash_fwd_launches']} launches), {prof['kernels']} "
            f"kernels; most time: " + "; ".join(
                f"{n[:60]} {ms:.2f} ms" for n, ms in prof["top_kernels_ms"])))
    del amg, image_pred, video_pred
    torch.cuda.empty_cache()
    drop_bulk(root)
    return row


def fused_everywhere(model):
    """Lower the flash kernel's size thresholds so a tiny SAM2 takes it."""
    from sola_torch.trackgen.sam2 import hiera, memory
    for m in model.modules():
        if isinstance(m, hiera.MultiScaleAttention):
            m.fused_min_tokens = 1
        if isinstance(m, memory.RoPEAttention):
            m.fused_min_keys = 1
    return model


def _same_records(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        (x["area"], x["bbox"], x["predicted_iou"], x["stability_score"])
        == (y["area"], y["bbox"], y["predicted_iou"], y["stability_score"])
        and np.array_equal(x["segmentation"], y["segmentation"])
        for x, y in zip(a, b))


# card against CPU at tiny size (fp32, TF32 off): predicted IoUs differ by
# summation order; stability is a ratio of 16 x 16 low-res pixel counts
# (one pixel at the +-1 logit edge moves it by about 1/256); a mask logit
# at 0 may round either way.
GRID_SMALL_TOL = {"predicted_iou": 1e-4, "stability": 1e-2,
                  "mask_pixels": 5e-3}
# The eval JSONs: confusion counts equal, J, F and J&F within 1e-6 (the
# same masks), the losses and score means within 1e-5 relative. A score
# std (the leaves ``*_score/1``) moves by at most the scores' largest
# difference, which a std of a few close scores may carry at well over
# 1e-5 of its size, so a std passes within 1e-5 relative or EVAL_STD_ATOL.
# That floor sits between the card's fp32 reading (largest std difference
# 1.97e-6) and a control run with the selection attention in bf16, which
# the check must reject (PERF.md, phase 12).
EVAL_RTOL, EVAL_STD_ATOL, JF_ATOL = 1e-5, 4e-6, 1e-6


def _json_leaves(got, ref, path=""):
    """(path, got, ref) of every float leaf of two eval JSONs and of every
    other leaf where they differ."""
    if isinstance(ref, dict) and isinstance(got, dict) and set(got) == set(
            ref):
        for key in ref:
            yield from _json_leaves(got[key], ref[key], f"{path}/{key}")
    elif (isinstance(ref, list) and isinstance(got, list)
          and len(got) == len(ref)):
        for i, (a, b) in enumerate(zip(got, ref)):
            yield from _json_leaves(a, b, f"{path}/{i}")
    elif isinstance(ref, float) or got != ref:
        yield path, got, ref


def _is_std(path: str) -> bool:
    return path.endswith("_score/1")


def _float_ok(path, got, ref) -> bool:
    atol = EVAL_STD_ATOL if _is_std(path) else 0.0
    return isinstance(ref, float) and isinstance(got, float) and (
        (np.isnan(got) and np.isnan(ref))
        or abs(got - ref) <= max(atol, EVAL_RTOL * abs(ref)))


def eval_differences(got: dict, ref: dict) -> tuple:
    """The leaves of two eval runs that break the limits above, and the
    readings: the largest std difference and the largest relative
    difference of the other floats."""
    leaves = list(_json_leaves(got["metrics"], ref["metrics"]))
    errors = ([leaf for leaf in leaves if not _float_ok(*leaf)]
              + [(v, e, k, got["jf"][v][e][k], ref["jf"][v][e][k])
                 for v in ref["jf"] for e in ref["jf"][v]
                 for k in ("J", "F", "JF")
                 if abs(got["jf"][v][e][k] - ref["jf"][v][e][k]) > JF_ATOL])
    finite = [(p, a, b) for p, a, b in leaves
              if isinstance(b, float) and np.isfinite(b)]
    std = max((abs(a - b) for p, a, b in finite if _is_std(p)), default=0.0)
    rel = max((abs(a - b) / max(abs(b), 1e-30) for p, a, b in finite
               if not _is_std(p)), default=0.0)
    return errors, {"std_max_abs_err": std, "other_max_rel_err": rel}


def run_grid_small_reference(fa) -> dict:
    """Phase 12: the grid path's new modules at tiny size on the card (fp32,
    the flash kernel's thresholds lowered so it runs) against the CPU, which
    runs the kernel's plain version: generate's records; generate_many on
    the card against generate on the card, exactly; the overflow fallback
    against the single pass, exactly; the eval JSONs."""
    from sola_torch.data import synthetic
    from sola_torch.trackgen.sam2.amg import (SAM2AutomaticMaskGenerator,
                                              build_point_grid)
    from sola_torch.trackgen.sam2.convert import load_sam2_image_predictor
    from sola_torch.trackgen.sam2.model import SAM2Config
    frames = _small_frames()[0]

    def amg_on(device, **kw):
        pred = load_sam2_image_predictor(
            None, cfg=SAM2Config.tiny_test(64), device=device, seed=3,
            compute_dtype=torch.float32)
        fused_everywhere(pred.model)
        return SAM2AutomaticMaskGenerator(pred, points_per_side=8,
                                          points_per_batch=16, **kw)

    # gates from the CPU's scores over 4 frames: stability between the
    # 0.3 and 0.7 quantiles of its distinct values, IoU then between the
    # 0.2 and 0.8 quantiles of the distinct values it passes
    ious, stabs = probe_scores(amg_on("cpu").predictor, frames[:4], 8)
    stab_t = gap_gate(stabs, 0.3, 0.7)
    passing = ious[stabs > stab_t]
    iou_t = gap_gate(passing, 0.2, 0.8)
    margin = min(np.abs(passing - iou_t).min(), np.abs(stabs - stab_t).min())
    # card and CPU must make the same keep decisions: their scores differ
    # by less than the predicted-IoU limit
    if margin <= GRID_SMALL_TOL["predicted_iou"]:
        raise AssertionError(f"a score lies {margin} from a gate")
    gates = dict(pred_iou_thresh=iou_t, stability_score_thresh=stab_t)
    before = fa.launches
    card = amg_on("cuda", **gates).generate(frames[0])
    card_launches = fa.launches - before
    before = fa.launches
    cpu = amg_on("cpu", **gates).generate(frames[0])
    if fa.launches != before or card_launches == 0:
        raise AssertionError(f"small AMG launches: card {card_launches}, "
                             f"cpu {fa.launches - before}")
    if len(card) != len(cpu) or not card:
        raise AssertionError(f"records: card {len(card)}, cpu {len(cpu)}")
    errs = dict.fromkeys(GRID_SMALL_TOL, 0.0)
    for a, b in zip(card, cpu):
        errs["predicted_iou"] = max(errs["predicted_iou"], abs(
            a["predicted_iou"] - b["predicted_iou"]))
        errs["stability"] = max(errs["stability"], abs(
            a["stability_score"] - b["stability_score"]))
        errs["mask_pixels"] = max(errs["mask_pixels"], float(
            (a["segmentation"] != b["segmentation"]).mean()))
    # the survivor buffer (score order, NMS's input) on both devices
    bufs = []
    for device in ("cuda", "cpu"):
        pred = amg_on(device).predictor
        pred.set_image(frames[2])
        pts = build_point_grid(8) * np.asarray([64, 48], np.float32)
        out = pred.propose_filter(pts[:, None], 1.0, gates["pred_iou_thresh"],
                                  gates["stability_score_thresh"], chunk=16,
                                  k_max=64)
        bufs.append([t.cpu().numpy() for t in out])
    (g_sc, _, g_flat, _, _, g_n), (c_sc, _, c_flat, _, _, c_n) = bufs
    k = min(int(c_n), 64)
    survivors_equal = (int(g_n) == int(c_n) > 0
                       and np.array_equal(g_flat, c_flat))
    errs["predicted_iou"] = max(errs["predicted_iou"], float(
        np.abs(g_sc[:k] - c_sc[:k]).max()))
    bad = {k: (v, GRID_SMALL_TOL[k]) for k, v in errs.items()
           if v > GRID_SMALL_TOL[k]}
    if bad or not survivors_equal:
        raise AssertionError(f"AMG card vs cpu beyond tolerance: {bad}; "
                             f"survivors {int(g_n)} / {int(c_n)}, equal "
                             f"order {survivors_equal}")

    # every survivor becomes a record (NMS at 1.0), so ~100 records a frame
    amg = amg_on("cuda", box_nms_thresh=1.0, **gates)
    many = list(amg.generate_many(iter(frames[:4])))
    one = [amg.generate(f) for f in frames[:4]]
    if not all(_same_records(a, b) for a, b in zip(many, one)):
        raise AssertionError("generate_many differs from generate")
    permissive = dict(pred_iou_thresh=-10.0, stability_score_thresh=-1.0,
                      box_nms_thresh=1.0)
    single = amg_on("cuda", **permissive).generate(frames[1])
    fb_amg = amg_on("cuda", max_survivors=4, **permissive)
    fallbacks = FallbackCounter(fb_amg)
    fallback = fb_amg.generate(frames[1])
    if fallbacks.n != 1 or not _same_records(fallback, single):
        raise AssertionError(f"overflow fallback ({fallbacks.n} taken): "
                             f"{len(fallback)} records against "
                             f"{len(single)}")

    # eval on the card against the CPU: a tiny corpus and selection model
    root = os.path.join(OUT_DIR, "grid_small")
    gen = synthetic.generate(os.path.join(root, "data"), n_videos=2,
                             n_frames=8, h=48, w=64, n_objects=2,
                             n_distractors=3)
    # the control runs the card's selection attention in bf16: the eval
    # check has to reject it
    from sola_torch.models import attention
    fused = attention.fused_attention

    def bf16_attention(q, k, v, **kw):
        return fused(q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw).to(
            q.dtype)

    runs = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu"),
                         ("control", "cuda")):
        ws = os.path.join(root, name)
        os.makedirs(ws)
        yaml_path = grid_configs(ws, "grid_small", {
            "object_token_dim": 256, "lang_token_dim": 64, "n_layers": 1,
            "n_negative": 4, "dropout_p": 0.0, "attn_dropout_p": 0.0,
            "use_pallas_attention": True})
        import yaml
        with open(yaml_path) as f:
            configs = yaml.safe_load(f)
        configs["dataset"]["data_root"] = gen["data_root"]
        configs["dataset"]["track_root"] = gen["track_root"]
        with open(yaml_path, "w") as f:
            yaml.safe_dump(configs, f)
        save_selection_checkpoint(yaml_path, seed=1)
        attention.fused_attention = (bf16_attention if name == "control"
                                     else fused)
        try:
            runs[name] = eval_outputs(yaml_path, device)
        finally:
            attention.fused_attention = fused
    c, g = runs["cpu"], runs["card"]
    check_jf(g, 4)
    errors, readings = eval_differences(g, c)
    control_errors, control = eval_differences(runs["control"], c)
    counts = [(g["metrics"][k], c["metrics"][k]) for k in ("tp", "fp", "fn",
                                                           "tn")]
    if (errors or g["pngs"] != c["pngs"] or g["eval_launches"] == 0
            or c["eval_launches"] != 0):
        raise AssertionError(f"eval card vs cpu: {errors[:5]}, counts "
                             f"{counts}, launches {g['eval_launches']} / "
                             f"{c['eval_launches']}")
    if not control_errors or runs["control"]["eval_launches"] == 0:
        raise AssertionError(f"the eval check passes the bf16 control: "
                             f"{control}")
    jf_err = max(abs(g["jf"][v][e][k] - c["jf"][v][e][k]) for v in c["jf"]
                 for e in c["jf"][v] for k in ("J", "F", "JF"))
    drop_bulk(root)
    log(f"  tiny_test AMG on the card vs the CPU (fp32, kernel route, "
        f"{card_launches} launches): {len(card)} records and the "
        f"{int(c_n)} survivors' order agree, largest "
        f"differences {errs} (limits {GRID_SMALL_TOL}); generate_many over "
        f"4 frames equals generate ({sum(map(len, one))} records); the "
        f"overflow fallback (max_survivors 4) equals the single pass "
        f"({len(single)} records); eval on the card vs the CPU: counts "
        f"{counts}, largest std difference {readings['std_max_abs_err']:.3g}"
        f" (limit {EVAL_STD_ATOL:.3g}), other floats within "
        f"{readings['other_max_rel_err']:.3g} rel (limit {EVAL_RTOL}); bf16 "
        f"control rejected ({len(control_errors)} leaves, {control}), J&F "
        f"within {jf_err:.3g} (limit {JF_ATOL}), {len(g['pngs'])} PNGs "
        f"alike, flash launches {g['eval_launches']}")
    return {"amg_errors": errs, "limits": GRID_SMALL_TOL, "gates": gates,
            "gate_margin": float(margin),
            "records": len(card), "survivors": int(c_n),
            "generate_many_records":
            sum(map(len, one)), "fallback_records": len(single),
            "eval_counts": counts, "jf_max_abs_err": jf_err,
            "eval_readings": readings, "eval_control_readings": control,
            "eval_control_rejected_leaves": len(control_errors),
            "eval_limits": {"rtol": EVAL_RTOL, "std_atol": EVAL_STD_ATOL,
                            "jf_atol": JF_ATOL},
            "card_launches": {"amg": card_launches,
                              "eval": g["eval_launches"]}}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    from sola_torch.ops import deformable_interp as di
    from sola_torch.ops import flash_attention as fa
    from sola_torch.ops import kernel_build

    smi = smi_line()
    # fp32 products in full fp32 on both paths; bf16 is the main path's type
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)

    t0 = time.perf_counter()
    kernel_build.build_all()  # one nvcc per kernel, all started together
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for "
        + ", ".join(f"{name} (nvcc {info['seconds']:.2f} s)"
                    for name, info in kernel_build.build_info.items()))
    ptxas = []
    for name, info in kernel_build.build_info.items():
        for ln in info["log"].splitlines():
            if "Compiling entry function" in ln:  # names the instance below
                ptxas.append(ptxas_instance(name, ln))
            elif "registers" in ln or "spill" in ln:
                ptxas.append(ln.strip())
    for ln in ptxas:
        log(f"  ptxas: {ln}")

    gen = torch.Generator().manual_seed(0)
    log("phase 2: flash kernel vs its plain version")
    kernel = check_flash_kernel(fa, gen)
    log("phase 3: tokens_grid main path at SAM2 hiera-L")
    di.launches = 0  # run_main_path zeroes the flash count itself
    main_path = run_main_path(fa)
    main_path["deform_launches"] = di.launches  # the path has no GDINO
    log("phase 4: small reference")
    small = run_small_reference(fa)
    log("phase 5: deformable sampling kernel vs its plain version")
    deform = check_deform_kernel(gen)
    log("phase 6: prompts_gdino -> tokens_gdino at GroundingDINO Swin-T + "
        "BERT-base and SAM2 hiera-L")
    gdino_path = run_gdino_path(fa, di)
    log("phase 7: GroundingDINO small reference")
    gdino_small = run_gdino_small_reference(fa, di)
    log("phase 8: training attention kernels (forward with dropout, fused "
        "backward) vs their plain versions")
    training_kernels = check_flash_training_kernels(fa, gen)
    log("phase 9: selection training at full width (Pallas route, "
        "RoBERTa-large)")
    training = run_selection_training(fa)
    log("phase 10: selection training small reference")
    training_small = run_selection_small_reference(fa)
    log("phase 11: the grid path from video to J&F: prompts_grid -> "
        "tokens_grid -> eval / inference at SAM2 hiera-L and "
        "SelectionConfig()")
    grid_path = run_grid_main_path(fa)
    log("phase 12: grid path small reference")
    grid_small = run_grid_small_reference(fa)

    head = kernel["rows"][0]  # memory cross-attention: most of the time
    # the main path's shape: 3 expressions padded to 4, fp32 (CLI default)
    dhead = next(r for r in deform["rows"] if r["shape"] == "encoder_e4")
    # the training path's largest site in fp32: object2lang_attn
    thead = next(r for r in training_kernels["rows"]
                 if r["shape"] == "object2lang_attn")
    by_path = {
        "flash_attn_fwd": {"tokens_grid": main_path["launches"],
                           "gdino": gdino_path["launches"]["flash_attn_fwd"],
                           "train": training["launches"]["flash_attn_fwd"],
                           "prompts_grid":
                           grid_path["launches"]["prompts_grid"],
                           "tokens_grid_from_grid_prompts":
                           grid_path["launches"]["tokens_grid"],
                           "eval": grid_path["launches"]["eval"],
                           "inference": grid_path["launches"]["inference"]},
        "ms_deform_attn_fwd": {
            "tokens_grid": main_path["deform_launches"],
            "gdino": gdino_path["launches"]["ms_deform_attn_fwd"]}}
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "sola_torch/csrc/flash_attn_fwd.cu",
        "replaces": "sola_tpu/ops/flash_attention.py:64",
        "launches": sum(by_path["flash_attn_fwd"].values()),
        "max_abs_err": max(
            [r["max_abs_err"] for r in kernel["rows"]]
            + [r[f"fwd_{t}"]["max_abs_err"] for r in training_kernels["rows"]
               for t in ("nodrop", "drop")]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": head["shape"], "launches_by_path": by_path["flash_attn_fwd"],
        "shapes": kernel["rows"],
        "training_shapes": [{"shape": r["shape"], **r["fwd"],
                             "ms_without_dropout": r["fwd_nodrop_ms"]}
                            for r in training_kernels["rows"]]}]
    kernels.append({
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "sola_torch/csrc/flash_attn_bwd.cu",
        "replaces": "sola_tpu/ops/flash_attention.py:117 and "
                    "sola_tpu/ops/flash_attention.py:159",
        "launches": training["launches"]["flash_attn_bwd"],
        "max_abs_err": max(r[f"{g}_{t}"]["max_abs_err"]
                           for r in training_kernels["rows"]
                           for g in ("dq", "dk", "dv")
                           for t in ("nodrop", "drop")),
        # the kernel alone beside SDPA's backward alone (torch.profiler),
        # and both by call (CUDA events)
        "ms": thead["bwd"]["device_ms"], "ms_by_call": thead["bwd"]["ms"],
        **{k: thead["bwd"][k] for k in ("plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "library_by_call_ms")},
        "at": f"{thead['shape']}, dropout {SEL_RATE}",
        "launches_by_path": {"train": training["launches"]["flash_attn_bwd"]},
        "shapes": [{"shape": r["shape"], "plan": r["plan"], **r["bwd"]}
                   for r in training_kernels["rows"]]})
    kernels.append({
        "name": "ms_deform_attn_fwd", "route": "cuda",
        "source": "sola_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "sola_tpu/ops/deformable_interp.py:42",
        "launches": sum(by_path["ms_deform_attn_fwd"].values()),
        "max_abs_err": max(r["max_abs_err"] for r in deform["rows"]),
        "ms": dhead["ms"], "plain_ms": dhead["plain_ms"],
        "bound_ms": dhead["bound_ms"], "bound_by": dhead["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
        "at": dhead["shape"],
        "launches_by_path": by_path["ms_deform_attn_fwd"],
        "shapes": deform["rows"]})
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "kernels": kernels,
                   "main_path": main_path, "small_reference": small,
                   "gdino_path": gdino_path, "gdino_small_reference":
                   gdino_small, "training_kernels": training_kernels,
                   "selection_training": training,
                   "selection_small_reference": training_small,
                   "grid_path": grid_path,
                   "grid_small_reference": grid_small,
                   "ptxas": ptxas}, f, indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in row.items()
         if k not in ("shapes", "training_shapes")} for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
