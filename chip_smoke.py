"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero, and no result line prints):

1. Environment: the card's name and power limit, torch and CUDA versions,
   both TF32 flags (set explicitly), and the kernel build time.
2. Kernels: builds every CUDA kernel of the port from the sources in this
   checkout (one nvcc per kernel, all at once), and holds the flash
   kernel against its plain PyTorch
   version on the card at the shapes and types the main path gives it
   (bf16 in memory attention at batch 4, a packed round's 8 slots and
   sequential GT's 1, fp32 at Hiera's global blocks, whose shape is
   checked in bf16 too) and at check shapes in both types (ragged
   head dims, a partial 128-row block, a zero-filled last key tile, masks
   that empty alternate key tiles or all but the last, one batch*head),
   and shows the limits reject a wrong key tile;
   times kernel, plain version, one library call (a yardstick the port
   never calls) and the bound (the least time the card could take).
3. The main path: SAM2 hiera-L (full width, seeded random weights) built by
   tokens_grid's own predictor factory, ``init_state`` + ``run_video`` on 2
   synthetic 12-frame 480x854 videos; checks the written masklets and
   tokens, the census, and the flash kernel's records in a torch.profiler
   trace of each stage (Hiera's global blocks during the encode; memory
   attention's, 2 a layer each propagation step, during propagation: the
   steps replay CUDA graphs, which no wrapper call sees); then measures how
   far the bf16-compute encoder's features lie from an fp32 model's.
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
   SAM2 image encode and video encode by wrapper call, propagation by
   device record, 2 a memory-attention layer a step). Then one forward of the
   Swin-B GroundingDINO (a swinb checkpoint name, absent: seeded random
   weights) on the same frame and expressions: 6 + 6 deformable launches,
   finite boxes, its time beside Swin-T's.
7. A small reference for that path: both stages at GDINOConfig.tiny_test
   and SAM2Config.tiny_test on the card (fp32) against the CPU.
8. The training attention kernels against their plain versions at the
   selection model's three call sites (obj_attn, motion_attn,
   object2lang_attn; fp32, full width, the path's masks), a bf16 check
   shape and three backward check shapes (keys spanning several chunks,
   D 256 in bf16, a batch entry with no valid key): the forward at dropout
   0 and 0.1, the fused backward (dQ, dK, dV) without and with dropout
   (the kernels read the seed from a slot inside a buffer of seeds, as a
   replayed training step gives it),
   masked keys' gradients exactly zero; shows the limits reject three
   wrong backward results; times each kernel (by call and alone), its
   plain version, a library yardstick and the bound.
9. Selection training at full width through ``sola_torch.train.loop.train``
   (SelectionConfig defaults with the Pallas attention route, a seeded
   random RoBERTa-large, configs/mevis/default.yaml's train values) on a
   synthetic corpus at bench.py's train shapes, 2 epochs: checks log.txt,
   that both checkpoints load strictly and the weights moved, the two
   kernels' records in a device trace of the run (training steps replay
   CUDA graphs, which no wrapper sees; CUPTI records their kernels), and
   the wrappers' calls at each call site (a shape's warm-up and capture,
   each validation batch); warm steps/s, pairs/s, peak memory and one
   profiled step.
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
   and the flash launches (3 per binned frame in the AMG, 2 a
   memory-attention layer each propagation step by device record, some in
   eval);
   prompt frames/s with a warm AMG frame's breakdown, object-fps, eval and
   inference seconds, peak memory.
12. A small reference for that path at SAM2Config.tiny_test: the AMG's
   records on the card against the CPU, generate_many against generate
   and the overflow fallback against the single pass on the card
   (exactly), and the eval JSONs and PNGs on the card against the CPU.
13. Packed propagation and GT tracks at SAM2 hiera-L (seeded random
   weights from the CLIs' own predictor factory): tokens_grid.main
   --video_pack 2 on 2 synthetic 12-frame 480x854 JPEG videos with grid
   prompt JSONs, tokens_gdino.main --expr_pack 3 on a 3-expression prompt
   JSON, tokens_gt.main --save_prec_rec_iou --video_pack 2 on a MeViS
   train layout of 2 videos with 3 GT objects each (one re-appears, one
   first appears at frame 3); each against its sequential run at the
   CLI's default obj_batch and at the packed run's 8: the same artifact
   files and decisions, masks, tokens and prec/rec/IoU within stated
   limits, the flash kernel at memory attention in every run, 2 a layer
   each step (its device records in a torch.profiler trace of the run: the
   propagation steps replay CUDA graphs, which no wrapper call sees), and
   the rest of its records at the image encoder; object-fps (under the
   profiler), GT seeds/s and peak memory.
14. A small reference for the packed paths at SAM2Config.tiny_test (fp32):
   packed grid tracks, packed expressions, sequential and packed GT on the
   card against the CPU; packed against sequential on the card under
   tests/test_packed.py's bounds; bank pushes on idle steps (the gate taken
   away) must break the packed GT agreement.
15. The distributed modules (``sola_torch/parallel``) on the card, after
   the phase-2 build: an NCCL group of 1 (an all_reduce of a card tensor,
   cp attention over the degenerate group equal to the kernel, a mesh
   step at n_model 1 equal to the plain step); the forward and the fused
   backward against their plain versions at a mesh rank's shapes (4 of 8
   batch entries, 4 of 8 heads; motion_attn packed 4 heads a block);
   then processes of this script that share the card in gloo groups (each
   under a time limit, any failure fails the phase): 4 ranks (2 data x 2
   model) run the train CLI at SelectionConfig() with the flash route on
   a cut phase-9 corpus, against one process: log.txt within limits,
   equal counts, weights within lr-scaled limits, gathered checkpoints
   that load strictly; out_proj's forward sum planted away must break the
   limits; with dropout, replicated parameters bit-equal on every rank;
   flash launches by rank and site. 2 ranks run cp attention over the
   memory cross shape's 2 key shards (one entry's second shard fully
   masked) against the kernel over all keys and the plain version, and
   the eval CLI over the run's checkpoint against one process.
16. Selection training killed and resumed on the card, after the phase-2
   build: ``python -m sola_torch.cli.train`` at SelectionConfig() with the
   flash route, dropout 0.2 and attention dropout 0.1 on a cut phase-9
   corpus (8 train videos, 2 valid, phase 9's batch shapes), 3 epochs,
   once unbroken and once SIGKILLed inside epoch 2 and resumed with
   --resume (the resumed process counts the flash kernels' records in a
   device trace, and the wrappers' calls at each call site). Epochs 2 and 3's weights and resume files must be
   torch.equal to the unbroken run's and log.txt equal; a resume from an
   epoch_1.pth with one weight moved by one ulp must end elsewhere; one
   train and one validation step under
   torch.use_deterministic_algorithms(True) must raise nothing; two equal
   3-step runs must be equal with deterministic cuDNN (how many tensors
   differ with its default algorithms is reported), and the warm train
   step is timed with either.
17. The training step from CUDA graphs (``sola_torch/train/graphs.py``) at
   full width (fp32, flash route, dropout 0.2 and 0.1, 96 words): for
   each of the select_mevis.train_b1 mix's 12 padded shapes (8-64 tracks
   x 32-128 frames), 4 eager steps against 4 captured and replayed ones
   from the same weights, AdamW moments and generator seed: losses,
   gradient norms, the gradients as AdamW took them, weights, both
   moments and the host generator equal bit for bit; a learning rate
   changed between replays takes effect; each shape's capture time, the
   eager and the replayed step's time, and the peak memory after all
   captures.

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


def packed_memory_mask(b: int, gen) -> torch.Tensor:
    """(B, 28,736) memory cross-attention mask of a packed round: slot i
    has 1 + i % 7 valid frame slots (its cond memory and i % 7 recent
    ones) and its own random half of the pointers, so every slot has its
    own valid-key count."""
    mask = memory_cross_mask(b, gen).cpu()
    for i in range(b):
        mask[i, :7 * 4096] = False
        mask[i, :(1 + i % 7) * 4096] = True
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
             # a packed round's 8 slots, each at its own fill of the banks,
             # and sequential GT's single slot
             ("memory_cross_b8", "memory", bf16, 8, 1, 4096, 28736, 256,
              packed_memory_mask(8, gen)),
             ("memory_cross_b1", "memory", bf16, 1, 1, 4096, 28736, 256,
              memory_cross_mask(1, gen)),
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


def device_kernel_counts(fn, parts=(("flash_attn_fwd", "flash_fwd_"),
                                    ("flash_attn_bwd", "flash_bwd_"))):
    """Run ``fn`` once under torch.profiler: (what it returns, for each
    (label, name part) of ``parts`` the number of device kernel records
    whose name holds that part, the port's counters over the run). CUPTI
    records every kernel a CUDA graph replay runs, so these count the
    launches of replayed training steps, which no wrapper sees."""
    from torch.profiler import ProfilerActivity, profile
    from sola_torch.utils import profiling
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    return (out, {label: sum(part in n for n in names)
                  for label, part in parts}, counters)


# the flash kernel's device records on a track-generation path: all of
# them, and memory attention's (bf16, head dim 256: SAM2's one head of
# d_model 256); the image encoders' global attention runs another instance
TRACK_PARTS = (("flash_attn_fwd", "flash_fwd_"),
               ("memory", "flash_fwd_wgmma_kernel<256"))


def track_records(fn) -> tuple:
    """Run ``fn`` once under torch.profiler: (what it returns, the flash
    kernel's device records: all, at memory attention, and the rest, the
    image encoders'; with the propagation steps, graph captures and
    replays the port counted). Replayed steps launch their kernels from
    CUDA graphs, which no wrapper call sees; CUPTI records each."""
    out, rec, counters = device_kernel_counts(fn, parts=TRACK_PARTS)
    rec["other"] = rec["flash_attn_fwd"] - rec["memory"]
    for k in ("steps", "graph_captures", "graph_replays"):
        rec[k] = counters.get(f"trackgen.{k}", 0)
    return out, rec


def check_memory_records(rec: dict, n_layers: int, what: str) -> None:
    """Every propagation step runs memory attention's self- and
    cross-attention once a layer, eagerly at a direction's first step and
    from its graph after (the capture launches nothing): the records at
    memory attention are 2 x layers x steps, and a step ran."""
    want = 2 * n_layers * rec["steps"]
    if rec["steps"] == 0 or rec["memory"] != want:
        raise AssertionError(f"{what}: flash records at memory attention "
                             f"{rec['memory']}, want 2 x {n_layers} layers "
                             f"x {rec['steps']} steps = {want} ({rec})")


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
    di.launches = 0  # the path's counts start here
    dsites.reset()
    fsites.reset()

    def stages():
        info, prompts_s = prompts_stage(root, vid, frames, masks, grounding,
                                        image_pred, "cuda", box_thr)
        stab_thr = stability_gate(info)
        return (info, prompts_s, stab_thr) + tokens_stage(
            root, vid, video_pred, "cuda", stab_thr)

    # the flash kernel's device records: the image encoders run eagerly,
    # so their wrapper calls by site count their launches; the
    # propagation steps replay graphs, so theirs are the records at
    # memory attention. Both stages are timed under torch.profiler.
    (info, prompts_s, stab_thr, census, tokens_s), rec = track_records(
        stages)
    launches = {"flash_attn_fwd": rec["flash_attn_fwd"],
                "ms_deform_attn_fwd": di.launches}  # read right after
    deform, flash = dict(dsites.counts), dict(fsites.counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_memory_records(rec, video_pred.cfg.memory_attention.num_layers,
                         "gdino")

    counts = check_prompt_json(info, vid, T_FRAMES, (H_VID, W_VID))
    check_gdino_tracks(root, vid, census, T_FRAMES, (H_VID, W_VID),
                       video_pred.cfg.d_model)
    binned = len(range(0, T_FRAMES, GD_BIN))
    chunks = binned * -(-len(GD_EXPRESSIONS) // grounding.max_expr_batch)
    want = {"encoder": gcfg.enc_layers * chunks,
            "decoder": gcfg.dec_layers * chunks}
    if rec["other"] != sum(flash.values()):
        raise AssertionError(f"flash records outside memory attention "
                             f"{rec['other']}, wrapper calls at the image "
                             f"encoders {flash}")
    flash["propagation"] = rec["memory"]
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
           "flash_launches": flash,
           "steps": {k: rec[k] for k in ("steps", "graph_captures",
                                         "graph_replays")},
           "peak_memory_gb": peak_gb,
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
        f"{flash} (propagation: device records over {rec['steps']} steps,"
        f" {rec['graph_captures']} captures, {rec['graph_replays']} "
        f"replays; stages timed under torch.profiler); peak memory "
        f"{peak_gb:.2f} GB; card {smi_line()}")
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
    row["swin_b"] = swin_b_forward(di, frames[0])
    log(f"  Swin-B GroundingDINO (a swinb checkpoint name, absent: seeded "
        f"random weights; {row['swin_b']['params_m']:.1f}M params, built in "
        f"{row['swin_b']['build_s']:.1f} s): one forward of the 3 "
        f"expressions, deformable launches {row['swin_b']['deform_launches']}"
        f", boxes finite; warm forward {row['swin_b']['forward_ms']:.2f} ms "
        f"beside Swin-T's {bd['gdino_forward_ms']:.2f} ms")
    return row


def swin_b_forward(di, frame) -> dict:
    """Phase 6's Swin-B GroundingDINO: the loader the CLIs use, given a
    swinb-named checkpoint path that is absent, builds GDINOConfig with
    SwinConfig.base() and seeded random weights; one forward of the
    phase's 3 expressions on its frame, the deformable kernel's launches
    at the encoder and decoder (zeroed just before, read just after), the
    boxes and logits finite, and the warm forward's time."""
    from sola_torch.trackgen.gdino.model import load_grounding_dino
    from sola_torch.trackgen.gdino.swin import SwinConfig
    t0 = time.perf_counter()
    grounding = load_grounding_dino(
        "pretrained_models/groundingdino_swinb_cogcoor.pth", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gcfg = grounding.cfg
    if gcfg.swin != SwinConfig.base():
        raise AssertionError(f"a swinb checkpoint name built {gcfg.swin}")
    sites = deform_sites(grounding)
    texts = [e["exp"] for e in GD_EXPRESSIONS.values()]
    torch.cuda.synchronize()
    di.launches = 0
    sites.reset()
    _, pendings = grounding.enqueue_boxes(frame, texts)
    torch.cuda.synchronize()
    launches = di.launches  # read right after
    deform = dict(sites.counts)
    chunks = -(-len(texts) // grounding.max_expr_batch)
    want = {"encoder": gcfg.enc_layers * chunks,
            "decoder": gcfg.dec_layers * chunks}
    outs = [out for *_, out in pendings]
    finite = all(bool(torch.isfinite(o["pred_boxes"]).all())
                 and not bool(torch.isnan(o["pred_logits"]).any())
                 for o in outs)
    shapes = [tuple(o["pred_boxes"].shape) for o in outs]
    if deform != want or launches != sum(want.values()) or not finite:
        raise AssertionError(f"Swin-B forward: deformable launches {deform} "
                             f"of {launches} (want {want}), boxes {shapes} "
                             f"finite {finite}")
    forward_ms = host_ms(lambda: grounding.enqueue_boxes(frame, texts))
    row = {"swin": dataclasses.asdict(gcfg.swin), "build_s": build_s,
           "params_m": sum(p.numel() for p in grounding.model.parameters())
           / 1e6, "deform_launches": deform, "boxes_shape": shapes,
           "forward_ms": forward_ms}
    del grounding, pendings, outs
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


def run_main_path() -> dict:
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
    # the flash kernel's device records (``track_records``), each stage
    # timed under torch.profiler
    per_video = []
    layers = cfg.memory_attention.num_layers
    hiera_launches = memory_launches = 0
    for vid, frames, path, n_prompts in videos:
        t0 = time.perf_counter()
        state, enc = track_records(lambda: predictor.init_state(frames))
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        census, run = track_records(lambda: tokens_grid.run_video(
            predictor, vid, None, path, out_root, "mevis", "valid_u",
            bin_size=4, batch_size=4, state=state, log=lambda s: None))
        prop_s = time.perf_counter() - t0
        check_memory_records(run, layers, vid)
        row_hiera = enc["flash_attn_fwd"] + run["other"]
        if enc["flash_attn_fwd"] == 0:
            raise AssertionError(f"{vid}: no flash record in the encode "
                                 f"({enc})")
        hiera_launches += row_hiera
        memory_launches += run["memory"]
        area = check_tracks(track_root, vid, census, tracks, rle,
                            cfg.d_model)
        row = {"video": vid, "prompts": n_prompts, "mask_area": area,
               "encode_s": enc_s,
               "encode_fps": T_FRAMES / enc_s, "run_video_s": prop_s,
               "object_fps": census["n_tracked"] * T_FRAMES / prop_s,
               "census": {k: census[k] for k in (
                   "n_tracked", "n_filtered", "n_not_used", "n_total")},
               "hiera_launches": row_hiera,
               "memory_launches": run["memory"],
               "steps": run["steps"],
               "graph_captures": run["graph_captures"],
               "graph_replays": run["graph_replays"]}
        per_video.append(row)
        log(f"  {vid}: encode {enc_s:.2f} s ({row['encode_fps']:.2f} "
            f"frames/s), run_video {prop_s:.2f} s ({row['object_fps']:.2f} "
            f"object-fps), both under torch.profiler; census "
            f"{row['census']}, mean masklet area {area:.3f} (random "
            f"weights); flash device records hiera {row_hiera}, memory "
            f"{run['memory']} over {run['steps']} steps "
            f"({run['graph_captures']} captures, {run['graph_replays']} "
            f"replays)")
    launches = hiera_launches + memory_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  main path: {launches} flash kernel records (hiera "
        f"{hiera_launches}, memory {memory_launches}), peak memory "
        f"{peak_gb:.2f} GB")
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
    backward check shapes, the kernels reading the seed from a slot of a
    buffer whose neighbours hold seed +- 1; the limits must reject three wrong backward
    results (the mask of seed + 1, dS without -delta, dV from the
    undropped P). Times each kernel (CUDA events over calls, and the
    backward alone by torch.profiler), its plain version, its bound and a
    library yardstick (SDPA's forward by call; SDPA's backward alone by
    torch.profiler, like the kernel, and by call as forward + backward -
    forward)."""
    import torch.nn.functional as F
    rows = []
    seeds = torch.tensor([SEL_SEED + 1, SEL_SEED, SEL_SEED - 1],
                         dtype=torch.int64, device="cuda")
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
            # the kernels read it from a slot inside a buffer of seeds
            slot = seeds[1:2] if rate else None
            tag = "drop" if rate else "nodrop"
            out, lse = fa._launch(q, k, v, mask, rate, slot)
            delta = fa.bwd_delta(out, do)
            args = (q, k, v, mask, do, lse, delta, rate, slot)
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
        fwd_ms = cuda_ms(lambda: fa._launch(q, k, v, mask, rate, slot), 20)
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
# the padded shapes of phases 9 and 16's corpora: every batch is 64 track
# slots x 64 frames x 96 words
TRAIN_SHAPES = 1


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


def graph_launches(n_layers: int, steps: int, shapes: int,
                   valid_batches: int) -> tuple:
    """What a ``train()`` run on the card launches: (flash kernel records
    on the device, wrapper calls at each site). Every training step
    replays its shape's graphs, and a shape's first step also runs its
    forward and backward once eagerly (the warm-up) before the capture,
    whose calls launch nothing; validation runs eagerly. Each layer calls
    each of its 3 sites once a forward and once a backward."""
    kernels = {"flash_attn_fwd": 3 * n_layers * (steps + shapes
                                                 + valid_batches),
               "flash_attn_bwd": 3 * n_layers * (steps + shapes)}
    calls = {"fwd": n_layers * (2 * shapes + valid_batches),
             "bwd": n_layers * 2 * shapes}
    return kernels, calls


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
        model, launches, counters = device_kernel_counts(
            lambda: loop.train(configs, text_encoder=text, log_fn=log,
                               device="cuda"))
        train_s = time.perf_counter() - t0
    finally:
        loop.build_model = build_model
    calls = {"flash_attn_fwd": fa.launches,
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
    want, want_calls = graph_launches(cfg.n_layers, steps, TRAIN_SHAPES,
                                      valid_batches)
    if (launches != want or any(by_site[s] != want_calls for s in ATTN_SITES)
            or calls != {k: 3 * want_calls[k[-3:]] for k in calls}
            or counters.get("train.steps") != steps
            or counters.get("train.graph_captures") != TRAIN_SHAPES):
        raise AssertionError(f"flash kernels on the device {launches} (want "
                             f"{want}); wrapper calls by site {by_site} "
                             f"(want {want_calls} each), totals {calls}; "
                             f"counters {counters}")

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
           "counters": counters, "launches": launches,
           "wrapper_calls": calls, "calls_by_site": by_site,
           "peak_memory_gb": peak_gb, "warm_step_ms": step_ms,
           "steps_per_s": 1e3 / step_ms,
           "pairs_per_s": BATCH * 1e3 / step_ms, "log": floats,
           "confusion": counts, "profile": prof}
    log(f"  train(): 2 epochs, {steps} steps + {valid_batches} validation "
        f"batches in {train_s:.2f} s (data loading, text encodes and "
        f"checkpoints included); log {floats[:4]}..., TP/FP/FN/TN "
        f"{counts[-4:]}; {counters.get('train.graph_captures')} graph "
        f"captures; flash kernels on the device {launches}; wrapper calls "
        f"(warm-ups, captures, validation) by site {by_site}; peak memory "
        f"{peak_gb:.2f} GB; card {smi_line()}")
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

        def run():
            train(configs, text_encoder=HashTextEncoder(
                hidden_size=64, vocab_size=128, device=device),
                log_fn=lambda *a: None, device=device)
            _sync(device)

        try:
            if device == "cuda":  # replayed steps: count device records
                _, kernels, _ = device_kernel_counts(run)
                launched = (kernels["flash_attn_fwd"],
                            kernels["flash_attn_bwd"])
            else:
                run()
                launched = tuple(a - b for a, b in zip(
                    (fa.launches, fa.bwd_launches), before))
        finally:
            fa.bwd_delta = honest_delta
        runs[name] = parse_train_log(os.path.join(
            root, name, "small", "mevis", "log.txt")) + (launched,)

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

    # tokens_grid's flash kernel records, timed under torch.profiler
    t0 = time.perf_counter()
    _, tokens_rec = track_records(lambda: tokens_grid.main(
        argv + ["--batch_size", "4", "--save_prec_rec_iou"],
        predictor_factory=lambda: video_pred))
    tokens_s = time.perf_counter() - t0
    check_memory_records(tokens_rec,
                         video_pred.cfg.memory_attention.num_layers,
                         "tokens_grid")
    tokens_launches = tokens_rec["flash_attn_fwd"]
    with open(os.path.join(root, "sam2_tracks", "grid_tracks", "mevis",
                           "valid_u", f"runtime_info_{GRID_BIN}.json")) as f:
        census = json.load(f)
    for vid, _, _ in videos:
        check_tracks(os.path.join(root, "sam2_tracks"), vid, census[vid],
                     tracks, rle, video_pred.cfg.d_model)
    tracked = sum(c["n_tracked"] for c in census.values())
    track_s = sum(c["time"] for c in census.values())

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
                        "tokens_grid_memory": tokens_rec["memory"],
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
        f"{tokens_s:.2f} s under torch.profiler, "
        f"tracking {track_s:.2f} s ({row['object_fps']:.2f} object-fps "
        f"over {tracked} tracks), flash device records {tokens_launches} "
        f"({tokens_rec['memory']} at memory attention over "
        f"{tokens_rec['steps']} steps), census {row['census']}")
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


# ---------------------------------------------------------------------------
# phases 13 and 14: packed propagation (tokens_grid --video_pack,
# tokens_gdino --expr_pack) and GT-prompted tracks (tokens_gt)
# ---------------------------------------------------------------------------

PACK_EXPRESSIONS = {"0": "the red box moving right",
                    "1": "a green ellipse",
                    "2": "the blue square moving up"}
# GT objects of a phase-13 video: object 1 leaves at frame 6 and comes back
# at 8 (two onsets, two tracks); object 2 first appears at frame 3
GT_ABSENT = {0: (), 1: (6, 7), 2: (0, 1, 2)}
# Phase 13's limits (PERF.md, written before the first run), bf16 compute.
# Packed against sequential at the same obj_batch (8): the slots see the
# same shapes and no op mixes them, so both should agree bit for bit; a
# mask may differ on 1e-4 of a track's pixels, a token by one bf16 ulp at
# the largest |token| (2^-7 of it), a prec/rec/IoU by 1e-4. Packed against
# the CLI's sequential default (obj_batch 4 for grid and gdino, 1 for GT):
# other batch sizes may take other GEMM algorithms, whose bf16 roundings
# differ and carry through the memory from frame to frame; the same
# tracks and decisions, a mask within 1e-2 of its pixels, a token within
# 2^-3 of the largest |token|, a prec/rec/IoU within 1e-2.
PACK_SAME = {"mask_frac": 1e-4, "token_rel": 2.0 ** -7, "metric": 1e-4}
PACK_DEFAULT = {"mask_frac": 1e-2, "token_rel": 2.0 ** -3, "metric": 1e-2}
# Phase 14 (tiny, fp32): card against CPU within phase 4's limits; packed
# against sequential on the card under tests/test_packed.py's bounds
SMALL_CARD_CPU = {"mask_frac": 1e-2, "token_atol": 1e-3, "metric": 1e-2}
SMALL_PACK = {"mask_frac": 1e-4, "token_atol": 1e-4}
SMALL_PACK_GT = {"mask_frac": 1e-4, "token_atol": 1e-5, "metric": 1e-5}


def read_tracks(track_root: str) -> dict:
    """{masklet JSON path relative to ``track_root``: (masklet, tokens,
    metrics, anno_id)} of every track under a sam2_tracks root."""
    from sola_torch.core import rle
    out = {}
    for dirpath, _, files in os.walk(track_root):
        if "sam2_masklets" not in dirpath.split(os.sep):
            continue
        for fn in files:
            if not fn.endswith(".json") or fn.startswith("labels_index"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                info = json.load(f)
            tok = path.replace(os.sep + "sam2_masklets" + os.sep,
                               os.sep + "sam2_object_tokens" + os.sep)
            metrics = {f"{k}/{g}": v for k in ("precision", "recall", "iou")
                       for g, v in info.get(k, {}).items()}
            out[os.path.relpath(path, track_root)] = (
                rle.decode_masklet(info["rle"]),
                np.load(tok[:-len(".json")] + ".npy"), metrics,
                info["anno_id"])
    return out


def track_differences(ref: dict, got: dict) -> dict:
    """Largest per-track differences of two read_tracks results on the
    same file set: share of a masklet's pixels, token error absolute and
    relative to the track's largest |token|, prec/rec/IoU."""
    if sorted(ref) != sorted(got) or not ref:
        raise AssertionError(f"track files differ: {sorted(ref)} against "
                             f"{sorted(got)}")
    d = {"mask_frac": 0.0, "token_atol": 0.0, "token_rel": 0.0,
         "metric": 0.0}
    for key, (m, t, met, anno) in ref.items():
        m2, t2, met2, anno2 = got[key]
        if m.shape != m2.shape or t.shape != t2.shape or anno != anno2 \
                or sorted(met) != sorted(met2):
            raise AssertionError(f"{key}: shapes {m.shape}/{m2.shape}, "
                                 f"{t.shape}/{t2.shape}, anno {anno}/{anno2}")
        if not np.isfinite(t2).all():
            raise AssertionError(f"{key}: tokens not finite")
        err = float(np.abs(t2 - t).max())
        d["mask_frac"] = max(d["mask_frac"], float((m != m2).mean()))
        d["token_atol"] = max(d["token_atol"], err)
        d["token_rel"] = max(d["token_rel"],
                             err / max(float(np.abs(t).max()), 1e-30))
        for k, v in met.items():
            d["metric"] = max(d["metric"], abs(met2[k] - v))
    return d


def beyond(diffs: dict, limits: dict) -> dict:
    return {k: (diffs[k], v) for k, v in limits.items() if diffs[k] > v}


def gt_video(seed: int):
    """A synthetic 12-frame 480x854 video and its 3 objects' GT masklets
    with GT_ABSENT's gaps."""
    frames, masks = synthetic_video(seed)
    gts = []
    for obj in range(3):
        m = np.stack([f[obj] for f in masks])
        m[list(GT_ABSENT[obj])] = 0
        gts.append(m)
    return frames, masks, gts


def write_layout(data_dir: str, videos: dict, expressions: dict,
                 mask_dict: dict = None) -> None:
    """A MeViS-layout split: JPEG frames, meta_expressions.json and, if
    given, mask_dict.json."""
    from PIL import Image
    meta = {"videos": {}}
    for vid, frames in videos.items():
        frames_dir = os.path.join(data_dir, "JPEGImages", vid)
        os.makedirs(frames_dir)
        for t, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(frames_dir, f"{t:05d}.jpg"))
        meta["videos"][vid] = {
            "frames": [f"{t:05d}" for t in range(len(frames))],
            "expressions": expressions[vid]}
    with open(os.path.join(data_dir, "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    if mask_dict is not None:
        with open(os.path.join(data_dir, "mask_dict.json"), "w") as f:
            json.dump(mask_dict, f)


def gdino_prompts(masks) -> list:
    """Per expression e of PACK_EXPRESSIONS: objects e and e+1 on frame 0,
    object e on frame 4 (a batch of 2, then one of 1)."""
    from sola_torch.core import rle
    out = []
    for e in range(3):
        for frame_idx, obj in ((0, e), (0, (e + 1) % 3), (4, e)):
            m = masks[frame_idx][obj]
            out.append({"segmentation": rle.encode(m),
                        "stability_score": 0.97, "score": 0.9,
                        "area": int(m.sum()), "area_ratio": float(m.mean()),
                        "frame_idx": frame_idx, "expression_id": str(e),
                        "prompt_id": len(out)})
    return out


class EncodeTimer:
    """Seconds the given predictors spend in ``init_state`` (each call
    ended by a synchronize), so a CLI run's tracking time is its wall time
    less its encodes."""

    def __init__(self, preds):
        self.seconds = 0.0
        for p in preds:
            p.init_state = self._timed(p.init_state)

    def _timed(self, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return run


def tracks_something(pred, frames, mask) -> bool:
    """Whether ``pred`` finds the prompted object on the 3 frames after
    its prompt: a tracked mask neither empty nor full."""
    state = pred.init_state(frames[:4])
    pred.add_new_mask(state, 0, 0, mask)
    areas = [float(m[0].mean()) for f, _, m in pred.propagate_in_video(
        state, output_mode="masks") if f > 0]
    return any(0 < a < 1 for a in areas)


def live_seed(frames, mask, seeds=range(16)) -> tuple:
    """(seed, seeds tried): the first seed whose random hiera-L tracks the
    object after the prompt frame. With seed 0 the object score is negative
    on every tracked frame, so every tracked mask is empty and every token
    is the no-object pointer, whatever the batch: the packed and sequential
    runs would then agree trivially."""
    from sola_torch.trackgen import tokens_grid
    for seed in seeds:
        pred = tokens_grid._default_predictor_factory(
            SAM2_CKPT, obj_batch=1, device="cuda", seed=seed)()
        live = tracks_something(pred, frames, mask)
        del pred
        if live:
            return seed, seed + 1
    raise AssertionError(f"no seed in {seeds} tracks anything")


def liveness(tracks: dict) -> dict:
    """Share of tracked frames (all but a track's first non-empty one)
    whose mask is neither empty nor full, and the largest token spread
    over frames."""
    shares, spread = [], 0.0
    for m, tok, _, _ in tracks.values():
        area = m.reshape(m.shape[0], -1).mean(axis=1)
        rest = np.arange(len(area)) != int(np.argmax(area > 0))
        shares += [0 < a < 1 for a in area[rest]]
        spread = max(spread, float(np.std(tok[rest], axis=0).max()))
    return {"live_frames": float(np.mean(shares)), "token_spread": spread}


def run_pack_path(name, main_fn, argv, pred, sites, timer,
                  out_root: str, object_frames) -> dict:
    """One CLI run of phase 13 with its own output root, under
    torch.profiler: the flash kernel's device records (``track_records``;
    memory attention's held to 2 x layers x steps), the wrapper calls at
    the eager image encoder (zeroed just before, read just after), wall
    and tracking seconds, and the written tracks."""
    torch.cuda.synchronize()
    sites.reset()
    enc0 = timer.seconds
    t0 = time.perf_counter()
    _, rec = track_records(
        lambda: main_fn(argv + ["--output_root", out_root],
                        predictor_factory=lambda: pred))
    wall = time.perf_counter() - t0
    encode = timer.seconds - enc0
    check_memory_records(rec, pred.cfg.memory_attention.num_layers, name)
    if rec["other"] != sites.counts["hiera"]:
        raise AssertionError(f"{name}: flash records outside memory "
                             f"attention {rec['other']}, wrapper calls at "
                             f"the image encoder {sites.counts}")
    track_root = os.path.join(out_root, "sam2_tracks")
    runtime = {}
    for dirpath, _, files in os.walk(track_root):
        for fn in files:
            if fn.startswith("runtime_info"):
                with open(os.path.join(dirpath, fn)) as f:
                    runtime = json.load(f)
    frames_objects = object_frames(runtime)
    return {"wall_s": wall, "encode_s": encode, "tracking_s": wall - encode,
            "object_frames": frames_objects,
            "object_fps": frames_objects / (wall - encode),
            "launches": rec["flash_attn_fwd"], "flash_records": rec,
            "runtime": runtime,
            "tracks": read_tracks(track_root)}


def compare_pack_runs(path: str, runs: dict, decisions) -> dict:
    """Phase 13's checks on one path: the same artifact files and
    decisions in every run, and packed against both sequential runs
    within PACK_SAME / PACK_DEFAULT."""
    seq, same, pk = runs["seq"], runs["seq8"], runs["pack"]
    for other in (seq, same):
        if decisions(other["runtime"]) != decisions(pk["runtime"]):
            raise AssertionError(f"{path}: decisions differ: "
                                 f"{decisions(other['runtime'])} against "
                                 f"{decisions(pk['runtime'])}")
    d_same = track_differences(same["tracks"], pk["tracks"])
    d_seq = track_differences(seq["tracks"], pk["tracks"])
    bad = {"same_batch": beyond(d_same, PACK_SAME),
           "default_batch": beyond(d_seq, PACK_DEFAULT)}
    if any(bad.values()):
        raise AssertionError(f"{path}: packed against sequential beyond "
                             f"limits: {bad}")
    return {"same_batch": d_same, "default_batch": d_seq}


def run_packed_paths(fa) -> dict:
    """Phase 13: tokens_grid.main --video_pack 2, tokens_gdino.main
    --expr_pack 3 and tokens_gt.main (--video_pack 2) at SAM2 hiera-L,
    seeded random weights from the CLIs' own predictor factory, each
    against its sequential run at the CLI's default obj_batch and at the
    packed run's (8)."""
    from sola_torch.core import rle
    from sola_torch.trackgen import tokens_gdino, tokens_grid, tokens_gt
    root = os.path.join(OUT_DIR, "packed")
    probe_frames, probe_masks = synthetic_video(19)
    t0 = time.perf_counter()
    seed, tried = live_seed(probe_frames, probe_masks[0][0])
    probe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_batch = {b: tokens_grid._default_predictor_factory(
        SAM2_CKPT, obj_batch=b, device="cuda", seed=seed)()
        for b in (1, 4, 8)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # one short run a batch size, so no timed run pays a first call
    for pred in by_batch.values():
        tracks_something(pred, probe_frames, probe_masks[0][0])
    log(f"  weights: seed {seed}, the first of {tried} tried whose model "
        f"tracks the object ({probe_s:.1f} s)")
    sites = SiteCounter(fa)
    sites.watch("hiera", [p.model.image_encoder for p in by_batch.values()])
    timer = EncodeTimer(by_batch.values())

    # (a) grid prompts: 2 videos, 6 prompts each (3 objects on frames 0, 4)
    grid_root = os.path.join(root, "grid")
    grid = {f"pgrid{i}": synthetic_video(20 + i) for i in range(2)}
    write_layout(os.path.join(grid_root, "datasets", "mevis", "valid_u"),
                 {v: f for v, (f, _) in grid.items()},
                 {v: {"0": {"exp": "a thing", "anno_id": [0]}}
                  for v in grid})
    # (b) GroundingDINO prompts: one video, 3 expressions, 3 prompts each
    gd_root = os.path.join(root, "gdino")
    gd_frames, gd_masks = synthetic_video(22)
    write_layout(os.path.join(gd_root, "datasets", "mevis", "valid_u"),
                 {"pgdino": gd_frames},
                 {"pgdino": {e: {"exp": x, "anno_id": [int(e)]}
                             for e, x in PACK_EXPRESSIONS.items()}})
    # (c) GT: a train split of 2 videos, 3 GT objects each
    gt_root = os.path.join(root, "gt")
    gt_videos = {f"pgt{i}": gt_video(23 + i) for i in range(2)}
    mask_dict, exprs = {}, {}
    for v, (vid, (_, _, gts)) in enumerate(gt_videos.items()):
        exprs[vid] = {}
        for obj, m in enumerate(gts):
            anno = 3 * v + obj
            exprs[vid][str(obj)] = {"exp": f"object {obj}",
                                    "anno_id": [anno]}
            mask_dict[str(anno)] = [rle.encode(f) if f.any() else None
                                    for f in m]
    write_layout(os.path.join(gt_root, "datasets", "mevis", "train"),
                 {v: f for v, (f, _, _) in gt_videos.items()}, exprs,
                 mask_dict)

    def grid_prompts(out_root):
        d = os.path.join(out_root, "sam2_prompts", "grid_prompts", "mevis",
                         "valid_u")
        os.makedirs(d)
        for vid, (_, masks) in grid.items():
            write_prompts(os.path.join(d, f"{vid}.json"), vid, masks, rle)

    def gd_prompts(out_root):
        d = os.path.join(out_root, "sam2_prompts", "gdino_prompts", "mevis",
                         "valid_u")
        os.makedirs(d)
        with open(os.path.join(d, "pgdino.json"), "w") as f:
            json.dump({"video_id": "pgdino", "bin_size": 4,
                       "prompt_masks": gdino_prompts(gd_masks)}, f)

    common = ["--device", "cuda", "--prefetch_videos", "0"]
    paths = {
        "grid": (tokens_grid.main, grid_root, grid_prompts,
                 common + ["--data_root", grid_root, "--bin_size", "4"],
                 "--video_pack", "2", 4,
                 lambda rt: sum(c["n_tracked"] * c["n_frames"]
                                for c in rt.values()),
                 lambda rt: {v: (c["tracked_prompt_ids"],
                                 c["filtered_prompt_ids"])
                             for v, c in rt.items()}),
        "gdino": (tokens_gdino.main, gd_root, gd_prompts,
                  common + ["--data_root", gd_root, "--bin_size", "4",
                            "--stability_score_thresh", "0.5"],
                  "--expr_pack", "3", 4,
                  lambda rt: sum(c["n_tracked"] * c["n_frames"]
                                 for e in rt.values() for c in e.values()),
                  lambda rt: {(v, e): (c["tracked_prompt_ids"],
                                       c["filtered_prompt_ids"])
                              for v, es in rt.items()
                              for e, c in es.items()}),
        "gt": (tokens_gt.main, gt_root, lambda out_root: None,
               common + ["--data_root", gt_root, "--save_prec_rec_iou"],
               "--video_pack", "2", 1,
               lambda rt: sum(c["n_frames"] for s in rt.values()
                              for c in s.values()),
               lambda rt: {(v, o): (c["gt_anno_id"], c["seed_frame"])
                           for v, s in rt.items() for o, c in s.items()}),
    }
    torch.cuda.reset_peak_memory_stats()
    out = {"build_s": build_s, "seed": seed, "seeds_tried": tried}
    for path, (main_fn, proot, write_in, argv, flag, n, seq_b, frames_of,
               decisions) in paths.items():
        runs = {}
        # packed between the two sequential runs, so none of them runs
        # first on a cold card alone
        for name, b, extra in (("seq", seq_b, []),
                               ("pack", 8, [flag, n]),
                               ("seq8", 8, ["--obj_batch", "8"])):
            out_root = os.path.join(proot, name)
            write_in(out_root)
            runs[name] = run_pack_path(name, main_fn, argv + extra,
                                       by_batch[b], sites, timer, out_root,
                                       frames_of)
        diffs = compare_pack_runs(path, runs, decisions)
        live = liveness(runs["pack"]["tracks"])
        if live["live_frames"] == 0 or live["token_spread"] == 0:
            raise AssertionError(f"{path}: nothing tracked: {live}")
        row = {"diffs": diffs, "liveness": live,
               "limits": {"same_batch": PACK_SAME,
                          "default_batch": PACK_DEFAULT}}
        for name, r in runs.items():
            row[name] = {k: r[k] for k in (
                "wall_s", "encode_s", "tracking_s", "object_frames",
                "object_fps", "launches", "flash_records")}
        if path == "gt":
            for name, r in runs.items():
                seeds = sum(len(s) for s in r["runtime"].values())
                row[name]["seeds"] = seeds
                row[name]["seeds_per_s"] = seeds / r["tracking_s"]
            if row["pack"]["seeds"] != 8:
                raise AssertionError(f"GT seeds: {row['pack']['seeds']}, "
                                     f"want 8 (2 videos x 4 onsets)")
        out[path] = row
        log(f"  {path}: " + "; ".join(
            f"{name} (obj_batch {by_b}) {row[name]['tracking_s']:.2f} s "
            f"tracking + {row[name]['encode_s']:.2f} s encode, "
            f"{row[name]['object_fps']:.2f} object-fps"
            + (f", {row[name]['seeds_per_s']:.3f} seeds/s"
               if path == "gt" else "")
            + f", flash device records {row[name]['flash_records']}"
            for name, by_b in (("seq", paths[path][6]), ("pack", 8),
                               ("seq8", 8))))
        log(f"  {path}: packed vs sequential at obj_batch 8 "
            f"{diffs['same_batch']} (limits {PACK_SAME}); vs the default "
            f"obj_batch {diffs['default_batch']} (limits {PACK_DEFAULT}); "
            f"{live['live_frames']:.3f} of the frames tracked, token "
            f"spread {live['token_spread']:.3g}")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(os.path.join(grid_root, "datasets"))
    shutil.rmtree(os.path.join(gd_root, "datasets"))
    shutil.rmtree(os.path.join(gt_root, "datasets"))
    log(f"  peak memory {out['peak_memory_gb']:.2f} GB; predictors built "
        f"in {build_s:.1f} s; card {smi_line()}")
    del by_batch
    torch.cuda.empty_cache()
    return out


def small_video(t: int, hw: tuple, seed: int) -> list:
    """Tiny frames with a bright box moving right; both axes at most 64,
    so no frame downscales to SAM2Config.tiny_test's 64."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(t):
        f = rng.integers(0, 60, hw + (3,), dtype=np.uint8)
        x = (4 + 3 * i) % (hw[1] - 12)
        f[6:20, x:x + 10] = 220
        frames.append(f)
    return frames


def small_box(hw, y0, y1, x0, x1) -> np.ndarray:
    m = np.zeros(hw, np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def small_gt(t, hw, y0, y1, x0, x1, absent=()) -> np.ndarray:
    m = np.zeros((t,) + hw, np.uint8)
    for f in range(t):
        if f not in absent:
            x = (x0 + 2 * f) % max(hw[1] - (x1 - x0), 1)
            m[f, y0:y1, x:x + (x1 - x0)] = 1
    return m


# tiny videos: (id, frames, (H, W), seed, grid prompts [(frame, mask)])
SMALL_PACK_VIDEOS = [
    ("sA", 6, (48, 64), 0, [(0, (6, 20, 4, 14)), (0, (24, 40, 30, 52)),
                            (0, (2, 12, 50, 62)), (2, (30, 44, 2, 20))]),
    ("sB", 4, (64, 64), 1, [(1, (6, 20, 7, 17)), (1, (40, 60, 40, 60))]),
    ("sC", 9, (40, 56), 2, [(0, (6, 20, 4, 14)), (0, (22, 38, 30, 50)),
                            (3, (2, 14, 36, 52)), (4, (20, 36, 4, 24)),
                            (4, (4, 18, 20, 34))]),
]
SMALL_GT = {
    "sA": {"1": (6, 20, 4, 14, ()), "2": (24, 40, 30, 42, ())},
    # two onsets; one onset at frame 3 beside the longer slots
    "sC": {"3": (6, 20, 4, 14, ()), "4": (22, 36, 20, 32, (2,)),
           "5": (8, 22, 30, 44, (0, 1, 2))},
}


def run_packed_small_reference(fa) -> dict:
    """Phase 14: the packed paths at SAM2Config.tiny_test, fp32, the flash
    kernel's thresholds lowered so it runs: grid tracks sequential and
    packed, expressions and GT at pack widths 1 (the CLIs' default) and 8,
    on the card against the CPU (the plain versions); on the card, width
    8 against sequential / width 1 under tests/test_packed.py's bounds;
    and a planted fault (bank pushes on a slot's idle steps) that must
    break the GT agreement."""
    from sola_torch.core import rle
    from sola_torch.trackgen import (engine, packed_engine, tokens_gdino,
                                     tokens_gt)
    from sola_torch.trackgen.sam2 import packed
    from sola_torch.trackgen.sam2.convert import build_sam2
    from sola_torch.trackgen.sam2.model import SAM2Config
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    root = os.path.join(OUT_DIR, "packed_small")

    def predictor(device):
        # seed 1: tracked masks cover about half a frame. At seeds 0 and
        # 2-5 the tiny model finds no object after the cond frame, so every
        # tracked mask is empty, every token is no_obj_ptr, and neither
        # the agreement nor the planted fault would test anything
        model = fused_everywhere(build_sam2(cfg=SAM2Config.tiny_test(64),
                                            seed=1, device=device))
        return SAM2VideoPredictor(model, obj_batch=4,
                                  feature_dtype=torch.float32,
                                  compute_dtype=torch.float32)

    def grid_tracks(pred, packed_run):
        """Tracks of SMALL_PACK_VIDEOS' grid prompts, packed or one video
        at a time: {video: {prompt: (masklet, tokens)}} and censuses."""
        tracks, censuses, jobs = {}, {}, []
        for vid, t, hw, seed, specs in SMALL_PACK_VIDEOS:
            state = pred.init_state(small_video(t, hw, seed))
            prompts = [engine.PromptMask(prompt_id=i, frame_idx=f,
                                         segmentation=small_box(hw, *box))
                       for i, (f, box) in enumerate(specs)]
            tracks[vid] = {}

            def on_track(r, d=tracks[vid]):
                d[r.prompt_id] = (r.masklet, r.tokens)
            if packed_run:
                jobs.append(packed_engine.VideoJob(
                    video_id=vid, state=state, prompts=prompts,
                    n_frames=t, n_max_tracks=16, on_track=on_track))
            else:
                censuses[vid] = engine.generate_tracks(
                    pred, state, prompts, n_frames=t, n_max_tracks=16,
                    on_track=on_track)
        if packed_run:
            for job, c in zip(jobs, packed_engine.generate_tracks_packed(
                    pred, jobs)):
                censuses[job.video_id] = c
        return tracks, censuses

    def expressions(pred, out_root, packed_run):
        vid, t, hw, seed, _ = SMALL_PACK_VIDEOS[0]
        prompts = []
        for e, x in enumerate((4, 24, 40)):
            for fi in (0, 1):
                m = small_box(hw, 6 + 6 * fi, 20 + 6 * fi, x, x + 14)
                prompts.append({"segmentation": rle.encode(m),
                                "stability_score": 0.95, "frame_idx": fi,
                                "expression_id": str(e),
                                "prompt_id": len(prompts)})
        path = os.path.join(root, f"{vid}_gdino.json")
        with open(path, "w") as f:
            json.dump({"video_id": vid, "bin_size": 1,
                       "prompt_masks": prompts}, f)
        state = pred.init_state(small_video(t, hw, seed))
        kw = dict(bin_size=1, n_max_tracks=8, log=lambda s: None)
        track_root = os.path.join(out_root, "sam2_tracks")
        # pack width 8 (every expression in one group) or 1 (the CLI's
        # default, one expression a group)
        census = tokens_gdino.run_video_packed(
            pred, state, vid, ["0", "1", "2"], path, track_root, "mevis",
            "valid_u", t, expr_pack=8 if packed_run else 1, **kw)
        return read_tracks(track_root), census

    def gt(pred, out_root, packed_run):
        items = []
        for vid, objs in SMALL_GT.items():
            _, t, hw, seed, _ = next(v for v in SMALL_PACK_VIDEOS
                                     if v[0] == vid)
            gts = {g: small_gt(t, hw, *spec) for g, spec in objs.items()}
            items.append({"video_id": vid, "gt_masklets": gts,
                          "n_frames": t,
                          "state": pred.init_state(small_video(t, hw,
                                                               seed))})
        track_root = os.path.join(out_root, "sam2_tracks")
        # every video in one pack, or one video a call (the CLI's default
        # pack width 1)
        census = {}
        for group in ([items] if packed_run else [[it] for it in items]):
            census.update(tokens_gt.run_videos_packed_gt(
                pred, group, track_root, "mevis", "train",
                save_prec_rec_iou=True, log=lambda s: None))
        return read_tracks(track_root), census

    os.makedirs(root)
    strip = lambda c: {k: v for k, v in c.items() if k not in ("time",
                                                               "fps")}
    res, launches = {}, {}
    for device in ("cuda", "cpu"):
        pred = predictor(device)
        before = fa.launches
        for mode in ("seq", "pack"):
            res[(device, "grid", mode)] = grid_tracks(pred, mode == "pack")
            res[(device, "gdino", mode)] = expressions(
                pred, os.path.join(root, f"gdino_{device}_{mode}"),
                mode == "pack")
            res[(device, "gt", mode)] = gt(
                pred, os.path.join(root, f"gt_{device}_{mode}"),
                mode == "pack")
        launches[device] = fa.launches - before
    if launches["cuda"] == 0 or launches["cpu"] != 0:
        raise AssertionError(f"small packed launches: {launches}")

    def grid_as_tracks(tr):
        return {f"{v}/{p}": (m, tok, {}, p) for v, d in tr.items()
                for p, (m, tok) in d.items()}

    report = {}
    for path in ("grid", "gdino", "gt"):
        for a, b, limits in (
                (("cuda", path, "pack"), ("cpu", path, "pack"),
                 SMALL_CARD_CPU),
                (("cuda", path, "seq"), ("cpu", path, "seq"),
                 SMALL_CARD_CPU),
                (("cuda", path, "seq"), ("cuda", path, "pack"),
                 SMALL_PACK_GT if path == "gt" else SMALL_PACK)):
            (ta, ca), (tb, cb) = res[a], res[b]
            if path == "grid":
                ta, tb = grid_as_tracks(ta), grid_as_tracks(tb)
                ca = {v: strip(c) for v, c in ca.items()}
                cb = {v: strip(c) for v, c in cb.items()}
                same = ca == cb
            elif path == "gdino":
                same = {e: strip(c) for e, c in ca.items()} == \
                    {e: strip(c) for e, c in cb.items()}
            else:
                same = ({v: {o: (e["gt_anno_id"], e["seed_frame"])
                             for o, e in s.items()} for v, s in ca.items()}
                        == {v: {o: (e["gt_anno_id"], e["seed_frame"])
                                for o, e in s.items()}
                            for v, s in cb.items()})
            d = track_differences(ta, tb)
            bad = beyond(d, limits)
            if bad or not same:
                raise AssertionError(f"small {path}: {a} vs {b}: {bad}, "
                                     f"censuses equal {same}")
            report[f"{path}: {a[0]} {a[2]} vs {b[0]} {b[2]}"] = d

    # the planted fault: the gate taken away, so a slot pushes memories of
    # its idle steps (its last frame again) into its banks
    gate = packed.gate
    packed.gate = lambda active: np.ones_like(active)
    try:
        fault, _ = gt(predictor("cuda"), os.path.join(root, "gt_fault"),
                      True)
    finally:
        packed.gate = gate
    live = [np.std(tok, axis=0).max() > 0 and 0 < m.mean() < 1
            for m, tok, _, _ in res[("cuda", "gt", "seq")][0].values()]
    if not all(live):
        raise AssertionError(f"GT tracks with constant tokens or empty/full "
                             f"masks: {live}")
    d_fault = track_differences(res[("cuda", "gt", "seq")][0], fault)
    if not beyond(d_fault, SMALL_PACK_GT):
        raise AssertionError(f"the ungated push passes the packed GT check: "
                             f"{d_fault}")
    log(f"  tiny_test fp32 (kernel route, {launches['cuda']} launches on "
        f"the card): " + "; ".join(f"{k} {v}" for k, v in report.items()))
    log(f"  limits: card vs cpu {SMALL_CARD_CPU}, packed vs sequential "
        f"{SMALL_PACK} (GT {SMALL_PACK_GT}); the ungated push gives "
        f"{d_fault}, rejected")
    return {"differences": report, "fault": d_fault,
            "card_launches": launches["cuda"],
            "limits": {"card_cpu": SMALL_CARD_CPU, "pack": SMALL_PACK,
                       "pack_gt": SMALL_PACK_GT}}


# ---------------------------------------------------------------------------
# phase 15: the distributed modules on one card: an NCCL group of one, and
# gloo groups whose ranks share the card (context-parallel attention, mesh
# training from the train CLI, the sharded eval CLI)
# ---------------------------------------------------------------------------

# Phase 15's limits (PERF.md, written before the first run). cp attention
# over 2 key shards against the kernel over all keys and against the plain
# version: phase 2's bf16 limits. Mesh training (2 data x 2 model ranks)
# against one process, fp32 with TF32 off: the log.txt numbers within
# MESH_LOG_ATOL and the confusion counts equal (sharded products and sums
# reduce in another order, as the card against the CPU in phase 10); the
# weights within MESH_STEP_LR x lr a step, since AdamW moves an element by
# about lr a step whatever its gradient's size, so two runs whose tiny
# gradients differ in sign part by up to 2 lr a step; the planted fault
# (out_proj's forward sum removed) must break the log limit. The sharded
# eval's JSONs within phase 12's eval limits, counts equal.
MESH_LOG_ATOL = 2e-3
MESH_STEP_LR = 2.0
CP_WORLD, MESH_WORLD, MESH_N_MODEL = 2, 4, 2
# mesh training's corpus: phase 9's batch shapes (40 of 64 tracks, 64
# frames, batch 8), cut to 4 train videos (2 steps an epoch) and 2 valid
MESH_TRAIN_VIDEOS, MESH_VALID_VIDEOS = 4, 2
RANKS_TIMEOUT_S = 300
CP_SEED = 15


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(role: str, world: int, workdir: str) -> list:
    """``world`` processes of ``chip_smoke.py --rank ROLE WORKDIR`` on this
    card, in a group on a free port (torchrun's environment variables);
    waits for every rank under RANKS_TIMEOUT_S and raises if any fails or
    hangs. Returns the wall seconds and each rank's result JSON."""
    port = str(free_port())
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        out = open(os.path.join(workdir, f"{role}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", role,
             workdir], env=env, stdout=out, stderr=subprocess.STDOUT,
            cwd=ROOT), out))
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    seconds = time.perf_counter() - t0
    failed = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"{role}_rank{r}.log")) as f:
                failed.append(f"rank {r} exit {p.returncode}:\n"
                              f"{f.read()[-3000:]}")
    if failed:
        raise AssertionError(f"{role} ranks failed:\n" + "\n".join(failed))
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"{role}_rank{r}.json")) as f:
            results.append(json.load(f))
    return seconds, results


def cp_inputs():
    """Phase 2's memory cross-attention inputs (bf16, 4 x 1 x 4096 x 28736,
    D 256, its key mask) from CP_SEED, with every key of batch entry 0 in
    the second half masked: that entry's second rank holds no valid key."""
    gen = torch.Generator().manual_seed(CP_SEED)
    mask = memory_cross_mask(4, gen)
    mask[0, 28736 // CP_WORLD:] = False
    q, k, v = (torch.randn(4, 1, n, 256, generator=gen).cuda().to(
        torch.bfloat16) for n in (4096, 28736, 28736))
    return q, k, v, mask


def rank_cp_eval(workdir: str) -> dict:
    """Rank role of the 2-rank gloo group: cp attention over this rank's
    key shard (flash launches counted, the kernel timed alone while the
    other rank waits, then the combine), then the eval CLI's share."""
    import torch.distributed as dist

    from sola_torch.cli import eval as eval_cli
    from sola_torch.ops import flash_attention as fa
    from sola_torch.parallel import cp, distributed
    distributed.initialize(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    q, k, v, mask = cp_inputs()
    k, v, mask = cp.shard_keys(k, v, mask, group)
    torch.cuda.synchronize()
    dist.barrier()
    fa.launches = 0
    out = cp.cp_attention(q, k, v, mask, group)
    torch.cuda.synchronize()
    launches = fa.launches  # read right after
    if rank == 0:
        torch.save(out.cpu(), os.path.join(workdir, "cp_out.pt"))
    import torch.nn.functional as F
    times = {}
    for r in range(world):  # one rank on the card at a time
        dist.barrier()
        if r == rank:
            times = {
                "ms": cuda_ms(lambda: fa.fused_attention_lse(q, k, v, mask),
                              5),
                "plain_ms": cuda_ms(
                    lambda: fa.attention_reference(q, k, v, mask), 3),
                "library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask[:, None, None, :]), 5)}
    least, by = bound(*attention_work(*q.shape[:3], k.shape[2], q.shape[3],
                                      mask, q.element_size()), q.dtype)
    times.update(bound_ms=least, bound_by=by)
    dist.barrier()
    o_i, lse_i = fa.fused_attention_lse(q, k, v, mask)
    combine_ms = host_ms(lambda: cp.combine(o_i, lse_i, group), 5)
    with open(os.path.join(workdir, "mesh.json")) as f:
        argv = json.load(f)["eval_sharded"]
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    eval_cli.main(argv)
    torch.cuda.synchronize()
    return {"rank": rank, "cp_launches": launches,
            "valid_keys": mask.sum(dim=1).tolist(),
            "cp_kernel_ms": times.pop("ms"), "cp_kernel": times,
            "cp_combine_ms": combine_ms,
            "eval_s": time.perf_counter() - t0, "eval_launches": fa.launches}


def rank_mesh(workdir: str) -> dict:
    """Rank role of the 4-rank gloo group (2 data x 2 model): the train CLI
    with dropout off (flash launches by site counted), again for one epoch
    with out_proj's forward sum planted away, and for one epoch with the
    configured dropout, whose replicated parameters go to a file."""
    import torch.distributed as dist

    from sola_torch.cli import train as train_cli
    from sola_torch.ops import flash_attention as fa
    from sola_torch.parallel import tp
    from sola_torch.train import loop
    with open(os.path.join(workdir, "mesh.json")) as f:
        spec = json.load(f)
    sites = TrainSiteCounter(fa)
    models = []
    build_model = loop.build_model

    def build_and_watch(*args, **kwargs):  # the hooks only read counters
        model = build_model(*args, **kwargs)
        sites.watch(model)
        models.append(model)
        return model

    loop.build_model = build_and_watch
    out = {}
    torch.cuda.synchronize()
    fa.launches = fa.bwd_launches = 0
    t0 = time.perf_counter()
    train_cli.main(spec["honest"])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_attn_fwd": fa.launches,
                       "flash_attn_bwd": fa.bwd_launches}  # read right after
    out["launches_by_site"] = copy.deepcopy(sites.counts)
    attn = models[0].object_lang_align_layers[0].obj_attn
    out["local_heads"] = attn.q_proj.out_features // (
        attn.embed_dim // attn.num_heads)
    out["rank"] = dist.get_rank()
    honest = tp.reduce_from_model
    tp.reduce_from_model = lambda x, group: x
    try:
        train_cli.main(spec["fault"])
    finally:
        tp.reduce_from_model = honest
    train_cli.main(spec["dropout"])
    state = models[-1].state_dict()
    dims = tp.split_dims(state)
    torch.save({k: v.cpu() for k, v in state.items() if dims[k] is None},
               os.path.join(workdir, f"replicated_rank{out['rank']}.pt"))
    return out


def run_rank(role: str, workdir: str) -> None:
    """Entry of a rank process: runs its role and writes its result JSON."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"cp_eval": rank_cp_eval, "mesh": rank_mesh}[role](workdir)
    with open(os.path.join(workdir, f"{role}_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def rank_selection_cases(gen):
    """Phase 8's three selection sites at a mesh rank's shapes: its data
    index's 4 of the 8 batch entries, its 4 of the 8 heads."""
    return [(f"{name}_rank", site, dtype, b // 2, SEL_HEADS // MESH_N_MODEL,
             lq, lk, SEL_D, mask[:b // 2].contiguous())
            for name, site, dtype, b, lq, lk, mask
            in selection_attention_cases(gen)[:3]]


def check_rank_kernels(fa, gen) -> list:
    """The forward and the fused backward against their plain versions at a
    mesh rank's shapes, without and with dropout (phase 8's limits);
    motion_attn's 4 heads of 8 x 8 pack 4 to a block. Times each kernel by
    call beside its plain version and its bound."""
    rows = []
    for name, site, dtype, b, h, lq, lk, d, mask in rank_selection_cases(
            gen):
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen).cuda()
                       for n in (lq, lk, lk, lq))
        plan = fa.bwd_plan(h, lq, lk, d)
        if site == "motion_attn" and plan[0] != 4:
            raise AssertionError(f"{name}: bwd_plan {plan}, want 4 heads a "
                                 f"block")
        row = {"shape": name, "site": site, "b": b, "h": h, "lq": lq,
               "lk": lk, "d": d, "plan": plan}
        for rate in (0.0, SEL_RATE):
            seed = SEL_SEED if rate else None
            tag = "drop" if rate else "nodrop"
            out, lse = fa._launch(q, k, v, mask, rate, seed)
            args = (q, k, v, mask, do, lse, fa.bwd_delta(out, do), rate,
                    seed)
            grads = fa._launch_bwd_kernel(*args)
            torch.cuda.synchronize()
            ref, _ = fa.attention_reference(q, k, v, mask, rate, seed)
            err, tol, rms, rms_tol = out_errors(out, ref.float(), dtype)
            bad = grad_limits_fail(grads, fa.attention_bwd_reference(
                q, k, v, mask, out, lse, do, rate, seed), dtype)
            if not (err <= tol and rms <= rms_tol) or bad:
                raise AssertionError(f"{name} rate {rate}: forward max {err}"
                                     f" (tol {tol}), rms {rms} (tol "
                                     f"{rms_tol}); backward {bad}")
            row[f"fwd_{tag}_max_abs_err"] = err
            row[f"bwd_{tag}_max_abs_err"] = max(
                out_errors(g, r.float(), dtype)[0] for g, r in zip(
                    grads, fa.attention_bwd_reference(
                        q, k, v, mask, out, lse, do, rate, seed)))
        flops, nbytes = attention_work(b, h, lq, lk, d, mask, 4)
        bflops, bbytes = bwd_work(b, h, lq, lk, d, mask, 4)
        for kern, call, plain, work in (
                ("fwd", lambda: fa._launch(q, k, v, mask),
                 lambda: fa.attention_reference(q, k, v, mask),
                 (flops, nbytes)),
                ("bwd", lambda: fa._launch_bwd_kernel(*args),
                 lambda: fa.attention_bwd_reference(
                     q, k, v, mask, out, lse, do, SEL_RATE, SEL_SEED),
                 (bflops, bbytes))):
            least, by = bound(*work, dtype)
            row[kern] = {"ms": cuda_ms(call, 20), "plain_ms": cuda_ms(
                plain, 5), "bound_ms": least, "bound_by": by}
        # the library yardstick by call: SDPA's forward at rate 0, its
        # backward with dropout as forward + backward - forward
        import torch.nn.functional as F
        attn_mask = mask[:, None, None, :]
        row["fwd"]["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=attn_mask), 20)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        drop_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=attn_mask, dropout_p=SEL_RATE), 20)
        row["bwd"]["library_ms"] = max(cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=attn_mask,
                dropout_p=SEL_RATE).backward(do), 20) - drop_fwd, 0.0)
        rows.append(row)
        log(f"  {name:>21} bh={b}x{h} lq={lq} lk={lk} plan {plan}: fwd max "
            f"err {row['fwd_drop_max_abs_err']:.3g}, bwd max err "
            f"{row['bwd_drop_max_abs_err']:.3g}; fwd {row['fwd']['ms']:.4f}"
            f" ms (plain {row['fwd']['plain_ms']:.4f}, SDPA "
            f"{row['fwd']['library_ms']:.4f}, bound "
            f"{row['fwd']['bound_ms']:.4f}), bwd with dropout "
            f"{row['bwd']['ms']:.4f} ms (plain {row['bwd']['plain_ms']:.4f},"
            f" SDPA {row['bwd']['library_ms']:.4f} by call, bound "
            f"{row['bwd']['bound_ms']:.4f})")
    return rows


def run_nccl_world1(fa) -> dict:
    """An NCCL group of one on this card: an all-reduce of a card tensor,
    cp attention over the degenerate group against the kernel over all
    keys (equal), and a mesh train step at n_model 1 against the plain
    step (equal)."""
    import torch.distributed as dist

    from sola_torch.models.selection import SelectionConfig, init_weights
    from sola_torch.models.selection import SelectionModel
    from sola_torch.parallel import cp
    from sola_torch.parallel.mesh import make_mesh
    from sola_torch.train import loop
    from sola_torch.train import state as state_lib
    # one host: the loopback carries NCCL's bootstrap
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        t = torch.arange(8.0, device="cuda")
        dist.all_reduce(t)
        if not torch.equal(t, torch.arange(8.0, device="cuda")):
            raise AssertionError(f"NCCL all_reduce of one rank: {t}")
        q, k, v, mask = cp_inputs()
        got = cp.cp_attention(q, k, v, mask, dist.group.WORLD)
        want, _ = fa.fused_attention_lse(q, k, v, mask)
        if not torch.equal(got, want):
            raise AssertionError("cp attention over one rank differs from "
                                 "the kernel")
        del q, k, v, got, want
        mesh = make_mesh(n_model=1)
        cfg = SelectionConfig(use_pallas_attention=True, dropout_p=0.0,
                              attn_dropout_p=0.0)
        gen = torch.Generator().manual_seed(0)
        batch = {"object_tokens": torch.randn(BATCH, 64, FRAMES, 256,
                                              generator=gen),
                 "track_mask": torch.arange(64)[None].expand(BATCH, 64) < 40,
                 "frame_lengths": torch.full((BATCH,), FRAMES),
                 "lang_tokens": torch.randn(BATCH, 96, 1024, generator=gen),
                 "lang_mask": torch.arange(96)[None].expand(BATCH, 96) < 12,
                 "pos_tokens": torch.randn(BATCH, 1, 1024, generator=gen),
                 "labels": (torch.rand(BATCH, 64, generator=gen) > 0.7
                            ).float()}
        batch = {k: t.cuda() for k, t in batch.items()}
        train_cfg = {"positive_weight": 1.5, "alignment_weight": 0.3,
                     "temperature": 0.07}
        finals = []
        # cuDNN's default conv backward algorithms may sum in another order
        # from one run to the next, so two equal steps differ in last bits
        with loop.deterministic_cudnn():
            for m in (mesh, None):
                model = SelectionModel(cfg)
                init_weights(model, 42)
                model = model.cuda()
                opt = state_lib.make_optimizer(model.parameters(), lr=5e-6)
                loop.train_step(model, opt, batch, train_cfg,
                                torch.Generator().manual_seed(0), m)
                finals.append(model.state_dict())
        if any(not torch.equal(finals[0][k], finals[1][k])
               for k in finals[0]):
            raise AssertionError("the mesh step at n_model 1 differs from "
                                 "the plain step")
        return {"backend": dist.get_backend(), "world": dist.get_world_size(),
                "mesh": [mesh.n_data, mesh.n_model]}
    finally:
        dist.destroy_process_group()


def max_weight_diff(a: str, b: str) -> float:
    sa = torch.load(a, weights_only=True)
    sb = torch.load(b, weights_only=True)
    if sa.keys() != sb.keys():
        raise AssertionError(f"checkpoint names differ: {a} {b}")
    return max((sa[k].float() - sb[k].float()).abs().max().item()
               for k in sa)


def run_distributed(fa) -> dict:
    """Phase 15."""
    import yaml

    from sola_torch import config as config_lib
    from sola_torch.cli import eval as eval_cli
    from sola_torch.cli import train as train_cli
    from sola_torch.models.selection import SelectionConfig, SelectionModel
    root = os.path.join(OUT_DIR, "distributed")
    os.makedirs(root)
    out = {"nccl_world1": run_nccl_world1(fa)}
    log(f"  NCCL group of 1: all_reduce, cp attention equal to the kernel, "
        f"a mesh step at n_model 1 equal to the plain step "
        f"{out['nccl_world1']}")
    gen = torch.Generator().manual_seed(15)
    out["rank_kernels"] = check_rank_kernels(fa, gen)

    dataset = selection_corpus(os.path.join(root, "data"), MESH_TRAIN_VIDEOS,
                               MESH_VALID_VIDEOS, FRAMES, OBJECTS,
                               DISTRACTORS, BATCH)
    dataset["num_workers"] = 2
    configs = config_lib.load_config("mevis/default")
    configs["exp_name"] = "mesh"
    configs["model"]["use_pallas_attention"] = True
    configs["dataset"] = dataset
    configs["results"] = {k: os.path.join(root, k) for k in (
        "output_dir", "eval_output_dir", "test_output_dir")}
    yaml_path = os.path.join(root, "mesh.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(configs, f)

    def train_argv(name, epochs, dropout=False):
        argv = ["--config", yaml_path, "--device", "cuda", "--backend",
                "gloo", "--train.n_model", str(MESH_N_MODEL),
                "--train.n_epochs", str(epochs),
                "--results.output_dir", os.path.join(root, name)]
        if not dropout:
            argv += ["--model.dropout_p", "0", "--model.attn_dropout_p", "0"]
        return argv

    def train_dir(name):
        return os.path.join(root, name, "mesh", "mevis")

    eval_argv = ["--config", yaml_path, "--device", "cuda",
                 "--eval_weight_epoch", "2", "--dataset.valid.batch_size",
                 "4", "--results.output_dir", os.path.join(root, "mesh2x2")]
    spec = {"honest": train_argv("mesh2x2", 2),
            "fault": train_argv("fault", 1),
            "dropout": train_argv("dropout", 1, dropout=True),
            "eval_sharded": eval_argv + [
                "--backend", "gloo", "--results.eval_output_dir",
                os.path.join(root, "eval_sharded")]}
    with open(os.path.join(root, "mesh.json"), "w") as f:
        json.dump(spec, f)

    out["mesh_s"], ranks = launch_ranks("mesh", MESH_WORLD, root)
    t0 = time.perf_counter()
    train_cli.main(train_argv("single", 2))
    torch.cuda.synchronize()
    out["single_train_s"] = time.perf_counter() - t0
    steps = MESH_TRAIN_VIDEOS * OBJECTS // BATCH * 2
    valid_batches = MESH_VALID_VIDEOS * OBJECTS // BATCH * 2
    want = {"fwd": 2 * (steps + valid_batches), "bwd": 2 * steps}
    for r in ranks:
        if (r["local_heads"] != SEL_HEADS // MESH_N_MODEL
                or any(r["launches_by_site"][s] != want
                       for s in ATTN_SITES)
                or r["launches"]["flash_attn_fwd"] != 3 * want["fwd"]
                or r["launches"]["flash_attn_bwd"] != 3 * want["bwd"]):
            raise AssertionError(f"rank {r['rank']}: {r['local_heads']} "
                                 f"heads, launches by site "
                                 f"{r['launches_by_site']} (want {want} "
                                 f"each), totals {r['launches']}")
    mesh_log = parse_train_log(os.path.join(train_dir("mesh2x2"),
                                            "log.txt"))
    single_log = parse_train_log(os.path.join(train_dir("single"),
                                              "log.txt"))
    log_err = (float(np.abs(np.subtract(mesh_log[0], single_log[0])).max())
               if len(mesh_log[0]) == len(single_log[0]) else float("inf"))
    lr = float(configs["train"]["lr"])
    weight_tol = MESH_STEP_LR * lr * steps
    weight_err = max_weight_diff(
        os.path.join(train_dir("mesh2x2"), "epoch_2.pth"),
        os.path.join(train_dir("single"), "epoch_2.pth"))
    if (mesh_log[2] != ["001", "002"] or mesh_log[1] != single_log[1]
            or not log_err <= MESH_LOG_ATOL
            or not weight_err <= weight_tol):
        raise AssertionError(
            f"mesh training against one process: log numbers within "
            f"{log_err} (tol {MESH_LOG_ATOL}), counts {mesh_log[1]} vs "
            f"{single_log[1]}, epochs {mesh_log[2]}, weights within "
            f"{weight_err} (tol {weight_tol})")
    cfg = SelectionConfig.from_dict(configs["model"])
    for epoch in (1, 2):
        SelectionModel(cfg).load_state_dict(torch.load(os.path.join(
            train_dir("mesh2x2"), f"epoch_{epoch}.pth"), weights_only=True),
            strict=True)
    full = dict(SelectionModel(cfg).named_parameters())
    moments = torch.load(os.path.join(train_dir("mesh2x2"),
                                      "epoch_2.resume.pth"),
                         weights_only=True)["optimizer"]["state"]
    shapes = [p.shape for p in full.values()]
    if len(moments) != len(shapes) or any(
            e["exp_avg"].shape != shapes[int(i)]
            for i, e in moments.items()):
        raise AssertionError("the gathered AdamW moments do not have the "
                             "full model's shapes")
    fault_log = parse_train_log(os.path.join(train_dir("fault"), "log.txt"))
    n1 = len(fault_log[0])
    fault_err = float(np.abs(np.subtract(
        fault_log[0], single_log[0][:n1])).max())
    if fault_err <= MESH_LOG_ATOL and fault_log[1] == single_log[1][:4]:
        raise AssertionError(f"the limits accept mesh training without "
                             f"out_proj's sum: log within {fault_err}")
    drop_log = parse_train_log(os.path.join(train_dir("dropout"),
                                            "log.txt"))
    reps = [torch.load(os.path.join(root, f"replicated_rank{r}.pt"),
                       weights_only=True) for r in range(MESH_WORLD)]
    if not np.isfinite(drop_log[0]).all() or any(
            not torch.equal(rep[k], reps[0][k]) for rep in reps[1:]
            for k in reps[0]):
        raise AssertionError(f"mesh training with dropout: log "
                             f"{drop_log[0]}, replicated parameters equal "
                             f"on every rank: False")
    out["mesh"] = {"ranks": ranks, "log": mesh_log[0],
                   "confusion": mesh_log[1], "max_abs_log_err": log_err,
                   "log_tol": MESH_LOG_ATOL,
                   "max_abs_weight_err": weight_err,
                   "weight_tol": weight_tol, "fault_max_abs_log_err":
                   fault_err, "dropout_log": drop_log[0],
                   "replicated_tensors": len(reps[0])}
    log(f"  mesh training 2 x 2 (gloo, one card; train CLI, "
        f"SelectionConfig() flash route, {steps} steps + {valid_batches} "
        f"validation batches): {out['mesh_s']:.1f} s for the ranks' three "
        f"runs, one process {out['single_train_s']:.1f} s; log within "
        f"{log_err:.3g} (tol {MESH_LOG_ATOL}), TP/FP/FN/TN equal "
        f"{mesh_log[1][-4:]}, weights within {weight_err:.3g} (tol "
        f"{weight_tol:.3g}); launches a rank by site "
        f"{ranks[0]['launches_by_site']}; out_proj's sum planted away: log "
        f"off by {fault_err:.4g} (rejected); with dropout: log finite, "
        f"{len(reps[0])} replicated tensors bit-equal on 4 ranks")

    # cp attention and the sharded eval on 2 ranks, then one process
    out["cp_eval_s"], cranks = launch_ranks("cp_eval", CP_WORLD, root)
    q, k, v, mask = cp_inputs()
    got = torch.load(os.path.join(root, "cp_out.pt")).cuda()
    single, _ = fa.fused_attention_lse(q, k, v, mask)
    ref = fa.attention_reference(q, k, v, mask)[0].float()
    errs = {"plain": out_errors(got, ref, torch.bfloat16),
            "kernel": out_errors(got, single.float(), torch.bfloat16)}
    if (any(not (e[0] <= e[1] and e[2] <= e[3]) for e in errs.values())
            or cranks[1]["valid_keys"][0] != 0
            or any(r["cp_launches"] != 1 for r in cranks)):
        raise AssertionError(f"cp attention over 2 ranks: errors {errs}, "
                             f"rank 1's valid keys "
                             f"{cranks[1]['valid_keys']}, launches "
                             f"{[r['cp_launches'] for r in cranks]}")
    del q, k, v, mask, got, single, ref
    eval_cli.main(eval_argv + ["--results.eval_output_dir",
                               os.path.join(root, "eval_single")])
    evals = {}
    for name in ("eval_single", "eval_sharded"):
        d = os.path.join(root, name, "mesh", "mevis", "pred_threshold_05",
                         "epoch_2")
        evals[name] = {}
        for key, f in (("metrics", "valid_u_metrics_2epoch.json"),
                       ("jf", "valid_u_JF_metrics_2epoch.json")):
            with open(os.path.join(d, f)) as fh:
                evals[name][key] = json.load(fh)
    bad, readings = eval_differences(evals["eval_sharded"],
                                     evals["eval_single"])
    counts = [evals[n]["metrics"][c] for n in evals
              for c in ("tp", "fp", "fn", "tn")]
    if bad or counts[:4] != counts[4:] or min(
            r["eval_launches"] for r in cranks) == 0:
        raise AssertionError(f"sharded eval against one process: {bad}, "
                             f"counts {counts}")
    out["cp"] = {"ranks": cranks, "errors": {
        k: dict(zip(("max_abs_err", "max_abs_tol", "rms_err", "rms_tol"), e))
        for k, e in errs.items()}}
    out["eval"] = {"equal": evals["eval_sharded"] == evals["eval_single"],
                   "readings": readings, "confusion": counts[:4],
                   "launches_by_rank": [r["eval_launches"] for r in cranks]}
    log(f"  cp attention over 2 gloo ranks on one card (14368 keys each; "
        f"rank 1 holds no valid key of entry 0): against the plain version "
        f"max {errs['plain'][0]:.3g} (tol {errs['plain'][1]:.3g}), against "
        f"the kernel over all keys max {errs['kernel'][0]:.3g}; flash "
        f"launches a rank {[r['cp_launches'] for r in cranks]}; each rank's "
        f"kernel alone {[round(r['cp_kernel_ms'], 4) for r in cranks]} ms "
        f"(plain {[round(r['cp_kernel']['plain_ms'], 3) for r in cranks]}, "
        f"SDPA {[round(r['cp_kernel']['library_ms'], 4) for r in cranks]}, "
        f"bound {[round(r['cp_kernel']['bound_ms'], 4) for r in cranks]}); "
        f"the combine (gloo staging through the host on a shared card, not "
        f"a scaling figure) {[round(r['cp_combine_ms'], 2) for r in cranks]}"
        f" ms")
    log(f"  eval CLI over 2 ranks against one process: JSONs equal "
        f"{out['eval']['equal']}, within the eval limits, TP/FP/FN/TN "
        f"{counts[:4]}; flash launches by rank "
        f"{out['eval']['launches_by_rank']}; 2-rank launch "
        f"{out['cp_eval_s']:.1f} s")
    drop_bulk(root)
    for f in os.listdir(root):
        if f.endswith(".pt"):
            os.remove(os.path.join(root, f))
    return out


# ---------------------------------------------------------------------------
# phase 16: selection training killed and resumed on the card
# ---------------------------------------------------------------------------

# phase 9's batch shapes (40 of 64 tracks, 64 frames, batch 8) on a cut
# corpus: 8 train videos x 4 expressions (4 steps an epoch) and 2 valid
# videos (1 batch), 3 epochs, SelectionConfig() with the flash route and
# dropout 0.2 / attention dropout 0.1
RESUME_TRAIN_VIDEOS, RESUME_VALID_VIDEOS, RESUME_EPOCHS = 8, 2, 3
RESUME_KILL_EPOCH = 2  # the SIGKILL lands inside this epoch
RESUME_TIMEOUT_S = 300
# the warm step with and without deterministic cuDNN, in turns
DET_TURNS = (False, True, True, False)


class ShapeSiteCounter:
    """The two flash kernels' launches by call site in a process whose
    autograd graph must stay as the train CLI builds it: phase 9's module
    backward hooks add nodes that change the order in which a tensor's
    gradients are summed. The wrappers alone count; this reads their
    counters around each call of ``flash_forward`` / ``flash_backward``
    and keys the growth by the call's query length, which differs between
    the three sites here (64 track slots, 8 frames after the motion
    encoder, 64 x 8 (track, frame) pairs); the sites are named in the
    order a layer first calls them."""

    def __init__(self, fa):
        self.by_lq = {}
        fwd, bwd = fa.flash_forward, fa.flash_backward

        def counted(fn, kind, counter):
            def call(q, *args, **kwargs):
                before = getattr(fa, counter)
                out = fn(q, *args, **kwargs)
                counts = self.by_lq.setdefault(q.shape[2],
                                               {"fwd": 0, "bwd": 0})
                counts[kind] += getattr(fa, counter) - before
                return out
            return call

        fa.flash_forward = counted(fwd, "fwd", "launches")
        fa.flash_backward = counted(bwd, "bwd", "bwd_launches")

    def sites(self) -> dict:
        return {f"{site} (Lq {lq})": counts for site, (lq, counts)
                in zip(ATTN_SITES, self.by_lq.items())}


def resumed_train(workdir: str, name: str) -> dict:
    """A resumed run: the train CLI's main with --resume, its flash
    launches counted by site (``ShapeSiteCounter``) and not otherwise
    touched, so it computes what ``python -m sola_torch.cli.train`` does.
    It starts while the run to kill trains: it imports what the CLI's
    start imports (transformers, for the text encoder's checkpoint probe,
    offline) and opens the card, then waits for the file ``go_NAME``."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    try:
        import transformers  # noqa: F401
    except ImportError:
        pass
    from sola_torch.cli import train as train_cli
    from sola_torch.ops import flash_attention as fa
    with open(os.path.join(workdir, "resume.json")) as f:
        argv = json.load(f)[name]
    torch.zeros(1, device="cuda")
    go = os.path.join(workdir, f"go_{name}")
    deadline = time.monotonic() + RESUME_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {go} within {RESUME_TIMEOUT_S} s")
        time.sleep(0.01)
    sites = ShapeSiteCounter(fa)
    torch.cuda.synchronize()
    fa.launches = fa.bwd_launches = 0
    t0 = time.perf_counter()
    _, launches, counters = device_kernel_counts(
        lambda: train_cli.main(argv))
    return {"launches": launches,
            "wrapper_calls": {"flash_attn_fwd": fa.launches,
                              "flash_attn_bwd": fa.bwd_launches},
            "calls_by_site": sites.sites(), "counters": counters,
            "train_s": time.perf_counter() - t0}


def role_determinism_check(workdir: str) -> dict:
    """One train step and one validation step of phase 16's configuration
    under ``torch.use_deterministic_algorithms(True)``, which raises on
    every op without a deterministic algorithm and fills uninitialized
    memory with NaN. The process starts with CUBLAS_WORKSPACE_CONFIG set,
    as torch requires before it lets cuBLAS run in that mode."""
    import yaml

    from sola_torch.data.dataset import get_loader_dict
    from sola_torch.models.selection import SelectionConfig
    from sola_torch.models.text import CachingTextEncoder, build_text_encoder
    from sola_torch.train import loop
    from sola_torch.train import state as state_lib
    with open(os.path.join(workdir, "resume.yaml")) as f:
        configs = yaml.safe_load(f)
    torch.use_deterministic_algorithms(True)
    cfg = SelectionConfig.from_dict(configs["model"])
    model = loop.build_model(cfg, "cuda")
    text = CachingTextEncoder(build_text_encoder(configs["model"], "cuda"))
    loaders = get_loader_dict(configs["dataset"])
    batch = loop.prepare_batch(next(iter(loaders["train"])), text,
                               configs["train"], "cuda")
    optimizer = state_lib.make_optimizer(model.parameters(), lr=5e-6)
    metrics = loop.train_step(model, optimizer, batch, configs["train"],
                              torch.Generator().manual_seed(0))
    valid = loop.eval_step(model, loop.prepare_batch(
        next(iter(loaders["valid"])), text, configs["train"], "cuda"),
        configs["train"], 0.5)
    torch.cuda.synchronize()
    values = [float(metrics[k]) for k in ("total", "total_grad_norm")] + [
        float(valid["total"])]
    finite = bool(np.isfinite(values).all()) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    return {"deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "loss_grad_norm_valid_loss": values, "finite": finite}


ROLES = {"resumed_train": lambda w: resumed_train(w, "resumed"),
         "fault_train": lambda w: resumed_train(w, "fault"),
         "determinism_check": role_determinism_check}


def run_role(role: str, workdir: str) -> None:
    """Entry of a phase-16 process: runs its role and writes its JSON."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    result = ROLES[role](workdir)
    with open(os.path.join(workdir, f"{role}.json"), "w") as f:
        json.dump(result, f)


def start(cmd: list, log_path: str, env=None) -> subprocess.Popen:
    with open(log_path, "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=env)


def finish(proc: subprocess.Popen, log_path: str, what: str,
           deadline: float) -> None:
    """Wait for ``proc`` until ``deadline``; kill it and raise if it hangs
    or fails."""
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.returncode != 0:
        with open(log_path) as f:
            raise AssertionError(f"{what} failed (exit {proc.returncode}):\n"
                                 f"{f.read()[-3000:]}")


def same_objects(a, b) -> bool:
    """Saved objects equal bit for bit: tensors ``torch.equal`` with equal
    dtypes and devices, every other leaf ``==``."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_objects(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_objects(x, y) for x, y in zip(a, b)))
    return a == b


def read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def determinism_cost(configs: dict) -> dict:
    """What ``train()``'s deterministic cuDNN buys and costs at phase 9's
    batch shapes: two equal 3-step runs from one seeded init with cuDNN's
    default algorithms and with the deterministic ones (the tensors that
    differ between the two runs of each; none may with the deterministic
    ones), and the warm train step under each, in turns."""
    from sola_torch.data.dataset import get_loader_dict
    from sola_torch.models.selection import SelectionConfig
    from sola_torch.models.text import CachingTextEncoder, build_text_encoder
    from sola_torch.train import loop
    from sola_torch.train import state as state_lib
    cfg = SelectionConfig.from_dict(configs["model"])
    model = loop.build_model(cfg, "cuda")
    text = CachingTextEncoder(build_text_encoder(configs["model"], "cuda"))
    batch = loop.prepare_batch(
        next(iter(get_loader_dict(configs["dataset"])["train"])), text,
        configs["train"], "cuda")
    optimizer = state_lib.make_optimizer(model.parameters(), lr=5e-6)
    gen = torch.Generator().manual_seed(0)

    def differing_after_3_steps() -> int:
        finals = []
        for _ in range(2):
            m = loop.build_model(cfg, "cuda")
            opt = state_lib.make_optimizer(m.parameters(), lr=5e-6)
            g = torch.Generator().manual_seed(0)
            for _ in range(3):
                loop.train_step(m, opt, batch, configs["train"], g)
            finals.append(m.state_dict())
        return sum(not torch.equal(finals[0][k], finals[1][k])
                   for k in finals[0])

    times = {False: [], True: []}
    differing = {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        for deterministic in DET_TURNS:
            cudnn.deterministic, cudnn.benchmark = deterministic, False
            differing.setdefault(deterministic, differing_after_3_steps())
            times[deterministic].append(host_ms(
                lambda: loop.train_step(model, optimizer, batch,
                                        configs["train"], gen), iters=10))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    if differing[True]:
        raise AssertionError(f"two equal runs with deterministic cuDNN "
                             f"differ in {differing[True]} tensors")
    return {"default_ms": times[False], "deterministic_ms": times[True],
            "cost": (statistics.mean(times[True])
                     / statistics.mean(times[False]) - 1.0),
            "differing_tensors_default": differing[False],
            "differing_tensors_deterministic": differing[True]}


def run_kill_and_resume(fa) -> dict:
    """Phase 16; its corpus and checkpoints (about 2 GB) are removed
    however it ends, and no process it started outlives it."""
    root = os.path.join(OUT_DIR, "resume")
    os.makedirs(root)
    started = []
    try:
        return kill_and_resume(fa, root, started)
    finally:
        for proc in started:  # none outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        drop_bulk(root)


def kill_and_resume(fa, root: str, started: list) -> dict:
    import yaml

    from sola_torch import config as config_lib
    from sola_torch.train import state as state_lib
    t_phase = time.perf_counter()
    dataset = selection_corpus(os.path.join(root, "data"),
                               RESUME_TRAIN_VIDEOS, RESUME_VALID_VIDEOS,
                               FRAMES, OBJECTS, DISTRACTORS, BATCH)
    dataset["num_workers"] = 2
    configs = config_lib.load_config("mevis/default")
    configs["exp_name"] = "resume"
    configs["model"].update(use_pallas_attention=True, dropout_p=0.2,
                            attn_dropout_p=0.1)
    configs["train"]["n_epochs"] = RESUME_EPOCHS
    configs["dataset"] = dataset
    configs["results"] = {k: os.path.join(root, k) for k in (
        "output_dir", "eval_output_dir", "test_output_dir")}
    yaml_path = os.path.join(root, "resume.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(configs, f)

    def train_cmd(name, resume=False):
        return [sys.executable, "-m", "sola_torch.cli.train", "--config",
                yaml_path, "--device", "cuda", "--results.output_dir",
                os.path.join(root, name)] + (["--resume"] if resume else [])

    def train_dir(name):
        return os.path.join(root, name, "resume", "mevis")

    def logfile(name):
        return os.path.join(root, f"{name}.out")

    with open(os.path.join(root, "resume.json"), "w") as f:
        json.dump({name: train_cmd(name, resume=True)[3:]
                   for name in ("resumed", "fault")}, f)
    role = [sys.executable, os.path.abspath(__file__), "--role"]
    deadline = time.monotonic() + RESUME_TIMEOUT_S
    procs = {"unbroken": start(train_cmd("unbroken"), logfile("unbroken")),
             "killed": start(train_cmd("resumed"), logfile("killed")),
             "determinism_check": start(
                 role + ["determinism_check", root],
                 logfile("determinism_check"),
                 env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")),
             # they start now and wait for the killed run's checkpoint
             "resumed": start(role + ["resumed_train", root],
                              logfile("resumed")),
             "fault": start(role + ["fault_train", root], logfile("fault"))}
    started += procs.values()
    t0 = time.perf_counter()
    killed = procs.pop("killed")
    last_line = f"VALID EPOCH {RESUME_KILL_EPOCH - 1:03d} | TP:"
    log_txt = os.path.join(train_dir("resumed"), "log.txt")
    while killed.poll() is None and time.monotonic() < deadline and not (
            os.path.exists(log_txt) and last_line in read_text(log_txt)):
        time.sleep(0.005)
    if killed.poll() is not None:
        raise AssertionError(f"the run to kill ended first (exit "
                             f"{killed.returncode}):\n"
                             f"{read_text(logfile('killed'))[-3000:]}")
    killed.kill()  # SIGKILL
    killed.wait()
    kill_s = time.perf_counter() - t0
    landed = state_lib.latest_checkpoint_epoch(train_dir("resumed"))
    leftovers = sorted(n for n in os.listdir(train_dir("resumed"))
                       if n.endswith(".tmp"))
    if landed != RESUME_KILL_EPOCH - 1:
        raise AssertionError(f"the kill landed after epoch {landed} ended, "
                             f"not inside epoch {RESUME_KILL_EPOCH}")

    # the planted fault: the killed run's checkpoint with one weight
    # element moved by one ulp, resumed the same way
    os.makedirs(train_dir("fault"))
    for name in os.listdir(train_dir("resumed")):
        if not name.endswith(".tmp"):
            shutil.copy(os.path.join(train_dir("resumed"), name),
                        train_dir("fault"))
    weights = os.path.join(train_dir("fault"), f"epoch_{landed}.pth")
    state = torch.load(weights, weights_only=True)
    planted = "object_lang_align_layers.0.obj_attn.q_proj.weight"
    flat = state[planted].view(-1)
    flat[0] = torch.nextafter(flat[0], torch.tensor(float("inf")))
    torch.save(state, weights)
    t0 = time.perf_counter()
    for name in ("resumed", "fault"):
        open(os.path.join(root, f"go_{name}"), "w").close()
    for name, proc in procs.items():
        finish(proc, logfile(name), f"phase 16 {name} run", deadline)
    runs_s = time.perf_counter() - t0

    resumed = json.load(open(os.path.join(root, "resumed_train.json")))
    fault_run = json.load(open(os.path.join(root, "fault_train.json")))
    check = json.load(open(os.path.join(root, "determinism_check.json")))
    for name in ("resumed", "fault"):
        if f"resumed from epoch {landed}" not in read_text(logfile(name)):
            raise AssertionError(f"the {name} run did not restore epoch "
                                 f"{landed}:\n{read_text(logfile(name))}")
    unequal = []
    for epoch in range(RESUME_KILL_EPOCH, RESUME_EPOCHS + 1):
        for name in state_lib.checkpoint_paths("", epoch):
            a, b = (torch.load(os.path.join(train_dir(run), name),
                               weights_only=True)
                    for run in ("unbroken", "resumed"))
            if not same_objects(a, b):
                unequal.append(name)
    logs_equal = (read_text(os.path.join(train_dir("unbroken"), "log.txt"))
                  == read_text(log_txt))
    final = f"epoch_{RESUME_EPOCHS}.pth"
    want_w, fault_w = (torch.load(os.path.join(train_dir(run), final),
                                  weights_only=True)
                       for run in ("unbroken", "fault"))
    fault_moved = sum(not torch.equal(want_w[k], fault_w[k]) for k in want_w)
    fault_max = max((want_w[k] - fault_w[k]).abs().max().item()
                    for k in want_w)
    epochs = RESUME_EPOCHS - landed
    steps = RESUME_TRAIN_VIDEOS * OBJECTS // BATCH * epochs
    valid_batches = RESUME_VALID_VIDEOS * OBJECTS // BATCH * epochs
    want, want_calls = graph_launches(2, steps, TRAIN_SHAPES, valid_batches)
    by_site = resumed["calls_by_site"]
    if (unequal or not logs_equal or fault_moved == 0
            or resumed["launches"] != want
            or resumed["counters"].get("train.steps") != steps
            or resumed["counters"].get("train.graph_captures")
            != TRAIN_SHAPES
            or len(by_site) != 3
            or any(c != want_calls for c in by_site.values())
            or not check["deterministic_algorithms"] or not check["finite"]):
        raise AssertionError(
            f"kill and resume: files unequal to the unbroken run's "
            f"{unequal}, log.txt equal {logs_equal}; the one-ulp fault moved "
            f"{fault_moved} tensors; resumed run's flash kernels on the "
            f"device {resumed['launches']} (want {want}), counters "
            f"{resumed['counters']}, wrapper calls by site {by_site} (want "
            f"{want_calls} each); deterministic check {check}")
    step = determinism_cost(configs)
    out = {"kill_s": kill_s, "kill_inside_epoch": RESUME_KILL_EPOCH,
           "newest_checkpoint_after_kill": landed,
           "unfinished_saves_left": leftovers,
           "compared_files": [n for e in range(RESUME_KILL_EPOCH,
                                               RESUME_EPOCHS + 1)
                              for n in state_lib.checkpoint_paths("", e)],
           "log_equal": logs_equal, "resumed": resumed,
           "resumed_and_fault_runs_s": runs_s,
           "fault": {"planted": planted, "tensors_moved": fault_moved,
                     "max_abs_diff": fault_max,
                     "launches": fault_run["launches"]},
           "determinism_check": check, "warm_step": step,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  SIGKILL {kill_s:.2f} s after launch, inside epoch "
        f"{RESUME_KILL_EPOCH} (newest checkpoint {landed}, unfinished saves "
        f"left {leftovers}); resumed run {resumed['train_s']:.2f} s in the "
        f"CLI: epochs {RESUME_KILL_EPOCH}-{RESUME_EPOCHS}' weights and "
        f"resume files torch.equal to the unbroken run's "
        f"({len(out['compared_files'])} files), log.txt equal; flash "
        f"kernels on the device {resumed['launches']}, wrapper calls by site "
        f"{by_site}")
    log(f"  one ulp planted in epoch {landed}'s {planted}[0]: epoch "
        f"{RESUME_EPOCHS}'s weights differ in {fault_moved} tensors (max "
        f"{fault_max:.3g}); torch.use_deterministic_algorithms(True): a "
        f"train and a validation step raise nothing, finite "
        f"{check['finite']}")
    log(f"  two equal 3-step runs differ in "
        f"{step['differing_tensors_default']} tensors with cuDNN's default "
        f"algorithms, in {step['differing_tensors_deterministic']} with the "
        f"deterministic ones")
    log(f"  warm train step (batch {BATCH}) with cuDNN's default algorithms "
        f"{[round(t, 3) for t in step['default_ms']]} ms, deterministic "
        f"{[round(t, 3) for t in step['deterministic_ms']]} ms (cost "
        f"{100 * step['cost']:+.2f}%); phase {out['phase_s']:.1f} s; card "
        f"{smi_line()}")
    return out

# phase 17: the select_mevis.train_b1 mix's padded shapes (its track and
# frame buckets; words pad to the text encoder's 96)
GRAPH_TRACKS, GRAPH_FRAMES, GRAPH_WORDS, GRAPH_STEPS = (8, 16, 32, 64), (
    32, 64, 128), 96, 4


def graph_batch(nb: int, tb: int, cfg, gen) -> dict:
    """A padded training batch of nb track slots and tb frame slots on the
    card, as ``prepare_batch`` gives it: ragged valid tracks, frames and
    words, labels from a 0.7 threshold."""
    n = int(torch.randint(nb // 2 + 1, nb + 1, (1,), generator=gen))
    t = int(torch.randint(tb // 2 + 1, tb + 1, (1,), generator=gen))
    w = int(torch.randint(4, 15, (1,), generator=gen))
    d = cfg.lang_token_dim
    return {k: v.cuda() for k, v in {
        "object_tokens": torch.randn(1, nb, tb, cfg.object_token_dim,
                                     generator=gen),
        "track_mask": (torch.arange(nb) < n)[None],
        "frame_lengths": torch.tensor([t]),
        "lang_tokens": torch.randn(1, GRAPH_WORDS, d, generator=gen),
        "lang_mask": (torch.arange(GRAPH_WORDS) < w)[None],
        "pos_tokens": torch.randn(1, 1, d, generator=gen),
        "labels": (torch.rand(1, nb, generator=gen) > 0.7).float()}.items()}


def train_state(optimizer) -> list:
    """Copies of each parameter and its AdamW state."""
    return [(p.detach().clone(), {k: v.clone() for k, v in
                                  optimizer.adamw.state[p].items()})
            for p in optimizer.params]


def load_train_state(optimizer, state: list) -> None:
    """Write a ``train_state`` back in place, so captured graphs keep
    reading and writing the same tensors."""
    with torch.no_grad():
        for p, (w, st) in zip(optimizer.params, state):
            p.copy_(w)
            for k, v in st.items():
                optimizer.adamw.state[p][k].copy_(v)


def unequal_state(a, b) -> list:
    """Where two optimizers' parameters, gradients as AdamW took them, and
    moments differ at all."""
    bad = []
    for i, (p, q) in enumerate(zip(a.params, b.params)):
        sa, sb = a.adamw.state[p], b.adamw.state[q]
        for name, x, y in (("weight", p, q), ("grad", p.grad, q.grad),
                           ("exp_avg", sa["exp_avg"], sb["exp_avg"]),
                           ("exp_avg_sq", sa["exp_avg_sq"],
                            sb["exp_avg_sq"]), ("step", sa["step"],
                                                sb["step"])):
            if not torch.equal(x, y):
                bad.append(f"{name} {i}")
    return bad


def run_train_graphs() -> dict:
    """Phase 17: eager against graph-replayed training steps at full width
    over the train_b1 mix's 12 padded shapes."""
    from sola_torch.models.selection import SelectionConfig
    from sola_torch.train import graphs, loop
    from sola_torch.train import state as state_lib
    cfg = SelectionConfig(use_pallas_attention=True, dropout_p=0.2,
                          attn_dropout_p=0.1)
    train_cfg = {"temperature": 0.07, "positive_weight": 1.5,
                 "alignment_weight": 0.3}
    gen = torch.Generator().manual_seed(17)
    shapes = [(nb, tb) for nb in GRAPH_TRACKS for tb in GRAPH_FRAMES]
    batches = {s: [graph_batch(*s, cfg, gen) for _ in range(GRAPH_STEPS)]
               for s in shapes}
    runs = {}
    for name in ("eager", "graph"):
        model = loop.build_model(cfg, "cuda", seed=3)
        runs[name] = (model, state_lib.make_optimizer(
            model.parameters(), lr=5e-6, grad_clip_norm=1.0))
    usable = graphs.usable

    def step(name, batch, g):
        model, opt = runs[name]
        if name == "eager":
            graphs.usable = lambda *_: False
        try:
            out = loop.train_step(model, opt, batch, train_cfg, g)
        finally:
            graphs.usable = usable
        torch.cuda.synchronize()
        return out

    rows = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with loop.deterministic_cudnn():
        # one eager step on each, alike: AdamW holds state from here on
        warm = graph_batch(16, 32, cfg, gen)
        for name in runs:
            graphs.usable = lambda *_: False
            try:
                step(name, warm, torch.Generator().manual_seed(1))
            finally:
                graphs.usable = usable
        start = train_state(runs["eager"][1])
        for si, shape in enumerate(shapes):
            for _, opt in runs.values():
                load_train_state(opt, start)
                state_lib.set_learning_rate(opt, 5e-6)
            gens = {n: torch.Generator().manual_seed(100 + si) for n in runs}
            row = {"shape": shape, "eager_ms": [], "graph_ms": [],
                   "update_norms": []}
            before = [p.detach().clone() for p in runs["graph"][1].params]
            for i, batch in enumerate(batches[shape]):
                if si == 0 and i == 2:  # between replays
                    for _, opt in runs.values():
                        state_lib.set_learning_rate(opt, 5e-5)
                outs = {}
                for name in runs:
                    t0 = time.perf_counter()
                    outs[name] = step(name, batch, gens[name])
                    row[f"{name}_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
                bad = [k for k in outs["eager"]
                       if not torch.equal(outs["eager"][k], outs["graph"][k])]
                bad += unequal_state(runs["eager"][1], runs["graph"][1])
                if not torch.equal(gens["eager"].get_state(),
                                   gens["graph"].get_state()):
                    bad.append("host generator")
                if bad:
                    raise AssertionError(f"shape {shape} step {i}: eager and "
                                         f"replayed steps differ in {bad}")
                now = [p.detach().clone() for p in runs["graph"][1].params]
                row["update_norms"].append(float(torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(a - b)
                                 for a, b in zip(now, before)]))))
                before = now
            row["capture_ms"] = row["graph_ms"][0]
            rows.append(row)
            log(f"  {shape[0]:>3} tracks x {shape[1]:>3} frames: equal over "
                f"{GRAPH_STEPS} steps; capture step {row['capture_ms']:.1f} "
                f"ms, eager {statistics.median(row['eager_ms'][1:]):.2f} ms, "
                f"replayed {statistics.median(row['graph_ms'][1:]):.2f} ms")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    captured = len(runs["graph"][1].graphs.shapes)
    ratio = rows[0]["update_norms"][2] / rows[0]["update_norms"][1]
    if captured != len(shapes) or ratio < 3.0:
        raise AssertionError(f"{captured} shapes captured of {len(shapes)}; "
                             f"the lr x10 between replays moved the update "
                             f"{ratio:.2f}x")
    log(f"  lr x10 between replays: the update grew {ratio:.2f}x; "
        f"{captured} shapes captured; peak memory {peak_gb:.2f} GB after "
        f"all captures (both runs' models and moments); card {smi_line()}")
    return {"shapes": rows,
            "lr_change_update_ratio": ratio, "captured_shapes": captured,
            "peak_memory_gb": peak_gb}


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":  # a phase-15 rank
        run_rank(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--role":  # a phase-16 process
        run_role(sys.argv[2], sys.argv[3])
        return
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
    di.launches = 0  # the main path's deformable count starts here
    main_path = run_main_path()
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
    log("phase 13: packed propagation and GT tracks at SAM2 hiera-L: "
        "tokens_grid --video_pack 2, tokens_gdino --expr_pack 3, "
        "tokens_gt [--video_pack 2]")
    packed_paths = run_packed_paths(fa)
    log("phase 14: packed paths small reference")
    packed_small = run_packed_small_reference(fa)
    log("phase 15: distributed: an NCCL group of 1; gloo ranks sharing the "
        "card: cp attention over 2 key shards, the train CLI on a 2 x 2 "
        "(data, model) mesh at SelectionConfig(), the eval CLI over 2 "
        "ranks")
    distributed = run_distributed(fa)
    log("phase 16: selection training at SelectionConfig() (flash route, "
        "dropout) through the train CLI: unbroken, SIGKILLed inside epoch "
        f"{RESUME_KILL_EPOCH} and resumed, bit for bit")
    resume = run_kill_and_resume(fa)
    log("phase 17: the training step from CUDA graphs, eager against "
        "replayed at the train_b1 mix's 12 padded shapes")
    train_graphs = run_train_graphs()

    head = kernel["rows"][0]  # memory cross-attention: most of the time
    # the main path's shape: 3 expressions padded to 4, fp32 (CLI default)
    dhead = next(r for r in deform["rows"] if r["shape"] == "encoder_e4")
    # the training path's largest site in fp32: object2lang_attn
    thead = next(r for r in training_kernels["rows"]
                 if r["shape"] == "object2lang_attn")
    # launches: device records where a path replays CUDA graphs (the
    # propagation steps, the training steps), wrapper calls where it runs
    # eagerly
    by_path = {
        "flash_attn_fwd": {"tokens_grid": main_path["launches"],
                           "gdino": gdino_path["launches"]["flash_attn_fwd"],
                           "train": training["launches"]["flash_attn_fwd"],
                           "prompts_grid":
                           grid_path["launches"]["prompts_grid"],
                           "tokens_grid_from_grid_prompts":
                           grid_path["launches"]["tokens_grid"],
                           "eval": grid_path["launches"]["eval"],
                           "inference": grid_path["launches"]["inference"],
                           **{f"{path}_{run}": packed_paths[path][run][
                               "launches"]
                              for path in ("grid", "gdino", "gt")
                              for run in ("seq", "pack", "seq8")},
                           **{f"cp_rank{r['rank']}": r["cp_launches"]
                              for r in distributed["cp"]["ranks"]},
                           **{f"train_mesh_rank{r['rank']}": r["launches"][
                               "flash_attn_fwd"]
                              for r in distributed["mesh"]["ranks"]},
                           "train_resumed":
                           resume["resumed"]["launches"]["flash_attn_fwd"]},
        "ms_deform_attn_fwd": {
            "tokens_grid": main_path["deform_launches"],
            "gdino": gdino_path["launches"]["ms_deform_attn_fwd"],
            "gdino_swin_b_forward": sum(
                gdino_path["swin_b"]["deform_launches"].values())}}
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
        "launches": training["launches"]["flash_attn_bwd"] + sum(
            r["launches"]["flash_attn_bwd"]
            for r in distributed["mesh"]["ranks"])
        + resume["resumed"]["launches"]["flash_attn_bwd"],
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
        "launches_by_path": {
            "train": training["launches"]["flash_attn_bwd"],
            **{f"train_mesh_rank{r['rank']}": r["launches"]["flash_attn_bwd"]
               for r in distributed["mesh"]["ranks"]},
            "train_resumed": resume["resumed"]["launches"]["flash_attn_bwd"]},
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
                   "packed_paths": packed_paths,
                   "packed_small_reference": packed_small,
                   "distributed": distributed, "kill_and_resume": resume,
                   "train_graphs": train_graphs,
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
