"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero, and no result line prints):

1. Environment: the card's name and power limit, torch and CUDA versions,
   both TF32 flags (set explicitly), and the kernel build time.
2. Kernels: builds every CUDA kernel of the tokens_grid path from the
   sources in this checkout and holds each against its plain PyTorch
   version on the card at the shapes and types the main path gives it
   (bf16 in memory attention, fp32 at Hiera's global blocks, whose shape
   is checked in bf16 too), and shows the limits reject a wrong key tile;
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

The second-to-last line is a JSON object listing every ported kernel; the
line before it is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# H100 SXM datasheet peaks for the inputs' type: bf16 on the tensor cores,
# float32 outside them (the kernel's fp32 path uses 3xTF32 on the tensor
# cores, which could reach 495 / 3 = 165 TFLOP/s)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12          # HBM3
# Kernel against its plain version, per shape: the largest error within one
# ulp of the largest |out| in the output's type (bf16 rounds the output and
# P before PV; fp32 allows 128 fp32 ulps for 3xTF32 and the summation
# order), and the RMS error a small share of the output's RMS, so that a
# few mishandled keys (0.1% of a row's keys move its output by about 3% of
# its RMS) fail even where the largest error would hide them.
OUT_MAX_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}
OUT_RMS_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-4               # fp32 lse near log(Lk) ~ 10: ~100 fp32 ulps
T_FRAMES, H_VID, W_VID = 12, 480, 854


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    return cases


def attention_work(b, h, lq, lk, d, mask, itemsize):
    """(flops, bytes) the function needs on these inputs: the keys that
    take part (masked keys add exactly zero, except on a fully masked row,
    which averages all keys), each input read once, each output written
    once."""
    if mask is None:
        keys = b * lk
    else:
        valid = mask.sum(dim=1)
        keys = int(torch.where(valid > 0, valid,
                               torch.full_like(valid, lk)).sum())
    flops = 4.0 * h * lq * d * keys
    nbytes = (itemsize * (2 * b * h * lq * d + 2 * b * h * lk * d)
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
# phase 3: the main path
# ---------------------------------------------------------------------------

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
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    ref_pred = SAM2VideoPredictor(
        build_sam2(cfg=predictor.cfg, seed=seed, device="cuda"),
        feature_dtype=torch.float32, compute_dtype=torch.float32)
    raw = torch.from_numpy(np.stack(frames)).cuda()
    ours, ref = predictor._encode_raw(raw), ref_pred._encode_raw(raw)
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
    from sola_torch.trackgen.sam2 import hiera, memory
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
        model = build_sam2(cfg=SAM2Config.tiny_test(s), seed=3,
                           device=device)
        for m in model.modules():
            if isinstance(m, hiera.MultiScaleAttention):
                m.fused_min_tokens = 1
            if isinstance(m, memory.RoPEAttention):
                m.fused_min_keys = 1
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
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
    fa._library()
    build = kernel_build.build_info["flash_attn_fwd"]
    log(f"kernel build: flash_attn_fwd in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build['seconds']:.2f} s)")
    ptxas = []
    for ln in build["log"].splitlines():
        if "Compiling entry function" in ln:  # names the instance below
            ptxas.append("flash_fwd_kernel<" + (
                "bf16" if "bfloat16" in ln else "float") + ">:")
        elif "registers" in ln or "spill" in ln:
            ptxas.append(ln.strip())
    for ln in ptxas:
        log(f"  ptxas: {ln}")

    gen = torch.Generator().manual_seed(0)
    log("phase 2: flash kernel vs its plain version")
    kernel = check_flash_kernel(fa, gen)
    log("phase 3: tokens_grid main path at SAM2 hiera-L")
    main_path = run_main_path(fa)
    log("phase 4: small reference")
    small = run_small_reference(fa)

    head = kernel["rows"][0]  # memory cross-attention: most of the time
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "sola_torch/csrc/flash_attn_fwd.cu",
        "replaces": "sola_tpu/ops/flash_attention.py:64",
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel["rows"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": head["shape"], "shapes": kernel["rows"]}]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "kernels": kernels,
                   "main_path": main_path, "small_reference": small,
                   "ptxas": ptxas}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
