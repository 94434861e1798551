"""Plain reference of grid-prompt track generation for one video.

The frozen SAM2 copy (``reference/sam2``, plain attention) behind the frozen
engine (``reference/engine.py``: greedy same-frame batches, forward and
reverse propagation, IoU dedup), on weights the benchmark's builder draws
anew from the seed and on frames it decodes itself from the video's JPEGs.
Returns every emitted track's full-resolution masklet and object tokens and
the prompts' statuses, and with ``feature_frame`` the image encoder's
stride-16 output of that frame in fp32.

``lower=True`` is the control: TF32 in the fp32 image encoder (the
precision below fp32 with TF32 off), and float8 e4m3 for the bf16 parts
(below bf16): every bf16 linear and convolution takes its weights and its
input rounded through e4m3, and the memory attention its q, k and v.
``encode_frame(..., tf32=True)`` is the encoder's own control: TF32 in the
image encoder and nothing else.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from benchmark.gen import rle
from benchmark.reference import attention


def _frames(frames_dir: str) -> list:
    from PIL import Image
    names = sorted(os.listdir(frames_dir))
    return [np.asarray(Image.open(os.path.join(frames_dir, n)).convert("RGB"))
            for n in names]


def _lower_bf16_layers(model) -> None:
    """Round every bf16 linear and convolution's weights, and its input on
    each call, through float8 e4m3 (the control's precision)."""
    from torch import nn
    for mod in model.modules():
        if not isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            continue
        if mod.weight.dtype != torch.bfloat16:
            continue
        with torch.no_grad():
            mod.weight.copy_(attention.fp8_round(mod.weight))
        mod.register_forward_pre_hook(
            lambda m, args: (attention.fp8_round(args[0]),) + args[1:])


def _predictor(state_dict: dict, size: str, obj_batch: int):
    from benchmark.models.sam2_hiera_l import sam2_config
    from benchmark.reference.sam2.model import SAM2Model
    from benchmark.reference.sam2.video import SAM2VideoPredictor
    with torch.device("meta"):
        model = SAM2Model(sam2_config(size))
    model.load_state_dict(state_dict, assign=True)
    return SAM2VideoPredictor(model.eval(), obj_batch=obj_batch)


def frame_feature(pred, frame: np.ndarray) -> torch.Tensor:
    """The image encoder's stride-16 output (h, w, d) of one frame, in fp32
    on the host, before the predictor stores frame features in bf16."""
    from benchmark.reference.sam2.video import encode_raw
    dev = next(pred.model.parameters()).device
    raw = torch.from_numpy(np.array(frame[None])).to(dev)
    return encode_raw(pred.model, raw, pred.compute_dtype)["pix"][0] \
        .float().cpu()


@torch.no_grad()
def encode_frame(state_dict: dict, size: str, frames_dir: str, frame: int,
                 tf32: bool = False) -> torch.Tensor:
    """``frame_feature`` of one frame of the video; ``tf32`` is the
    encoder's control (TF32 in its matmuls and convolutions)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        pred = _predictor(state_dict, size, 1)
        return frame_feature(pred, _frames(frames_dir)[frame])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _prompts(prompt_path: str):
    from benchmark.reference import engine
    with open(prompt_path) as f:
        info = json.load(f)
    return [engine.PromptMask(prompt_id=p["prompt_id"],
                              frame_idx=int(p["frame_idx"]),
                              segmentation=rle.decode(p["segmentation"]))
            for p in info["prompt_masks"]]


@torch.no_grad()
def run_video(state_dict: dict, size: str, frames_dir: str,
              prompt_path: str, params: dict, lower: bool = False,
              feature_frame: Optional[int] = None) -> dict:
    from benchmark.reference import engine
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, attention.LOWER["fp8_attention"])
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    attention.LOWER["fp8_attention"] = lower
    try:
        pred = _predictor(state_dict, size, int(params["batch_size"]))
        if lower:
            _lower_bf16_layers(pred.model)
        frames = _frames(frames_dir)
        feature = (None if feature_frame is None
                   else frame_feature(pred, frames[feature_frame]))
        state = pred.init_state(frames)
        prompts = _prompts(prompt_path)
        engine.mark_not_used(prompts, int(params["bin_size"]))
        tracks = {}

        def on_track(r):
            tracks[int(r.prompt_id)] = (np.asarray(r.masklet, np.uint8),
                                        np.asarray(r.tokens, np.float32))

        census = engine.generate_tracks(
            pred, state, prompts, n_frames=len(frames),
            batch_size=int(params["batch_size"]),
            miou_thresh=float(params["miou_thresh"]),
            n_max_tracks=int(params["n_max_tracks"]),
            on_track=on_track, scan_all_for_same_frame=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         attention.LOWER["fp8_attention"]) = saved
    return {"tracks": tracks,
            "tracked": sorted(census["tracked_prompt_ids"]),
            "filtered": sorted(census["filtered_prompt_ids"]),
            "feature": feature}
