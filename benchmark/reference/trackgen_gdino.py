"""Plain reference of text-prompted track generation for one video, as
``prompts_gdino`` then ``tokens_gdino --expr_pack 8`` make it, split at
the program's gates: each part starts from the program's own choice at the
gate before it, so a decision that rounding could flip on random weights
is handed over and what follows it is compared.

- ``ground``: GroundingDINO (``reference/gdino``) on one binned frame and
  one chunk of expressions, decoding the queries the program's top-900
  selection kept (``topk``); its own selection scores come back beside.
- ``box_masks``: SAM2's image predictor on the program's boxes: the frame
  encoded (fp32 on bf16-rounded weights, the patch embedding in bf16), the
  box corners as prompts labelled 2 and 3, one mask resized to the frame
  and thresholded at 0, and the stability score of its low-res logits
  (the share above +1 of those above -1).
- ``track``: the program's tracked prompts (past the stability, dedup
  and track-count gates, with the program's masks) propagated forward and
  back by the frozen SAM2 video predictor, prompts of one frame together
  in batches of ``obj_batch``; each track's masklet (logits above 0) and
  per-frame object tokens.
- ``dedup``: one expression's dedup and track-count gates replayed on
  those masklets: the engine's greedy same-frame batches, capped at
  ``n_max_tracks``, walked through the program's choices, each prompt's
  IoU against the tracks before its decision taken as the engine takes it
  (the masklet's frame at the <=960x540 canonical size, the prompt
  nearest-resampled to it).

Weights are drawn anew from the configuration's seed; frames are decoded
from the video's JPEGs here. ``tf32=True`` (grounding, box masks) and
``lower=True`` (tracks, as ``reference/trackgen.py``) are the controls.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from benchmark.reference import attention
from benchmark.reference.trackgen import (_frames, _lower_bf16_layers,
                                          _predictor, frame_feature)


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _tf32_inside(module) -> None:
    """TF32 on while ``module`` runs (the grounding control's parts)."""
    saved = []

    def pre(m, args):
        saved.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def post(m, args, out):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved.pop()

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def normalize(text: str) -> str:
    text = text.lower().strip()
    return text if text.endswith(".") else text + "."


def chunk_rows(texts: list) -> list:
    """A chunk's rows: its normalized texts, padded to a multiple of 4 by
    repeating the first (one text stays one row)."""
    rows = [normalize(t) for t in texts]
    n = len(rows) if len(rows) == 1 else -(-len(rows) // 4) * 4
    return rows + rows[:1] * (n - len(rows))


def grounding_model(state_dict: dict, cfg):
    from benchmark.reference.gdino.model import GroundingDINO
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.eval()


@torch.no_grad()
def ground(state_dict: dict, cfg, frame: np.ndarray, texts: list,
           topk: torch.Tensor, tf32: bool = False) -> dict:
    """pred_logits, pred_boxes, scores and own_topk (on the host) of one
    frame and one chunk of expressions, decoding the ``topk`` queries.
    ``tf32``: the control, TF32 in Swin and the deformable encoder
    layers."""
    from benchmark.reference.gdino.model import canvas
    from benchmark.reference.gdino.text import tokenize_chunk
    model = grounding_model(state_dict, cfg)
    if tf32:
        _tf32_inside(model.model.backbone)
        for layer in model.model.encoder.layers:
            _tf32_inside(layer.deformable_layer)
    dev = next(model.parameters()).device
    ids, tvalid, smask, pos = (
        torch.from_numpy(x).to(dev) for x in tokenize_chunk(
            chunk_rows(texts), cfg.text.vocab_size, cfg.text.pad_token_id,
            min(64, cfg.max_text_len)))
    image, pmask = canvas(frame, cfg, dev)
    with _tf32(False):
        out = model(image, pmask, ids, tvalid, smask, pos, topk=topk)
    return {k: v.cpu() for k, v in out.items()}


def _image_model(state_dict: dict, size: str):
    """SAM2 with the image predictor's precision: fp32 on the bf16-rounded
    weights, the patch embedding in bf16."""
    from benchmark.models.sam2_hiera_l import sam2_config
    from benchmark.reference.sam2.model import SAM2Model
    with torch.device("meta"):
        model = SAM2Model(sam2_config(size))
    model.load_state_dict(state_dict, assign=True)
    model.to(torch.bfloat16).float()
    model.image_encoder.trunk.patch_embed.to(torch.bfloat16)
    return model.eval()


@torch.no_grad()
def box_masks(state_dict: dict, size: str, frames_dir: str,
              boxes: dict, tf32: bool = False) -> dict:
    """{frame: (masks (n, H, W) bool, stability (n,))} of each frame's
    xyxy pixel boxes ``boxes[frame]`` (n, 4); ``tf32`` is the control."""
    from benchmark.reference.mask_ops import resize_bilinear
    from benchmark.reference.sam2.video import encode_raw
    model = _image_model(state_dict, size)
    dev = next(model.parameters()).device
    s = model.cfg.image_size
    frames = _frames(frames_dir)
    out = {}
    with _tf32(tf32):
        for f, bx in sorted(boxes.items()):
            h, w = frames[f].shape[:2]
            feats = encode_raw(model, torch.from_numpy(
                np.array(frames[f][None])).to(dev), torch.bfloat16)
            corners = torch.as_tensor(np.asarray(bx, np.float32).reshape(
                -1, 2, 2) * np.float32([s / w, s / h]), device=dev)
            n = corners.shape[0]
            labels = torch.tensor([[2, 3]] * n, device=dev)
            heads = model.sam_heads(
                *(feats[k].expand(n, *feats[k].shape[1:])
                  for k in ("pix", "s0", "s1")), corners, labels, None,
                False)
            masks = resize_bilinear(heads["high_res_masks"][:, 0].float(),
                                    (h, w)) > 0
            low = heads["low_res_masks"][:, 0].float()
            inter = (low > 1.0).sum((-2, -1)).float()
            union = (low > -1.0).sum((-2, -1)).float()
            stab = torch.where(union > 0, inter / union.clamp_min(1.0),
                               torch.zeros_like(inter))
            out[f] = (masks.cpu().numpy(), stab.cpu().numpy())
    return out


@torch.no_grad()
def track(state_dict: dict, size: str, frames_dir: str, prompts: list,
          obj_batch: int, lower: bool = False,
          feature_frame: Optional[int] = None) -> dict:
    """``tracks``, {prompt id: (masklet, tokens)} of each (id, frame,
    mask) of ``prompts``, and ``feature`` (``reference/trackgen.py``'s
    ``frame_feature``) of ``feature_frame``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, attention.LOWER["fp8_attention"])
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    attention.LOWER["fp8_attention"] = lower
    try:
        pred = _predictor(state_dict, size, obj_batch)
        if lower:
            _lower_bf16_layers(pred.model)
        frames = _frames(frames_dir)
        n = len(frames)
        feature = (None if feature_frame is None
                   else frame_feature(pred, frames[feature_frame]))
        state = pred.init_state(frames)
        tracks = {}
        by_frame: dict = {}
        for pid, f, mask in prompts:
            by_frame.setdefault(int(f), []).append((int(pid), mask))
        for f, items in sorted(by_frame.items()):
            for b0 in range(0, len(items), obj_batch):
                batch = items[b0:b0 + obj_batch]
                pred.reset_state(state)
                masklets = np.zeros((len(batch), n) + frames[0].shape[:2],
                                    np.uint8)
                for j, (_, mask) in enumerate(batch):
                    _, _, logits = pred.add_new_mask(state, f, j, mask)
                    masklets[j, f] = np.asarray(logits[0]) > 0
                for reverse in (False, True):
                    for g, _, logits in pred.propagate_in_video(
                            state, reverse=reverse):
                        masklets[:, g] = np.asarray(logits[:, 0]) > 0
                toks = pred.get_output_tokens(state)
                for j, (pid, _) in enumerate(batch):
                    tracks[pid] = (masklets[j], np.stack(
                        [np.asarray(toks[g][j], np.float32)
                         for g in range(n)]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         attention.LOWER["fp8_attention"]) = saved
    return {"tracks": tracks, "feature": feature}


def _canonical(masklet: np.ndarray, frame: int) -> torch.Tensor:
    """A masklet's frame at the <=960x540 canonical size, as the engine
    dedups against it (bilinear, over 0.5)."""
    from benchmark.reference import mask_ops
    hw = mask_ops.reshape_hw(*masklet.shape[1:])
    return mask_ops.reshape_masklet(masklet[frame:frame + 1], hw)[0]


def _prompt_small(mask: np.ndarray, hw: tuple) -> torch.Tensor:
    """A prompt's mask nearest-resampled to the canonical size."""
    from benchmark.reference import mask_ops
    return torch.from_numpy(mask_ops.resize_nearest_np(
        np.asarray(mask, np.float32), hw))


def dedup(prompts: list, status: dict, masklets: list, n_frames: int, *,
          batch_size: int, n_max_tracks: int,
          miou_thresh: float) -> dict:
    """One expression's dedup and track-count gates, walked through the
    program's choices.

    ``prompts``: (id, frame, mask) of the expression's prompts past the
    stability gate, in the program's order; ``status``: the program's final
    status of each id (1 tracked, 2 filtered, 0 neither); ``masklets``:
    {id: (T, H, W) masklet} dicts of the tracked ids, the first the
    reference's, the others scored at the same moments (the program's own,
    a control's).

    The engine's loop: while fewer than ``n_max_tracks`` are tracked, take
    the first open prompt's frame and the open prompts after it up to the
    first of another frame, at most ``batch_size`` (2 past 200 frames) and
    the cap; track them; after each track, filter the open prompts whose
    IoU with it exceeds ``miou_thresh``. Walked here with the program's
    choice handed over at each prompt: a prompt the program filtered is
    closed when the walk reaches it (had it still been open there, it
    would have joined the batch or ended it: a prompt of another frame
    whose reference IoU is within the threshold ends it), one the program
    tracked joins the batch, and filtering follows the program. Each
    prompt is scored once, by its highest IoU against the tracks before
    its decision: when it is tracked, when the walk closes it, or at the
    end.

    Returns ``items``, (id, the program filtered it, [score for each of
    ``masklets``]) per prompt decided; ``tracked`` and ``filtered``, the
    walk's ids; ``mismatch``, the prompts whose status the walk cannot
    reach from the program's (one tracked past the cap or never reached,
    one left open before the cap)."""
    from benchmark.reference import mask_ops
    limit = 2 if n_frames > 200 else batch_size
    order = [(int(i), int(f), m) for i, f, m in prompts]
    open_ = {i: True for i, _, _ in order}
    emitted, items, tracked, filtered = [], [], [], []
    mismatch = 0
    smalls, cache = {}, {}

    def iou(k, t, i, f, m):
        if (k, t, f) not in cache:
            cache[k, t, f] = _canonical(masklets[k][t], f)
        small = cache[k, t, f]
        if i not in smalls:
            smalls[i] = _prompt_small(m, tuple(small.shape))
        return float(mask_ops.mask_iou(small, smalls[i]))

    def score(i, f, m, sets=None):
        return [max((iou(k, t, i, f, m) for t in emitted), default=0.0)
                for k in (range(len(masklets)) if sets is None else sets)]

    def close(i, f, m, was_filtered):
        open_[i] = False
        items.append((i, was_filtered, score(i, f, m)))

    while len(tracked) < n_max_tracks:
        batch, frame = [], None
        for i, f, m in order:
            if not open_[i]:
                continue
            if status[i] == 2:
                if (frame is not None and f != frame
                        and score(i, f, m, [0])[0] <= miou_thresh):
                    break
                close(i, f, m, True)
                filtered.append(i)
                continue
            if frame is not None and f != frame:
                break
            if status[i] != 1:
                open_[i] = False
                mismatch += 1
                continue
            frame = f
            batch.append(i)
            close(i, f, m, False)
            if (len(batch) >= limit
                    or len(tracked) + len(batch) >= n_max_tracks):
                break
        if not batch:
            break
        tracked += batch
        emitted += batch
    for i, f, m in order:
        if open_[i]:
            if status[i] == 1:
                mismatch += 1
            else:
                close(i, f, m, status[i] == 2)
                if status[i] == 2:
                    filtered.append(i)
    return {"items": items, "tracked": tracked, "filtered": filtered,
            "mismatch": mismatch}
