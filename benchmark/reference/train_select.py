"""Plain reference of the selector's first training steps.

From weights the benchmark's builder draws anew from the seed, the frozen
selector copy (``reference/selection``) takes the same samples the program
took, built here from the corpus files (tracks of ``gt_tracks`` then
``grid_tracks``, each in anno-id order; the label is the best IoU over the
expression's GT objects above the threshold; tracks and frames padded to the
dataset's buckets, so the dropout draws see the same shapes), the frozen
RoBERTa copy's features of each expression (padded to the text cache's 96
words), the same dropout generator, ``total_loss``, the global-norm clip
and ``torch.optim.AdamW``. Returns each step's loss, the clipped gradient
per leaf of step ``window_start`` (counted from 0), and the weights before
that step and after the last.

``lower=True`` is the control: TF32 in matmuls and convolutions, the
precision below the configuration's fp32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TRACK_BUCKETS = (8, 16, 32, 64, 96, 128)
FRAME_BUCKETS = (16, 32, 64, 128, 256, 512)
MAX_WORDS = 96


def _round_up(x: int, buckets) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


def sample(video: dict, expression_id: str, threshold: float) -> dict:
    """One (video, expression) pair, padded as the dataset pads it."""
    expr = video["expressions"][expression_id]
    toks = np.stack([np.load(t["token_path"]) for t in video["tracks"]])
    ious = []
    for t in video["tracks"]:
        best = 0.0
        for a in expr["anno_id"]:
            best = max(best, t["iou"].get(str(a), 0.0))
        ious.append(best)
    n, t, d = toks.shape
    nb, tb = _round_up(n, TRACK_BUCKETS), _round_up(t, FRAME_BUCKETS)
    tokens = np.zeros((1, nb, tb, d), np.float32)
    tokens[0, :n, :t] = toks
    track_mask = np.zeros((1, nb), bool)
    track_mask[0, :n] = True
    labels = np.zeros((1, nb), np.float32)
    labels[0, :n] = np.asarray(ious, np.float32) > threshold
    return {"object_tokens": tokens, "track_mask": track_mask,
            "frame_lengths": np.asarray([t], np.int64), "labels": labels,
            "expression": expr["exp"]}


def _text(encoder, text: str, device):
    input_ids, mask = encoder.tokenizer([text], max_len=MAX_WORDS)
    ids = torch.from_numpy(np.asarray(input_ids)).to(device)
    mask = torch.from_numpy(np.asarray(mask)).to(device)
    with torch.no_grad():
        hidden = encoder.model(ids, mask)
    pooled = encoder_mean_pool(hidden, mask)[:, None, :]
    w = hidden.shape[1]
    hidden = F.pad(hidden, (0, 0, 0, MAX_WORDS - w))
    mask = F.pad(mask, (0, MAX_WORDS - w))
    return hidden, mask.bool(), pooled


def encoder_mean_pool(hidden, mask):
    from benchmark.reference.selection.text import mean_pool
    return mean_pool(hidden, mask)


def run_steps(selection_sd: dict, roberta_sd: dict, config: dict,
              samples: list, generator_seed: int, window_start: int,
              device="cuda", size: str = "large",
              lower: bool = False) -> dict:
    from benchmark.models.sola_selection_mevis import (roberta_config,
                                                       selection_config)
    from benchmark.reference.selection import loss as loss_lib
    from benchmark.reference.selection.model import SelectionModel
    from benchmark.reference.selection.text import (RobertaEncoder,
                                                    TextEncoder)
    tc = config["train"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    try:
        with torch.device("meta"):
            model = SelectionModel(selection_config(config, size))
            roberta = RobertaEncoder(roberta_config(size))
        model.load_state_dict(selection_sd, assign=True)
        roberta.load_state_dict(roberta_sd, assign=True)
        text = TextEncoder(roberta)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        params = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.AdamW(params, lr=float(tc["lr"]),
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        gen = torch.Generator().manual_seed(int(generator_seed))
        losses, grads_at, start = [], None, None
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        benchmark=False, allow_tf32=lower):
            for i, s in enumerate(samples):
                if i == window_start:
                    start = {n: p.detach().clone()
                             for n, p in zip(names, params)}
                lang, lang_mask, pos = _text(text, s["expression"], device)
                dev = {k: torch.from_numpy(s[k]).to(device) for k in (
                    "object_tokens", "track_mask", "frame_lengths",
                    "labels")}
                model.train()
                opt.zero_grad(set_to_none=True)
                logits, score_tokens = model(
                    dev["object_tokens"], lang,
                    track_mask=dev["track_mask"],
                    frame_lengths=dev["frame_lengths"], lang_mask=lang_mask,
                    deterministic=False, generator=gen)
                loss, _ = loss_lib.total_loss(
                    logits, score_tokens, dev["labels"], pos,
                    model.get_negative_tokens(score_tokens.shape[0]),
                    temperature=float(tc["temperature"]),
                    positive_weight=float(tc["positive_weight"]),
                    alignment_weight=float(tc["alignment_weight"]),
                    track_mask=dev["track_mask"])
                loss.backward()
                grads = [p.grad for p in params]
                norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)).float())
                clip = float(tc["grad_clip_norm"])
                if clip > 0:
                    torch._foreach_mul_(grads, torch.where(
                        norm < clip, 1.0, clip / norm))
                if i == window_start:
                    grads_at = {n: g.detach().clone()
                                for n, g in zip(names, grads)}
                opt.step()
                losses.append(float(loss.detach()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"losses": losses, "grads": grads_at, "start": start,
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}
