"""Training loop of the selection model.

Counterpart of ``sola_tpu/train/loop.py`` (the reference's train.py:23-246):
frozen text encoder (each expression encoded once), labels = (metric >
positive_threshold), weighted BCE + 0.3 x alignment loss, AdamW with
global-norm clipping at 1.0, a validation pass per epoch with TP/FP/FN/TN,
``log.txt`` epoch lines in the same format, ReduceLROnPlateau on the
validation loss, and a checkpoint every epoch (``epoch_N.pth`` plus a
resume file).

The steps run eagerly on the device. Dropout (the motion encoder's and, in
the model's attention, the kernels' counter hash) draws from one
``torch.Generator`` per epoch, seeded ``42 + epoch``, and epoch N's
shuffle is seeded ``seed + N`` however many epochs the process ran before,
so a run resumed from epoch N replays what the uninterrupted run did. On
the card that holds bit for bit only with deterministic cuDNN algorithms
(the motion encoder's conv backward may otherwise sum in another order from
run to run), so ``train`` sets them for its run and restores the caller's
flags (``deterministic_cudnn``); the port's attention kernels sum in a
fixed order.
``train.steps_per_dispatch`` is accepted and its steps run one by one (the
JAX package's scan gives the same numbers).

In a process group of several ranks (``parallel/distributed.initialize``)
``train`` runs on a (data, model) mesh of processes, the counterpart of
``make_mesh_context`` (``train.n_model`` ranks split the wide layers,
``parallel/tp.py``): every rank builds the same padded global batch and
keeps its data index's rows (``mesh.shard_batch``), losses divide by the
global batch's valid tracks, gradients are summed over the data group, the
clip takes the global norm, validation losses and counts are summed over
the data group, and rank 0 alone writes ``log.txt`` and the checkpoints
(gathered into single-device names). Each split keeps one token cache and
each rank takes its rows from it. A rank's dropout generator
(``epoch_generator``) adds its data index to the seed: the ranks of a
model group draw alike, so their replicated activations stay equal, and
data ranks draw apart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
from tqdm import tqdm

from sola_torch.config import finalize_train_configs
from sola_torch.data.dataset import get_loader_dict
from sola_torch.device import resolve_device
from sola_torch.models.selection import (SelectionConfig, SelectionModel,
                                         init_weights)
from sola_torch.models.text import CachingTextEncoder, build_text_encoder
from sola_torch.parallel import tp
from sola_torch.parallel.distributed import process_count, rank_device
from sola_torch.parallel.mesh import (make_mesh, reduce_sum, shard_batch,
                                      sum_gradients)
from sola_torch.train import loss as loss_lib
from sola_torch.train import state as state_lib
from sola_torch.train.schedule import ReduceLROnPlateau
from sola_torch.utils import profiling


@profiling.spanned("train.prepare")
def prepare_batch(batch: dict, text_encoder, train_cfg: Optional[dict],
                  device, token_cache=None) -> dict:
    """A collated batch's tensors on ``device``: object tokens (from the
    device cache when given; bfloat16 on the wire with
    ``bf16_token_transfer``), masks, frame lengths, the language tensors of
    the frozen encoder, and the thresholded labels."""
    lang_tokens, lang_mask, pos_tokens = text_encoder.encode_batch(
        batch["expression"])
    if token_cache is not None:
        object_tokens = token_cache.batch_tokens(batch)
    else:
        tokens = batch.get("object_tokens")
        if tokens is None:
            tokens = np.stack(batch["object_token_rows"], axis=0)
        tok_dtype = (torch.bfloat16 if train_cfg
                     and train_cfg.get("bf16_token_transfer")
                     else torch.float32)
        object_tokens = torch.from_numpy(tokens).to(device, tok_dtype)
    out = {
        "object_tokens": object_tokens,
        "track_mask": torch.from_numpy(batch["track_mask"]).to(device),
        "frame_lengths": torch.from_numpy(
            batch["frame_lengths"].astype(np.int64)).to(device),
        "lang_tokens": lang_tokens.to(device),
        "lang_mask": lang_mask.to(device),
        "pos_tokens": pos_tokens.to(device),
    }
    if batch.get("labels") is not None and train_cfg is not None:
        metric = train_cfg["positive_metric"]
        thresh = train_cfg["positive_threshold"]
        out["labels"] = torch.from_numpy(
            (batch["labels"][metric] > thresh).astype(np.float32)).to(device)
    return out


def _forward(model: SelectionModel, batch: dict,
             generator: Optional[torch.Generator] = None):
    """(score logits, score tokens) of one batch; a training forward when
    ``generator`` is given."""
    return model(
        batch["object_tokens"], batch["lang_tokens"],
        track_mask=batch["track_mask"], frame_lengths=batch["frame_lengths"],
        lang_mask=batch["lang_mask"], deterministic=generator is None,
        generator=generator)


def _losses(model: SelectionModel, batch: dict, train_cfg: dict,
            generator: Optional[torch.Generator] = None, group=None):
    """(score logits, loss, parts) of one batch; a training forward when
    ``generator`` is given; means over a data-parallel ``group``'s valid
    tracks."""
    score_logits, score_tokens = _forward(model, batch, generator)
    loss, parts = loss_lib.total_loss(
        score_logits, score_tokens, batch["labels"], batch["pos_tokens"],
        model.get_negative_tokens(score_tokens.shape[0]),
        temperature=float(train_cfg["temperature"]),
        positive_weight=float(train_cfg["positive_weight"]),
        alignment_weight=float(train_cfg["alignment_weight"]),
        track_mask=batch["track_mask"], group=group)
    return score_logits, loss, parts


@profiling.spanned("train.step")
def train_step(model: SelectionModel, optimizer: state_lib.Optimizer,
               batch: dict, train_cfg: dict,
               generator: torch.Generator, mesh=None) -> dict:
    """One optimizer step: forward with dropout, ``total_loss``, backward,
    clip, AdamW. Returns the loss parts and the gradient norm as device
    scalars (no host sync). On a ``mesh`` the parts are this rank's shares
    of the global batch's, and the gradients are summed over the data
    group before the clip."""
    data_group = mesh.data_group if mesh is not None else None
    model.train()
    optimizer.zero_grad()
    with profiling.span("train.forward"):
        _, loss, parts = _losses(model, batch, train_cfg, generator,
                                 data_group)
    with profiling.span("train.backward"):
        loss.backward()
        sum_gradients(optimizer.params, data_group)
    with profiling.span("train.optimizer"):
        norm = optimizer.step()
    return {**{k: v.detach() for k, v in parts.items()},
            "total_grad_norm": norm}


@torch.no_grad()
def eval_step(model: SelectionModel, batch: dict, train_cfg: dict,
              pred_threshold: float, group=None) -> dict:
    """Scores and predictions, and for a batch with labels the loss parts
    and the confusion counts over valid tracks (device tensors); with a
    data-parallel ``group`` the parts are this rank's shares of the
    group's."""
    model.eval()
    labels = batch.get("labels")
    if labels is None:
        score_logits, _ = _forward(model, batch)
        out = {}
    else:
        score_logits, _, parts = _losses(model, batch, train_cfg,
                                         group=group)
        out = dict(parts)
    scores = torch.sigmoid(score_logits)
    preds = (scores > pred_threshold).float()
    out.update(pred_score=scores, pred=preds)
    if labels is not None:
        m = batch["track_mask"]
        out.update(tp=((preds == 1) & (labels == 1) & m).sum(),
                   fp=((preds == 1) & (labels == 0) & m).sum(),
                   fn=((preds == 0) & (labels == 1) & m).sum(),
                   tn=((preds == 0) & (labels == 0) & m).sum())
    return out


def build_model(cfg: SelectionConfig, device, seed: int = 42,
                init_weights_path: Optional[str] = None,
                group=None) -> SelectionModel:
    """A SelectionModel on ``device``: seeded random weights, or a
    reference-format checkpoint (``.pth`` or ``.npz``); with a model
    ``group``, this rank's shard of those weights."""
    model = SelectionModel(cfg)
    if init_weights_path:
        model.load_state_dict(state_lib.load_torch_weights(init_weights_path))
    else:
        init_weights(model, seed)
    if tp.group_size(group) > 1:
        full = model.state_dict()
        model = SelectionModel(cfg, group)
        model.load_state_dict(tp.shard_state_dict(
            full, tp.group_size(group), tp.group_rank(group)))
    return model.to(device)


def epoch_generator(epoch: int, mesh=None) -> torch.Generator:
    """Epoch ``epoch``'s dropout generator: seeded ``42 + epoch``, plus
    2^16 times the data index on a mesh (the CPU generator keeps 32 bits
    of a seed), so the ranks of a model group draw alike and data ranks
    draw apart."""
    data_index = mesh.data_index if mesh is not None else 0
    return torch.Generator().manual_seed(42 + epoch + (data_index << 16))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN takes deterministic algorithms only, chosen by heuristic and
    not by timing, until the block ends; then the caller's flags return."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def train(configs: dict, max_steps_per_epoch: Optional[int] = None,
          text_encoder=None, log_fn=print, resume: bool = False,
          device="cuda") -> SelectionModel:
    """Full training run (train.py:23-246) on ``device`` (CUDA by default;
    it raises without CUDA unless ``device="cpu"``), with deterministic
    cuDNN algorithms, so two equal runs, or a resumed run and the one it
    continues, end bit for bit equal on the card as on the CPU.

    ``resume=True`` restores the newest ``epoch_N`` checkpoint of the output
    dir (weights, optimizer, schedule) and continues. Returns the model
    (on a mesh, this rank's shard). In a process group every rank calls
    it, and ``device="cuda"`` is the rank's own card."""
    with deterministic_cudnn():
        return _train(configs, max_steps_per_epoch, text_encoder, log_fn,
                      resume, device)


def _train(configs: dict, max_steps_per_epoch: Optional[int],
           text_encoder, log_fn, resume: bool, device) -> SelectionModel:
    device = resolve_device(rank_device(device))
    configs = finalize_train_configs(configs)
    out_dir = configs["results"]["output_dir"]
    train_cfg = configs["train"]
    mesh = None
    if process_count() > 1:
        mesh = make_mesh(n_model=int(train_cfg.get("n_model", 1)))
        if mesh.rank != 0:
            log_fn = lambda *a: None  # noqa: E731
        log_fn(f"mesh training over ({mesh.n_data}, {mesh.n_model}) "
               f"(data, model) processes")
    model_group = mesh.model_group if mesh is not None else None
    data_group = mesh.data_group if mesh is not None else None
    cfg = SelectionConfig.from_dict(configs["model"])
    init_path = train_cfg.get("init_weights")
    model = build_model(cfg, device, init_weights_path=init_path,
                        group=model_group)
    if init_path:
        log_fn(f"initialized weights from {init_path}")
    text_encoder = text_encoder or build_text_encoder(configs["model"],
                                                      device)
    if not isinstance(text_encoder, CachingTextEncoder):
        text_encoder = CachingTextEncoder(text_encoder)

    dims = tp.split_dims(dict(model.named_parameters()))
    optimizer = state_lib.make_optimizer(
        model.parameters(), lr=float(train_cfg["lr"]),
        grad_clip_norm=float(train_cfg.get("grad_clip_norm", 0.0)),
        split=[dims[n] is not None for n, _ in model.named_parameters()],
        group=model_group)
    schedule = ReduceLROnPlateau(
        lr=float(train_cfg["lr"]),
        factor=float(train_cfg.get("lr_factor", 0.5)),
        patience=int(train_cfg.get("lr_patience", 5)))
    start_epoch, step = 0, 0
    if resume:
        latest = state_lib.latest_checkpoint_epoch(out_dir)
        if latest is not None:
            start_epoch, step, sched_state = state_lib.restore_checkpoint(
                out_dir, latest, model, optimizer, mesh)
            if sched_state:
                schedule.load_state_dict(sched_state)
            state_lib.set_learning_rate(optimizer, schedule.lr)
            log_fn(f"resumed from epoch {start_epoch}")

    loader_dict = get_loader_dict(configs["dataset"])
    # one cache per split: the JAX package shares one between them, and a
    # valid video whose id is also a train video's then gets the train
    # video's tokens
    token_caches = {"train": None, "valid": None}
    if bool(train_cfg.get("device_token_cache", True)):
        from sola_torch.data.device_cache import make_token_cache
        for split in token_caches:
            token_caches[split] = make_token_cache(
                configs["dataset"].get(split),
                dtype=torch.bfloat16 if train_cfg.get("bf16_token_transfer")
                else torch.float32, device=device)
            # batches then carry per-sample padded rows only
            loader_dict[split].materialize_tokens = False
    pred_threshold = float(train_cfg.get("pred_threshold", 0.5))
    n_epochs = int(train_cfg["n_epochs"])

    for epoch in range(start_epoch, n_epochs):
        t0 = time.time()
        generator = epoch_generator(epoch, mesh)
        loader_dict["train"].set_epoch(epoch)
        # per-step losses stay on the device until the epoch's end
        train_losses: dict = {"total": [], "bce": [], "alignment": []}
        for step_idx, raw in enumerate(tqdm(
                loader_dict["train"], desc=f"EPOCH [{epoch + 1} / {n_epochs}]",
                disable=None)):
            if max_steps_per_epoch and step_idx >= max_steps_per_epoch:
                break
            if mesh is not None:
                raw = shard_batch(mesh, raw)
            batch = prepare_batch(raw, text_encoder, train_cfg, device,
                                  token_caches["train"])
            metrics = train_step(model, optimizer, batch, train_cfg,
                                 generator, mesh)
            step += 1
            for k in train_losses:
                train_losses[k].append(metrics[k])
        if data_group is not None and train_losses["total"]:
            # this rank's shares of each step's parts, summed once
            parts = reduce_sum(torch.stack(
                [torch.stack(v) for v in train_losses.values()]), data_group)
            train_losses = dict(zip(train_losses, parts.unbind()))
        train_losses = {k: [float(x) for x in v]
                        for k, v in train_losses.items()}

        # validation pass (train.py:147-232)
        ev = {"total": [], "bce": [], "alignment": [],
              "tp": 0, "fp": 0, "fn": 0, "tn": 0}
        for step_idx, raw in enumerate(loader_dict["valid"]):
            if max_steps_per_epoch and step_idx >= max_steps_per_epoch:
                break
            if mesh is not None:
                raw = shard_batch(mesh, raw)
            batch = prepare_batch(raw, text_encoder, train_cfg, device,
                                  token_caches["valid"])
            metrics = eval_step(model, batch, train_cfg, pred_threshold,
                                data_group)
            if data_group is not None:  # float64: the counts stay exact
                keys = ("total", "bce", "alignment", "tp", "fp", "fn", "tn")
                summed = reduce_sum(torch.stack(
                    [metrics[k].double() for k in keys]), data_group)
                metrics = dict(zip(keys, summed.tolist()))
            for k in ("total", "bce", "alignment"):
                ev[k].append(float(metrics[k]))
            for k in ("tp", "fp", "fn", "tn"):
                ev[k] += int(metrics[k])

        denom = ev["tp"] + ev["tn"] + ev["fp"] + ev["fn"]
        acc = (ev["tp"] + ev["tn"]) / max(denom, 1)
        precision = ev["tp"] / (ev["tp"] + ev["fp"] + 1e-6)
        recall = ev["tp"] / (ev["tp"] + ev["fn"] + 1e-6)
        f1 = 2 * precision * recall / (precision + recall + 1e-6)
        valid_loss = float(np.mean(ev["total"])) if ev["total"] else 0.0

        new_lr = schedule.step(valid_loss)
        state_lib.set_learning_rate(optimizer, new_lr)
        state_lib.save_checkpoint(out_dir, epoch + 1, model, optimizer,
                                  schedule.state_dict(), step, mesh)
        if mesh is not None and mesh.rank != 0:
            continue
        # log.txt epoch block (train.py:235-240 format)
        with open(os.path.join(out_dir, "log.txt"), "a") as f:
            e = epoch + 1
            f.write(f"EPOCH {e:03d}\n")
            f.write(
                f"TRAIN EPOCH {e:03d} | LOSS: {np.mean(train_losses['total']):.4f} "
                f"({np.std(train_losses['total']):.4f}) | "
                f"BCE: {np.mean(train_losses['bce']):.4f} | "
                f"ALIGNMENT: {np.mean(train_losses['alignment']):.4f}\n")
            f.write(
                f"VALID EPOCH {e:03d} | LOSS: {valid_loss:.4f} "
                f"({np.std(ev['total']) if ev['total'] else 0.0:.4f}) | "
                f"BCE: {np.mean(ev['bce']) if ev['bce'] else 0.0:.4f} | "
                f"ALIGNMENT: {np.mean(ev['alignment']) if ev['alignment'] else 0.0:.4f}\n")
            f.write(
                f"VALID EPOCH {e:03d} | ACC: {acc:.4f} | F1: {f1:.4f} | "
                f"PRECISION: {precision:.4f} | RECALL: {recall:.4f}\n")
            f.write(
                f"VALID EPOCH {e:03d} | TP: {ev['tp']} | FP: {ev['fp']} | "
                f"FN: {ev['fn']} | TN: {ev['tn']}\n")
        log_fn(f"epoch {epoch + 1} done in {time.time() - t0:.1f}s | "
               f"train loss {np.mean(train_losses['total']):.4f} | "
               f"valid loss {valid_loss:.4f} | lr {new_lr:.2e}")
    return model
