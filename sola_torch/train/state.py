"""Optimizer, gradient clipping and checkpoints of selection training.

Counterpart of ``sola_tpu/train/state.py``. The optimizer matches the
reference and the JAX package: AdamW (betas (0.9, 0.999), eps 1e-8,
weight decay 0.01; train.py:44-49) after global-norm clipping at
``grad_clip_norm``, which scales the gradients only when their norm is at
or above the threshold, as ``optax.clip_by_global_norm`` does
(``g / norm * max_norm``). On a CUDA device AdamW is capturable, its step
counts and learning rate device tensors, so a CUDA graph of the update
(``train/graphs.py``) and the eager update run the same kernels, and a
new learning rate reaches the graph; gradients are zeroed in place, never
freed, so the buffers a graph writes stay the parameters' ``grad``.

Checkpoints: orbax is JAX's, so each epoch writes ``epoch_N.pth``, the
model's reference-named ``state_dict`` (what the reference saves,
train.py:246, and what ``sola_tpu.train.state.load_torch_weights`` and the
JAX eval CLI read), and ``epoch_N.resume.pth`` beside it with the
optimizer, the plateau schedule, the step and the epoch. Each file is
written to a temporary name in the same directory, flushed to disk and
renamed onto its own, the weights first and the resume file last: a resume
file stands only beside complete weights, and a process killed while it
writes leaves nothing that ``latest_checkpoint_epoch`` would take (orbax
commits the JAX package's checkpoint directories the same way).

On a (data, model) mesh (``parallel/mesh.py``) the clip takes the global
norm over the model group's shards, each element once; checkpoints are
gathered into the single-device names and written by rank 0 alone, and a
resume shards the weights and AdamW's moments alike
(``parallel/tp.py``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sola_torch.parallel import tp


class Optimizer:
    """AdamW with global-norm clipping before each step.

    ``split``: one flag per parameter, True where a model ``group`` splits
    it; the squares of split gradients are summed over the group and those
    of replicated ones, equal on every rank, counted once."""

    def __init__(self, params, lr: float, grad_clip_norm: float = 1.0,
                 weight_decay: float = 0.01, split=None, group=None):
        params = list(params)
        keep = [p.requires_grad for p in params]
        self.params = [p for p, k in zip(params, keep) if k]
        self.group = group
        self.split = (torch.tensor([s for s, k in zip(split, keep) if k])
                      if group is not None else None)
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.capturable = bool(self.params) and self.params[0].is_cuda
        # the learning rate every update reads: one device tensor, written
        # in place, on CUDA; a float elsewhere
        self.lr = (torch.tensor(float(lr), device=self.params[0].device)
                   if self.capturable else float(lr))
        self.adamw = torch.optim.AdamW(self.params, lr=self.lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay,
                                       capturable=self.capturable)
        self.set_lr(self.lr)
        # eager capturable updates are meant: they equal the replayed ones
        self.adamw._warned_capturable_if_run_uncaptured = True
        # the training step's CUDA graphs (train/graphs.py), made by the
        # first step that runs from them
        self.graphs = None

    def clip(self) -> torch.Tensor:
        """Scale the gradients by max_norm / norm when norm >= max_norm;
        returns the norm before clipping (on the gradients' device, no
        host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norms = torch.stack(torch._foreach_norm(grads)).float()
        if self.group is None:
            norm = torch.linalg.vector_norm(norms)
        else:  # a mesh's ranks hold every parameter's gradient
            sq = norms.square()
            split = self.split.to(sq.device)
            shards = torch.where(split, sq, 0.0).sum()
            dist.all_reduce(shards, group=self.group)
            norm = torch.sqrt(shards + torch.where(split, 0.0, sq).sum())
        if self.grad_clip_norm > 0:
            torch._foreach_mul_(grads, torch.where(
                norm < self.grad_clip_norm, 1.0, self.grad_clip_norm / norm))
        return norm

    def step(self) -> torch.Tensor:
        norm = self.clip()
        self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        """Zero the gradients in place (a graph's buffers stay bound)."""
        self.adamw.zero_grad(set_to_none=False)

    def set_lr(self, lr: float) -> None:
        """The learning rate of the next update, eager or replayed."""
        if self.capturable:
            if lr is not self.lr:
                self.lr.fill_(float(lr))
        else:
            self.lr = float(lr)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Load a state dict written capturable or not, with a float or a
        tensor learning rate: step counts move to where this optimizer
        keeps them, and the learning rate into ``self.lr``. Graphs of the
        old state are dropped."""
        state = dict(state)
        state["param_groups"] = [
            {**g, "capturable": self.capturable, "lr": float(g["lr"])}
            for g in state["param_groups"]]
        self.adamw.load_state_dict(state)
        self.set_lr(state["param_groups"][0]["lr"])
        self.graphs = None


def make_optimizer(params, lr: float, grad_clip_norm: float = 1.0,
                   weight_decay: float = 0.01, split=None,
                   group=None) -> Optimizer:
    return Optimizer(params, lr, grad_clip_norm, weight_decay, split, group)


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    """Write the plateau schedule's LR into the optimizer (and so into
    its captured update)."""
    optimizer.set_lr(lr)


def grad_norm_dict(model: nn.Module) -> dict:
    """Gradient L2 norms by submodule (module/module.py:164-199 grouping):
    short_motion_encoder, scmola_layer_i (alignment layer i),
    negative_token, and the total. Tensors on the gradients' device."""
    sq: dict = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        s = p.grad.float().square().sum()
        top = name.split(".")
        if top[0] == "object_lang_align_layers":
            key = f"scmola_layer_{top[1]}"
        else:
            key = top[0]
        sq[key] = sq.get(key, 0.0) + s
        sq["total_grad_norm"] = sq.get("total_grad_norm", 0.0) + s
    return {k: torch.sqrt(torch.as_tensor(v)) for k, v in sq.items()}


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def checkpoint_paths(ckpt_dir: str, epoch: int) -> tuple:
    """(model weights ``epoch_N.pth``, resume state ``epoch_N.resume.pth``)."""
    base = os.path.join(ckpt_dir, f"epoch_{epoch}")
    return base + ".pth", base + ".resume.pth"


def _param_names(model: nn.Module) -> list:
    """Parameter names in the optimizer's index order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def save_atomic(obj, path: str) -> None:
    """``torch.save`` to a temporary file beside ``path`` (a dot name that
    no checkpoint name matches), flushed to disk, then renamed onto
    ``path``: a reader sees the old file or the whole new one, never part
    of it. A save that raises removes its temporary file; a killed one
    leaves it behind, unread."""
    directory, name = os.path.split(os.path.abspath(path))
    tmp = os.path.join(directory, f".{name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    dir_fd = os.open(directory, os.O_RDONLY)
    try:  # the rename itself survives a crash of the machine
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def save_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                    optimizer: Optimizer, schedule_state: Optional[dict],
                    step: int, mesh=None) -> str:
    """Write ``epoch_N.pth`` and then its resume file, each atomically
    (``save_atomic``). On a mesh every rank calls: the ranks of data index
    0 gather the shards, rank 0 writes, and no rank returns before the
    files are complete."""
    weights, resume = checkpoint_paths(ckpt_dir, epoch)
    state, opt_state = model.state_dict(), optimizer.state_dict()
    if mesh is not None and mesh.data_index == 0:
        dims = tp.split_dims(state)
        opt_state = tp.gather_optimizer_state(
            opt_state, _param_names(model), dims, mesh.model_group)
        state = tp.gather_state_dict(state, mesh.model_group)
    if mesh is None or mesh.rank == 0:
        save_atomic({k: v.detach().cpu() for k, v in state.items()}, weights)
        save_atomic({"optimizer": opt_state,
                     "schedule": schedule_state or {}, "step": int(step),
                     "epoch": epoch}, resume)
    if mesh is not None:
        dist.barrier()
    return weights


def latest_checkpoint_epoch(ckpt_dir: str) -> Optional[int]:
    """Highest N with both ``epoch_N.pth`` and its resume file, or None.
    The temporary file of a save that did not finish matches neither."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = set(os.listdir(ckpt_dir))
    epochs = [int(m.group(1)) for name in names
              if (m := re.fullmatch(r"epoch_(\d+)\.pth", name))
              and f"epoch_{m.group(1)}.resume.pth" in names]
    return max(epochs) if epochs else None


def restore_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                       optimizer: Optimizer, mesh=None) -> tuple:
    """Load ``epoch_N`` into ``model`` and ``optimizer`` (on a mesh: this
    rank's shards of both); returns (epoch, step, schedule state)."""
    weights, resume = checkpoint_paths(ckpt_dir, epoch)
    device = next(model.parameters()).device
    full = torch.load(weights, map_location=device, weights_only=True)
    # on the host: AdamW's step counts stay there, as in the run that
    # wrote them, and load_state_dict moves the moments to the parameters
    state = torch.load(resume, map_location="cpu", weights_only=True)
    opt_state = state["optimizer"]
    if mesh is not None and mesh.n_model > 1:
        dims = tp.split_dims(full)
        opt_state = tp.shard_optimizer_state(
            opt_state, _param_names(model), dims, mesh.n_model,
            mesh.model_index)
        full = tp.shard_state_dict(full, mesh.n_model, mesh.model_index)
    model.load_state_dict(full)
    optimizer.load_state_dict(opt_state)
    return state["epoch"], state["step"], state["schedule"]


def load_torch_weights(path: str) -> dict:
    """A reference-named state dict from a ``.pth`` (torch) or ``.npz``
    (the JAX package's ``export_torch_npz``), as CPU float32 tensors."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(np.asarray(data[k], np.float32))
                    for k in data.files}
    return {k: v.float() for k, v in torch.load(
        path, map_location="cpu", weights_only=True).items()}
