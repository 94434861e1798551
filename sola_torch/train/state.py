"""Optimizer, gradient clipping and checkpoints of selection training.

Counterpart of ``sola_tpu/train/state.py``. The optimizer matches the
reference and the JAX package: AdamW (betas (0.9, 0.999), eps 1e-8,
weight decay 0.01; train.py:44-49) after global-norm clipping at
``grad_clip_norm``, which scales the gradients only when their norm is at
or above the threshold, as ``optax.clip_by_global_norm`` does
(``g / norm * max_norm``).

Checkpoints: orbax is JAX's, so each epoch writes ``epoch_N.pth``, the
model's reference-named ``state_dict`` (what the reference saves,
train.py:246, and what ``sola_tpu.train.state.load_torch_weights`` and the
JAX eval CLI read), and ``epoch_N.resume.pth`` beside it with the
optimizer, the plateau schedule, the step and the epoch.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn


class Optimizer:
    """AdamW with global-norm clipping before each step."""

    def __init__(self, params, lr: float, grad_clip_norm: float = 1.0,
                 weight_decay: float = 0.01):
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def clip(self) -> torch.Tensor:
        """Scale the gradients by max_norm / norm when norm >= max_norm;
        returns the norm before clipping (on the gradients' device, no
        host sync)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
        if self.grad_clip_norm > 0:
            torch._foreach_mul_(grads, torch.where(
                norm < self.grad_clip_norm, 1.0, self.grad_clip_norm / norm))
        return norm

    def step(self) -> torch.Tensor:
        norm = self.clip()
        self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def make_optimizer(params, lr: float, grad_clip_norm: float = 1.0,
                   weight_decay: float = 0.01) -> Optimizer:
    return Optimizer(params, lr, grad_clip_norm, weight_decay)


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    """Write the plateau schedule's LR into the optimizer."""
    for group in optimizer.adamw.param_groups:
        group["lr"] = lr


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


def save_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                    optimizer: Optimizer, schedule_state: Optional[dict],
                    step: int) -> str:
    weights, resume = checkpoint_paths(ckpt_dir, epoch)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               weights)
    torch.save({"optimizer": optimizer.state_dict(),
                "schedule": schedule_state or {}, "step": int(step),
                "epoch": epoch}, resume)
    return weights


def latest_checkpoint_epoch(ckpt_dir: str) -> Optional[int]:
    """Highest N with both ``epoch_N.pth`` and its resume file, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = set(os.listdir(ckpt_dir))
    epochs = [int(m.group(1)) for name in names
              if (m := re.fullmatch(r"epoch_(\d+)\.pth", name))
              and f"epoch_{m.group(1)}.resume.pth" in names]
    return max(epochs) if epochs else None


def restore_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                       optimizer: Optimizer) -> tuple:
    """Load ``epoch_N`` into ``model`` and ``optimizer``; returns
    (epoch, step, schedule state)."""
    weights, resume = checkpoint_paths(ckpt_dir, epoch)
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(weights, map_location=device,
                                     weights_only=True))
    state = torch.load(resume, map_location=device, weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
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
