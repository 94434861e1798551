"""The (data, model) process mesh of selection training.

Counterpart of ``sola_tpu/parallel/mesh.py``. JAX lays its devices out as
a (data, model) array and lets jit place the batch and insert the
collectives; here the mesh is processes: rank r sits at
``(r // n_model, r % n_model)`` (row-major, as ``make_mesh``'s reshape),
with a process group along each axis. Every rank builds the same padded
global batch and keeps the rows of its data index (``shard_batch``); ranks
of one model group hold the same rows and split the wide layers between
them (``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sola_torch.parallel.distributed import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and its two process groups: the data
    group (the ranks with its model index, over which gradients and losses
    are summed) and the model group (the ranks with its data index, which
    hold one batch shard and split the weights). A group is None where its
    axis has size 1, and its collectives are then the identity."""
    n_data: int
    n_model: int
    rank: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every process of the group (one process: a 1 x 1 mesh
    without groups). Every rank must call it, in the same order as its
    other group constructions."""
    world, rank = process_count(), process_index()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} must divide {world} processes")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} needs "
                         f"{n_data * n_model} processes, have {world}")
    data_group = model_group = None
    if n_data > 1:
        for j in range(n_model):
            g = dist.new_group([i * n_model + j for i in range(n_data)])
            if j == rank % n_model:
                data_group = g
    if n_model > 1:
        for i in range(n_data):
            g = dist.new_group([i * n_model + j for j in range(n_model)])
            if i == rank // n_model:
                model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (no-op for None); returns
    it."""
    if group is not None:
        dist.all_reduce(tensor, group=group)
    return tensor


def sum_gradients(params, group) -> None:
    """Sum every parameter's gradient over ``group`` in one flat
    all-reduce (a parameter without a gradient contributes zeros)."""
    if group is None:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


class _PadEntry(str):
    """Sentinel for list padding in ``pad_batch_to``: a distinct object
    (check with ``is PAD_ENTRY``) that still behaves as an empty string so
    text encoders and logging accept padded expression rows."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<PAD_ENTRY>"


PAD_ENTRY = _PadEntry("")


def pad_batch_to(batch: dict, target_b: int) -> dict:
    """Pad the leading axis to ``target_b`` with zeros/False so every shard
    is full; padded rows carry all-False track masks and thus contribute
    nothing to masked losses or metrics.

    List entries (metadata like ``(video_id, expression_id)``) are padded
    with ``PAD_ENTRY``, a distinct sentinel and not a copy of the last
    sample, so a consumer keying a dict by entry can never overwrite a real
    row with a padded one; filter with ``e is not PAD_ENTRY``."""

    def pad(x):
        if isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] < target_b:
            pad_width = [(0, target_b - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, pad_width)
        if isinstance(x, list) and len(x) < target_b:
            # array rows (object_token_rows) pad with a zeros row of the
            # same shape, masked out downstream; metadata with PAD_ENTRY
            fill = (np.zeros_like(x[-1])
                    if x and isinstance(x[-1], np.ndarray) else PAD_ENTRY)
            return x + [fill] * (target_b - len(x))
        return x

    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = {kk: pad(vv) for kk, vv in v.items()}
        else:
            out[k] = pad(v)
    return out


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This data index's rows of a collated host batch: padded with
    ``pad_batch_to`` to a multiple of ``n_data``, then cut into ``n_data``
    equal blocks of rows (the counterpart of ``shard_batch``'s placement
    over the data axis)."""
    b = len(batch["expression"])
    per = -(-b // mesh.n_data)
    if per * mesh.n_data != b:
        batch = pad_batch_to(batch, per * mesh.n_data)
    lo, hi = mesh.data_index * per, (mesh.data_index + 1) * per

    def rows(x):
        if isinstance(x, (np.ndarray, list)) and len(x) == per * mesh.n_data:
            return x[lo:hi]
        return x

    return {k: ({kk: rows(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else rows(v))
            for k, v in batch.items()}
