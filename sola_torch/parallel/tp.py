"""Tensor-parallel sharding of the selection model over a model group.

Counterpart of ``sola_tpu/parallel/tp.py``: Megatron-style splits of the
selection model's wide (1024-d) layers, by torch parameter names:

* attention q/k/v projections, weight (out, in) and bias split on ``out``
  (dim 0): each rank computes its own heads (8 heads x 128, so a model
  group that divides 8 keeps whole heads);
* attention ``out_proj``, weight split on ``in`` (dim 1, row parallel): the
  partial products are summed over the group and the bias, replicated, is
  added once after the sum;
* motion-encoder ``WSConv1d`` weights (out, in, k) and biases split on
  ``out`` (weight standardization is per output channel, so it needs no
  cross-rank statistics);
* everything else (GroupNorm affine, negative tokens, the PE buffer)
  replicated.

JAX states the splits as shardings and XLA inserts the collectives; here
they are explicit autograd functions: ``copy_to_model`` (identity forward,
sum of the gradient backward) on the replicated input of a split layer,
``reduce_from_model`` (sum forward, identity backward) after a row-parallel
product, and ``gather_from_model`` (the channel shards concatenated
forward, this rank's slice of the gradient backward) after a split conv.
Each collective is an ``all_reduce``: a gather sums a zero-filled full
tensor, because gloo's CUDA support covers ``all_reduce`` and
``broadcast`` only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

COLUMN_PROJ = ("q_proj", "k_proj", "v_proj")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def split_dims(state: dict) -> dict:
    """name -> the dim a model group splits that tensor on, or None where
    it is replicated, for a selection model's (full or sharded)
    ``state_dict``."""
    dims = {}
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        proj = module.rsplit(".", 1)[-1]
        conv = state.get(f"{module}.weight")
        if proj in COLUMN_PROJ:
            dims[name] = 0
        elif proj == "out_proj":
            dims[name] = 1 if leaf == "weight" else None
        elif conv is not None and conv.ndim == 3:  # WSConv1d weight, bias
            dims[name] = 0
        else:
            dims[name] = None
    return dims


def _shard(t: torch.Tensor, dim: Optional[int], n: int, index: int):
    if dim is None:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).clone()


def shard_state_dict(state: dict, n_model: int, index: int) -> dict:
    """Rank ``index``'s shard of a full single-device ``state_dict`` (the
    reference checkpoint's names, ``models/convert.py``)."""
    dims = split_dims(state)
    return {k: _shard(v, dims[k], n_model, index) for k, v in state.items()}


def _gather(t: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    if dim is None or group is None:
        return t
    n, index = group_size(group), group_rank(group)
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, index * size, size).copy_(t)
    dist.all_reduce(full, group=group)
    return full


def gather_state_dict(state: dict, group) -> dict:
    """The full single-device ``state_dict`` from each rank's shard: a
    collective over the model group, every member gets the result."""
    dims = split_dims(state)
    return {k: _gather(v.detach(), dims[k], group) for k, v in state.items()}


def _map_moments(opt_state: dict, names: Sequence[str], dims: dict, fn):
    """A copy of a torch optimizer ``state_dict`` with ``fn(tensor, dim)``
    applied to every moment of parameter index i (named ``names[i]``);
    scalars such as Adam's step are kept."""
    state = {}
    for idx, entry in opt_state["state"].items():
        dim = dims[names[int(idx)]]
        state[idx] = {k: (fn(v, dim) if torch.is_tensor(v) and v.ndim > 0
                          else v) for k, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_optimizer_state(opt_state: dict, names: Sequence[str], dims: dict,
                          n_model: int, index: int) -> dict:
    """Shard an optimizer ``state_dict`` saved from the full model: AdamW's
    moments follow their parameters' splits (the counterpart of
    ``shard_train_state`` keeping the optimizer's values)."""
    return _map_moments(opt_state, names, dims,
                        lambda t, d: _shard(t, d, n_model, index))


def gather_optimizer_state(opt_state: dict, names: Sequence[str],
                           dims: dict, group) -> dict:
    """The full model's optimizer ``state_dict`` from each rank's shard (a
    collective over the model group)."""
    return _map_moments(opt_state, names, dims,
                        lambda t, d: _gather(t, d, group))


# ---------------------------------------------------------------------------
# the collectives, as autograd functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, x.ndim - 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _shard(grad, grad.ndim - 1, group_size(ctx.group),
                      group_rank(ctx.group)), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated input of a split layer: identity forward; backward
    sums the ranks' partial gradients over ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over ``group``
    forward; the gradient passes through."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Last-dim channel shards concatenated in rank order over ``group``;
    backward keeps this rank's slice of the gradient."""
    return x if group is None else _GatherFromModel.apply(x, group)
