"""Context parallelism: attention over a key axis sharded across processes.

Counterpart of ``sola_tpu/parallel/cp.py``. SAM2's memory cross-attention
(4096 queries x ~29k memory keys a frame step at hiera-L) grows with the
memory bank; context parallelism shards the KEY axis over a process group:
each rank attends its local key shard with the flash forward the
single-card path uses (``fused_attention_lse``), and the partial rows
combine exactly through their logsumexp:

    o = sum_i exp(lse_i - LSE) * o_i,   LSE = logsumexp_i(lse_i)

as two all-reduces (a max, then the weighted sums). No model path calls it,
as in the JAX package.

The port's forward scores a masked key -1e30, so a row whose local keys are
all masked comes back with a finite lse (-1e30 in fp32) and the mean of V;
the plain route gives lse -inf and 0. The combine treats any lse at or
below -1e30 / 2 as "no valid key here" and gives that shard weight 0
(``sola_tpu/parallel/cp.py:63-66`` guards -inf alone, and its kernel's
finite lse then weighs 0 by underflow). A row with no valid key on any
rank weighs every shard alike, so it comes out as each route gives it on
one device and as JAX's ``cp_attention`` returns it by that route: 0 by
the plain route, the mean of V through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from sola_torch.ops.flash_attention import NEG_INF, fused_attention_lse
from sola_torch.parallel.tp import group_rank, group_size


def _local_attention_lse(q, k, v, key_mask, use_flash: bool):
    """(out (B, H, Lq, D), lse (B, H, Lq) fp32) over the local key shard."""
    if use_flash:
        return fused_attention_lse(q, k, v, key_mask)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    # a row with no valid key: lse -inf, p 0, o 0
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_mask: Optional[torch.Tensor], group,
                 use_flash: bool = True) -> torch.Tensor:
    """Attention where k, v and key_mask hold only this rank's KEY SHARD
    and q is the same on every rank of ``group``; returns the exact
    full-key attention, the same on every rank (``group`` None: one
    shard).

    Shapes (local): q (B, H, Lq, D); k, v (B, H, Lk_local, D); key_mask
    (B, Lk_local) bool or None."""
    o_i, lse_i = _local_attention_lse(q, k, v, key_mask, use_flash)
    return combine(o_i, lse_i, group)


def combine(o_i: torch.Tensor, lse_i: torch.Tensor, group) -> torch.Tensor:
    """The exact attention over every rank's keys from each rank's (out,
    lse) over its own: a max and a sum all-reduce over ``group``. Returns
    o_i's dtype."""
    valid = lse_i > NEG_INF / 2
    m = torch.where(valid, lse_i, -torch.inf)
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    anywhere = torch.isfinite(m)  # some rank holds a valid key of the row
    m_safe = torch.where(anywhere, m, 0.0)
    e_i = torch.where(valid, torch.exp(lse_i - m_safe),
                      torch.where(anywhere, 0.0, 1.0))
    # one all-reduce for the weighted outputs and their weights' sum
    parts = torch.cat([o_i.float() * e_i[..., None], e_i[..., None]], -1)
    if group is not None:
        dist.all_reduce(parts, group=group)
    denom = parts[..., -1:].clamp_min(1e-30)
    return (parts[..., :-1] / denom).to(o_i.dtype)


def shard_keys(k: torch.Tensor, v: torch.Tensor,
               key_mask: Optional[torch.Tensor], group):
    """This rank's key shard of global k, v (B, H, Lk, D) and key_mask
    (B, Lk): contiguous blocks of Lk / group size keys in rank order (the
    counterpart of ``place_cp_inputs``). Lk must divide the group size."""
    n, r = group_size(group), group_rank(group)
    lk = k.shape[2]
    if lk % n:
        raise ValueError(f"key length {lk} does not split over {n} ranks")
    size = lk // n
    k = k.narrow(2, r * size, size).contiguous()
    v = v.narrow(2, r * size, size).contiguous()
    if key_mask is not None:
        key_mask = key_mask.narrow(1, r * size, size).contiguous()
    return k, v, key_mask
