"""Plain attention of the selection reference: the flash kernels' function
(fp32 scores and softmax statistics, the undropped row sum dividing after
the PV product, dropout by the kernels' counter hash on the probabilities),
differentiated by autograd. The hash is a copy of the port's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF


def dropout_consts(rate: float) -> tuple:
    """(keep_thresh, inv_keep) of ``_dropout_consts``: keep an entry whose
    hash is below keep_thresh, and scale it by inv_keep."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - rate
    return min(2 ** 32 - 1, int(round(keep * 2 ** 32))), 1.0 / keep


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): two 16-bit halves of c, so
    no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask_reference(seed: int, bh, lq: int, lk: int,
                        rate: float) -> torch.Tensor:
    """Plain version of the kernels' keep mask: bool (*bh.shape, lq, lk),
    True where (batch*head ``bh``, query q, key k) is kept. ``bh`` is an
    index or a tensor of indices; the hash uses global indices, so the mask
    does not depend on any tiling. The wrapping uint32 arithmetic runs in
    int64 with a 32-bit mask after each multiply."""
    thresh, _ = dropout_consts(rate)
    bh = torch.as_tensor(bh, dtype=torch.int64)
    seed_t = torch.tensor(int(seed) & _MASK32, dtype=torch.int64,
                          device=bh.device)
    base = _fmix32(seed_t ^ _mul32(bh, 0x9E3779B1))[..., None, None]
    rows = _mul32(torch.arange(lq, dtype=torch.int64, device=bh.device),
                  0x85EBCA6B)[:, None]
    cols = _mul32(torch.arange(lk, dtype=torch.int64, device=bh.device),
                  0xC2B2AE35)[None, :]
    return _fmix32(base ^ rows ^ cols) < thresh


def _drop_factor(b, h, lq, lk, rate, seed, device) -> torch.Tensor:
    """keep x inv_keep as fp32 (B, H, Lq, Lk), with bh = b * H + h (the
    JAX package's repeat-and-reshape order)."""
    _, inv_keep = dropout_consts(rate)
    bh = torch.arange(b * h, device=device).reshape(b, h)
    return keep_mask_reference(seed, bh, lq, lk, rate).float() * inv_keep




def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_k: int = 128,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, H, Lq, D) attention over (B, H, Lk, D) keys with an optional
    (B, Lk) key-validity mask; a masked key scores -1e30."""
    del block_q, block_k
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        seed = int(dropout_seed.reshape(-1)[0]) & _MASK32
        b, h, lq, lk = p.shape
        p = p * _drop_factor(b, h, lq, lk, dropout_rate, seed, p.device)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / denom).to(q.dtype)
