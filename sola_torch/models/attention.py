"""Multi-head attention for the selection model.

Counterpart of ``sola_tpu/models/attention.py`` (tools/attention.py:7-74
semantics): four projections, 8 heads, softmax(QK^T / sqrt(head_dim)) V,
train-only dropout 0.1 on the attention probabilities (torch SDPA's
placement), output projection, and an optional key-validity mask.

Two routes, as in the JAX package: ``use_pallas=False`` is the dense
einsum path; ``use_pallas=True`` goes through ``fused_attention``, the
hand-written CUDA forward and backward kernels (their plain versions on
CPU tensors), with the probabilities' dropout inside the kernels, seeded
once per call from the forward's ``DropoutRng`` (a view of its device
buffer of draws).

With a model ``group`` (``parallel/tp.py``) the layer holds this rank's
share: q/k/v project to ``num_heads / group size`` local heads, the
attention runs over those heads by either route, and ``out_proj``'s
partial products are summed over the group before its bias. Without one
the layer is the single-device layer, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sola_torch.models.layers import DropoutRng, standardize_dense_kernel
from sola_torch.ops.flash_attention import fused_attention
from sola_torch.parallel import tp

NEG_INF = -1e30


class WSDense(nn.Linear):
    """Linear layer with on-the-fly weight standardization (ws.Linear,
    module/ws.py:24-38)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, standardize_dense_kernel(self.weight),
                                    self.bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 8,
                 dropout_p: float = 0.1, use_pallas: bool = False,
                 weight_standardization: bool = False, group=None):
        super().__init__()
        n = tp.group_size(group)
        if num_heads % n:
            raise ValueError(f"a model group of {n} does not divide "
                             f"{num_heads} heads")
        if weight_standardization and n > 1:
            # out_proj's per-row statistics would span the split inputs
            raise ValueError("weight standardization is not split")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_p = dropout_p
        self.use_pallas = use_pallas
        # a training forward seeds the kernels' dropout once a call
        self.seeds_kernel = use_pallas and dropout_p > 0.0
        self.group = group if n > 1 else None
        local = embed_dim // n
        dense = WSDense if weight_standardization else nn.Linear
        self.q_proj = dense(embed_dim, local)
        self.k_proj = dense(embed_dim, local)
        self.v_proj = dense(embed_dim, local)
        self.out_proj = dense(local, embed_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """q: (B, Lq, D); k, v: (B, Lk, D); key_mask: (B, Lk) bool or None;
        ``rng`` None is the deterministic (eval) forward."""
        hd = self.embed_dim // self.num_heads
        h = self.q_proj.out_features // hd  # this rank's heads
        b, lq, _ = q.shape
        lk = k.shape[1]
        if self.group is not None:
            # one copy per distinct tensor: q and k are often one tensor
            copies: dict = {}
            for t in (q, k, v):
                if id(t) not in copies:
                    copies[id(t)] = tp.copy_to_model(t, self.group)
            q, k, v = (copies[id(t)] for t in (q, k, v))
        qh = self.q_proj(q).reshape(b, lq, h, hd).transpose(1, 2)
        kh = self.k_proj(k).reshape(b, lk, h, hd).transpose(1, 2)
        vh = self.v_proj(v).reshape(b, lk, h, hd).transpose(1, 2)
        train = rng is not None and self.dropout_p > 0.0
        if self.use_pallas:
            if train:
                out = fused_attention(qh, kh, vh, key_mask=key_mask,
                                      dropout_rate=self.dropout_p,
                                      dropout_seed=rng.seed())
            else:
                out = fused_attention(qh, kh, vh, key_mask=key_mask)
        else:
            scale = 1.0 / (hd ** 0.5)
            logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(),
                                  kh.float()) * scale
            if key_mask is not None:
                logits = logits.masked_fill(~key_mask[:, None, None, :],
                                            NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(qh.dtype)
            if train:
                probs = rng.dropout(probs, self.dropout_p)
            out = torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                               vh.float()).to(qh.dtype)
        out = out.transpose(1, 2).reshape(b, lq, h * hd)
        if self.group is None:
            return self.out_proj(out)
        partial = nn.functional.linear(out, self.out_proj.weight)
        return tp.reduce_from_model(partial, self.group) + self.out_proj.bias
