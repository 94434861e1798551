"""Plain attention for the references: scores and softmax in fp32, the
unnormalised probabilities cast to V's type for the PV product, the row sum
dividing afterwards (the flash kernels' arithmetic, without their tiling).

``LOWER`` switches the control on: q, k and v pass through float8 e4m3 (the
precision below bf16) before the product. The references leave it off.
``fp8_round`` rounds a tensor through e4m3 with one scale to its range.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
LOWER = {"fp8_attention": False}
# query rows per block, so a (rows x keys) fp32 score block stays small
_ROWS = 1024


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Round through float8 e4m3 with a per-tensor scale to its range."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(t.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    **_unused) -> torch.Tensor:
    """q (B, H, Lq, D), k / v (B, H, Lk, D), key_mask (B, Lk) bool or None
    -> (B, H, Lq, D) in q's type."""
    if LOWER["fp8_attention"]:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    kf = k.float().transpose(-1, -2)
    out = torch.empty_like(q)
    for r0 in range(0, q.shape[2], _ROWS):
        s = torch.matmul(q[:, :, r0:r0 + _ROWS].float(), kf) * scale
        if key_mask is not None:
            s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(v.dtype).float(), v.float())
        out[:, :, r0:r0 + _ROWS] = (acc / denom).to(q.dtype)
    return out
