"""Multi-scale deformable attention.

Counterpart of ``sola_tpu/trackgen/gdino/deformable.py``. ``MSDeformAttn``
projects values, predicts sampling offsets and weights, and samples through
``ops.deformable_interp.ms_deform_attn``: the hand-written CUDA kernel on a
CUDA tensor, and on a CPU tensor ``ms_deform_attn_core`` below, the plain
PyTorch version of the kernel's function (the gather form of the upstream
op, written with ``torch.gather``).

Every call site takes the kernel on the card, the encoder's ~22k queries and
the decoder's 900 alike; the JAX package routes only Lq >= 4096 to its
Pallas kernel on the TPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sola_torch.ops.deformable_interp import flatten_levels, ms_deform_attn


def corner_terms(loc_xy: torch.Tensor, h: int, w: int):
    """Bilinear corners of (..., 2) normalized xy locations on an (h, w)
    map, ``align_corners=False``: flat clipped indices (..., 4) and bilinear
    weights (..., 4) fp32, zero for corners outside the map. Corner order
    (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)."""
    loc_xy = loc_xy.to(torch.float32)  # bf16 coords quantize subpixel
    x = loc_xy[..., 0] * w - 0.5
    y = loc_xy[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    idxs, wgts = [], []
    for yi, xi, cw in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                       (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        idxs.append(yi_c * w + xi_c)
        wgts.append(torch.where(inb, cw, torch.zeros_like(cw)))
    return torch.stack(idxs, dim=-1), torch.stack(wgts, dim=-1)


def _gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (N, HW, C), idx (N, M) -> (N, M, C)."""
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                        flat.shape[-1]))


def bilinear_sample(value: torch.Tensor, loc_xy: torch.Tensor
                    ) -> torch.Tensor:
    """Sample (B, H, W, C) maps at (B, N, 2) normalized [0, 1] xy locations
    (zero padding, ``align_corners=False``). Returns (B, N, C) fp32."""
    b, h, w, c = value.shape
    idx, wgt = corner_terms(loc_xy, h, w)
    flat = value.reshape(b, h * w, c)
    out = 0.0
    for k in range(4):
        out = out + _gather_rows(flat, idx[..., k]).float() * wgt[..., k:k + 1]
    return out


def ms_deform_attn_core(value_levels, sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        spatial_shapes: Optional[Sequence[tuple]] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the deformable sampling kernel.

    value_levels: per-level (B, H_l, W_l, n_heads * head_dim), or the
      flattened (B, sum HW, C) tensor with ``spatial_shapes``
    sampling_locations: (B, Lq, n_heads, n_levels, n_points, 2) in [0, 1]
    attention_weights:  (B, Lq, n_heads, n_levels, n_points)
    Each term's weight is attn_w * corner_w in fp32 (zero outside the map);
    every level and point accumulates in fp32, and the result is cast to the
    values' dtype once, as in the kernel. Returns (B, Lq, n_heads *
    head_dim)."""
    if spatial_shapes is None:
        value, shapes = flatten_levels(value_levels)
    else:
        value, shapes = value_levels, list(spatial_shapes)
    b, _, c = value.shape
    _, lq, n_heads, _, n_points, _ = sampling_locations.shape
    head_dim = c // n_heads
    attn = attention_weights.to(torch.float32)
    out = torch.zeros((b * n_heads, lq, head_dim), dtype=torch.float32,
                      device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        # heads fold into the batch so each head samples its own channels
        v = value[:, start:start + h * w].reshape(b, h * w, n_heads, head_dim)
        v = v.permute(0, 2, 1, 3).reshape(b * n_heads, h * w, head_dim)
        start += h * w
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)
        idx, wgt = corner_terms(loc.reshape(b * n_heads, lq, n_points, 2),
                                h, w)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            b * n_heads, lq, n_points)
        wgt = (wgt * a[..., None]).reshape(b * n_heads, lq * n_points * 4)
        rows = _gather_rows(v, idx.reshape(b * n_heads, lq * n_points * 4))
        out += (rows.float() * wgt[..., None]).reshape(
            b * n_heads, lq, n_points * 4, head_dim).sum(dim=2)
    out = out.reshape(b, n_heads, lq, head_dim).permute(0, 2, 1, 3)
    return out.reshape(b, lq, c).to(value.dtype)


class MSDeformAttn(nn.Module):
    """Deformable attention module: value projection, sampling offsets and
    attention weights from the query, sampling, output projection.
    Parameter names follow the HF GroundingDino checkpoint."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value, spatial_shapes: Optional[Sequence[tuple]] = None,
                value_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Lq, d); reference_points (B, Lq, n_levels, 2|4)
        normalized; value: flattened (B, sum HW, d) with ``spatial_shapes``
        [(H_l, W_l)] or a per-level list of (B, H_l, W_l, d); value_mask
        (B, sum HW) bool True = valid (padded values are zeroed after the
        projection, as upstream's masked_fill)."""
        nh, nl, np_ = self.n_heads, self.n_levels, self.n_points
        b, lq, _ = query.shape
        if spatial_shapes is None:
            value, spatial_shapes = flatten_levels(value)
        projected = self.value_proj(value)
        if value_mask is not None:
            projected = projected.masked_fill(~value_mask[..., None], 0.0)
        offsets = self.sampling_offsets(query).reshape(b, lq, nh, nl, np_, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, lq, nh, nl * np_),
            dim=-1).reshape(b, lq, nh, nl, np_)
        shapes = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                              dtype=torch.float32, device=query.device)
        if reference_points.shape[-1] == 2:
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / shapes[None, None, None, :, None, :])
        else:
            center = reference_points[..., :2]
            wh = reference_points[..., 2:]
            loc = (center[:, :, None, :, None, :]
                   + offsets / np_ * wh[:, :, None, :, None, :] * 0.5)
        out = ms_deform_attn(projected, loc, weights, spatial_shapes)
        return self.output_proj(out)
