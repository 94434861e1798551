"""Swin-T, GroundingDINO's image backbone, with plain window attention.

Channels-last (B, H, W, C). Stages of (2, 2, 6, 2) blocks at widths
96/192/384/768 with (3, 6, 12, 24) heads; odd blocks shift their 7 x 7
windows by 3; patch merging between stages; the last three stages'
outputs, each behind its own layer norm, are the strides 8, 16 and 32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sam2.common import (attn_scale, window_partition,
                                             window_unpartition)

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_indices: tuple = (1, 2, 3)

    @classmethod
    def tiny_test(cls) -> "SwinConfig":
        return cls(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                   window_size=4)

    @property
    def stage_dims(self):
        return [self.embed_dim * (2 ** i) for i in range(len(self.depths))]


def relative_index(window: int) -> torch.Tensor:
    """(w^2, w^2) index of each (query, key) offset in the bias table."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    c = torch.stack([ys.reshape(-1), xs.reshape(-1)])
    rel = (c[:, :, None] - c[:, None, :]) + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def shift_mask(hp: int, wp: int, window: int, shift: int) -> torch.Tensor:
    """(nW, w^2, w^2) additive mask: -100 between pixels that the cyclic
    shift brought together from different regions."""
    region = np.zeros((hp, wp), np.int64)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for ys in cuts:
        for xs in cuts:
            region[ys, xs] = n
            n += 1
    r = torch.from_numpy(region).reshape(hp // window, window,
                                         wp // window, window)
    r = r.permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(r[:, :, None] == r[:, None, :], 0.0, -100.0)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(B, C, H, W) padded so that a ``kernel``/``stride`` convolution
    gives ceil(n / stride) outputs, the extra on the high side."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _QKV(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.self = _QKV(dim, heads, window)
        self.output = _Dense(dim, dim)

    def forward(self, x, window: int, mask=None):
        """x (nW, w^2, C) -> (nW, w^2, C)."""
        nw, n, c = x.shape
        h = self.heads
        sa = self.self
        q, k, v = (p(x).reshape(nw, n, h, c // h)
                   for p in (sa.query, sa.key, sa.value))
        logits = torch.einsum("wqhd,wkhd->whqk", q, k) \
            * attn_scale(c // h, x.dtype).to(x.device)
        table = sa.relative_position_bias_table
        bias = table[relative_index(window).to(x.device)]   # (n, n, h)
        logits = logits + bias.permute(2, 0, 1)[None]
        if mask is not None:
            g = mask.shape[0]
            logits = (logits.reshape(nw // g, g, h, n, n)
                      + mask.to(x.device)[None, :, None]).reshape(nw, h, n, n)
        out = torch.einsum("whqk,wkhd->wqhd", logits.softmax(-1), v)
        return self.output.dense(out.reshape(nw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio, table_window):
        super().__init__()
        self.window, self.shift = window, shift
        self.layernorm_before = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = WindowAttention(dim, heads, table_window)
        self.layernorm_after = nn.LayerNorm(dim, eps=LN_EPS)
        self.intermediate = _Dense(dim, int(dim * mlp_ratio))
        self.output = _Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, h, w, c = x.shape
        window, shift = self.window, self.shift
        if min(h, w) <= window:
            window, shift = min(h, w), 0
        y = self.layernorm_before(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        yw, pad_hw = window_partition(y, window)
        mask = shift_mask(*pad_hw, window, shift) if shift else None
        yw = self.attention(yw.reshape(-1, window * window, c), window, mask)
        y = window_unpartition(yw.reshape(-1, window, window, c), window,
                               pad_hw, (h, w))
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.output.dense(F.gelu(self.intermediate.dense(
            self.layernorm_after(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, dim_out, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                    stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.patch_embeddings = _PatchEmbeddings(cfg)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)


def table_windows(cfg: SwinConfig, image_hw) -> list:
    """Each stage's bias-table window for an ``image_hw`` input."""
    h, w = (math.ceil(d / cfg.patch_size) for d in image_hw)
    out = []
    for _ in cfg.depths:
        out.append(min(h, w, cfg.window_size))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return out


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, s: int, table_window: int):
        super().__init__()
        dim = cfg.stage_dims[s]
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[s], cfg.window_size,
                      (i % 2) * (cfg.window_size // 2), cfg.mlp_ratio,
                      table_window)
            for i in range(cfg.depths[s]))
        if s < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim, cfg.stage_dims[s + 1])


class _Encoder(nn.Module):
    def __init__(self, cfg: SwinConfig, image_hw):
        super().__init__()
        self.layers = nn.ModuleList(
            _Stage(cfg, s, win)
            for s, win in enumerate(table_windows(cfg, image_hw)))


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig, image_hw):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, image_hw)
        self.hidden_states_norms = nn.ModuleDict({
            f"stage{s + 1}": nn.LayerNorm(cfg.stage_dims[s], eps=LN_EPS)
            for s in cfg.out_indices})

    def forward(self, images):
        """(B, H, W, 3) -> the out_indices stages' (B, h, w, C)."""
        cfg = self.cfg
        x = same_pad(images.permute(0, 3, 1, 2), cfg.patch_size,
                     cfg.patch_size)
        x = self.embeddings.patch_embeddings.projection(x).permute(0, 2, 3, 1)
        x = self.embeddings.norm(x)
        outs = []
        for s, stage in enumerate(self.encoder.layers):
            for blk in stage.blocks:
                x = blk(x)
            if s in cfg.out_indices:
                outs.append(self.hidden_states_norms[f"stage{s + 1}"](x))
            if s < len(cfg.depths) - 1:
                x = stage.downsample(x)
        return outs
