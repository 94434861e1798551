"""Swin Transformer backbone (GroundingDINO's image encoder), channels-last.

Counterpart of ``sola_tpu/trackgen/gdino/swin.py``. Swin-T: embed 96, depths
(2, 2, 6, 2), heads (3, 6, 12, 24), window 7, shifted windows with relative
position bias, patch-merging downsampling; outputs stages 2-4 (strides 8,
16, 32). Module names follow the HF Swin checkpoint keys
(``embeddings.*``, ``encoder.layers.{s}.blocks.{b}.*``,
``hidden_states_norms.stage{k}``). LayerNorms use flax's default epsilon
1e-6 and the patch embedding flax's "SAME" padding, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sola_torch.trackgen.sam2.common import (attn_scale, window_partition,
                                             window_unpartition)

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_indices: tuple = (1, 2, 3)

    # GroundingDINO backbone family: default = Swin-T (swint_ogc ckpt);
    # Swin-B matches the groundingdino_swinb_cogcoor checkpoint
    @classmethod
    def base(cls) -> "SwinConfig":
        return cls(embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32), window_size=12)

    @classmethod
    def tiny_test(cls) -> "SwinConfig":
        return cls(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                   window_size=4)

    @property
    def stage_dims(self):
        return [self.embed_dim * (2 ** i) for i in range(len(self.depths))]


def relative_position_index(window: int) -> np.ndarray:
    """(window^2, window^2) index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"), axis=0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shifted_window_mask(hp: int, wp: int, window: int,
                        shift: int) -> np.ndarray:
    """Attention mask groups for shifted windows ((nW, w^2, w^2) additive)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(hp // window, window, wp // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad (B, C, H, W) as flax's "SAME" convolution does: out = ceil(n /
    stride), the padding split low = total // 2, high = the rest."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W first
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class _QKV(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.self = _QKV(dim, num_heads, window)
        self.output = _Dense(dim, dim)

    def forward(self, x: torch.Tensor, window: int, attn_mask=None
                ) -> torch.Tensor:
        """x: (nW, window*window, C); ``window`` may be smaller than the
        configured one (a level at or below the window size)."""
        nw, l, c = x.shape
        h = self.num_heads
        hd = self.dim // h
        q, k, v = (p(x).reshape(nw, l, h, hd).transpose(1, 2)
                   for p in (self.self.query, self.self.key, self.self.value))
        scale = attn_scale(hd, x.dtype).to(x.device)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        idx = torch.from_numpy(relative_position_index(window).reshape(-1))
        bias = self.self.relative_position_bias_table[idx.to(x.device)]
        logits = logits + bias.reshape(l, l, h).permute(2, 0, 1)[None]
        if attn_mask is not None:
            # attn_mask: (n_mask_groups, l, l); windows cycle through groups
            ng = attn_mask.shape[0]
            logits = (logits.reshape(nw // ng, ng, h, l, l)
                      + attn_mask[None, :, None]).reshape(nw, h, l, l)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(nw, l, self.dim)
        return self.output.dense(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float, table_window: int):
        """``table_window`` sizes the relative position bias table: the
        window the block runs at for the image size the model was built
        for (smaller than ``window`` on a level at or below it)."""
        super().__init__()
        self.window, self.shift = window, shift
        self.layernorm_before = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = WindowAttention(dim, num_heads, table_window)
        self.layernorm_after = nn.LayerNorm(dim, eps=LN_EPS)
        self.intermediate = _Dense(dim, int(dim * mlp_ratio))
        self.output = _Dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        shortcut = x
        x = self.layernorm_before(x)
        # HF Swin rule: a resolution at or below the window size collapses to
        # one unshifted window (identical to upstream at real sizes, where
        # every level exceeds the window)
        window, shift = self.window, self.shift
        if min(h, w) <= window:
            window, shift = min(h, w), 0
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw, pad_hw = window_partition(x, window)
        nw = xw.shape[0]
        mask = None
        if shift > 0:
            mask = torch.from_numpy(shifted_window_mask(
                pad_hw[0], pad_hw[1], window, shift)).to(x.device)
        xw = self.attention(xw.reshape(nw, window * window, c), window, mask)
        x = window_unpartition(xw.reshape(nw, window, window, c), window,
                               pad_hw, (h, w))
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x
        y = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(y)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, dim_out, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
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


def stage_windows(cfg: SwinConfig, image_hw=None) -> list:
    """Each stage's window at an ``image_hw`` input: the configured window,
    or a level's shorter side when that is at or below it. The JAX package
    sizes each block's bias table at the size its model is initialized
    with, so the port builds its tables for the same size."""
    n = len(cfg.depths)
    if image_hw is None:
        return [cfg.window_size] * n
    h, w = (math.ceil(d / cfg.patch_size) for d in image_hw)
    out = []
    for _ in range(n):
        out.append(min(h, w) if min(h, w) <= cfg.window_size
                   else cfg.window_size)
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return out


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, table_window: int):
        super().__init__()
        dim = cfg.stage_dims[stage]
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[stage], cfg.window_size,
                      0 if blk % 2 == 0 else cfg.window_size // 2,
                      cfg.mlp_ratio, table_window)
            for blk in range(cfg.depths[stage]))
        if stage < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim, cfg.stage_dims[stage + 1])


class _Encoder(nn.Module):
    def __init__(self, cfg: SwinConfig, image_hw):
        super().__init__()
        self.layers = nn.ModuleList(
            _Stage(cfg, s, win)
            for s, win in enumerate(stage_windows(cfg, image_hw)))


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig, image_hw=None):
        """``image_hw``: the input size the bias tables are built for (see
        ``stage_windows``); None builds every table at the full window."""
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, image_hw)
        self.hidden_states_norms = nn.ModuleDict({
            f"stage{s + 1}": nn.LayerNorm(cfg.stage_dims[s], eps=LN_EPS)
            for s in cfg.out_indices})

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images (B, H, W, 3) -> the out_indices stages' (B, h, w, C)."""
        cfg = self.cfg
        x = same_pad(images.permute(0, 3, 1, 2), cfg.patch_size,
                     cfg.patch_size)
        x = self.embeddings.patch_embeddings.projection(x).permute(0, 2, 3, 1)
        x = self.embeddings.norm(x)
        outs = []
        for stage, layer in enumerate(self.encoder.layers):
            for blk in layer.blocks:
                x = blk(x)
            if stage in cfg.out_indices:
                outs.append(self.hidden_states_norms[f"stage{stage + 1}"](x))
            if stage < len(cfg.depths) - 1:
                x = layer.downsample(x)
        return outs
