"""Hiera ViT image-encoder trunk (SAM2's backbone), channels-last torch.

Counterpart of ``sola_tpu/trackgen/sam2/hiera.py``: hierarchical windowed
attention with q-pooling between stages and a few global-attention blocks.
SAM2-L ("hiera_l"): embed_dim 144, heads 2, stages (2, 6, 36, 4), global
attention at blocks (23, 33, 43), window sizes (8, 4, 16, 8). The global
blocks (4096 tokens at 1024 px, head dim 72 at hiera-L) go through the
hand-written flash-attention kernel; windowed blocks stay dense.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.attention import plain_attention as fused_attention
from benchmark.reference.sam2.common import (MLP, conv_nhwc, sdpa,
                                             torch_bicubic_resize,
                                             window_partition,
                                             window_unpartition)


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: tuple = (2, 6, 36, 4)
    global_att_blocks: tuple = (23, 33, 43)
    window_spec: tuple = (8, 4, 16, 8)
    window_pos_embed_bkg_spatial_size: tuple = (7, 7)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3

    @classmethod
    def large(cls) -> "HieraConfig":
        return cls()

    # upstream SAM2 model family (sam2_hiera_{t,s,b+}.yaml backbone blocks)
    @classmethod
    def tiny(cls) -> "HieraConfig":
        return cls(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                   global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7))

    @classmethod
    def small(cls) -> "HieraConfig":
        return cls(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                   global_att_blocks=(7, 10, 13), window_spec=(8, 4, 14, 7))

    @classmethod
    def base_plus(cls) -> "HieraConfig":
        return cls(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                   global_att_blocks=(12, 16, 20), window_spec=(8, 4, 14, 7),
                   window_pos_embed_bkg_spatial_size=(14, 14))

    @classmethod
    def tiny_test(cls) -> "HieraConfig":
        """Small config for unit tests (4 stages, 1 block each)."""
        return cls(embed_dim=32, num_heads=1, stages=(1, 1, 1, 1),
                   global_att_blocks=(2,), window_spec=(4, 2, 4, 2),
                   window_pos_embed_bkg_spatial_size=(2, 2))

    @property
    def stage_ends(self):
        ends = []
        total = 0
        for s in self.stages:
            total += s
            ends.append(total - 1)
        return ends

    @property
    def q_pool_blocks(self):
        # pooling happens at the first block of stages 2..4
        return [end + 1 for end in self.stage_ends[:-1]]

    @property
    def output_dims(self):
        d = self.embed_dim
        dims = []
        for _ in range(len(self.stages)):
            dims.append(int(d))
            d *= self.dim_mul
        return dims


def block_specs(cfg: HieraConfig) -> list[tuple]:
    """Per block: (dim, dim_out, heads, window, q_pool); window 0 is global
    attention. The first block of a stage (q_pool) keeps the PREVIOUS
    stage's window size (upstream hiera.py "lags by a block")."""
    q_pool_blocks = set(cfg.q_pool_blocks)
    specs = []
    dim = cfg.embed_dim
    heads = cfg.num_heads
    stage = 0
    for i in range(sum(cfg.stages)):
        q_pool = i in q_pool_blocks
        dim_out = dim
        if q_pool:
            dim_out = int(dim * cfg.dim_mul)
            heads = int(heads * cfg.head_mul)
            stage += 1
        window = cfg.window_spec[stage - 1 if q_pool else stage]
        if i in cfg.global_att_blocks:
            window = 0
        specs.append((dim, dim_out, heads, window, q_pool))
        dim = dim_out
    return specs


def hiera_segments(cfg: HieraConfig) -> list[tuple]:
    """The JAX package's grouping of blocks into ("single", i, spec) and
    scanned ("run", start, n, spec) segments; its parameter tree stacks a
    run's blocks, so the weight converter needs the grouping."""
    specs = block_specs(cfg)
    total = len(specs)
    segments: list[tuple] = []
    i = 0
    while i < total:
        spec = specs[i]
        if spec[4] or spec[3] == 0:  # q_pool or global: always single
            segments.append(("single", i, spec))
            i += 1
            continue
        j = i
        while j + 1 < total and specs[j + 1] == spec:
            j += 1
        if j > i:
            segments.append(("run", i, j - i + 1, spec))
        else:
            segments.append(("single", i, spec))
        i = j + 1
    return segments


def _maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pooling on (B, H, W, C) via reshape (H, W even)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_pool: bool = False):
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        # long token sequences (the global blocks: 4096 tokens at 1024 px)
        # go through the flash kernel; windowed blocks (<= 256 tokens) stay
        # dense. A field, so tests can lower it.
        self.fused_min_tokens = 1024

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads = self.num_heads
        head_dim = self.dim_out // heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, head_dim)
        q, k, v = qkv.unbind(2)
        if self.q_pool:
            q = _maxpool2x2(q.reshape(b, h, w, heads * head_dim))
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(b, h * w, heads, head_dim)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if kh.shape[2] >= self.fused_min_tokens and head_dim % 8 == 0:
            out = fused_attention(qh.contiguous(), kh.contiguous(),
                                  vh.contiguous())
        else:
            out = sdpa(qh, kh, vh)
        out = out.transpose(1, 2).reshape(b, h, w, self.dim_out)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 mlp_ratio: float = 4.0, q_pool: bool = False,
                 window_size: int = 0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.q_pool = q_pool
        self.window_size = window_size  # 0 = global attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2,
                       activation=F.gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_pool:
                shortcut = _maxpool2x2(shortcut)
        h, w = x.shape[1], x.shape[2]
        window = self.window_size
        pad_hw = (h, w)
        if window > 0:
            x, pad_hw = window_partition(x, window)
        x = self.attn(x)
        if self.q_pool:
            window = window // 2 if window > 0 else 0
            pad_hw = (pad_hw[0] // 2, pad_hw[1] // 2)
            h, w = h // 2, w // 2
        if window > 0:
            x = window_unpartition(x, window, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel,
                              stride=cfg.patch_stride,
                              padding=cfg.patch_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.proj, x)


class Hiera(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.embed_dim, *cfg.window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, cfg.embed_dim, cfg.window_spec[0], cfg.window_spec[0]))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(dim, dim_out, heads, cfg.mlp_ratio, q_pool,
                            window)
            for dim, dim_out, heads, window, q_pool in block_specs(cfg))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, H, W, 3) -> the 4 stage-end feature maps, strides
        4/8/16/32, dims embed_dim * 2^stage."""
        cfg = self.cfg
        x = self.patch_embed(x)
        h, w = x.shape[1], x.shape[2]
        # learned background PE (torch bicubic) + tiled window PE, in fp32
        # as in the JAX package (its interpolation matrices are fp32): adding
        # it promotes a bf16 patch embedding to fp32, so the blocks after it
        # compute in fp32 (SAM2VideoPredictor keeps their weights fp32).
        pos = torch_bicubic_resize(
            self.pos_embed[0].permute(1, 2, 0).float(), h, w)
        win = self.pos_embed_window[0].permute(1, 2, 0).float()
        pos = pos + win.repeat(h // cfg.window_spec[0],
                               w // cfg.window_spec[0], 1)
        x = x + pos[None]
        outputs = []
        ends = set(cfg.stage_ends)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in ends:
                outputs.append(x)
        return outputs
