"""SAM2 memory subsystem: memory encoder + RoPE memory attention.

Counterpart of ``sola_tpu/trackgen/sam2/memory.py``. The memory encoder
fuses the current frame's stride-16 features with a 16x-downsampled sigmoid
mask into 64-d memory features; memory attention cross-attends the current
frame's tokens to the spatial memories of conditioning + recent frames plus
object-pointer tokens (2D axial RoPE on the spatial tokens only). This is
the per-frame hot loop of track generation: at SAM2 width its
cross-attention (4096 queries x 28,736 keys, head dim 256, key mask) and its
4096x4096 self-attention go through the hand-written flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sola_torch.ops.flash_attention import fused_attention
from sola_torch.trackgen.sam2.common import (LayerNorm2d, attn_scale,
                                             conv_nhwc, conv2d)


# ---------------------------------------------------------------------------
# 2D axial rotary position embedding
# ---------------------------------------------------------------------------

def axial_rope_freqs(head_dim: int, end_x: int, end_y: int,
                     theta: float = 10000.0, device=None):
    """cos/sin tables (end_x*end_y, head_dim//2) for 2D axial RoPE: half the
    rotated pairs follow x, half follow y."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (torch.arange(0, quarter, dtype=torch.float32,
                                          device=device) * 2
                             / (head_dim // 2)))
    idx = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    tx = idx % end_x
    ty = torch.div(idx, end_x, rounding_mode="floor")
    ang = torch.cat([tx[:, None] * freqs[None], ty[:, None] * freqs[None]],
                    dim=-1)
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) of (B, H, L, D)
    by the (L0, D//2) tables, tiled along L when L is a multiple of L0
    (multi-frame memories). Tables are cast to the activation dtype."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    l = x.shape[-2]
    if cos.shape[0] != l:
        reps = l // cos.shape[0]
        cos = cos.repeat(reps, 1)
        sin = sin.repeat(reps, 1)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape)


class RoPEAttention(nn.Module):
    """Attention with 2D axial RoPE on q and the spatial prefix of k. Key
    counts from ``fused_min_keys`` up go through the flash kernel (a field,
    so tests can lower it); smaller ones use dense matmuls."""

    def __init__(self, embed_dim: int, num_heads: int,
                 kv_in_dim: Optional[int] = None, feat_size: int = 64,
                 rope_theta: float = 10000.0):
        super().__init__()
        kv = kv_in_dim or embed_dim
        self.num_heads = num_heads
        self.feat_size = feat_size
        self.rope_theta = rope_theta
        self.fused_min_keys = 4096
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(kv, embed_dim)
        self.v_proj = nn.Linear(kv, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0,
                key_mask: Optional[torch.Tensor] = None):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, lq, d = qp.shape
        lk = kp.shape[1]
        h = self.num_heads
        hd = d // h
        qh = qp.reshape(b, lq, h, hd).transpose(1, 2)
        kh = kp.reshape(b, lk, h, hd).transpose(1, 2)
        vh = vp.reshape(b, lk, h, hd).transpose(1, 2)

        cos, sin = axial_rope_freqs(hd, self.feat_size, self.feat_size,
                                    self.rope_theta, device=qh.device)
        qh = apply_rope(qh, cos[:lq], sin[:lq])
        n_rope = lk - num_k_exclude_rope
        k_rope = apply_rope(kh[:, :, :n_rope], cos, sin)
        kh = (torch.cat([k_rope, kh[:, :, n_rope:]], dim=2)
              if num_k_exclude_rope > 0 else k_rope)

        if lk >= self.fused_min_keys and hd % 8 == 0:
            out = fused_attention(qh.contiguous(), kh.contiguous(),
                                  vh.contiguous(), key_mask=key_mask)
        else:
            scale = attn_scale(hd, qh.dtype)   # a CPU scalar, as sdpa's
            logits = torch.matmul(qh.float(),
                                  kh.float().transpose(-1, -2)) * scale
            if key_mask is not None:
                logits = logits.masked_fill(~key_mask[:, None, None, :],
                                            -1e30)
            probs = torch.softmax(logits, dim=-1).to(qh.dtype)
            out = torch.matmul(probs, vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d))


@dataclasses.dataclass(frozen=True)
class MemoryAttentionConfig:
    d_model: int = 256
    num_layers: int = 4
    dim_feedforward: int = 2048
    num_heads: int = 1
    mem_dim: int = 64
    feat_size: int = 64

    @classmethod
    def tiny_test(cls) -> "MemoryAttentionConfig":
        return cls(d_model=32, num_layers=1, dim_feedforward=64, num_heads=1,
                   mem_dim=16, feat_size=4)


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig):
        super().__init__()
        d = cfg.d_model
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = RoPEAttention(d, cfg.num_heads,
                                       feat_size=cfg.feat_size)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn_image = RoPEAttention(d, cfg.num_heads,
                                              kv_in_dim=cfg.mem_dim,
                                              feat_size=cfg.feat_size)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)

    def forward(self, tgt, memory, query_pos, memory_pos,
                num_obj_ptr_tokens: int = 0, key_mask=None):
        # self attention (pre-norm, no PE at attn per SAM2 config)
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        # cross attention: keys get their positional encodings added
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(
            t2, memory + memory_pos, memory,
            num_k_exclude_rope=num_obj_ptr_tokens, key_mask=key_mask)
        t2 = self.linear2(F.relu(self.linear1(self.norm3(tgt))))
        return tgt + t2


class MemoryAttention(nn.Module):
    def __init__(self, cfg: MemoryAttentionConfig):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, curr, curr_pos, memory, memory_pos,
                num_obj_ptr_tokens: int = 0, key_mask=None):
        """curr (B, L, d_model); memory (B, Lm, mem_dim) incl. obj-ptr
        tokens; key_mask (B, Lm) bool masks invalid memory slots.
        pos_enc_at_input: the query PE is added once, damped by 0.1."""
        x = curr + 0.1 * curr_pos
        for layer in self.layers:
            x = layer(x, memory, curr_pos, memory_pos, num_obj_ptr_tokens,
                      key_mask=key_mask)
        return self.norm(x)


# ---------------------------------------------------------------------------
# Memory encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryEncoderConfig:
    in_dim: int = 256
    out_dim: int = 64
    mask_downsample_layers: int = 4  # stride 16 total
    fuser_layers: int = 2

    @classmethod
    def tiny_test(cls) -> "MemoryEncoderConfig":
        return cls(in_dim=32, out_dim=16, mask_downsample_layers=4,
                   fuser_layers=1)


class CXBlock(nn.Module):
    """ConvNeXt block (SAM2 memory fuser): 7x7 depthwise conv + LN + MLP with
    layer-scale, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + self.gamma * y


class MaskDownSampler(nn.Module):
    def __init__(self, cfg: MemoryEncoderConfig):
        super().__init__()
        layers: list = []
        chans = 1
        for _ in range(cfg.mask_downsample_layers):
            layers += [conv2d(chans, chans * 4, 3, stride=2, padding=1),
                       LayerNorm2d(chans * 4), nn.GELU()]
            chans *= 4
        layers.append(conv2d(chans, cfg.in_dim, 1))
        # facebook indices: 3i conv, 3i+1 LN2d, 3i+2 GELU, 3n conv_out
        self.encoder = nn.Sequential(*layers)

    def forward(self, masks):
        """(B, 16h, 16w, 1) scaled-sigmoid masks -> (B, h, w, in_dim)."""
        x = masks
        for layer in self.encoder:
            x = conv_nhwc(layer, x) if isinstance(layer, nn.Conv2d) \
                else layer(x)
        return x


class _Fuser(nn.Module):
    def __init__(self, cfg: MemoryEncoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(cfg.in_dim)
                                    for _ in range(cfg.fuser_layers))


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: MemoryEncoderConfig):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(cfg)
        self.pix_feat_proj = conv2d(cfg.in_dim, cfg.in_dim, 1)
        self.fuser = _Fuser(cfg)
        self.out_proj = conv2d(cfg.in_dim, cfg.out_dim, 1)

    def forward(self, pix_feat, masks):
        """pix_feat (B, h, w, in_dim); masks (B, 16h, 16w, 1) already
        sigmoid-scaled -> (B, h, w, out_dim) memory features."""
        x = conv_nhwc(self.pix_feat_proj, pix_feat) \
            + self.mask_downsampler(masks)
        for blk in self.fuser.layers:
            x = blk(x)
        return conv_nhwc(self.out_proj, x)
