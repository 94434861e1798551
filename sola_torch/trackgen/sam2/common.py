"""Shared building blocks of the SAM2 port.

Counterpart of ``sola_tpu/trackgen/sam2/common.py``. Public functions keep
the JAX package's channels-last (B, H, W, C) layout and (B, H, L, D) heads,
so the tests compare like with like. Convolutions run through
``conv_nhwc``: the permuted view of a channels-last tensor is a
``channels_last`` NCHW tensor, which cuDNN takes without a copy.
Module attribute names follow the facebook SAM2 checkpoint keys.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sola_torch.core.mask_ops import resize_bilinear


class MLP(nn.Module):
    """N-layer MLP (SAM's MLP block, ``layers.{i}``); ReLU between layers
    unless another activation is given; optional sigmoid output."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False,
                 activation=F.relu):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims_in, dims_out))
        self.sigmoid_output = sigmoid_output
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over the last axis of (B, H, W, C) maps (SAM's
    LayerNorm2d, channels-last)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module (Conv2d / ConvTranspose2d) to (B, H, W, C)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
           padding: int = 0, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     groups=groups)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B*nW, window, window, C), padding H/W up to
    multiples."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, pad_hw, hw):
    """Inverse of window_partition, cropping any padding."""
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    c = x.shape[-1]
    x = x.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, :h, :w]


def sine_position_encoding(h: int, w: int, dim: int,
                           temperature: float = 10000.0,
                           normalize: bool = True,
                           scale: Optional[float] = None,
                           device=None) -> torch.Tensor:
    """DETR-style 2D sine position embedding -> (H, W, dim) fp32, SAM2's
    PositionEmbeddingSine (dim split between y and x; sin/cos
    interleaved)."""
    if scale is None:
        scale = 2.0 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    y = y.expand(h, w)
    x = x.expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    npf = dim // 2
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / npf)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(h, w, npf)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(h, w, npf)
    return torch.cat([pos_y, pos_x], dim=-1)


class RandomPositionEncoding(nn.Module):
    """SAM's PositionEmbeddingRandom: random-Fourier features of (x, y) in
    [0, 1], producing ``dim`` channels."""

    def __init__(self, dim: int, scale: float = 1.0):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, dim // 2))
        self.scale = scale  # std of the seeded init (convert.init_weights)

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1], shape (..., 2) -> (..., dim)."""
        g = self.positional_encoding_gaussian_matrix
        dt = torch.promote_types(coords.dtype, g.dtype)
        proj = (2.0 * coords.to(dt) - 1.0) @ g.to(dt)
        proj = 2.0 * np.pi * proj
        return torch.cat([proj.sin(), proj.cos()], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """Dense PE over a (h, w) grid of pixel centers -> (h, w, dim)."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.encode(torch.stack([gx, gy], dim=-1))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return self.encode(coords)


def _torch_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D interpolation matrix (n_out, n_in) of torch
    ``F.interpolate(mode="bicubic", align_corners=False)``: cubic-convolution
    kernel with A=-0.75, half-pixel sampling, clamped borders."""
    a = -0.75

    def cc1(t):  # |s| <= 1
        return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0

    def cc2(t):  # 1 < |s| < 2
        return ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a

    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        w = [cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t)]
        for k in range(4):
            j = min(max(i0 - 1 + k, 0), n_in - 1)
            m[i, j] += w[k]
    return m.astype(np.float32)


def torch_bicubic_resize(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C) through the two 1-D bicubic matrices
    (the JAX package's formulation; equal to torch bicubic, A=-0.75)."""
    mh = torch.from_numpy(_torch_bicubic_matrix(x.shape[0], out_h)).to(x)
    mw = torch.from_numpy(_torch_bicubic_matrix(x.shape[1], out_w)).to(x)
    return torch.einsum("Hh,Ww,hwc->HWc", mh, mw, x)


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) maps (align_corners=False,
    antialiased when it downscales, as ``jax.image.resize``)."""
    y = resize_bilinear(x.movedim(-1, -3), (out_h, out_w))
    return y.movedim(-3, -1)


def interpolate_nearest(x: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """Nearest resize of (B, H, W, C) maps, half-pixel-center floor
    indexing (``jax.image.resize(method="nearest")``)."""
    h, w = x.shape[-3], x.shape[-2]
    ri = torch.floor((torch.arange(out_h, dtype=torch.float64) + 0.5)
                     * h / out_h).long().to(x.device)
    ci = torch.floor((torch.arange(out_w, dtype=torch.float64) + 0.5)
                     * w / out_w).long().to(x.device)
    return x.index_select(-3, ri).index_select(-2, ci)


def attn_scale(head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(head_dim) rounded through ``dtype``, as the JAX modules form
    it (``1 / jnp.sqrt(jnp.asarray(d, dtype))``)."""
    d = torch.tensor(float(head_dim), dtype=dtype)
    return (1.0 / torch.sqrt(d)).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, L, D) head tensors as plain
    matmuls: fp32 logits and softmax, probabilities cast to q's dtype for
    the PV product."""
    # a CPU scalar: no host-to-device copy, so a CUDA graph can capture it
    scale = attn_scale(q.shape[-1], q.dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)
