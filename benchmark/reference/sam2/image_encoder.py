"""SAM2 image encoder: Hiera trunk + FPN neck + sine position encodings.

Counterpart of ``sola_tpu/trackgen/sam2/image_encoder.py``. Produces the
three feature levels SAM2's heads consume: stride-4 and stride-8 maps (mask
decoder skip connections) and the stride-16 image embedding that memory
attention and the mask decoder operate on.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from benchmark.reference.sam2.common import (conv_nhwc, interpolate_nearest,
                                             sine_position_encoding)
from benchmark.reference.sam2.hiera import Hiera, HieraConfig


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    hiera: HieraConfig = HieraConfig.large()
    d_model: int = 256
    # top-down levels that receive the upsampled coarser map (indices into
    # the stride-ascending list [4, 8, 16, 32]; SAM2 uses [2, 3])
    fpn_top_down_levels: tuple = (2, 3)

    @classmethod
    def tiny_test(cls) -> "ImageEncoderConfig":
        return cls(hiera=HieraConfig.tiny_test(), d_model=32)


class _LateralConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, x)


class FpnNeck(nn.Module):
    """1x1 lateral convs to d_model + nearest top-down pathway. ``convs``
    are coarsest-first, as in the facebook checkpoint."""

    def __init__(self, cfg: ImageEncoderConfig):
        super().__init__()
        self.cfg = cfg
        dims = cfg.hiera.output_dims
        self.convs = nn.ModuleList(_LateralConv(d, cfg.d_model)
                                   for d in reversed(dims))

    def forward(self, xs: list[torch.Tensor]):
        cfg = self.cfg
        n = len(xs)
        outs: list = [None] * n
        prev = None
        for i in range(n - 1, -1, -1):  # coarsest first
            x = self.convs[n - 1 - i](xs[i])
            if i in cfg.fpn_top_down_levels and prev is not None:
                x = x + interpolate_nearest(prev, x.shape[1], x.shape[2])
            outs[i] = x
            prev = x
        poss = [sine_position_encoding(o.shape[1], o.shape[2], cfg.d_model,
                                       device=o.device)[None].expand(o.shape)
                for o in outs]
        return outs, poss


class ImageEncoder(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig):
        super().__init__()
        self.trunk = Hiera(cfg.hiera)
        self.neck = FpnNeck(cfg)

    def forward(self, images: torch.Tensor) -> dict:
        """images: (B, H, W, 3), ImageNet-normalized. Returns backbone_fpn
        (stride 4, 8, 16 maps of d_model channels) and their sine PEs."""
        outs, poss = self.neck(self.trunk(images))
        return {"backbone_fpn": outs[:3], "vision_pos": poss[:3]}


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(image_uint8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> normalized fp32 (SAM2's transform)."""
    x = image_uint8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
