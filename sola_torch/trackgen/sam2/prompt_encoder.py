"""SAM2 prompt encoder: points / boxes / masks -> sparse + dense embeddings.

Counterpart of ``sola_tpu/trackgen/sam2/prompt_encoder.py``. Point labels
follow SAM2's convention: -1 pad ("not a point"), 0 negative, 1 positive,
2/3 box corners; callers pad the point list with label -1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sola_torch.trackgen.sam2.common import (LayerNorm2d,
                                             RandomPositionEncoding,
                                             conv_nhwc, conv2d)


@dataclasses.dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: tuple = (64, 64)
    input_image_size: tuple = (1024, 1024)
    mask_in_chans: int = 16

    @classmethod
    def tiny_test(cls) -> "PromptEncoderConfig":
        return cls(embed_dim=32, image_embedding_size=(4, 4),
                   input_image_size=(64, 64), mask_in_chans=4)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        chans = cfg.mask_in_chans
        self.pe_layer = RandomPositionEncoding(d)
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        # facebook indices: 0 conv, 1 LN, 2 GELU, 3 conv, 4 LN, 5 GELU, 6 conv
        self.mask_downscaling = nn.Sequential(
            conv2d(1, chans // 4, 2, stride=2), LayerNorm2d(chans // 4),
            nn.GELU(), conv2d(chans // 4, chans, 2, stride=2),
            LayerNorm2d(chans), nn.GELU(), conv2d(chans, d, 1))

    def dense_pe(self) -> torch.Tensor:
        h, w = self.cfg.image_embedding_size
        return self.pe_layer.grid(h, w)  # (h, w, d)

    def embed_points(self, coords: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
        """coords (B, N, 2) in input-image pixels; labels (B, N) ints ->
        (B, N, d). Padding entries (label -1) get the not-a-point embedding
        with zero positional term."""
        cfg = self.cfg
        coords = coords + 0.5  # pixel centers
        # (W, H) filled on the device: no host-to-device copy, so a CUDA
        # graph can capture it
        norm = torch.empty(2, dtype=torch.float32, device=coords.device)
        norm[0].fill_(cfg.input_image_size[1])
        norm[1].fill_(cfg.input_image_size[0])
        pe = self.pe_layer(coords / norm)
        pad = (labels == -1)[..., None]
        pe = torch.where(pad, torch.zeros_like(pe), pe)
        table = torch.cat([e.weight for e in self.point_embeddings], dim=0)
        type_embed = torch.where(pad, self.not_a_point_embed.weight[0],
                                 table[labels.clamp(0, 3)])
        return pe + type_embed

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (B, N, 4) xyxy pixels -> (B, 2N, d) corner embeddings."""
        b, n, _ = boxes.shape
        corners = boxes.reshape(b, n * 2, 2)
        labels = torch.tensor([2, 3], device=boxes.device).repeat(b, n)
        return self.embed_points(corners, labels)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (B, 4*h, 4*w, 1) logits -> dense embeddings (B, h, w, d)."""
        md = self.mask_downscaling
        x = F.gelu(md[1](conv_nhwc(md[0], masks)))
        x = F.gelu(md[4](conv_nhwc(md[3], x)))
        return conv_nhwc(md[6], x)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        h, w = self.cfg.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.cfg.embed_dim)

    def forward(self, coords, labels, masks=None):
        sparse = self.embed_points(coords, labels)
        if masks is None:
            dense = self.no_mask_dense(coords.shape[0])
        else:
            dense = self.embed_masks(masks)
        return sparse, dense
