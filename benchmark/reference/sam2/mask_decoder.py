"""SAM2 mask decoder: two-way transformer + upscaling + prediction heads.

Counterpart of ``sola_tpu/trackgen/sam2/mask_decoder.py``. Decodes the
(memory-conditioned) image embedding and prompt tokens into mask logits,
IoU predictions, an object-presence score and the SAM output token that
becomes the per-frame ``obj_ptr`` (generate_tokens_grid.py:227-237).
The high-res skip projections ``conv_s0``/``conv_s1`` live here, where the
facebook checkpoint keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sam2.common import (MLP, LayerNorm2d, conv_nhwc,
                                             sdpa)


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    num_heads: int = 8
    num_multimask_outputs: int = 3
    attention_downsample_rate: int = 2
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    use_high_res_features: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    @classmethod
    def tiny_test(cls) -> "MaskDecoderConfig":
        return cls(transformer_dim=32, transformer_mlp_dim=64, num_heads=2,
                   iou_head_hidden_dim=32)

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


class DownsampledAttention(nn.Module):
    """SAM's Attention with internal-dim downsampling."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        d = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, d)
        self.k_proj = nn.Linear(embed_dim, d)
        self.v_proj = nn.Linear(embed_dim, d)
        self.out_proj = nn.Linear(d, embed_dim)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, lq, d = qp.shape
        lk = kp.shape[1]
        h = self.num_heads
        hd = d // h
        out = sdpa(qp.reshape(b, lq, h, hd).transpose(1, 2),
                   kp.reshape(b, lk, h, hd).transpose(1, 2),
                   vp.reshape(b, lk, h, hd).transpose(1, 2))
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d))


class _MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        d, h, r = (cfg.transformer_dim, cfg.num_heads,
                   cfg.attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(d, h)
        self.cross_attn_token_to_image = DownsampledAttention(d, h, r)
        self.cross_attn_image_to_token = DownsampledAttention(d, h, r)
        self.mlp = _MlpBlock(d, cfg.transformer_mlp_dim)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.norm4 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        d = cfg.transformer_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.transformer_depth))
        self.final_attn_token_to_image = DownsampledAttention(
            d, cfg.num_heads, cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/pe: (B, h, w, d); point_embedding: (B, N, d)."""
        b, h, w, d = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, d)
        key_pe = image_pe.reshape(b, h * w, d)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        attn = self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries + attn), keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.transformer_dim
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(cfg.num_mask_tokens, d)
        if cfg.pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, d)
            self.pred_obj_score_head = (MLP(d, d, 1, 3)
                                        if cfg.pred_obj_scores_mlp
                                        else nn.Linear(d, 1))
        # facebook indices: 0 ConvT, 1 LN2d, 2 GELU, 3 ConvT, 4 GELU
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(cfg.num_mask_tokens))
        # SAM2 builds the decoder with iou_prediction_use_sigmoid=True
        self.iou_prediction_head = MLP(d, cfg.iou_head_hidden_dim,
                                       cfg.num_mask_tokens,
                                       cfg.iou_head_depth,
                                       sigmoid_output=True)
        self.conv_s0 = nn.Conv2d(d, d // 8, 1)
        self.conv_s1 = nn.Conv2d(d, d // 4, 1)

    def forward(self, image_embedding, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool,
                high_res_features: Optional[tuple] = None):
        """image_embedding (B, h, w, d); sparse_prompt (B, N, d);
        dense_prompt (B, h, w, d); high_res_features = (s0 (B,4h,4w,d/8),
        s1 (B,2h,2w,d/4)) or None.

        Returns (masks (B, K, 4h, 4w) fp32, iou_pred (B, K), sam_token_out
        (B, d), object_score_logits (B, 1)); K = 3 if multimask else 1."""
        cfg = self.cfg
        b = sparse_prompt.shape[0]
        tokens = [self.iou_token.weight, self.mask_tokens.weight]
        s_offset = 0
        if cfg.pred_obj_scores:
            tokens = [self.obj_score_token.weight] + tokens
            s_offset = 1
        output_tokens = torch.cat(tokens, dim=0)
        output_tokens = output_tokens[None].expand(b, *output_tokens.shape)
        tokens = torch.cat([output_tokens, sparse_prompt], dim=1)

        src = image_embedding + dense_prompt
        pe = (image_pe[None] if image_pe.dim() == 3 else image_pe).expand(
            src.shape)
        hs, keys = self.transformer(src, pe, tokens)
        iou_token_out = hs[:, s_offset]
        mask_tokens_out = hs[:, s_offset + 1:s_offset + 1
                             + cfg.num_mask_tokens]

        h, w, d = src.shape[1], src.shape[2], src.shape[3]
        src = keys.reshape(b, h, w, d)
        up = self.output_upscaling
        x = conv_nhwc(up[0], src)
        if cfg.use_high_res_features and high_res_features is not None:
            s0, s1 = high_res_features
            x = x + s1
        x = F.gelu(up[1](x))
        x = conv_nhwc(up[3], x)
        if cfg.use_high_res_features and high_res_features is not None:
            x = x + s0
        upscaled = F.gelu(x)  # (B, 4h, 4w, d/8)

        hyper = torch.stack([
            self.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
            for i in range(cfg.num_mask_tokens)], dim=1)  # (B, K, d/8)
        # mask logits in fp32 (the JAX einsum's preferred_element_type)
        masks = torch.einsum("bkc,bhwc->bkhw", hyper.float(),
                             upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        if cfg.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = 10.0 * torch.ones(
                (b, 1), dtype=masks.dtype, device=masks.device)

        if multimask_output:
            out_masks = masks[:, 1:]
            out_iou = iou_pred[:, 1:]
            best = out_iou.argmax(dim=-1)
            rows = torch.arange(b, device=best.device)
            sam_token_out = mask_tokens_out[:, 1:][rows, best]
        elif cfg.dynamic_multimask_via_stability:
            out_masks, out_iou, sam_token_out = self._stable_single(
                masks, iou_pred, mask_tokens_out)
        else:
            out_masks = masks[:, 0:1]
            out_iou = iou_pred[:, 0:1]
            sam_token_out = mask_tokens_out[:, 0]
        return out_masks, out_iou, sam_token_out, object_score_logits

    def _stable_single(self, masks, iou_pred, mask_tokens_out):
        """Single-mask output with the dynamic stability fallback: an
        unstable token-0 mask is replaced by the best multimask output; the
        SAM token stays token 0 either way (upstream
        mask_decoder._dynamic_multimask_via_stability)."""
        cfg = self.cfg
        delta = cfg.dynamic_multimask_stability_delta
        m0 = masks[:, 0]
        area_i = (m0 > delta).sum(dim=(-2, -1)).float()
        area_u = (m0 > -delta).sum(dim=(-2, -1)).float()
        stability = torch.where(area_u > 0, area_i / area_u.clamp_min(1.0),
                                torch.ones_like(area_u))
        is_stable = stability >= cfg.dynamic_multimask_stability_thresh
        multi_iou = iou_pred[:, 1:]
        best = multi_iou.argmax(dim=-1)
        rows = torch.arange(masks.shape[0], device=masks.device)
        best_mask = masks[:, 1:][rows, best]
        best_iou = multi_iou[rows, best]
        out_mask = torch.where(is_stable[:, None, None], m0, best_mask)
        out_iou = torch.where(is_stable, iou_pred[:, 0], best_iou)
        return out_mask[:, None], out_iou[:, None], mask_tokens_out[:, 0]
