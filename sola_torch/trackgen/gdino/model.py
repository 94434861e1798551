"""GroundingDINO in PyTorch: open-vocabulary detection for prompt generation.

Counterpart of ``sola_tpu/trackgen/gdino/model.py`` (IDEA-Research
GroundingDINO, the SwinT-OGC model the reference loads at
generate_prompts_gdino.py:33-34):

* Swin-T backbone (3 stages) + 1x1 projections + an extra stride-64 level;
* BERT text encoder with sub-sentence self-attention masks and per-phrase
  position ids (generate_masks_with_special_tokens semantics);
* feature enhancer: 6 x {image<->text bidirectional fusion (BiMHA with layer
  scale), text self-attention enhancer, image deformable self-attention};
* two-stage language-guided query selection over masked proposals;
* cross-modality decoder: 6 x {self-attn, query->text cross-attn,
  query->image deformable attn} with shared-head iterative box refinement;
* contrastive embedding head -> (pred_logits, pred_boxes).

Module names follow the HF ``GroundingDinoForObjectDetection`` checkpoint,
so an HF-named state dict loads with plain ``load_state_dict``. Every
deformable attention call (6 encoder + 6 decoder layers per forward) goes
through ``ops.deformable_interp.ms_deform_attn``: the hand-written CUDA
kernel on the card. Images ride on a fixed padded canvas with a pixel mask,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sola_torch.core.mask_ops import resize_bilinear
from sola_torch.device import resolve_device
from sola_torch.models.text import RobertaConfig, RobertaEncoder
from sola_torch.trackgen.gdino.deformable import MSDeformAttn
from sola_torch.trackgen.gdino.swin import SwinConfig, SwinTransformer
from sola_torch.trackgen.sam2.common import MLP

NEG_INF = float("-inf")
GN_EPS = 1e-6  # flax nn.GroupNorm's default epsilon


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    swin: SwinConfig = SwinConfig()
    text: RobertaConfig = RobertaConfig.bert_base()
    d_model: int = 256
    n_heads: int = 8
    n_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_queries: int = 900
    max_text_len: int = 256
    # sine PE temperature over image features (GroundingDINO uses 20)
    pe_temperature: float = 20.0
    layer_norm_eps: float = 1e-5
    # inference canvas: shorter side target / longer side cap (upstream
    # RandomResize([800], max_size=1333))
    size_target: int = 800
    size_max: int = 1333

    @classmethod
    def tiny_test(cls) -> "GDINOConfig":
        return cls(swin=SwinConfig.tiny_test(),
                   text=dataclasses.replace(
                       RobertaConfig.tiny(), position_style="bert",
                       pad_token_id=0),
                   d_model=32, n_heads=2, n_levels=4, enc_n_points=2,
                   dec_n_points=2, enc_layers=1, dec_layers=1,
                   dim_feedforward=64, num_queries=20, max_text_len=32,
                   size_target=64, size_max=64)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _dim_t(n: int, temperature: float, device) -> torch.Tensor:
    d = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor") / n)


def _interleave(p: torch.Tensor) -> torch.Tensor:
    """sin on even, cos on odd channels, interleaved (upstream layout)."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int,
                       temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """Upstream get_sine_pos_embed: (..., n) -> (..., n * num_pos_feats)."""
    dim_t = _dim_t(num_pos_feats, temperature, pos.device)
    parts = [_interleave(pos[..., i, None] * (2.0 * math.pi) / dim_t)
             for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def sine_pos_from_mask(mask: torch.Tensor, d_model: int,
                       temperature: float) -> torch.Tensor:
    """Mask-aware image sine PE (upstream GroundingDinoSinePositionEmbedding):
    mask (B, H, W) bool valid -> (B, H, W, d_model) fp32."""
    m = mask.to(torch.float32)
    y = torch.cumsum(m, dim=1)
    x = torch.cumsum(m, dim=2)
    eps = 1e-6
    scale = 2.0 * math.pi
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    half = d_model // 2
    dim_t = _dim_t(half, temperature, mask.device)
    return torch.cat([_interleave(y[..., None] / dim_t),
                      _interleave(x[..., None] / dim_t)], dim=-1)


# BERT [CLS], [SEP], '.', '?' — phrases are the spans between these
BERT_SPECIAL_TOKENS = (101, 102, 1012, 1029)


def generate_special_token_masks(input_ids: np.ndarray,
                                 special_tokens=BERT_SPECIAL_TOKENS):
    """Host-side replica of upstream generate_masks_with_special_tokens_and
    _transfer_map: per-phrase block-diagonal self-attention masks + position
    ids restarting at 0 inside each phrase.

    Returns (attention_mask (B, L, L) bool, position_ids (B, L) int32).
    """
    input_ids = np.asarray(input_ids)
    bs, num_token = input_ids.shape
    special = np.isin(input_ids, np.asarray(special_tokens))
    attention_mask = np.broadcast_to(np.eye(num_token, dtype=bool),
                                     (bs, num_token, num_token)).copy()
    position_ids = np.zeros((bs, num_token), np.int64)
    idxs = np.argwhere(special)
    previous_col = 0
    for row, col in idxs:
        if col in (0, num_token - 1):
            attention_mask[row, col, col] = True
            position_ids[row, col] = 0
        else:
            attention_mask[row, previous_col + 1: col + 1,
                           previous_col + 1: col + 1] = True
            position_ids[row, previous_col + 1: col + 1] = np.arange(
                0, col - previous_col)
        previous_col = col
    return attention_mask, position_ids.astype(np.int32)


class BiMultiHeadAttention(nn.Module):
    """Upstream GroundingDinoBiMultiHeadAttention: embed = ffn_dim // 2,
    heads = n_heads // 2, scaled vision queries, global-max subtraction and
    +-50000 clamping, separate value projections each side."""

    def __init__(self, d_model: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.vision_proj = nn.Linear(d_model, embed_dim)
        self.text_proj = nn.Linear(d_model, embed_dim)
        self.values_vision_proj = nn.Linear(d_model, embed_dim)
        self.values_text_proj = nn.Linear(d_model, embed_dim)
        self.out_vision_proj = nn.Linear(embed_dim, d_model)
        self.out_text_proj = nn.Linear(embed_dim, d_model)

    def forward(self, vision, text, vision_pad_mask, text_pad_mask):
        """vision (B, Li, d); text (B, Lt, d); pad masks True = PADDING."""
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        b, li, _ = vision.shape
        lt = text.shape[1]
        vq = (self.vision_proj(vision) * hd ** -0.5).reshape(b, li, h, hd)
        tk = self.text_proj(text).reshape(b, lt, h, hd)
        vv = self.values_vision_proj(vision).reshape(b, li, h, hd)
        tv = self.values_text_proj(text).reshape(b, lt, h, hd)

        attn = torch.einsum("bihd,bthd->bhit", vq.float(), tk.float())
        attn = attn - attn.max()  # global max, as upstream
        attn = attn.clamp(-50000.0, 50000.0)
        attn_t = attn.transpose(-1, -2)  # (B, h, Lt, Li)
        attn_t = attn_t - attn_t.amax(dim=-1, keepdim=True)
        attn_t = attn_t.clamp(-50000.0, 50000.0)
        if vision_pad_mask is not None:
            attn_t = attn_t.masked_fill(vision_pad_mask[:, None, None, :],
                                        NEG_INF)
        text_attn = torch.softmax(attn_t, dim=-1)
        if text_pad_mask is not None:
            attn = attn.masked_fill(text_pad_mask[:, None, None, :], NEG_INF)
        vision_attn = torch.softmax(attn, dim=-1)
        # probabilities cast to the value dtype before PV
        v_out = torch.einsum("bhit,bthd->bihd", vision_attn.to(tv.dtype), tv)
        t_out = torch.einsum("bhti,bihd->bthd", text_attn.to(vv.dtype), vv)
        v_out = self.out_vision_proj(v_out.reshape(b, li, e).to(vision.dtype))
        t_out = self.out_text_proj(t_out.reshape(b, lt, e).to(text.dtype))
        return v_out, t_out


class FusionLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d = cfg.d_model
        self.layer_norm_vision = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layer_norm_text = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = BiMultiHeadAttention(d, cfg.dim_feedforward // 2,
                                         cfg.n_heads // 2)
        self.vision_param = nn.Parameter(torch.full((d,), 1e-4))
        self.text_param = nn.Parameter(torch.full((d,), 1e-4))

    def forward(self, vision, text, vision_pad_mask, text_pad_mask):
        vision = self.layer_norm_vision(vision)
        text = self.layer_norm_text(text)
        dv, dt = self.attn(vision, text, vision_pad_mask, text_pad_mask)
        return vision + self.vision_param * dv, text + self.text_param * dt


class PlainMHA(nn.Module):
    """Upstream GroundingDinoMultiheadAttention (batch-first, additive
    mask)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_bias=None):
        b, lq, d = q.shape
        h = self.num_heads
        hd = d // h
        lk = k.shape[1]
        qh = self.query(q).reshape(b, lq, h, hd).transpose(1, 2)
        kh = self.key(k).reshape(b, lk, h, hd).transpose(1, 2)
        vh = self.value(v).reshape(b, lk, h, hd).transpose(1, 2)
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.matmul(probs, vh).transpose(1, 2).reshape(b, lq, d)
        return self.out_proj(out)


def _ffn(fc1: nn.Linear, fc2: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return fc2(F.relu(fc1(x)))


class TextEnhancerLayer(nn.Module):
    """Text self-attention within sub-sentence blocks (post-norm)."""

    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = PlainMHA(d, cfg.n_heads // 2)
        self.layer_norm_before = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward // 2)
        self.fc2 = nn.Linear(cfg.dim_feedforward // 2, d)
        self.layer_norm_after = nn.LayerNorm(d, eps=eps)

    def forward(self, text, self_mask_bias, pos_embed):
        q = text + pos_embed
        attn = self.self_attn(q, q, text, self_mask_bias)
        text = self.layer_norm_before(text + attn)
        return self.layer_norm_after(text + _ffn(self.fc1, self.fc2, text))


class DeformableLayer(nn.Module):
    """Image deformable self-attention + FFN (post-norm)."""

    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MSDeformAttn(d, cfg.n_levels, cfg.n_heads,
                                      cfg.enc_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, vision, pos_embed, reference_points, spatial_shapes,
                valid_mask):
        attn = self.self_attn(vision + pos_embed, reference_points, vision,
                              spatial_shapes, value_mask=valid_mask)
        vision = self.self_attn_layer_norm(vision + attn)
        return self.final_layer_norm(vision
                                     + _ffn(self.fc1, self.fc2, vision))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg)
        self.text_enhancer_layer = TextEnhancerLayer(cfg)
        self.deformable_layer = DeformableLayer(cfg)

    def forward(self, vision, text, pos_embed, reference_points,
                spatial_shapes, vision_valid, text_valid, text_self_bias,
                text_pos):
        fused_v, fused_t = self.fusion_layer(
            vision, text, vision_pad_mask=~vision_valid,
            text_pad_mask=~text_valid)
        # text self-attention restricted to sub-sentence blocks
        fused_t = self.text_enhancer_layer(fused_t, text_self_bias, text_pos)
        fused_v = self.deformable_layer(fused_v, pos_embed, reference_points,
                                        spatial_shapes, vision_valid)
        return fused_v, fused_t


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = PlainMHA(d, cfg.n_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn_text = PlainMHA(d, cfg.n_heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = MSDeformAttn(d, cfg.n_levels, cfg.n_heads,
                                         cfg.dec_n_points)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, tgt, query_pos, reference_points, vision, text,
                spatial_shapes, vision_valid, text_bias):
        q = tgt + query_pos
        tgt = self.self_attn_layer_norm(tgt + self.self_attn(q, q, tgt))
        attn = self.encoder_attn_text(tgt + query_pos, text, text, text_bias)
        tgt = self.encoder_attn_text_layer_norm(tgt + attn)
        attn = self.encoder_attn(tgt + query_pos, reference_points, vision,
                                 spatial_shapes, value_mask=vision_valid)
        tgt = self.encoder_attn_layer_norm(tgt + attn)
        return self.final_layer_norm(tgt + _ffn(self.fc1, self.fc2, tgt))


def contrastive_logits(queries, text, text_valid, max_text_len):
    """(B, nq, d) x (B, Lt, d) -> (B, nq, max_text_len) fp32, -inf padded."""
    logits = torch.einsum("bqd,btd->bqt", queries.float(), text.float())
    logits = logits.masked_fill(~text_valid[:, None, :], NEG_INF)
    pad = max_text_len - logits.shape[-1]
    if pad > 0:
        logits = F.pad(logits, (0, pad), value=NEG_INF)
    return logits[:, :, :max_text_len]


# ---------------------------------------------------------------------------
# Containers that give the parameters their HF checkpoint names
# ---------------------------------------------------------------------------

class _ConvEncoder(nn.Module):
    def __init__(self, swin: SwinTransformer):
        super().__init__()
        self.model = swin


class _Backbone(nn.Module):
    def __init__(self, swin: SwinTransformer):
        super().__init__()
        self.conv_encoder = _ConvEncoder(swin)


class _Encoder(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.enc_layers))


class _Decoder(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.dec_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.reference_points_head = MLP(2 * d, d, d, 2)


class _GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics that also takes a group of one value
    (torch's ``group_norm`` refuses it; flax normalizes it to the bias). The
    tiny test config has one channel per group and a 1x1 last level."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float().reshape(x.shape[0], self.num_groups, -1)
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (y * self.weight.float().view(shape)
                + self.bias.float().view(shape)).to(x.dtype)


def _group_norm(d: int) -> nn.GroupNorm:
    return _GroupNorm(32 if d % 32 == 0 else 1, d, eps=GN_EPS)


class _GDinoModel(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d = cfg.d_model
        # the JAX package sizes Swin's bias tables at its init canvas
        swin = SwinTransformer(cfg.swin,
                               image_hw=(cfg.size_target, cfg.size_target))
        self.backbone = _Backbone(swin)
        self.text_backbone = RobertaEncoder(cfg.text)
        self.text_projection = nn.Linear(cfg.text.hidden_size, d)
        dims = [cfg.swin.stage_dims[i] for i in cfg.swin.out_indices]
        proj = [nn.Sequential(nn.Conv2d(c, d, 1), _group_norm(d))
                for c in dims]
        if cfg.n_levels > len(dims):  # one extra stride-2 level
            proj.append(nn.Sequential(
                nn.Conv2d(dims[-1], d, 3, stride=2, padding=1),
                _group_norm(d)))
        self.input_proj_vision = nn.ModuleList(proj)
        self.level_embed = nn.Parameter(torch.zeros(cfg.n_levels, d))
        self.encoder = _Encoder(cfg)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder_output_bbox_embed = MLP(d, d, 4, 3)
        self.query_position_embeddings = nn.Embedding(cfg.num_queries, d)
        self.decoder = _Decoder(cfg)


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _GDinoModel(cfg)
        # decoder_bbox_embed_share=True: one head shared by every layer
        self.bbox_embed = nn.ModuleList([MLP(cfg.d_model, cfg.d_model, 4, 3)])

    def forward(self, images: torch.Tensor, pixel_mask: torch.Tensor,
                input_ids: torch.Tensor, token_mask: torch.Tensor,
                text_self_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> dict:
        """images (B, H, W, 3) normalized on a padded canvas; pixel_mask
        (B, H, W) bool True = valid pixels; input_ids/token_mask (B, Lt);
        text_self_mask (B, Lt, Lt) bool sub-sentence blocks; position_ids
        (B, Lt) per-phrase positions.

        Returns {"pred_logits": (B, nq, max_text_len) fp32 (-inf padded),
        "pred_boxes": (B, nq, 4) cxcywh in [0,1], "encoder_text",
        "init_reference_points"}.

        Expression batching: when the text batch E exceeds the image batch
        (allowed only for image batch 1), the vision backbone runs once and
        its features broadcast to E before the fused encoder."""
        cfg = self.cfg
        m = self.model
        dev = images.device
        b = images.shape[0]
        token_mask = token_mask.bool()
        lt = input_ids.shape[1]
        if text_self_mask is None:
            # always keep the diagonal so padded rows have one key
            text_self_mask = ((token_mask[:, :, None] & token_mask[:, None, :])
                              | torch.eye(lt, dtype=torch.bool, device=dev))
        if position_ids is None:
            position_ids = torch.arange(lt, device=dev)[None].expand(
                input_ids.shape)

        # ---- text backbone + projection ----
        txt = m.text_projection(m.text_backbone(input_ids, text_self_mask,
                                                position_ids=position_ids))

        # ---- vision backbone -> 4 levels + per-level masks/PE ----
        feats = m.backbone.conv_encoder.model(images)
        levels = []
        for i, proj in enumerate(m.input_proj_vision):
            src = feats[i] if i < len(feats) else feats[-1]
            levels.append(proj(src.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))

        def level_mask(v):
            # upstream: F.interpolate(mask.float(), feat hw).to(bool) with
            # the default nearest mode: src index = floor(dst * in/out)
            oh, ow = v.shape[1], v.shape[2]
            ih, iw = pixel_mask.shape[1], pixel_mask.shape[2]
            yi = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev)
                             * (ih / oh)).long()
            xi = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev)
                             * (iw / ow)).long()
            return pixel_mask[:, yi][:, :, xi]

        masks = [level_mask(v) for v in levels]

        # expression batching: one backbone pass fans out to E text rows
        bt = input_ids.shape[0]
        if bt != b:
            if b != 1:
                raise ValueError("text batch > image batch requires image "
                                 "batch 1")
            levels = [v.expand((bt,) + v.shape[1:]) for v in levels]
            masks = [mk.expand((bt,) + mk.shape[1:]) for mk in masks]
            b = bt

        spatial_shapes = [(v.shape[1], v.shape[2]) for v in levels]
        d = cfg.d_model
        flat = torch.cat([v.reshape(b, -1, d) for v in levels], dim=1)
        # PEs are built in fp32 and cast to the feature dtype at the join
        pos_flat = torch.cat(
            [(sine_pos_from_mask(mk, d, cfg.pe_temperature)
              + m.level_embed[i]).reshape(b, -1, d)
             for i, mk in enumerate(masks)], dim=1).to(flat.dtype)
        valid_flat = torch.cat([mk.reshape(b, -1) for mk in masks], dim=1)

        # valid ratios per level (upstream get_valid_ratio)
        valid_ratios = torch.stack([
            torch.stack([mk[:, 0, :].float().sum(1) / mk.shape[2],
                         mk[:, :, 0].float().sum(1) / mk.shape[1]], dim=-1)
            for mk in masks], dim=1)  # (B, n_levels, [w, h])

        # encoder reference points (per level grid scaled by valid ratios)
        refs = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                indexing="ij")
            ref = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
            wh = torch.tensor([w, h], dtype=torch.float32, device=dev)
            refs.append(ref[None] / (valid_ratios[:, None, lvl] * wh))
        ref_pts = torch.cat(refs, dim=1)  # (B, L, 2)
        enc_ref = ref_pts[:, :, None, :] * valid_ratios[:, None]

        # text position embedding and sub-sentence bias for the enhancer
        text_pos = get_sine_pos_embed(position_ids[..., None].float(), d,
                                      exchange_xy=False).to(txt.dtype)
        text_self_bias = torch.zeros(text_self_mask.shape, device=dev
                                     ).masked_fill(~text_self_mask,
                                                   NEG_INF)[:, None]

        # ---- feature enhancer ----
        for layer in m.encoder.layers:
            flat, txt = layer(flat, txt, pos_flat, enc_ref, spatial_shapes,
                              valid_flat, token_mask, text_self_bias,
                              text_pos)

        # ---- two-stage query selection ----
        proposals = []
        start = 0
        for lvl, (h, w) in enumerate(spatial_shapes):
            mk = valid_flat[:, start:start + h * w].reshape(b, h, w)
            vh = mk[:, :, 0].float().sum(1)
            vw = mk[:, 0, :].float().sum(1)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = torch.stack([gx, gy], -1)[None]  # (1, h, w, 2)
            scale = torch.stack([vw, vh], -1).reshape(b, 1, 1, 2)
            grid = (grid + 0.5) / scale
            wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
            proposals.append(torch.cat([grid, wh], -1).reshape(b, -1, 4))
            start += h * w
        output_proposals = torch.cat(proposals, dim=1)
        proposals_valid = ((output_proposals > 0.01)
                           & (output_proposals < 0.99)).all(-1, keepdim=True)
        output_proposals = torch.log(output_proposals
                                     / (1.0 - output_proposals))
        bad = (~valid_flat[..., None]) | (~proposals_valid)
        output_proposals = output_proposals.masked_fill(bad, math.inf)

        object_query = flat.masked_fill(bad, 0.0)
        object_query = m.enc_output_norm(m.enc_output(object_query))
        enc_logits = contrastive_logits(object_query, txt, token_mask,
                                        cfg.max_text_len)
        enc_coord_logits = (m.encoder_output_bbox_embed(object_query)
                            + output_proposals)

        nq = min(cfg.num_queries, enc_logits.shape[1])
        topk_scores = torch.where(torch.isfinite(enc_logits), enc_logits,
                                  torch.full_like(enc_logits, -1e30)
                                  ).amax(dim=-1)
        # a stable descending sort orders ties by lower index first, as
        # jax.lax.top_k does
        topk = torch.sort(topk_scores, dim=1, descending=True,
                          stable=True).indices[:, :nq]
        topk_coords = torch.gather(enc_coord_logits, 1,
                                   topk[..., None].expand(-1, -1, 4))
        reference_points = torch.sigmoid(topk_coords.float())
        init_reference_points = reference_points

        tgt = m.query_position_embeddings.weight[None, :nq].expand(b, nq, d)

        # ---- decoder with shared-head iterative refinement ----
        dec = m.decoder
        head_dtype = dec.reference_points_head.layers[0].weight.dtype
        text_bias = torch.zeros(token_mask.shape, device=dev).masked_fill(
            ~token_mask, NEG_INF)[:, None, None, :]
        ratios4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        for layer in dec.layers:
            ref_input = reference_points[:, :, None] * ratios4
            query_pos = dec.reference_points_head(get_sine_pos_embed(
                ref_input[:, :, 0, :], d // 2).to(head_dtype)).to(tgt.dtype)
            tgt = layer(tgt, query_pos, ref_input, flat, txt,
                        spatial_shapes, valid_flat, text_bias)
            delta = self.bbox_embed[0](tgt)
            reference_points = torch.sigmoid(
                delta + inverse_sigmoid(reference_points))

        final = dec.layer_norm(tgt)
        logits = contrastive_logits(final, txt, token_mask, cfg.max_text_len)
        return {"pred_logits": logits, "pred_boxes": reference_points,
                "encoder_text": txt,
                "init_reference_points": init_reference_points}


@torch.no_grad()
def init_weights(model: GroundingDINO, seed: int = 0) -> None:
    """Seeded random init from one ``torch.Generator`` (CPU tensors):
    lecun-normal weights and zero biases for linear and conv layers, unit
    norms, N(0, 1/dim) token embeddings, the JAX package's N(0, 1) level and
    query embeddings, N(0, 0.02) Swin bias tables, 1e-4 fusion layer scales,
    zero token-type embeddings and zero sampling offsets."""
    g = torch.Generator().manual_seed(seed)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = mod.weight
            normal_(w, (w.shape[1] * int(np.prod(w.shape[2:]))) ** -0.5)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, mod.weight.shape[1] ** -0.5)
        elif isinstance(mod, MSDeformAttn):
            nn.init.zeros_(mod.sampling_offsets.weight)
            nn.init.zeros_(mod.sampling_offsets.bias)
    m = model.model
    normal_(m.level_embed, 1.0)
    normal_(m.query_position_embeddings.weight, 1.0)
    nn.init.zeros_(m.text_backbone.embeddings.token_type_embeddings.weight)
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            normal_(p, 0.02)
        elif name.endswith(("vision_param", "text_param")):
            nn.init.constant_(p, 1e-4)


# ---------------------------------------------------------------------------
# Preprocessing (upstream datasets.transforms semantics)
# ---------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_shape(h: int, w: int, target: int, max_size: int):
    """Upstream get_size_with_aspect_ratio: shorter side -> target, capped so
    the longer side stays <= max_size."""
    if max_size is not None:
        min_side, max_side = float(min(h, w)), float(max(h, w))
        if max_side / min_side * target > max_size:
            target = int(round(max_size * min_side / max_side))
    if (h <= w and h == target) or (w <= h and w == target):
        return h, w
    if h < w:
        oh = target
        ow = int(round(target * w / h))
    else:
        ow = target
        oh = int(round(target * h / w))
    return oh, ow


def preprocess_image(image: np.ndarray, cfg: GDINOConfig, device="cpu"):
    """uint8 (H, W, 3) -> (canvas (ch, cw, 3) fp32, pixel_mask (ch, cw)
    bool, (oh, ow)) on ``device``: linear resize (antialiased only when it
    downscales, as ``jax.image.resize``), normalize, pad onto the fixed
    canvas; the mask carries the true extent. The raw image crosses to the
    device as uint8."""
    h, w = image.shape[:2]
    oh, ow = resize_shape(h, w, cfg.size_target, cfg.size_max)
    ch = cfg.size_max if oh > ow else cfg.size_target
    cw = cfg.size_max if ow >= oh else cfg.size_target
    ch, cw = max(ch, oh), max(cw, ow)
    raw = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    img = resize_bilinear(raw.permute(2, 0, 1).float(), (oh, ow))
    img = img.permute(1, 2, 0) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=img.device)
    canvas[:oh, :ow] = (img - mean) / std
    mask = ((torch.arange(ch, device=img.device)[:, None] < oh)
            & (torch.arange(cw, device=img.device)[None, :] < ow))
    return canvas, mask, (oh, ow)


# ---------------------------------------------------------------------------
# Inference wrapper with the PromptGenerator-facing API
# ---------------------------------------------------------------------------

def _pad_tokens(tok: tuple, n: int, pad_id: int) -> tuple:
    """Pad one text's (ids, mask, sub-sentence mask, position ids) to
    ``n`` tokens after its masks were made, so that its padding takes part
    in nothing and it gives what it gives alone. The hash tokenizer pads a
    text only to its own length; the JAX package concatenates such texts
    unpadded, which fails when their word counts differ."""
    ids, mask, smask, pids = tok
    k = n - ids.shape[1]
    if k == 0:
        return tok
    smask = np.pad(smask, ((0, 0), (0, k), (0, k)))
    smask[:, np.arange(n), np.arange(n)] = True
    return (np.pad(ids, ((0, 0), (0, k)), constant_values=pad_id),
            np.pad(mask, ((0, 0), (0, k))), smask,
            np.pad(pids, ((0, 0), (0, k))))


class GroundingModel:
    """get_boxes(image, text) facade over the GroundingDINO forward."""

    # expression-batch cap: the fused encoder's buffers scale with E x ~22k
    # vision tokens; 8 keeps peak memory bounded while still amortizing the
    # Swin trunk
    max_expr_batch: int = 8

    def __init__(self, model: GroundingDINO, tokenizer=None,
                 max_text_len: int = 64, compute_dtype=None):
        """``compute_dtype=torch.bfloat16`` casts the model for bf16
        compute (fp32 constants inside re-promote locally where stability
        needs it); outputs are fetched and thresholded in fp32."""
        if compute_dtype is not None:
            model = model.to(compute_dtype)
        self.model = model.eval()
        self.cfg: GDINOConfig = model.cfg
        self.device = next(model.parameters()).device
        self.compute_dtype = compute_dtype
        self.hf_tokenizer = tokenizer is not None and hasattr(
            tokenizer, "decode")
        if tokenizer is None:
            from sola_torch.models.text import HashTokenizer
            tokenizer = HashTokenizer(self.cfg.text.vocab_size,
                                      self.cfg.text.pad_token_id)
        self.tokenizer = tokenizer
        self.max_text_len = min(max_text_len, self.cfg.max_text_len)

    def _tokenize(self, text: str):
        if self.hf_tokenizer:
            out = self.tokenizer([text], return_tensors="np",
                                 padding="max_length", truncation=True,
                                 max_length=self.max_text_len)
            ids = np.asarray(out["input_ids"], np.int32)
            mask = np.asarray(out["attention_mask"], np.int32)
        else:
            ids, mask = self.tokenizer([text], max_len=self.max_text_len)
            ids = np.asarray(ids, np.int32)
            mask = np.asarray(mask, np.int32)
        if self.hf_tokenizer or not hasattr(self.tokenizer, "bos_token_id"):
            specials = BERT_SPECIAL_TOKENS
        else:  # HashTokenizer: sentence boundaries are its bos/eos
            specials = (self.tokenizer.bos_token_id,
                        self.tokenizer.eos_token_id)
        smask, pids = generate_special_token_masks(ids, specials)
        # restrict sub-sentence blocks to real tokens
        smask = smask & (mask[:, None, :] > 0) & (mask[:, :, None] > 0)
        smask |= np.eye(ids.shape[1], dtype=bool)[None]
        return ids, mask, smask, pids

    def get_boxes(self, image: np.ndarray, text: str,
                  box_threshold: float = 0.2,
                  text_threshold: float = 0.25) -> list[dict]:
        """Returns [{"bbox": xyxy pixels, "phrase": str,
        "token_score": [...]}] (prompt_generator.py:133-160 semantics)."""
        return self.get_boxes_many(image, [text], box_threshold,
                                   text_threshold)[0]

    def get_boxes_many(self, image: np.ndarray, texts: Sequence[str],
                       box_threshold: float = 0.2,
                       text_threshold: float = 0.25) -> list[list[dict]]:
        """All expressions of one frame in one forward: the Swin trunk runs
        once and the text-fused encoder/decoder batch over expressions
        (padded to a multiple of 4; chunked at ``max_expr_batch``). Returns
        one pred list per text, equal to per-text ``get_boxes``."""
        return self.harvest_boxes(
            self.enqueue_boxes(image, texts), box_threshold, text_threshold)

    @torch.no_grad()
    def enqueue_boxes(self, image: np.ndarray, texts: Sequence[str]):
        """Device phase of ``get_boxes_many``: tokenize and launch the
        forward(s); returns a pending record holding device outputs, so a
        caller can enqueue the next frame before fetching this one."""
        if not texts:
            return (image.shape[:2], [])
        cap = self.max_expr_batch
        pendings = []
        canvas, pmask, _ = preprocess_image(image, self.cfg, self.device)
        if self.compute_dtype is not None:
            canvas = canvas.to(self.compute_dtype)
        for s in range(0, len(texts), cap):
            chunk = texts[s:s + cap]
            toks = [self._tokenize(t) for t in chunk]
            e = len(toks)
            e_pad = max(((e + 3) // 4) * 4, 1) if e != 1 else 1
            toks = toks + [toks[0]] * (e_pad - e)
            n = max(t[0].shape[1] for t in toks)
            ids, tmask, smask, pids = (np.concatenate(
                [_pad_tokens(t, n, self.cfg.text.pad_token_id)[i]
                 for t in toks], 0) for i in range(4))
            dev = self.device
            out = self.model(canvas[None], pmask[None],
                             torch.from_numpy(ids).to(dev),
                             torch.from_numpy(tmask).to(dev),
                             torch.from_numpy(smask).to(dev),
                             torch.from_numpy(pids).to(dev))
            pendings.append((chunk, ids, tmask, {
                k: out[k] for k in ("pred_logits", "pred_boxes")}))
        return (image.shape[:2], pendings)

    def harvest_boxes(self, pending, box_threshold: float = 0.2,
                      text_threshold: float = 0.25) -> list[list[dict]]:
        """Host phase of ``get_boxes_many``: fetch + threshold + phrases."""
        (h, w), pendings = pending
        results = []
        for chunk, ids, tmask, out in pendings:
            results.extend(self._postprocess(
                chunk, ids, tmask, out, h, w, box_threshold, text_threshold))
        return results

    def _postprocess(self, texts, ids, tmask, out, h, w,
                     box_threshold, text_threshold) -> list[list[dict]]:
        # sigmoid on the host, as the JAX package does
        raw = out["pred_logits"].float().cpu().numpy()
        with np.errstate(over="ignore"):
            logits_all = 1.0 / (1.0 + np.exp(-raw))
        logits_all = np.where(np.isfinite(logits_all), logits_all, 0.0)
        boxes_all = out["pred_boxes"].float().cpu().numpy()
        results = []
        for ti, text in enumerate(texts):
            logits = logits_all[ti]
            boxes = boxes_all[ti]
            n_tokens = int(tmask[ti].sum())
            keep = logits.max(axis=-1) > box_threshold
            preds = []
            for i in np.nonzero(keep)[0]:
                cx, cy, bw, bh = boxes[i]
                bbox = np.asarray([
                    (cx - bw / 2) * w, (cy - bh / 2) * h,
                    (cx + bw / 2) * w, (cy + bh / 2) * h,
                ], np.float32)
                token_mask = logits[i, :n_tokens] > text_threshold
                phrase = self._phrase_from_posmap(ids[ti], token_mask, text)
                preds.append({
                    "phrase": phrase,
                    "bbox": bbox,
                    "token_score": logits[i, :n_tokens].tolist(),
                })
            results.append(preds)
        return results

    def _phrase_from_posmap(self, input_ids: np.ndarray,
                            token_mask: np.ndarray, text: str) -> str:
        """Upstream get_phrases_from_posmap: decode the token ids the posmap
        selects (BPE-correct with a real tokenizer); the hash tokenizer maps
        positions onto whitespace words."""
        if self.hf_tokenizer:
            sel = [int(input_ids[i]) for i in np.nonzero(token_mask)[0]
                   if int(input_ids[i]) not in BERT_SPECIAL_TOKENS]
            return self.tokenizer.decode(sel)
        words = text.rstrip(".").split()
        picked = [words[i - 1] for i in range(1, len(words) + 1)
                  if i < len(token_mask) and token_mask[i]]
        return " ".join(picked)


def build_gdino(ckpt_path: Optional[str] = None,
                cfg: Optional[GDINOConfig] = None, seed: int = 0,
                device="cuda") -> GroundingDINO:
    """A GroundingDINO on ``device``: the checkpoint's weights when the path
    exists (IDEA or HF naming), else seeded random init. A swinb checkpoint
    name selects the Swin-B backbone."""
    dev = resolve_device(device)
    if cfg is None and ckpt_path and "swinb" in os.path.basename(
            ckpt_path).lower():
        cfg = GDINOConfig(swin=SwinConfig.base())
    if ckpt_path and os.path.exists(ckpt_path):
        from sola_torch.trackgen.gdino.convert import \
            build_gdino_from_checkpoint
        model, _ = build_gdino_from_checkpoint(ckpt_path, cfg)
    else:
        model = GroundingDINO(cfg or GDINOConfig())
        init_weights(model, seed)
    return model.to(dev).eval()


def load_grounding_dino(ckpt_path: Optional[str] = None,
                        cfg: Optional[GDINOConfig] = None,
                        compute_dtype=None, device="cuda",
                        seed: int = 0) -> GroundingModel:
    return GroundingModel(build_gdino(ckpt_path, cfg, seed=seed,
                                      device=device),
                          compute_dtype=compute_dtype)
