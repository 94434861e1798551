"""GroundingDINO's forward after the backbones: level projections, the
feature enhancer, language-guided query selection, the cross-modality
decoder and the contrastive head; and the image preprocessing.

Shapes: a frame (1, H, W, 3) on the padded canvas, E texts (E, L). The
backbone runs once and its levels broadcast to the E texts, whose rows are
independent from there on except through the fusion's global maximum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.gdino.swin import SwinConfig, SwinTransformer
from benchmark.reference.gdino.text import BertConfig, BertEncoder
from benchmark.reference.mask_ops import resize_bilinear
from benchmark.reference.sam2.common import MLP

NEG_INF = float("-inf")
DEFORM_BLOCK = 4096     # queries a grid_sample block takes


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    swin: SwinConfig = SwinConfig()
    text: BertConfig = BertConfig()
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
    pe_temperature: float = 20.0
    layer_norm_eps: float = 1e-5
    size_target: int = 800
    size_max: int = 1333

    @classmethod
    def tiny_test(cls) -> "GDINOConfig":
        return cls(swin=SwinConfig.tiny_test(), text=BertConfig.tiny_test(),
                   d_model=32, n_heads=2, enc_n_points=2, dec_n_points=2,
                   enc_layers=1, dec_layers=1, dim_feedforward=64,
                   num_queries=20, max_text_len=32, size_target=64,
                   size_max=64)


# ---------------------------------------------------------------------------
# Position embeddings
# ---------------------------------------------------------------------------

def _sin_cos(p):
    """sin of the even channels, cos of the odd ones, interleaved."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def _dim_t(n: int, temperature: float, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(i, 2, rounding_mode="floor") / n)


def sine_embed(pos, n: int, temperature: float = 10000.0,
               exchange_xy: bool = True):
    """(..., k) coordinates -> (..., k * n): each coordinate's sine
    embedding, the first two swapped with ``exchange_xy``."""
    dim_t = _dim_t(n, temperature, pos.device)
    parts = [_sin_cos(pos[..., i, None] * 2 * math.pi / dim_t)
             for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) > 1:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


def mask_sine(mask, d: int, temperature: float):
    """(B, H, W) valid mask -> (B, H, W, d) sine embedding of the
    normalized cumulative y and x."""
    m = mask.float()
    y = m.cumsum(1)
    x = m.cumsum(2)
    y = y / (y[:, -1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, :, -1:] + 1e-6) * 2 * math.pi
    dim_t = _dim_t(d // 2, temperature, mask.device)
    return torch.cat([_sin_cos(y[..., None] / dim_t),
                      _sin_cos(x[..., None] / dim_t)], -1)


# ---------------------------------------------------------------------------
# Attention blocks
# ---------------------------------------------------------------------------

class BiMultiHeadAttention(nn.Module):
    """Image <-> text cross-attention of the fusion layer."""

    def __init__(self, d: int, e: int, heads: int):
        super().__init__()
        self.e, self.heads = e, heads
        self.vision_proj = nn.Linear(d, e)
        self.text_proj = nn.Linear(d, e)
        self.values_vision_proj = nn.Linear(d, e)
        self.values_text_proj = nn.Linear(d, e)
        self.out_vision_proj = nn.Linear(e, d)
        self.out_text_proj = nn.Linear(e, d)

    def forward(self, v, t, v_pad, t_pad):
        b, li, _ = v.shape
        lt = t.shape[1]
        h, hd = self.heads, self.e // self.heads
        q = (self.vision_proj(v) * hd ** -0.5).reshape(b, li, h, hd)
        k = self.text_proj(t).reshape(b, lt, h, hd)
        vv = self.values_vision_proj(v).reshape(b, li, h, hd)
        tv = self.values_text_proj(t).reshape(b, lt, h, hd)
        a = torch.einsum("bihd,bthd->bhit", q, k)
        a = (a - a.max()).clamp(-50000.0, 50000.0)
        at = a.transpose(-1, -2)
        at = (at - at.amax(-1, keepdim=True)).clamp(-50000.0, 50000.0)
        at = at.masked_fill(v_pad[:, None, None, :], NEG_INF)
        a = a.masked_fill(t_pad[:, None, None, :], NEG_INF)
        v_out = torch.einsum("bhit,bthd->bihd", a.softmax(-1), tv)
        t_out = torch.einsum("bhti,bihd->bthd", at.softmax(-1), vv)
        return (self.out_vision_proj(v_out.reshape(b, li, self.e)),
                self.out_text_proj(t_out.reshape(b, lt, self.e)))


class FusionLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d = cfg.d_model
        self.layer_norm_vision = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layer_norm_text = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = BiMultiHeadAttention(d, cfg.dim_feedforward // 2,
                                         cfg.n_heads // 2)
        self.vision_param = nn.Parameter(torch.zeros(d))
        self.text_param = nn.Parameter(torch.zeros(d))

    def forward(self, v, t, v_pad, t_pad):
        v = self.layer_norm_vision(v)
        t = self.layer_norm_text(t)
        dv, dt = self.attn(v, t, v_pad, t_pad)
        return v + self.vision_param * dv, t + self.text_param * dt


class PlainMHA(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, bias=None):
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.heads
        qh = self.query(q).reshape(b, lq, h, d // h)
        kh = self.key(k).reshape(b, lk, h, d // h)
        vh = self.value(v).reshape(b, lk, h, d // h)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d // h)
        if bias is not None:
            logits = logits + bias
        out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vh)
        return self.out_proj(out.reshape(b, lq, d))


def deform_sample(value, shapes, loc, weights):
    """Upstream ``multi_scale_deformable_attn_pytorch`` in blocks of
    queries: value (B, S, C) over the levels ``shapes``; loc (B, Lq, heads,
    levels, points, 2) in [0, 1]; weights (B, Lq, heads, levels, points).
    Returns (B, Lq, C)."""
    b, _, c = value.shape
    _, lq, nh, nl, npt, _ = loc.shape
    hd = c // nh
    maps = [v.reshape(b, h * w, nh, hd).permute(0, 2, 3, 1)
            .reshape(b * nh, hd, h, w)
            for v, (h, w) in zip(value.split([h * w for h, w in shapes], 1),
                                 shapes)]
    out = []
    for q0 in range(0, lq, DEFORM_BLOCK):
        grid = 2 * loc[:, q0:q0 + DEFORM_BLOCK] - 1
        n = grid.shape[1]
        samples = [F.grid_sample(
            maps[i], grid[:, :, :, i].transpose(1, 2).flatten(0, 1),
            mode="bilinear", padding_mode="zeros", align_corners=False)
            for i in range(nl)]                   # (B*heads, hd, n, points)
        a = weights[:, q0:q0 + n].transpose(1, 2).reshape(b * nh, 1, n,
                                                          nl * npt)
        o = (torch.stack(samples, -2).flatten(-2) * a).sum(-1)
        out.append(o.reshape(b, c, n).transpose(1, 2))
    return torch.cat(out, 1)


class MSDeformAttn(nn.Module):
    def __init__(self, d: int, levels: int, heads: int, points: int):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, value, shapes, valid):
        b, lq, _ = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value_proj(value).masked_fill(~valid[..., None], 0.0)
        off = self.sampling_offsets(query).reshape(b, lq, nh, nl, npt, 2)
        w = self.attention_weights(query).reshape(b, lq, nh, nl * npt)
        w = w.softmax(-1).reshape(b, lq, nh, nl, npt)
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w_, h_] for h_, w_ in shapes],
                              dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None] + off / wh[None, None, None, :,
                                                      None]
        else:
            loc = (ref[:, :, None, :, None, :2]
                   + off / npt * ref[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(deform_sample(value, shapes, loc, w))


def _ffn(fc1, fc2, x):
    return fc2(F.relu(fc1(x)))


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = PlainMHA(d, cfg.n_heads // 2)
        self.layer_norm_before = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward // 2)
        self.fc2 = nn.Linear(cfg.dim_feedforward // 2, d)
        self.layer_norm_after = nn.LayerNorm(d, eps=eps)

    def forward(self, t, bias, pos):
        q = t + pos
        t = self.layer_norm_before(t + self.self_attn(q, q, t, bias))
        return self.layer_norm_after(t + _ffn(self.fc1, self.fc2, t))


class DeformableLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MSDeformAttn(d, cfg.n_levels, cfg.n_heads,
                                      cfg.enc_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, v, pos, ref, shapes, valid):
        v = self.self_attn_layer_norm(
            v + self.self_attn(v + pos, ref, v, shapes, valid))
        return self.final_layer_norm(v + _ffn(self.fc1, self.fc2, v))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg)
        self.text_enhancer_layer = TextEnhancerLayer(cfg)
        self.deformable_layer = DeformableLayer(cfg)


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

    def forward(self, tgt, qpos, ref, v, t, shapes, valid, t_bias):
        q = tgt + qpos
        tgt = self.self_attn_layer_norm(tgt + self.self_attn(q, q, tgt))
        tgt = self.encoder_attn_text_layer_norm(
            tgt + self.encoder_attn_text(tgt + qpos, t, t, t_bias))
        tgt = self.encoder_attn_layer_norm(
            tgt + self.encoder_attn(tgt + qpos, ref, v, shapes, valid))
        return self.final_layer_norm(tgt + _ffn(self.fc1, self.fc2, tgt))


def contrastive(queries, text, text_valid, max_text_len: int):
    """(B, nq, d) . (B, Lt, d) -> (B, nq, max_text_len), -inf off the
    text."""
    logits = torch.einsum("bqd,btd->bqt", queries, text)
    logits = logits.masked_fill(~text_valid[:, None], NEG_INF)
    return F.pad(logits, (0, max_text_len - logits.shape[-1]),
                 value=NEG_INF)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, d: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        """(B, C, H, W) with statistics over each group's values."""
        g = x.reshape(x.shape[0], self.groups, -1)
        g = (g - g.mean(-1, keepdim=True)) * torch.rsqrt(
            g.var(-1, unbiased=False, keepdim=True) + self.eps)
        return (g.reshape(x.shape) * self.weight[:, None, None]
                + self.bias[:, None, None])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class _Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class _Inner(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        d = cfg.d_model
        swin = SwinTransformer(cfg.swin, (cfg.size_target, cfg.size_target))
        self.backbone = _Holder(conv_encoder=_Holder(model=swin))
        self.text_backbone = BertEncoder(cfg.text)
        self.text_projection = nn.Linear(cfg.text.hidden_size, d)
        dims = [cfg.swin.stage_dims[i] for i in cfg.swin.out_indices]
        groups = 32 if d % 32 == 0 else 1
        proj = [nn.Sequential(nn.Conv2d(c, d, 1), GroupNorm(groups, d))
                for c in dims]
        proj += [nn.Sequential(nn.Conv2d(dims[-1], d, 3, stride=2, padding=1),
                               GroupNorm(groups, d))
                 for _ in range(cfg.n_levels - len(dims))]
        self.input_proj_vision = nn.ModuleList(proj)
        self.level_embed = nn.Parameter(torch.zeros(cfg.n_levels, d))
        self.encoder = _Holder(layers=nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.enc_layers)))
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder_output_bbox_embed = MLP(d, d, 4, 3)
        self.query_position_embeddings = nn.Embedding(cfg.num_queries, d)
        self.decoder = _Holder(
            layers=nn.ModuleList(DecoderLayer(cfg)
                                 for _ in range(cfg.dec_layers)),
            layer_norm=nn.LayerNorm(d, eps=cfg.layer_norm_eps),
            reference_points_head=MLP(2 * d, d, d, 2))


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _Inner(cfg)
        self.bbox_embed = nn.ModuleList([MLP(cfg.d_model, cfg.d_model, 4, 3)])

    def levels(self, image, pixel_mask):
        """Swin and the level projections: [(1, h, w, d)] and [(1, h, w)]
        valid masks (nearest from the pixel mask)."""
        m = self.model
        feats = m.backbone.conv_encoder.model(image)
        out, masks = [], []
        for i, proj in enumerate(m.input_proj_vision):
            src = feats[min(i, len(feats) - 1)]
            x = proj(src.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            oh, ow = x.shape[1:3]
            ih, iw = pixel_mask.shape[1:]
            yi = (torch.arange(oh, dtype=torch.float32, device=x.device)
                  * (ih / oh)).floor().long()
            xi = (torch.arange(ow, dtype=torch.float32, device=x.device)
                  * (iw / ow)).floor().long()
            out.append(x)
            masks.append(pixel_mask[:, yi][:, :, xi])
        return out, masks

    def forward(self, image, pixel_mask, ids, token_valid, self_mask, pos_ids,
                topk: Optional[torch.Tensor] = None) -> dict:
        """image (1, H, W, 3) normalized canvas, pixel_mask (1, H, W); texts
        (E, L). ``topk`` (E, nq): the query selection's indices to decode
        (the reference's own when None). Returns pred_logits (E, nq,
        max_text_len), pred_boxes (E, nq, 4) cxcywh, scores (E, S) each
        proposal's selection score, and own_topk (E, nq)."""
        cfg, m, d = self.cfg, self.model, self.cfg.d_model
        dev = image.device
        e = ids.shape[0]
        txt = m.text_projection(m.text_backbone(ids, self_mask, pos_ids))
        levels, masks = self.levels(image, pixel_mask)
        levels = [x.expand(e, *x.shape[1:]) for x in levels]
        masks = [x.expand(e, *x.shape[1:]) for x in masks]
        shapes = [tuple(x.shape[1:3]) for x in levels]
        flat = torch.cat([x.reshape(e, -1, d) for x in levels], 1)
        pos = torch.cat([(mask_sine(mk, d, cfg.pe_temperature)
                          + m.level_embed[i]).reshape(e, -1, d)
                         for i, mk in enumerate(masks)], 1)
        valid = torch.cat([mk.reshape(e, -1) for mk in masks], 1)
        ratios = torch.stack([torch.stack(
            [mk[:, 0, :].float().sum(1) / mk.shape[2],
             mk[:, :, 0].float().sum(1) / mk.shape[1]], -1)
            for mk in masks], 1)                              # (E, levels, 2)
        refs = []
        for lvl, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                indexing="ij")
            xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
            wh = torch.tensor([w, h], dtype=torch.float32, device=dev)
            refs.append(xy[None] / (ratios[:, None, lvl] * wh))
        enc_ref = torch.cat(refs, 1)[:, :, None] * ratios[:, None]

        text_pos = sine_embed(pos_ids[..., None].float(), d,
                              exchange_xy=False)
        text_bias = torch.where(self_mask, 0.0, NEG_INF)[:, None]
        for layer in m.encoder.layers:
            flat, txt = layer.fusion_layer(flat, txt, ~valid, ~token_valid)
            txt = layer.text_enhancer_layer(txt, text_bias, text_pos)
            flat = layer.deformable_layer(flat, pos, enc_ref, shapes, valid)

        # proposals: a box per valid pixel of each level, 0.05 * 2^level
        props, start = [], 0
        for lvl, (h, w) in enumerate(shapes):
            mk = valid[:, start:start + h * w].reshape(e, h, w)
            vh = mk[:, :, 0].float().sum(1)
            vw = mk[:, 0, :].float().sum(1)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = (torch.stack([gx, gy], -1)[None] + 0.5) \
                / torch.stack([vw, vh], -1).reshape(e, 1, 1, 2)
            props.append(torch.cat(
                [grid, torch.full_like(grid, 0.05 * 2.0 ** lvl)],
                -1).reshape(e, -1, 4))
            start += h * w
        props = torch.cat(props, 1)
        keep = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        bad = ~valid[..., None] | ~keep
        props = torch.log(props / (1 - props)).masked_fill(bad, math.inf)
        obj = m.enc_output_norm(m.enc_output(flat.masked_fill(bad, 0.0)))
        enc_logits = contrastive(obj, txt, token_valid, cfg.max_text_len)
        coords = m.encoder_output_bbox_embed(obj) + props

        nq = min(cfg.num_queries, enc_logits.shape[1])
        scores = torch.where(torch.isfinite(enc_logits), enc_logits,
                             torch.full_like(enc_logits, -1e30)).amax(-1)
        own = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :nq]
        sel = own if topk is None else topk.to(dev).long()
        ref = torch.gather(coords, 1, sel[..., None].expand(-1, -1, 4))
        ref = ref.sigmoid()

        dec = m.decoder
        tgt = m.query_position_embeddings.weight[None, :nq].expand(e, nq, d)
        t_bias = torch.where(token_valid, 0.0, NEG_INF)[:, None, None]
        ratios4 = torch.cat([ratios, ratios], -1)[:, None]
        for layer in dec.layers:
            ref_in = ref[:, :, None] * ratios4
            qpos = dec.reference_points_head(sine_embed(ref_in[:, :, 0],
                                                        d // 2))
            tgt = layer(tgt, qpos, ref_in, flat, txt, shapes, valid, t_bias)
            delta = self.bbox_embed[0](tgt)
            ref = torch.sigmoid(delta + torch.log(
                ref.clamp(1e-5, 1 - 1e-5) / (1 - ref.clamp(1e-5, 1 - 1e-5))))
        logits = contrastive(dec.layer_norm(tgt), txt, token_valid,
                             cfg.max_text_len)
        return {"pred_logits": logits, "pred_boxes": ref, "scores": scores,
                "own_topk": own}


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def resize_shape(h: int, w: int, target: int, max_size: int):
    """Shorter side to ``target``, capped so the longer is <= ``max_size``
    (upstream's get_size_with_aspect_ratio)."""
    lo, hi = float(min(h, w)), float(max(h, w))
    if hi / lo * target > max_size:
        target = int(round(max_size * lo / hi))
    if (h <= w and h == target) or (w <= h and w == target):
        return h, w
    if h < w:
        return target, int(round(target * w / h))
    return int(round(target * h / w)), target


def canvas(frame: np.ndarray, cfg: GDINOConfig, device):
    """uint8 (H, W, 3) -> ((1, ch, cw, 3) normalized canvas, (1, ch, cw)
    valid mask)."""
    h, w = frame.shape[:2]
    oh, ow = resize_shape(h, w, cfg.size_target, cfg.size_max)
    ch = max(cfg.size_max if oh > ow else cfg.size_target, oh)
    cw = max(cfg.size_max if ow >= oh else cfg.size_target, ow)
    raw = torch.from_numpy(np.array(frame)).to(device)
    img = resize_bilinear(raw.permute(2, 0, 1).float(), (oh, ow))
    img = (img.permute(1, 2, 0) / 255.0 - torch.tensor(MEAN, device=device)) \
        / torch.tensor(STD, device=device)
    out = torch.zeros((1, ch, cw, 3), device=device)
    out[0, :oh, :ow] = img
    mask = torch.zeros((1, ch, cw), dtype=torch.bool, device=device)
    mask[0, :oh, :ow] = True
    return out, mask
