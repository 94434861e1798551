"""Seeded random weights of GroundingDINO SwinT-OGC and of the SAM2 hiera-L
beside it, made on the card from the seed the configuration fixes.

The parameter names and shapes come from the plain reference's model at the
configuration's sizes, built on the meta device; the values from one
``torch.Generator`` in one normal draw, split and scaled per tensor: linear
and conv weights N(0, 1/fan_in), biases 0, norms 1 and 0, word and position
embeddings N(0, 1/width), token type embeddings 0, the level and query
embeddings N(0, 1), Swin's relative-position tables N(0, 0.02), the fusion's
layer scales the configuration's ``fusion_layer_scale``, each deformable
sampling-offset bias upstream's initial pattern (head h's points along the
angle 2 pi h / heads at 1 to 4 pixels, or box fractions in the decoder),
and the last layer of both box heads (the decoder's shared one and the
query selection's) N(0, box_head_scale^2 / fan_in): upstream starts those
layers at zero, and at full scale the shared head's fixed drift, added by
all six decoder layers, shrinks every box to a pixel.

The configuration's ``box_gate`` then sets the last text enhancer layer's
output norm bias (``text_norm_bias`` on every channel plus
``text_norm_tilt`` along a zero-mean unit direction w drawn from the seed)
and the decoder's final norm bias (``query_norm_bias`` on every channel;
its weight stays 1). Both norms' outputs before their bias have zero
channel mean, so a contrastive logit is the dot product of the normalized
query and text token + text_norm_tilt x the query's component along w +
width x text_norm_bias x query_norm_bias. The tilt gives every query a
score of its own beside the one its text tokens give, so boxes spread over
the expressions as on trained weights instead of following a few words;
the constant last term shifts the logits so that as many queries clear
``box_threshold`` as on trained weights (``tools/gdino_box_gate.py``
measures the boxes a gate passes over the mix and sets the bias). Nothing
upstream of the head sees the query norm; the text bias also reaches the
decoder's text cross-attention (one vector added to every value) and the
query selection's scores.

The SAM2 weights are ``models/sam2_hiera_l.py``'s, from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TEXT_NORM = "model.encoder.layers.{}.text_enhancer_layer.layer_norm_after.bias"
QUERY_NORM = "model.decoder.layer_norm"
BOX_LAST = "bbox_embed.0.layers.2.weight", "bbox_embed.layers.2.weight"


def gdino_config(config: dict, size: str = "large"):
    """The reference's ``GDINOConfig`` of ``configs/gdino_swin_t.json``
    (``tiny_test``: the CPU tests' size)."""
    from benchmark.reference.gdino.model import GDINOConfig
    from benchmark.reference.gdino.swin import SwinConfig
    from benchmark.reference.gdino.text import BertConfig
    if size != "large":
        return GDINOConfig.tiny_test()
    s = config["sizes"]
    return GDINOConfig(
        swin=SwinConfig(embed_dim=s["swin_embed_dim"],
                        depths=tuple(s["swin_depths"]),
                        num_heads=tuple(s["swin_num_heads"]),
                        window_size=s["swin_window_size"]),
        text=BertConfig(vocab_size=s["text_vocab_size"],
                        hidden_size=s["text_hidden_size"],
                        num_layers=s["text_num_layers"],
                        num_heads=s["text_num_heads"],
                        intermediate_size=s["text_intermediate_size"]),
        d_model=s["hidden_dim"], n_heads=s["nheads"],
        n_levels=s["num_feature_levels"], enc_n_points=s["enc_n_points"],
        dec_n_points=s["dec_n_points"], enc_layers=s["enc_layers"],
        dec_layers=s["dec_layers"], dim_feedforward=s["dim_feedforward"],
        num_queries=s["num_queries"], max_text_len=s["max_text_len"],
        size_target=s["canvas"][0], size_max=s["canvas"][1])


def text_norm_bias(gate: dict, width: int, seed: int) -> torch.Tensor:
    """The last text layer's norm bias: ``text_norm_bias`` on every
    channel plus ``text_norm_tilt`` along a zero-mean unit direction drawn
    on the host from ``seed``."""
    w = torch.randn(width, generator=torch.Generator().manual_seed(seed))
    w = w - w.mean()
    w = w / w.norm()
    return (float(gate["text_norm_bias"])
            + float(gate["text_norm_tilt"]) * w)


def _offset_bias(heads: int, levels: int, points: int) -> torch.Tensor:
    """Upstream MSDeformAttn's initial sampling-offset bias."""
    theta = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float32)[
        None, None, :, None]
    return grid.reshape(-1)


def _specs(model, layer_scale: float, box_scale: float) -> list:
    """(name, shape, std or None, constant or tensor) per state tensor."""
    from benchmark.reference.gdino.model import GroupNorm, MSDeformAttn
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    parents = {f"{n}.sampling_offsets": m for n, m in model.named_modules()
               if isinstance(m, MSDeformAttn)}
    specs = []
    for name, t in model.state_dict().items():
        mod, leaf = owner[name]
        shape = tuple(t.shape)
        if name.endswith("sampling_offsets.bias"):
            a = parents[name.rsplit(".", 1)[0]]
            specs.append((name, shape, None,
                          _offset_bias(a.heads, a.levels, a.points)))
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if leaf == "weight":
                scale = box_scale if name.endswith(BOX_LAST) else 1.0
                specs.append((name, shape,
                              scale * math.prod(shape[1:]) ** -0.5, 0.0))
            else:
                specs.append((name, shape, None, 0.0))
        elif isinstance(mod, (nn.LayerNorm, GroupNorm)):
            specs.append((name, shape, None, 1.0 if leaf == "weight" else 0.0))
        elif name.endswith("token_type_embeddings.weight"):
            specs.append((name, shape, None, 0.0))
        elif name.endswith("query_position_embeddings.weight"):
            specs.append((name, shape, 1.0, 0.0))
        elif isinstance(mod, nn.Embedding):
            specs.append((name, shape, shape[1] ** -0.5, 0.0))
        elif leaf == "level_embed":
            specs.append((name, shape, 1.0, 0.0))
        elif leaf == "relative_position_bias_table":
            specs.append((name, shape, 0.02, 0.0))
        elif leaf in ("vision_param", "text_param"):
            specs.append((name, shape, None, layer_scale))
        else:
            raise KeyError(f"no init rule for {name}")
    return specs


@torch.no_grad()
def state_dict(config: dict, device="cuda", size: str = "large",
               box_gate: dict = None) -> dict:
    """GroundingDINO's fp32 weights drawn from the configuration's
    ``weights_seed`` on ``device``, with its ``box_gate`` applied, or
    ``box_gate`` given (``tools/gdino_box_gate.py``, which sets it)."""
    from benchmark.reference.gdino.model import GroundingDINO
    assumed = config["assumed"]
    cfg = gdino_config(config, size)
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    specs = _specs(model, float(assumed["fusion_layer_scale"]),
                   float(assumed["box_head_scale"]))
    n = sum(math.prod(s) for _, s, std, _ in specs if std is not None)
    gen = torch.Generator(device=device).manual_seed(
        int(assumed["weights_seed"]))
    draw = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std, const in specs:
        if std is None:
            out[name] = (const.to(device).reshape(shape).clone()
                         if torch.is_tensor(const)
                         else torch.full(shape, const, device=device))
        else:
            k = math.prod(shape)
            out[name] = (draw[off:off + k] * std).reshape(shape)
            off += k
    gate = box_gate or assumed["box_gate"]
    out[TEXT_NORM.format(cfg.enc_layers - 1)].copy_(
        text_norm_bias(gate, cfg.d_model, int(assumed["weights_seed"]))
        .to(device))
    out[QUERY_NORM + ".bias"].fill_(float(gate["query_norm_bias"]))
    return out


def sam2_state_dict(config: dict, device="cuda", size: str = "large"):
    """SAM2 hiera-L's bf16 weights (``models/sam2_hiera_l.py``, with the
    configuration's ``obj_score_bias``) from its ``weights_seed``."""
    from benchmark.models import sam2_hiera_l
    return sam2_hiera_l.state_dict(config,
                                   int(config["assumed"]["weights_seed"]),
                                   device, size)
