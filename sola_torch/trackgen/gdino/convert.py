"""GroundingDINO weights: the JAX package's parameters and torch checkpoints.

Counterpart of ``sola_tpu/trackgen/gdino/convert.py``. The port's modules
carry the HF ``GroundingDinoForObjectDetection`` key names, so an HF-named
state dict loads with plain ``load_state_dict``, and an IDEA-Research
checkpoint (``groundingdino_swint_ogc.pth``, the format the reference loads)
loads after ``idea_to_hf_keys``, a copy of the JAX package's key
translation. ``state_dict_from_jax_params`` carries the JAX package's flax
parameters (nested numpy arrays) across to that naming; it is the numpy-only
inverse of that package's ``hf_gdino_to_params``:

    flax Dense kernel (I, O)         -> torch Linear weight (O, I)
    flax Conv kernel  (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)
    LayerNorm / GroupNorm scale      -> weight
    Swin's fused qkv Dense           -> separate query / key / value
    BERT's token-type row            -> token_type_embeddings row 0 (row 1
                                        zero; GroundingDINO uses type 0)
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from sola_torch.trackgen.gdino.model import (GDINOConfig, GroundingDINO,
                                             init_weights)


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def state_dict_from_jax_params(variables: dict, cfg: GDINOConfig) -> dict:
    """JAX package GroundingDINO variables ({"params": ...}, nested numpy
    arrays) -> this package's state_dict (torch tensors, HF naming)."""
    p = variables["params"]
    out: dict = {}

    def dense(name, node):
        out[f"{name}.weight"] = _np(node["kernel"]).T
        if "bias" in node:
            out[f"{name}.bias"] = _np(node["bias"])

    def conv(name, node):
        out[f"{name}.weight"] = _np(node["kernel"]).transpose(3, 2, 0, 1)
        out[f"{name}.bias"] = _np(node["bias"])

    def norm(name, node):
        out[f"{name}.weight"] = _np(node["scale"])
        out[f"{name}.bias"] = _np(node["bias"])

    def mlp(name, node, n):
        for i in range(n):
            dense(f"{name}.layers.{i}", node[f"layer_{i}"])

    def mha(name, node):
        for proj in ("query", "key", "value", "out_proj"):
            dense(f"{name}.{proj}", node[proj])

    def deform(name, node):
        for proj in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            dense(f"{name}.{proj}", node[proj])

    # ---- Swin backbone ----
    sw = "model.backbone.conv_encoder.model"
    swin = p["backbone"]
    conv(f"{sw}.embeddings.patch_embeddings.projection", swin["patch_embed"])
    norm(f"{sw}.embeddings.norm", swin["patch_norm"])
    scfg = cfg.swin
    for s, depth in enumerate(scfg.depths):
        dim = scfg.stage_dims[s]
        for b in range(depth):
            blk = swin[f"stage_{s}_block_{b}"]
            t = f"{sw}.encoder.layers.{s}.blocks.{b}"
            norm(f"{t}.layernorm_before", blk["norm1"])
            norm(f"{t}.layernorm_after", blk["norm2"])
            qkv_k, qkv_b = _np(blk["attn"]["qkv"]["kernel"]), _np(
                blk["attn"]["qkv"]["bias"])
            for i, proj in enumerate(("query", "key", "value")):
                dense(f"{t}.attention.self.{proj}",
                      {"kernel": qkv_k[:, i * dim:(i + 1) * dim],
                       "bias": qkv_b[i * dim:(i + 1) * dim]})
            out[f"{t}.attention.self.relative_position_bias_table"] = _np(
                blk["attn"]["rel_pos_bias"])
            dense(f"{t}.attention.output.dense", blk["attn"]["proj"])
            dense(f"{t}.intermediate.dense", blk["mlp_0"])
            dense(f"{t}.output.dense", blk["mlp_1"])
        if s < len(scfg.depths) - 1:
            t = f"{sw}.encoder.layers.{s}.downsample"
            norm(f"{t}.norm", swin[f"merge_{s}"]["norm"])
            dense(f"{t}.reduction", swin[f"merge_{s}"]["reduction"])
    for stage in scfg.out_indices:
        norm(f"{sw}.hidden_states_norms.stage{stage + 1}",
             swin[f"out_norm_{stage}"])

    # ---- text backbone + projection ----
    tb = "model.text_backbone"
    bert = p["bert"]
    out[f"{tb}.embeddings.word_embeddings.weight"] = _np(
        bert["word_emb"]["embedding"])
    out[f"{tb}.embeddings.position_embeddings.weight"] = _np(
        bert["pos_emb"]["embedding"])
    tok = np.zeros((cfg.text.type_vocab_size, cfg.text.hidden_size),
                   np.float32)
    tok[0] = _np(bert["token_type_emb"])
    out[f"{tb}.embeddings.token_type_embeddings.weight"] = tok
    norm(f"{tb}.embeddings.LayerNorm", bert["emb_ln"])
    for i in range(cfg.text.num_layers):
        layer = bert[f"layer_{i}"]
        t = f"{tb}.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            dense(f"{t}.attention.self.{proj}", layer[proj])
        dense(f"{t}.attention.output.dense", layer["attn_out"])
        norm(f"{t}.attention.output.LayerNorm", layer["attn_ln"])
        dense(f"{t}.intermediate.dense", layer["ffn_in"])
        dense(f"{t}.output.dense", layer["ffn_out"])
        norm(f"{t}.output.LayerNorm", layer["ffn_ln"])
    dense("model.text_projection", p["feat_map"])

    # ---- input projections + level embedding ----
    for i in range(cfg.n_levels):
        conv(f"model.input_proj_vision.{i}.0", p[f"input_proj_{i}"])
        norm(f"model.input_proj_vision.{i}.1", p[f"input_proj_norm_{i}"])
    out["model.level_embed"] = _np(p["level_embed"])

    # ---- encoder layers ----
    for i in range(cfg.enc_layers):
        layer = p[f"enc_{i}"]
        t = f"model.encoder.layers.{i}"
        fus = layer["fusion_layer"]
        norm(f"{t}.fusion_layer.layer_norm_vision", fus["layer_norm_vision"])
        norm(f"{t}.fusion_layer.layer_norm_text", fus["layer_norm_text"])
        out[f"{t}.fusion_layer.vision_param"] = _np(fus["vision_param"])
        out[f"{t}.fusion_layer.text_param"] = _np(fus["text_param"])
        for k in ("vision_proj", "text_proj", "values_vision_proj",
                  "values_text_proj", "out_vision_proj", "out_text_proj"):
            dense(f"{t}.fusion_layer.attn.{k}", fus["attn"][k])
        te = layer["text_enhancer_layer"]
        mha(f"{t}.text_enhancer_layer.self_attn", te["self_attn"])
        for k in ("fc1", "fc2"):
            dense(f"{t}.text_enhancer_layer.{k}", te[k])
        for k in ("layer_norm_before", "layer_norm_after"):
            norm(f"{t}.text_enhancer_layer.{k}", te[k])
        de = layer["deformable_layer"]
        deform(f"{t}.deformable_layer.self_attn", de["self_attn"])
        for k in ("fc1", "fc2"):
            dense(f"{t}.deformable_layer.{k}", de[k])
        for k in ("self_attn_layer_norm", "final_layer_norm"):
            norm(f"{t}.deformable_layer.{k}", de[k])

    # ---- query selection ----
    dense("model.enc_output", p["enc_output"])
    norm("model.enc_output_norm", p["enc_output_norm"])
    mlp("model.encoder_output_bbox_embed", p["encoder_output_bbox_embed"], 3)
    out["model.query_position_embeddings.weight"] = _np(p["query_embed"])

    # ---- decoder ----
    for i in range(cfg.dec_layers):
        layer = p[f"dec_{i}"]
        t = f"model.decoder.layers.{i}"
        mha(f"{t}.self_attn", layer["self_attn"])
        mha(f"{t}.encoder_attn_text", layer["encoder_attn_text"])
        deform(f"{t}.encoder_attn", layer["encoder_attn"])
        for k in ("fc1", "fc2"):
            dense(f"{t}.{k}", layer[k])
        for k in ("self_attn_layer_norm", "encoder_attn_text_layer_norm",
                  "encoder_attn_layer_norm", "final_layer_norm"):
            norm(f"{t}.{k}", layer[k])
    norm("model.decoder.layer_norm", p["decoder_layer_norm"])
    mlp("model.decoder.reference_points_head", p["reference_points_head"], 2)
    mlp("bbox_embed.0", p["bbox_embed"], 3)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# ---------------------------------------------------------------------------
# IDEA-Research naming -> HF naming (copy of the JAX package's translation)
# ---------------------------------------------------------------------------

_IDEA_RULES = [
    (r"^backbone\.0\.patch_embed\.proj\.",
     "model.backbone.conv_encoder.model.embeddings.patch_embeddings.projection."),
    (r"^backbone\.0\.patch_embed\.norm\.",
     "model.backbone.conv_encoder.model.embeddings.norm."),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.norm1\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.layernorm_before."),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.norm2\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.layernorm_after."),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn\.proj\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.attention.output.dense."),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn\.relative_position_bias_table",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.attention.self.relative_position_bias_table"),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc1\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.intermediate.dense."),
    (r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc2\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.blocks.\2.output.dense."),
    (r"^backbone\.0\.layers\.(\d+)\.downsample\.",
     r"model.backbone.conv_encoder.model.encoder.layers.\1.downsample."),
    (r"^backbone\.0\.norm1\.",
     "model.backbone.conv_encoder.model.hidden_states_norms.stage2."),
    (r"^backbone\.0\.norm2\.",
     "model.backbone.conv_encoder.model.hidden_states_norms.stage3."),
    (r"^backbone\.0\.norm3\.",
     "model.backbone.conv_encoder.model.hidden_states_norms.stage4."),
    (r"^bert\.", "model.text_backbone."),
    (r"^feat_map\.", "model.text_projection."),
    (r"^input_proj\.(\d+)\.", r"model.input_proj_vision.\1."),
    (r"^transformer\.level_embed$", "model.level_embed"),
    # encoder: deformable / text / fusion sub-layers
    (r"^transformer\.encoder\.layers\.(\d+)\.self_attn\.",
     r"model.encoder.layers.\1.deformable_layer.self_attn."),
    (r"^transformer\.encoder\.layers\.(\d+)\.norm1\.",
     r"model.encoder.layers.\1.deformable_layer.self_attn_layer_norm."),
    (r"^transformer\.encoder\.layers\.(\d+)\.linear1\.",
     r"model.encoder.layers.\1.deformable_layer.fc1."),
    (r"^transformer\.encoder\.layers\.(\d+)\.linear2\.",
     r"model.encoder.layers.\1.deformable_layer.fc2."),
    (r"^transformer\.encoder\.layers\.(\d+)\.norm2\.",
     r"model.encoder.layers.\1.deformable_layer.final_layer_norm."),
    (r"^transformer\.encoder\.text_layers\.(\d+)\.self_attn\.out_proj\.",
     r"model.encoder.layers.\1.text_enhancer_layer.self_attn.out_proj."),
    (r"^transformer\.encoder\.text_layers\.(\d+)\.linear1\.",
     r"model.encoder.layers.\1.text_enhancer_layer.fc1."),
    (r"^transformer\.encoder\.text_layers\.(\d+)\.linear2\.",
     r"model.encoder.layers.\1.text_enhancer_layer.fc2."),
    (r"^transformer\.encoder\.text_layers\.(\d+)\.norm1\.",
     r"model.encoder.layers.\1.text_enhancer_layer.layer_norm_before."),
    (r"^transformer\.encoder\.text_layers\.(\d+)\.norm2\.",
     r"model.encoder.layers.\1.text_enhancer_layer.layer_norm_after."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.layer_norm_v\.",
     r"model.encoder.layers.\1.fusion_layer.layer_norm_vision."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.layer_norm_l\.",
     r"model.encoder.layers.\1.fusion_layer.layer_norm_text."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.gamma_v$",
     r"model.encoder.layers.\1.fusion_layer.vision_param"),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.gamma_l$",
     r"model.encoder.layers.\1.fusion_layer.text_param"),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.v_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.vision_proj."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.l_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.text_proj."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.values_v_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.values_vision_proj."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.values_l_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.values_text_proj."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.out_v_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.out_vision_proj."),
    (r"^transformer\.encoder\.fusion_layers\.(\d+)\.attn\.out_l_proj\.",
     r"model.encoder.layers.\1.fusion_layer.attn.out_text_proj."),
    # decoder
    (r"^transformer\.decoder\.layers\.(\d+)\.cross_attn\.",
     r"model.decoder.layers.\1.encoder_attn."),
    (r"^transformer\.decoder\.layers\.(\d+)\.norm1\.",
     r"model.decoder.layers.\1.encoder_attn_layer_norm."),
    (r"^transformer\.decoder\.layers\.(\d+)\.ca_text\.out_proj\.",
     r"model.decoder.layers.\1.encoder_attn_text.out_proj."),
    (r"^transformer\.decoder\.layers\.(\d+)\.catext_norm\.",
     r"model.decoder.layers.\1.encoder_attn_text_layer_norm."),
    (r"^transformer\.decoder\.layers\.(\d+)\.self_attn\.out_proj\.",
     r"model.decoder.layers.\1.self_attn.out_proj."),
    (r"^transformer\.decoder\.layers\.(\d+)\.norm2\.",
     r"model.decoder.layers.\1.self_attn_layer_norm."),
    (r"^transformer\.decoder\.layers\.(\d+)\.linear1\.",
     r"model.decoder.layers.\1.fc1."),
    (r"^transformer\.decoder\.layers\.(\d+)\.linear2\.",
     r"model.decoder.layers.\1.fc2."),
    (r"^transformer\.decoder\.layers\.(\d+)\.norm3\.",
     r"model.decoder.layers.\1.final_layer_norm."),
    (r"^transformer\.decoder\.norm\.", "model.decoder.layer_norm."),
    (r"^transformer\.decoder\.ref_point_head\.",
     "model.decoder.reference_points_head."),
    (r"^transformer\.decoder\.bbox_embed\.(\d+)\.", r"bbox_embed.\1."),
    (r"^bbox_embed\.(\d+)\.", r"bbox_embed.\1."),
    (r"^transformer\.enc_output\.", "model.enc_output."),
    (r"^transformer\.enc_output_norm\.", "model.enc_output_norm."),
    (r"^transformer\.enc_out_bbox_embed\.",
     "model.encoder_output_bbox_embed."),
    (r"^transformer\.tgt_embed\.weight$",
     "model.query_position_embeddings.weight"),
]

# keys with no counterpart in the model (pooler, buffers, unused heads)
_IDEA_DROP = (
    "bert.pooler.", "transformer.enc_out_class_embed",
    "label_enc", ".relative_position_index", ".attn_mask",
    "bert.embeddings.position_ids",
)


def idea_to_hf_keys(state: dict) -> dict:
    """Translate IDEA-Research checkpoint keys to the HF scheme; splits the
    fused torch MultiheadAttention/Swin qkv projections into q/k/v."""
    out = {}
    for key, value in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if any(d in key for d in _IDEA_DROP):
            continue
        # fused projections -> split
        m = re.match(r"^backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn"
                     r"\.qkv\.(weight|bias)$", key)
        if m:
            s, b, kind = m.groups()
            v = _np(value)
            d = v.shape[0] // 3
            base = (f"model.backbone.conv_encoder.model.encoder.layers.{s}"
                    f".blocks.{b}.attention.self")
            for i, proj in enumerate(("query", "key", "value")):
                out[f"{base}.{proj}.{kind}"] = v[i * d:(i + 1) * d]
            continue
        m = re.match(r"^transformer\.encoder\.text_layers\.(\d+)\.self_attn"
                     r"\.in_proj_(weight|bias)$", key)
        if m:
            i, kind = m.groups()
            v = _np(value)
            d = v.shape[0] // 3
            base = f"model.encoder.layers.{i}.text_enhancer_layer.self_attn"
            for j, proj in enumerate(("query", "key", "value")):
                out[f"{base}.{proj}.{kind}"] = v[j * d:(j + 1) * d]
            continue
        m = re.match(r"^transformer\.decoder\.layers\.(\d+)\.(self_attn|"
                     r"ca_text)\.in_proj_(weight|bias)$", key)
        if m:
            i, which, kind = m.groups()
            v = _np(value)
            d = v.shape[0] // 3
            hf_which = ("self_attn" if which == "self_attn"
                        else "encoder_attn_text")
            base = f"model.decoder.layers.{i}.{hf_which}"
            for j, proj in enumerate(("query", "key", "value")):
                out[f"{base}.{proj}.{kind}"] = v[j * d:(j + 1) * d]
            continue
        name = key
        for pat, rep in _IDEA_RULES:
            new = re.sub(pat, rep, name)
            if new != name:
                name = new
                break
        out[name] = value
    return out


def conversion_coverage(template: dict, converted: dict) -> float:
    """Fraction of a nested parameter tree's leaves that ``converted``
    assigns (trees as the JAX package's variables: dicts of arrays)."""
    def leaves(tree):
        n = 0
        for v in tree.values():
            n += leaves(v) if isinstance(v, dict) else 1
        return n

    def assigned(tpl, conv):
        n = 0
        for k, v in tpl.items():
            if isinstance(conv, dict) and k in conv:
                n += assigned(v, conv[k]) if isinstance(v, dict) else 1
        return n

    total = sum(leaves(template[c]) for c in template)
    got = sum(assigned(template[c], converted.get(c, {})) for c in template)
    return got / max(total, 1)


def build_gdino_from_checkpoint(ckpt_path: str,
                                cfg: Optional[GDINOConfig] = None,
                                seed: int = 0):
    """GroundingDINO (CPU) with a checkpoint's weights in IDEA or HF naming
    -> (model, {"coverage", "missing", "extra"}). Every parameter of the
    model must be in the checkpoint: a silent fallback to random init for
    any parameter family is a bug, not a degraded mode."""
    model = GroundingDINO(cfg or GDINOConfig())
    init_weights(model, seed)
    report = {"coverage": 0.0, "missing": [], "extra": []}
    if ckpt_path and os.path.exists(ckpt_path):
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        state = ckpt.get("model", ckpt)
        if any(k.startswith(("transformer.", "backbone.0.", "module."))
               for k in state):
            state = idea_to_hf_keys(state)
        state = {k: torch.as_tensor(np.asarray(_np(v)))
                 for k, v in state.items()}
        missing, extra = model.load_state_dict(state, strict=False)
        n = len(model.state_dict())
        report = {"coverage": (n - len(missing)) / max(n, 1),
                  "missing": list(missing), "extra": list(extra)}
        if missing:
            raise KeyError(f"checkpoint {ckpt_path} lacks {len(missing)} "
                           f"parameters, e.g. {missing[:8]}")
    return model, report
