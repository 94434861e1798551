"""SAM2 model construction and weight conversion.

Counterpart of ``sola_tpu/trackgen/sam2/convert.py``. The port's modules use
the facebook ``sam2_hiera_*.pt`` key names, so a checkpoint loads with plain
``load_state_dict``. ``state_dict_from_jax_params`` carries the JAX
package's flax parameters (nested numpy arrays) across to this naming; it is
a numpy-only copy of that package's ``params_to_torch_sam2`` mapping:

    flax Conv kernel          (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)
    flax ConvTranspose kernel (kh, kw, I, O), spatially flipped
                                             -> torch ConvTranspose2d
                                                (I, O, kh, kw)
    flax Dense kernel         (I, O)         -> torch Linear (O, I)
    LayerNorm scale / bias                   -> weight / bias
    scanned Hiera runs / memory layers (stacked on axis 0) -> one key set
                                                               per block
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from sola_torch.device import resolve_device
from sola_torch.trackgen.sam2.common import LayerNorm2d
from sola_torch.trackgen.sam2.hiera import HieraConfig, hiera_segments
from sola_torch.trackgen.sam2.image_encoder import ImageEncoderConfig
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model

SIZES = ("tiny", "small", "base_plus", "large")


def sam2_config_for(size: str) -> SAM2Config:
    """SAM2 model family: 'tiny' | 'small' | 'base_plus' | 'large'
    (upstream sam2_hiera_{t,s,b+,l}.yaml backbones; everything outside the
    image encoder is shared across sizes)."""
    hiera = {"tiny": HieraConfig.tiny, "small": HieraConfig.small,
             "base_plus": HieraConfig.base_plus,
             "large": HieraConfig.large}[size]()
    return dataclasses.replace(SAM2Config.large(),
                               image_encoder=ImageEncoderConfig(hiera=hiera))


@torch.no_grad()
def init_weights(model: SAM2Model, seed: int = 0) -> None:
    """Seeded random init from one ``torch.Generator`` (CPU tensors):
    lecun-normal weights and zero biases for linear and conv layers, unit
    LayerNorms, N(0, 1) token embeddings and the JAX package's N(0, 0.02)
    position / memory parameters."""
    g = torch.Generator().manual_seed(seed)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * int(np.prod(w.shape[2:]))
            normal_(w, fan_in ** -0.5)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "pos_embed_window", "no_mem_embed",
                    "maskmem_tpos_enc", "no_obj_ptr"):
            normal_(p, 0.02)
        elif leaf == "gamma":
            nn.init.constant_(p, 1e-6)
    pe = model.sam_prompt_encoder.pe_layer
    normal_(pe.positional_encoding_gaussian_matrix, pe.scale)


def load_checkpoint_state(ckpt_path: str) -> dict:
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return ckpt.get("model", ckpt)


def build_sam2(ckpt_path: Optional[str] = None,
               cfg: Optional[SAM2Config] = None, seed: int = 0,
               size: str = "large", device="cuda") -> SAM2Model:
    """Build a SAM2Model on ``device``: the checkpoint's weights when the
    path exists, else seeded random init. ``size`` picks the hiera backbone
    when no cfg is given; a checkpoint name (sam2_hiera_{size}.pt) picks
    it automatically."""
    dev = resolve_device(device)
    if cfg is None and ckpt_path:
        stem = os.path.basename(ckpt_path)
        size = next((s for s in SIZES if s in stem), size)
    cfg = cfg or sam2_config_for(size)
    model = SAM2Model(cfg)
    if ckpt_path and os.path.exists(ckpt_path):
        # facebook checkpoints carry modules this model does not use
        # (e.g. obj_ptr_tpos_proj); every key the model has must be there
        missing, _ = model.load_state_dict(load_checkpoint_state(ckpt_path),
                                           strict=False)
        if missing:
            raise KeyError(f"checkpoint {ckpt_path} lacks {missing[:8]}")
    else:
        init_weights(model, seed)
    return model.to(dev).eval()


def state_dict_from_jax_params(variables: dict, cfg: SAM2Config) -> dict:
    """JAX package SAM2Model variables ({"params", "buffers"}, nested numpy
    arrays) -> this package's state_dict (torch tensors, facebook naming)."""
    p = variables["params"]
    b = variables.get("buffers", {})
    out: dict = {}

    def arr(x):
        return np.asarray(x, dtype=np.float32)

    def put_conv(name, node):
        out[f"{name}.weight"] = arr(node["kernel"]).transpose(3, 2, 0, 1)
        out[f"{name}.bias"] = arr(node["bias"])

    def put_convT(name, node):
        # un-flip the spatial dims, then (kh,kw,I,O) -> (I,O,kh,kw)
        k = arr(node["kernel"])[::-1, ::-1]
        out[f"{name}.weight"] = k.transpose(2, 3, 0, 1)
        out[f"{name}.bias"] = arr(node["bias"])

    def put_dense(name, node):
        out[f"{name}.weight"] = arr(node["kernel"]).T
        out[f"{name}.bias"] = arr(node["bias"])

    def put_ln(name, node):
        out[f"{name}.weight"] = arr(node["scale"])
        out[f"{name}.bias"] = arr(node["bias"])

    def put_mlp(name, node, n):
        for i in range(n):
            put_dense(f"{name}.layers.{i}", node[f"layer_{i}"])

    def put_attn(name, node):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_dense(f"{name}.{proj}", node[proj])

    def index_tree(tree, i):
        if isinstance(tree, dict):
            return {k: index_tree(v, i) for k, v in tree.items()}
        return arr(tree)[i]

    trunk = p["image_encoder"]["trunk"]
    put_conv("image_encoder.trunk.patch_embed.proj", trunk["patch_embed"])
    out["image_encoder.trunk.pos_embed"] = arr(
        trunk["pos_embed"]).transpose(2, 0, 1)[None]
    out["image_encoder.trunk.pos_embed_window"] = arr(
        trunk["pos_embed_window"]).transpose(2, 0, 1)[None]

    def put_block(i, blk):
        t = f"image_encoder.trunk.blocks.{i}"
        put_ln(f"{t}.norm1", blk["norm1"])
        put_ln(f"{t}.norm2", blk["norm2"])
        put_dense(f"{t}.attn.qkv", blk["attn"]["qkv"])
        put_dense(f"{t}.attn.proj", blk["attn"]["proj"])
        put_dense(f"{t}.mlp.layers.0", blk["mlp_0"])
        put_dense(f"{t}.mlp.layers.1", blk["mlp_1"])
        if "proj" in blk:
            put_dense(f"{t}.proj", blk["proj"])

    for seg in hiera_segments(cfg.image_encoder.hiera):
        if seg[0] == "single":
            put_block(seg[1], trunk[f"block_{seg[1]}"])
        else:
            _, start, n, _ = seg
            stacked = trunk[f"run_{start}"]["block"]
            for k in range(n):
                put_block(start + k, index_tree(stacked, k))
    for i in range(4):
        put_conv(f"image_encoder.neck.convs.{i}.conv",
                 p["image_encoder"]["neck"][f"conv_{3 - i}"])

    pe = p["prompt_encoder"]
    for i in range(4):
        out[f"sam_prompt_encoder.point_embeddings.{i}.weight"] = \
            arr(pe["point_embeddings"])[i][None]
    out["sam_prompt_encoder.not_a_point_embed.weight"] = arr(
        pe["not_a_point_embed"])[None]
    out["sam_prompt_encoder.no_mask_embed.weight"] = arr(
        pe["no_mask_embed"])[None]
    put_conv("sam_prompt_encoder.mask_downscaling.0", pe["mask_conv1"])
    put_ln("sam_prompt_encoder.mask_downscaling.1", pe["mask_ln1"])
    put_conv("sam_prompt_encoder.mask_downscaling.3", pe["mask_conv2"])
    put_ln("sam_prompt_encoder.mask_downscaling.4", pe["mask_ln2"])
    put_conv("sam_prompt_encoder.mask_downscaling.6", pe["mask_conv3"])
    out["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        arr(b["prompt_encoder"]["pe_layer"]
            ["positional_encoding_gaussian_matrix"])

    md = p["mask_decoder"]
    out["sam_mask_decoder.iou_token.weight"] = arr(md["iou_token"])
    out["sam_mask_decoder.mask_tokens.weight"] = arr(md["mask_tokens"])
    if cfg.mask_decoder.pred_obj_scores:
        out["sam_mask_decoder.obj_score_token.weight"] = arr(
            md["obj_score_token"])
        if cfg.mask_decoder.pred_obj_scores_mlp:
            put_mlp("sam_mask_decoder.pred_obj_score_head",
                    md["obj_score_head"], 3)
        else:
            put_dense("sam_mask_decoder.pred_obj_score_head",
                      md["obj_score_head"])
    put_convT("sam_mask_decoder.output_upscaling.0", md["upscale_conv1"])
    put_ln("sam_mask_decoder.output_upscaling.1", md["upscale_ln"])
    put_convT("sam_mask_decoder.output_upscaling.3", md["upscale_conv2"])
    put_mlp("sam_mask_decoder.iou_prediction_head", md["iou_head"],
            cfg.mask_decoder.iou_head_depth)
    for i in range(cfg.mask_decoder.num_mask_tokens):
        put_mlp(f"sam_mask_decoder.output_hypernetworks_mlps.{i}",
                md[f"hyper_mlp_{i}"], 3)
    for i in range(cfg.mask_decoder.transformer_depth):
        layer = md["transformer"][f"layer_{i}"]
        t = f"sam_mask_decoder.transformer.layers.{i}"
        put_attn(f"{t}.self_attn", layer["self_attn"])
        put_attn(f"{t}.cross_attn_token_to_image", layer["cross_attn_t2i"])
        put_attn(f"{t}.cross_attn_image_to_token", layer["cross_attn_i2t"])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            put_ln(f"{t}.{n}", layer[n])
        put_dense(f"{t}.mlp.lin1", layer["mlp_0"])
        put_dense(f"{t}.mlp.lin2", layer["mlp_1"])
    put_attn("sam_mask_decoder.transformer.final_attn_token_to_image",
             md["transformer"]["final_attn"])
    put_ln("sam_mask_decoder.transformer.norm_final_attn",
           md["transformer"]["norm_final"])
    put_conv("sam_mask_decoder.conv_s0", p["conv_s0"])
    put_conv("sam_mask_decoder.conv_s1", p["conv_s1"])

    ma = p["memory_attention"]
    put_ln("memory_attention.norm", ma["norm"])
    for i in range(cfg.memory_attention.num_layers):
        layer = index_tree(ma["layers"]["layer"], i)
        t = f"memory_attention.layers.{i}"
        put_attn(f"{t}.self_attn", layer["self_attn"])
        put_attn(f"{t}.cross_attn_image", layer["cross_attn"])
        for n in ("norm1", "norm2", "norm3"):
            put_ln(f"{t}.{n}", layer[n])
        put_dense(f"{t}.linear1", layer["linear1"])
        put_dense(f"{t}.linear2", layer["linear2"])

    me = p["memory_encoder"]
    n_ds = cfg.memory_encoder.mask_downsample_layers
    for i in range(n_ds):
        put_conv(f"memory_encoder.mask_downsampler.encoder.{3 * i}",
                 me["mask_downsampler"][f"conv_{i}"])
        put_ln(f"memory_encoder.mask_downsampler.encoder.{3 * i + 1}",
               me["mask_downsampler"][f"ln_{i}"])
    put_conv(f"memory_encoder.mask_downsampler.encoder.{3 * n_ds}",
             me["mask_downsampler"]["conv_out"])
    put_conv("memory_encoder.pix_feat_proj", me["pix_feat_proj"])
    put_conv("memory_encoder.out_proj", me["out_proj"])
    for i in range(cfg.memory_encoder.fuser_layers):
        f = me[f"fuser_{i}"]
        t = f"memory_encoder.fuser.layers.{i}"
        put_conv(f"{t}.dwconv", f["dwconv"])
        put_ln(f"{t}.norm", f["norm"])
        put_dense(f"{t}.pwconv1", f["pwconv1"])
        put_dense(f"{t}.pwconv2", f["pwconv2"])
        out[f"{t}.gamma"] = arr(f["gamma"])

    out["no_mem_embed"] = arr(p["no_mem_embed"])
    out["maskmem_tpos_enc"] = arr(p["maskmem_tpos_enc"])
    out["no_obj_ptr"] = arr(p["no_obj_ptr"])
    put_mlp("obj_ptr_proj", p["obj_ptr_proj"], 3)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_sam2_video_predictor(ckpt_path: Optional[str], obj_batch: int = 4,
                              cfg: Optional[SAM2Config] = None,
                              device="cuda", seed: int = 0, **kwargs):
    """The ``tokens_grid`` predictor factory: SAM2 (hiera-L unless the
    checkpoint name or ``cfg`` says otherwise) behind the video-predictor
    protocol. Extra keyword arguments go to ``SAM2VideoPredictor``."""
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    model = build_sam2(ckpt_path, cfg, seed=seed, device=device)
    return SAM2VideoPredictor(model, obj_batch=obj_batch, **kwargs)


def load_sam2_image_predictor(ckpt_path: Optional[str],
                              cfg: Optional[SAM2Config] = None,
                              device="cuda", seed: int = 0, **kwargs):
    """The ``prompts_gdino`` box -> mask predictor: SAM2 (hiera-L unless the
    checkpoint name or ``cfg`` says otherwise) behind the image-predictor
    surface. Extra keyword arguments go to ``SAM2ImagePredictor``."""
    from sola_torch.trackgen.sam2.image import SAM2ImagePredictor
    model = build_sam2(ckpt_path, cfg, seed=seed, device=device)
    return SAM2ImagePredictor(model, **kwargs)
