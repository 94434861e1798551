"""SAM2 base model: image encoder + prompt/mask heads + memory machinery.

Counterpart of ``sola_tpu/trackgen/sam2/model.py``. Memory comes in FIXED
banks (max_cond_frames conditioning slots + num_recent recent slots + a
16-slot object-pointer bank) with validity masks; invalid slots are masked
out of the attention, which is functionally upstream SAM2's
variable-length concat. The object axis is a batch dimension.
Submodule names follow the facebook checkpoint, so a ``sam2_hiera_*.pt``
state dict loads with plain ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from benchmark.reference.sam2.common import (MLP, conv_nhwc,
                                             interpolate_bilinear,
                                             sine_position_encoding)
from benchmark.reference.sam2.image_encoder import (ImageEncoder,
                                                    ImageEncoderConfig)
from benchmark.reference.sam2.mask_decoder import (MaskDecoder,
                                                   MaskDecoderConfig)
from benchmark.reference.sam2.memory import (MemoryAttention,
                                             MemoryAttentionConfig,
                                             MemoryEncoder,
                                             MemoryEncoderConfig)
from benchmark.reference.sam2.prompt_encoder import (PromptEncoder,
                                                     PromptEncoderConfig)


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    image_encoder: ImageEncoderConfig = ImageEncoderConfig()
    prompt_encoder: PromptEncoderConfig = PromptEncoderConfig()
    mask_decoder: MaskDecoderConfig = MaskDecoderConfig()
    memory_attention: MemoryAttentionConfig = MemoryAttentionConfig()
    memory_encoder: MemoryEncoderConfig = MemoryEncoderConfig()
    image_size: int = 1024
    num_maskmem: int = 7          # 1 cond + 6 recent (upstream default)
    max_cond_frames: int = 1      # static conditioning slots
    max_obj_ptrs: int = 16
    # keep a non-cond memory only every r-th frame (upstream
    # memory_temporal_stride_for_eval)
    memory_stride: int = 1
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    use_mask_input_as_output_without_sam: bool = True
    directly_add_no_mem_embed: bool = True
    multimask_output_for_tracking: bool = False
    fixed_no_obj_ptr: bool = True

    @classmethod
    def large(cls) -> "SAM2Config":
        return cls()

    @classmethod
    def tiny_test(cls, image_size: int = 64) -> "SAM2Config":
        return cls(
            image_encoder=ImageEncoderConfig.tiny_test(),
            prompt_encoder=PromptEncoderConfig.tiny_test(),
            mask_decoder=MaskDecoderConfig.tiny_test(),
            memory_attention=MemoryAttentionConfig.tiny_test(),
            memory_encoder=MemoryEncoderConfig.tiny_test(),
            image_size=image_size,
            max_cond_frames=1,
            max_obj_ptrs=4,
        )

    @property
    def num_recent(self) -> int:
        return self.num_maskmem - 1

    @property
    def feat_hw(self) -> int:
        return self.image_size // 16

    @property
    def d_model(self) -> int:
        return self.image_encoder.d_model

    @property
    def mem_dim(self) -> int:
        return self.memory_encoder.out_dim


class SAM2Model(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.image_encoder = ImageEncoder(cfg.image_encoder)
        self.sam_prompt_encoder = PromptEncoder(cfg.prompt_encoder)
        self.sam_mask_decoder = MaskDecoder(cfg.mask_decoder)
        self.memory_attention = MemoryAttention(cfg.memory_attention)
        self.memory_encoder = MemoryEncoder(cfg.memory_encoder)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, d))
        self.obj_ptr_proj = MLP(d, d, d, 3)

    # ------------------------------------------------------------------
    # Image encoding
    # ------------------------------------------------------------------

    def encode_image(self, images: torch.Tensor) -> dict:
        """images (B, S, S, 3) normalized -> s0 (B, S/4, S/4, d/8),
        s1 (B, S/8, S/8, d/4), pix (B, S/16, S/16, d), pos (sine PE)."""
        out = self.image_encoder(images)
        f4, f8, f16 = out["backbone_fpn"]
        md = self.sam_mask_decoder
        return {"s0": conv_nhwc(md.conv_s0, f4),
                "s1": conv_nhwc(md.conv_s1, f8),
                "pix": f16,
                "pos": out["vision_pos"][2]}

    # ------------------------------------------------------------------
    # SAM heads
    # ------------------------------------------------------------------

    def sam_heads(self, pix_feat, s0, s1, coords, labels, mask_prompt=None,
                  multimask_output: bool = False,
                  suppress_empty_obj: bool = False,
                  compute_high_res: bool = True) -> dict:
        """Prompt encoder + mask decoder on (possibly memory-conditioned)
        stride-16 features. coords (B, N, 2) / labels (B, N) padded with
        -1; mask_prompt (B, 4h, 4w, 1) logits or None.
        ``suppress_empty_obj``: the video path's convention — object score
        <= 0 collapses the mask logits to -1024.
        Returns low_res_masks (B, K, 4h, 4w), high_res_masks (B, K, S, S)
        or None, ious (B, K), obj_ptr (B, d), object_score_logits (B, 1)."""
        cfg = self.cfg
        dt = pix_feat.dtype
        if mask_prompt is not None:
            mask_prompt = mask_prompt.to(dt)
        sparse, dense = self.sam_prompt_encoder(coords, labels, mask_prompt)
        pe = self.sam_prompt_encoder.dense_pe()
        # prompt embeddings and PE take the feature dtype at the decoder
        # boundary, so a bf16 model decodes in bf16
        sparse, dense, pe = sparse.to(dt), dense.to(dt), pe.to(dt)
        low_res, ious, sam_token, obj_score = self.sam_mask_decoder(
            pix_feat, pe, sparse, dense, multimask_output,
            high_res_features=(s0, s1))
        if cfg.mask_decoder.pred_obj_scores and suppress_empty_obj:
            is_obj = obj_score[:, 0] > 0
            low_res = torch.where(is_obj[:, None, None, None], low_res,
                                  torch.full_like(low_res, -1024.0))
        high_res = None
        if compute_high_res:
            high_res = interpolate_bilinear(
                low_res.permute(0, 2, 3, 1), cfg.image_size,
                cfg.image_size).permute(0, 3, 1, 2)
        obj_ptr = self.obj_ptr_proj(sam_token)
        if cfg.fixed_no_obj_ptr:
            lam = (obj_score > 0).to(obj_ptr.dtype)
            obj_ptr = lam * obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return {"low_res_masks": low_res, "high_res_masks": high_res,
                "ious": ious, "obj_ptr": obj_ptr,
                "object_score_logits": obj_score}

    def mask_as_output(self, pix_feat, s0, s1, mask_high: torch.Tensor
                       ) -> dict:
        """use_mask_input_as_output_without_sam: the given mask becomes the
        frame output (scaled to +-10 logits); the SAM heads still run with
        the mask as a dense prompt to produce obj_ptr."""
        cfg = self.cfg
        scale, bias = 20.0, -10.0
        b = mask_high.shape[0]
        high_res = mask_high.float() * scale + bias  # (B, S, S)
        h4 = cfg.feat_hw * 4
        low_res = interpolate_bilinear(high_res[..., None], h4, h4)[..., 0]
        prompt_hw = cfg.prompt_encoder.image_embedding_size[0] * 4
        mask_prompt = interpolate_bilinear(high_res[..., None], prompt_hw,
                                           prompt_hw)
        coords = torch.zeros((b, 1, 2), device=pix_feat.device)
        labels = torch.full((b, 1), -1, dtype=torch.long,
                            device=pix_feat.device)
        sam_out = self.sam_heads(pix_feat, s0, s1, coords, labels,
                                 mask_prompt=mask_prompt)
        is_obj = mask_high.reshape(b, -1).amax(dim=-1) > 0
        obj_score = (scale * is_obj.float() + bias)[:, None]
        obj_ptr = sam_out["obj_ptr"]
        if cfg.fixed_no_obj_ptr:
            lam = is_obj.to(obj_ptr.dtype)[:, None]
            obj_ptr = lam * obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return {"low_res_masks": low_res[:, None],
                "high_res_masks": high_res[:, None],
                "ious": torch.ones((b, 1), device=pix_feat.device),
                "obj_ptr": obj_ptr,
                "object_score_logits": obj_score}

    # ------------------------------------------------------------------
    # Memory
    # ------------------------------------------------------------------

    def encode_memory(self, pix_feat, high_res_masks) -> torch.Tensor:
        """(B, h, w, d) + (B, S, S) mask logits -> (B, h, w, mem_dim)."""
        cfg = self.cfg
        m = torch.sigmoid(high_res_masks)[..., None]
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        return self.memory_encoder(pix_feat, m.to(pix_feat.dtype))

    def condition_features(self, pix_feat, pos, cond_mem, cond_valid,
                           recent_mem, recent_valid, recent_tpos, obj_ptrs,
                           obj_ptr_valid) -> torch.Tensor:
        """Cross-attend the current frame to the memory banks.

        pix_feat/pos: (B, h, w, d)
        cond_mem:     (B, C, h, w, mem)   cond_valid:    (B, C) bool
        recent_mem:   (B, R, h, w, mem)   recent_valid:  (B, R) bool
        recent_tpos:  (B, R) int in [1, R] (temporal distance)
        obj_ptrs:     (B, P, d)           obj_ptr_valid: (B, P) bool

        Rows with no valid memory take the learned no-mem embedding
        (directly_add_no_mem_embed)."""
        cfg = self.cfg
        b, h, w, d = pix_feat.shape
        mem_dim = cfg.mem_dim
        hw = h * w
        curr = pix_feat.reshape(b, hw, d)
        curr_pos = pos.reshape(b, hw, d)
        any_mem = cond_valid.any(dim=1) | recent_valid.any(dim=1)  # (B,)

        spatial_pos = sine_position_encoding(
            h, w, mem_dim, device=pix_feat.device).to(cond_mem.dtype
                                                     ).reshape(1, hw, mem_dim)
        tpos_table = self.maskmem_tpos_enc.reshape(cfg.num_maskmem, mem_dim)

        # conditioning slots: t_pos = 0 -> tpos index num_maskmem - 1
        cond_tok = cond_mem.reshape(b, -1, hw, mem_dim)
        cond_pos = (spatial_pos[:, None]
                    + tpos_table[cfg.num_maskmem - 1].reshape(1, 1, 1,
                                                              mem_dim))
        cond_pos = cond_pos.expand(cond_tok.shape).reshape(b, -1, mem_dim)
        cond_tok = cond_tok.reshape(b, -1, mem_dim)
        cond_mask = cond_valid.repeat_interleave(hw, dim=1)

        # recent slots: temporal distance t_rel in [1, num_recent] gets
        # maskmem_tpos_enc[t_rel - 1]
        rec_tok = recent_mem.reshape(b, -1, hw, mem_dim)
        tpos_idx = (recent_tpos - 1).clamp(0, cfg.num_maskmem - 2).long()
        tpos_enc = tpos_table[tpos_idx]  # (B, R, mem)
        rec_pos = spatial_pos[:, None] + tpos_enc[:, :, None, :]
        rec_pos = rec_pos.expand(rec_tok.shape).reshape(b, -1, mem_dim)
        rec_tok = rec_tok.reshape(b, -1, mem_dim)
        rec_mask = recent_valid.repeat_interleave(hw, dim=1)

        # object pointers: each d-dim pointer -> d/mem_dim tokens of mem_dim
        tok_per_ptr = d // mem_dim
        ptr_tok = obj_ptrs.reshape(b, -1, mem_dim)
        ptr_pos = torch.zeros_like(ptr_tok)
        ptr_mask = obj_ptr_valid.repeat_interleave(tok_per_ptr, dim=1)
        num_obj_ptr_tokens = ptr_tok.shape[1]

        memory = torch.cat([cond_tok, rec_tok, ptr_tok], dim=1)
        memory_pos = torch.cat([cond_pos.to(memory.dtype),
                                rec_pos.to(memory.dtype),
                                ptr_pos], dim=1)
        key_mask = torch.cat([cond_mask, rec_mask, ptr_mask], dim=1)
        # key 0 always stays unmasked, so every softmax row is well defined;
        # rows with no memory at all are replaced by no_mem below anyway
        key_mask[:, 0] |= ~key_mask.any(dim=1)
        memory = torch.where(key_mask[..., None], memory,
                             torch.zeros_like(memory))

        conditioned = self.memory_attention(
            curr, curr_pos, memory, memory_pos, num_obj_ptr_tokens,
            key_mask=key_mask)
        no_mem = curr + self.no_mem_embed
        out = torch.where(any_mem[:, None, None], conditioned,
                          no_mem.to(conditioned.dtype))
        return out.reshape(b, h, w, d)
