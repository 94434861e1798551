"""Language-aligned track-selection transformer (the trainable core of SOLA).

Counterpart of ``sola_tpu/models/selection.py`` (module/module.py:54-162):

* short-term motion encoder: 6 weight-standardized 1-D convs with GroupNorm
  + LeakyReLU + dropout, 8x temporal downsample, dims 256 -> 512 -> 512 ->
  512 -> 1024 -> 1024 -> 1024 (module/module.py:74-96);
* random-Fourier temporal positional encoding from a fixed Gaussian buffer;
* ``n_negative`` learned negative tokens appended to the language sequence;
* N alignment layers: inter-object attention (per frame, across tracks),
  motion attention (per track, across frames, PE on q/k only) and
  object -> language cross-attention, each with residual + GroupNorm;
* the einsum scoring head.

Every ragged axis (tracks, frames, words) is padded with validity masks, as
in the JAX package, and the layout is feature-last. Submodule and
parameter names follow the reference checkpoint (``epoch_N.pth``,
``sola_tpu/models/convert.py``), so one loads with a strict
``load_state_dict``. Training randomness comes from an explicit
``torch.Generator`` passed to ``forward``.

``SelectionModel(cfg, group)`` with a model group (``parallel/tp.py``)
holds this rank's shard: its attention layers compute ``num_heads / group
size`` heads, and each motion conv computes its share of the output
channels, gathered over the group before the GroupNorm that follows it.
A shard loads ``tp.shard_state_dict`` of a full state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from sola_torch.models.attention import MultiHeadAttention
from sola_torch.models.layers import (DropoutRng, MaskedGroupNorm, WSConv1d,
                                      downsampled_length, leaky_relu,
                                      prefix_mask)
from sola_torch.parallel import tp

# indices of the reference's nn.Sequential motion encoder: conv, GroupNorm,
# LeakyReLU, Dropout per block; the last block is the conv alone
CONV_SEQ_IDX = (0, 4, 8, 12, 16, 20)
NORM_SEQ_IDX = (1, 5, 9, 13, 17)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Model hyperparameters (configs/mevis/default.yaml:3-13)."""
    object_token_dim: int = 256
    lang_token_dim: int = 1024
    n_layers: int = 2
    max_temporal_length: int = 100
    n_negative: int = 32
    dropout_p: float = 0.2
    n_groups: int = 8
    n_groups_module: int = 8
    num_heads: int = 8
    attn_dropout_p: float = 0.1
    use_pallas_attention: bool = False

    @classmethod
    def from_dict(cls, model_configs: dict) -> "SelectionConfig":
        return cls(
            object_token_dim=model_configs.get("object_token_dim", 256),
            lang_token_dim=model_configs.get("lang_token_dim", 1024),
            n_layers=model_configs.get("n_layers", 2),
            max_temporal_length=model_configs.get("max_temporal_length", 100),
            n_negative=model_configs.get("n_negative", 32),
            dropout_p=model_configs.get("dropout_p", 0.2),
            n_groups=model_configs.get("n_groups", 8),
            n_groups_module=model_configs.get("n_groups_module", 8),
            attn_dropout_p=model_configs.get("attn_dropout_p", 0.1),
            use_pallas_attention=model_configs.get("use_pallas_attention",
                                                   False),
        )

    def conv_specs(self) -> list:
        """(in, out, kernel, stride, padding) of the six motion convs."""
        hidden = self.object_token_dim * 2
        d = self.lang_token_dim
        return [(self.object_token_dim, hidden, 3, 2, 1),
                (hidden, hidden, 3, 2, 1), (hidden, hidden, 3, 2, 1),
                (hidden, d, 3, 1, 1), (d, d, 3, 1, 1), (d, d, 1, 1, 0)]


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                dim: int) -> torch.Tensor:
    """Mean over ``dim`` counting only mask-valid entries (mask
    broadcastable)."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask.to(x.dtype)
    return (x * m).sum(dim=dim) / m.expand_as(x).sum(dim=dim).clamp_min(1.0)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int) -> torch.Tensor:
    """Softmax over ``dim`` with invalid entries forced to 0 probability."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    out = torch.softmax(logits.masked_fill(~mask, -1e30), dim=dim)
    return out.masked_fill(~mask, 0.0)


class AlignmentLayer(nn.Module):
    """One object-language alignment layer (module/module.py:8-52)."""

    def __init__(self, cfg: SelectionConfig, group=None):
        super().__init__()
        d = cfg.lang_token_dim

        def mha():
            return MultiHeadAttention(d, cfg.num_heads, cfg.attn_dropout_p,
                                      cfg.use_pallas_attention, group=group)

        self.obj_attn = mha()
        self.motion_attn = mha()
        self.object2lang_attn = mha()
        # norm.0 after obj_attn, norm.1 after motion_attn, norm.2 after the
        # language cross-attention (the reference's names)
        self.norm = nn.ModuleList(MaskedGroupNorm(cfg.n_groups_module, d)
                                  for _ in range(3))

    def forward(self, object_tokens, object_tokens_pe, lang_tokens,
                track_mask, frame_mask, lang_mask,
                rng: Optional[DropoutRng] = None):
        """object_tokens (b, n, t, d); object_tokens_pe (1|b, 1, t, d);
        lang_tokens (b, w, d); track_mask (b, n), frame_mask (b, t),
        lang_mask (b, w) bool or None."""
        b, n, t, d = object_tokens.shape

        # inter-object attention: the tokens of all tracks at one frame
        x = object_tokens.transpose(1, 2).reshape(b * t, n, d)
        kmask = (None if track_mask is None
                 else track_mask.repeat_interleave(t, dim=0))
        x = x + self.obj_attn(x, x, x, key_mask=kmask, rng=rng)
        x = self.norm[0](x, kmask)
        x = x.reshape(b, t, n, d).transpose(1, 2)

        # motion attention: one track across frames, PE on q/k only
        xq = (x + object_tokens_pe).reshape(b * n, t, d)
        xv = x.reshape(b * n, t, d)
        kmask = (None if frame_mask is None
                 else frame_mask.repeat_interleave(n, dim=0))
        x = xv + self.motion_attn(xq, xq, xv, key_mask=kmask, rng=rng)
        x = self.norm[1](x, kmask).reshape(b, n, t, d)

        # object -> language cross-attention over (n * t) queries
        xq = x.reshape(b, n * t, d)
        xq = xq + self.object2lang_attn(xq, lang_tokens, lang_tokens,
                                        key_mask=lang_mask, rng=rng)
        nt_mask = None
        if track_mask is not None or frame_mask is not None:
            tm = (track_mask if track_mask is not None else
                  torch.ones(b, n, dtype=torch.bool, device=x.device))
            fm = (frame_mask if frame_mask is not None else
                  torch.ones(b, t, dtype=torch.bool, device=x.device))
            nt_mask = (tm[:, :, None] & fm[:, None, :]).reshape(b, n * t)
        xq = self.norm[2](xq, nt_mask)
        return xq.reshape(b, n, t, d), lang_tokens


class SelectionModel(nn.Module):
    """LanguageAlignedTrackSelectionModule (module/module.py:54)."""

    def __init__(self, cfg: SelectionConfig, group=None):
        super().__init__()
        self.cfg = cfg
        n = tp.group_size(group)
        self.group = group if n > 1 else None
        d = cfg.lang_token_dim
        specs = cfg.conv_specs()
        # keyed by the reference Sequential's indices; its LeakyReLU and
        # Dropout slots carry no weights and are applied in encode_motion
        encoder = {}
        for i, (cin, cout, k, s, p) in enumerate(specs):
            if cout % n:
                raise ValueError(f"a model group of {n} does not divide "
                                 f"conv_{i}'s {cout} channels")
            encoder[str(CONV_SEQ_IDX[i])] = WSConv1d(cin, cout // n, k, s, p)
            if i < len(NORM_SEQ_IDX):
                encoder[str(NORM_SEQ_IDX[i])] = MaskedGroupNorm(cfg.n_groups,
                                                                cout)
        self.short_motion_encoder = nn.ModuleDict(encoder)
        self.object_lang_align_layers = nn.ModuleList(
            AlignmentLayer(cfg, self.group) for _ in range(cfg.n_layers))
        self.negative_token = nn.Embedding(cfg.n_negative, d)
        # fixed random-Fourier buffer (module/module.py:104)
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(1, d // 2))

    def temporal_positional_encoding(self, t: int) -> torch.Tensor:
        """Random-Fourier PE over frame index (module/module.py:112-128)."""
        cfg = self.cfg
        gauss = self.positional_encoding_gaussian_matrix
        pos = torch.arange(t, dtype=torch.float32,
                           device=gauss.device).reshape(t, 1)
        proj = 2.0 * math.pi * ((pos / cfg.max_temporal_length) @ gauss)
        pe = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        return pe.reshape(1, 1, t, cfg.lang_token_dim)

    def encode_motion(self, object_tokens: torch.Tensor,
                      frame_lengths: Optional[torch.Tensor],
                      rng: Optional[DropoutRng] = None):
        """Short-term motion encoder; returns (tokens', frame_mask')."""
        cfg = self.cfg
        b, n, t, d = object_tokens.shape
        x = object_tokens.reshape(b * n, t, d)
        lengths = (None if frame_lengths is None
                   else frame_lengths.repeat_interleave(n, dim=0))
        specs = cfg.conv_specs()
        for i, (_, _, k, s, p) in enumerate(specs):
            if lengths is not None:
                # zero the padded tail so boundary windows see the zeros
                # torch's conv padding would
                x = x * prefix_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
            conv = self.short_motion_encoder[str(CONV_SEQ_IDX[i])]
            x = tp.gather_from_model(conv(tp.copy_to_model(x, self.group)),
                                     self.group)
            if lengths is not None:
                lengths = downsampled_length(lengths, s, k, p)
            if i < len(specs) - 1:
                mask = (prefix_mask(lengths, x.shape[1])
                        if lengths is not None else None)
                x = self.short_motion_encoder[str(NORM_SEQ_IDX[i])](x, mask)
                x = leaky_relu(x)
                if rng is not None and cfg.dropout_p > 0:
                    x = rng.dropout(x, cfg.dropout_p)
        t_out = x.shape[1]
        x = x.reshape(b, n, t_out, cfg.lang_token_dim)
        out_mask = None
        if frame_lengths is not None:
            out_lengths = frame_lengths
            for (_, _, k, s, p) in specs:
                out_lengths = downsampled_length(out_lengths, s, k, p)
            out_mask = prefix_mask(out_lengths, t_out)
        return x, out_mask

    def forward(self, object_tokens: torch.Tensor,
                lang_tokens: torch.Tensor,
                track_mask: Optional[torch.Tensor] = None,
                frame_lengths: Optional[torch.Tensor] = None,
                lang_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """object_tokens (b, n, t, object_token_dim); lang_tokens (b, w,
        lang_token_dim); track_mask (b, n) bool; frame_lengths (b,) int;
        lang_mask (b, w) bool. ``deterministic=False`` turns dropout on,
        drawn from ``generator`` (a host ``torch.Generator``, required
        then). Returns (score logits (b, n), score tokens (b, n, d))."""
        cfg = self.cfg
        b, n = object_tokens.shape[:2]
        rng = None
        if not deterministic:
            if generator is None:
                raise ValueError("a training forward needs a generator")
            rng = DropoutRng(generator, object_tokens.device)

        x, frame_mask = self.encode_motion(object_tokens, frame_lengths, rng)
        pe = self.temporal_positional_encoding(x.shape[2])

        neg = self.get_negative_tokens(b)
        lang_full = torch.cat([lang_tokens.to(neg.dtype), neg], dim=1)
        lang_full_mask = None
        if lang_mask is not None:
            ones = torch.ones(b, cfg.n_negative, dtype=torch.bool,
                              device=lang_mask.device)
            lang_full_mask = torch.cat([lang_mask, ones], dim=1)

        for layer in self.object_lang_align_layers:
            x, lang_full = layer(x, pe, lang_full, track_mask, frame_mask,
                                 lang_full_mask, rng)

        # scoring head (module/module.py:152-161)
        score_logits = torch.einsum("bntd,bwd->bntw", x, lang_full)
        score_logits = masked_mean(
            score_logits, None if lang_full_mask is None
            else lang_full_mask[:, None, None, :], dim=-1)  # (b, n, t)
        weight = masked_softmax(
            score_logits, None if frame_mask is None
            else frame_mask[:, None, :], dim=-1)
        score_tokens = (x * weight[..., None]).sum(dim=2)  # (b, n, d)
        score_map = torch.einsum("bnd,bwd->bnw", score_tokens, lang_full)
        score_map = masked_mean(
            score_map, None if lang_full_mask is None
            else lang_full_mask[:, None, :], dim=-1)  # (b, n)
        return score_map, score_tokens

    def get_negative_tokens(self, batch_size: int) -> torch.Tensor:
        """(b, n_negative, d) view of the learned negatives (train.py:92)."""
        w = self.negative_token.weight
        return w[None].expand(batch_size, *w.shape)


def init_weights(model: SelectionModel, seed: int = 42) -> None:
    """Seeded random initialization from a ``torch.Generator``, in the JAX
    package's distributions (torch's Linear and Conv1d defaults,
    U(+-1/sqrt(fan_in)) for weights and biases; GroupNorm 1/0; negatives
    and the Fourier buffer N(0, 1)). The values are not the JAX
    package's: parity tests carry the JAX weights across instead."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t, fan_in):
        t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0)
                / math.sqrt(fan_in))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, WSConv1d)):
                fan_in = m.weight[0].numel()
                uniform_(m.weight, fan_in)
                uniform_(m.bias, fan_in)
            elif isinstance(m, MaskedGroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for t in (model.negative_token.weight,
                  model.positional_encoding_gaussian_matrix):
            t.copy_(torch.randn(t.shape, generator=gen))
