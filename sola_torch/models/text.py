"""Text encoder building blocks: RoBERTa/BERT in PyTorch, and the hash
tokenizer.

Counterpart of the GroundingDINO half of ``sola_tpu/models/text.py``:
``RobertaConfig`` (``bert_base`` is GroundingDINO's text encoder),
``create_position_ids``, ``RobertaLayer``, ``RobertaEncoder`` (padding mask
or a full 3-D self-attention mask, GroundingDINO's sub-sentence blocks) and
a copy of ``HashTokenizer``, the deterministic stand-in for a BPE tokenizer
where no vocabulary is on disk. Module names follow the HF BERT/RoBERTa
checkpoints (``embeddings.*``, ``encoder.layer.{i}.*``). The selection-side
encoders (``TextEncoder``, ``CachingTextEncoder``, ``build_text_encoder``)
come with the selection slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    # "roberta": positions offset past pad_token_id; "bert": plain arange
    position_style: str = "roberta"
    type_vocab_size: int = 2

    @classmethod
    def large(cls) -> "RobertaConfig":
        return cls()

    @classmethod
    def bert_base(cls) -> "RobertaConfig":
        """BERT-base-uncased (GroundingDINO's text encoder)."""
        return cls(vocab_size=30522, hidden_size=768, num_layers=12,
                   num_heads=12, intermediate_size=3072,
                   max_position_embeddings=512, pad_token_id=0,
                   layer_norm_eps=1e-12, position_style="bert")

    @classmethod
    def tiny(cls) -> "RobertaConfig":
        """Small config for tests."""
        return cls(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64)


def create_position_ids(input_ids: torch.Tensor,
                        pad_token_id: int) -> torch.Tensor:
    """RoBERTa position ids: pad positions keep padding_idx; real tokens get
    padding_idx + cumulative index (HF ``create_position_ids_from_input_ids``)."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _DenseNorm(nn.Module):
    def __init__(self, d_in: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class _Attention(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.self = _SelfAttention(d)
        self.output = _DenseNorm(d, d, eps)


class _Intermediate(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.dense = nn.Linear(d, d_ff)


class RobertaLayer(nn.Module):
    """Post-norm transformer layer: self-attention (fp32 logits and
    softmax, probabilities in the activations' dtype) and a GELU FFN."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = _Attention(d, eps)
        self.intermediate = _Intermediate(d, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, d, eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        b, l, d = x.shape
        h = cfg.num_heads
        hd = d // h
        sa = self.attention.self
        q, k, v = (proj(x).reshape(b, l, h, hd).transpose(1, 2)
                   for proj in (sa.query, sa.key, sa.value))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / torch.sqrt(torch.tensor(float(hd)))
        probs = torch.softmax(logits + attn_bias, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, d)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(ctx))
        ffn = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(ffn))


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Layers(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(cfg)
                                   for _ in range(cfg.num_layers))


class RobertaEncoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attention_mask: (B, L) padding mask, or (B, L, L) full
        self-attention mask (GroundingDINO's sub-sentence blocks);
        position_ids: optional explicit positions (GroundingDINO restarts
        them per phrase). Token types are all 0."""
        cfg = self.cfg
        emb = self.embeddings
        input_ids = input_ids.long()
        if position_ids is None:
            if cfg.position_style == "bert":
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None]
            else:
                position_ids = create_position_ids(input_ids,
                                                   cfg.pad_token_id)
        x = (emb.word_embeddings(input_ids)
             + emb.position_embeddings(position_ids.long())
             + emb.token_type_embeddings.weight[0])
        x = emb.LayerNorm(x)
        mask = attention_mask > 0
        mask = mask[:, None] if mask.dim() == 3 else mask[:, None, None]
        attn_bias = torch.zeros(mask.shape, dtype=torch.float32,
                                device=x.device).masked_fill(~mask, -1e30)
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        return x


# ---------------------------------------------------------------------------
# Tokenizer stand-in (copy of sola_tpu.models.text.HashTokenizer)
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    """Deterministic whitespace/punct tokenizer hashing words into a vocab.

    Stand-in for the BPE tokenizer in weight-free environments; ids are
    stable across processes (sha1-based, not Python ``hash``).
    """

    def __init__(self, vocab_size: int = 50265, pad_token_id: int = 1,
                 bos_token_id: int = 0, eos_token_id: int = 2):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "big")
        # avoid the special ids 0..3
        return 4 + h % (self.vocab_size - 4)

    def __call__(self, texts: list[str], max_len: Optional[int] = None):
        seqs = []
        for text in texts:
            words = _WORD_RE.findall(text.lower())
            ids = [self.bos_token_id] + [self._word_id(w) for w in words] + [
                self.eos_token_id]
            seqs.append(ids)
        longest = max(len(s) for s in seqs)
        if max_len is not None:
            longest = min(longest, max_len)
        input_ids = np.full((len(seqs), longest), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), longest), np.int32)
        for i, s in enumerate(seqs):
            s = s[:longest]
            input_ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        return input_ids, mask
