"""GroundingDINO's text half: BERT-base as einsums, the hash tokenizer,
and the sub-sentence masks and position ids of the phrases.

BERT-base: 768 wide, 12 post-norm layers of 12-head self-attention and a
3072-wide GELU FFN, layer-norm epsilon 1e-12, token type 0; the
self-attention mask is GroundingDINO's (B, L, L) block mask, so a token
attends only inside its phrase, and positions restart in each phrase.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12

    @classmethod
    def tiny_test(cls) -> "BertConfig":
        return cls(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64,
                   layer_norm_eps=1e-5)


class _Linear3(nn.Module):
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
        self.self = _Linear3(d)
        self.output = _DenseNorm(d, d, eps)


class _Intermediate(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.dense = nn.Linear(d, d_ff)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_heads
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = _Attention(d, eps)
        self.intermediate = _Intermediate(d, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, d, eps)

    def forward(self, x, bias):
        b, n, d = x.shape
        h = self.heads
        sa = self.attention.self
        q, k, v = (p(x).reshape(b, n, h, d // h)
                   for p in (sa.query, sa.key, sa.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d // h) ** 0.5
        ctx = torch.einsum("bhqk,bkhd->bqhd", (logits + bias).softmax(-1), v)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(ctx.reshape(b, n, d)))
        return self.output.LayerNorm(
            x + self.output.dense(F.gelu(self.intermediate.dense(x))))


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(2, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Layers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, input_ids, self_mask, position_ids):
        """input_ids (B, L); self_mask (B, L, L) bool, True where a token
        may attend; position_ids (B, L) -> (B, L, hidden)."""
        e = self.embeddings
        x = e.LayerNorm(e.word_embeddings(input_ids.long())
                        + e.position_embeddings(position_ids.long())
                        + e.token_type_embeddings.weight[0])
        bias = torch.where(self_mask, 0.0, -1e30)[:, None]
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------

_WORD = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")
BOS, EOS = 0, 2


def hash_ids(text: str, vocab_size: int) -> list:
    """[BOS] + one id per word or punctuation mark (the first 4 bytes of
    its SHA-1, past the 4 special ids) + [EOS]."""
    ids = [BOS]
    for word in _WORD.findall(text.lower()):
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "big")
        ids.append(4 + h % (vocab_size - 4))
    return ids + [EOS]


def phrase_masks(ids: np.ndarray, specials=(BOS, EOS)):
    """GroundingDINO's generate_masks_with_special_tokens_and_transfer_map
    for one row: the (L, L) block mask of each phrase (the tokens after a
    special token up to and including the next), the identity elsewhere,
    and positions that restart at 0 in each phrase."""
    n = len(ids)
    mask = np.eye(n, dtype=bool)
    pos = np.zeros(n, np.int64)
    prev = 0
    for col in np.nonzero(np.isin(ids, specials))[0]:
        if col not in (0, n - 1):
            mask[prev + 1:col + 1, prev + 1:col + 1] = True
            pos[prev + 1:col + 1] = np.arange(col - prev)
        prev = col
    return mask, pos


def tokenize_chunk(texts, vocab_size: int, pad_id: int, max_len: int = 64):
    """(ids, token mask, self mask, position ids) of a batch of texts, as
    numpy arrays: each text tokenized alone (truncated to ``max_len``), its
    masks made on its own tokens, then padded to the batch's longest with
    padding that attends to itself only."""
    rows = []
    for t in texts:
        ids = np.asarray(hash_ids(t, vocab_size)[:max_len], np.int64)
        mask, pos = phrase_masks(ids)
        rows.append((ids, mask, pos))
    n = max(len(r[0]) for r in rows)
    out_ids = np.full((len(rows), n), pad_id, np.int64)
    tmask = np.zeros((len(rows), n), bool)
    smask = np.broadcast_to(np.eye(n, dtype=bool),
                            (len(rows), n, n)).copy()
    pos = np.zeros((len(rows), n), np.int64)
    for i, (ids, m, p) in enumerate(rows):
        k = len(ids)
        out_ids[i, :k] = ids
        tmask[i, :k] = True
        smask[i, :k, :k] = m
        pos[i, :k] = p
    return out_ids, tmask, smask, pos
