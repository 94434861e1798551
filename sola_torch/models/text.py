"""Text encoders: RoBERTa/BERT in PyTorch, the hash tokenizer, and the
frozen expression encoders of track selection.

Counterpart of ``sola_tpu/models/text.py``. GroundingDINO's half:
``RobertaConfig`` (``bert_base`` is GroundingDINO's text encoder),
``create_position_ids``, ``RobertaLayer``, ``RobertaEncoder`` (padding mask
or a full 3-D self-attention mask, GroundingDINO's sub-sentence blocks) and
a copy of ``HashTokenizer``, the deterministic stand-in for a BPE tokenizer
where no vocabulary is on disk. Module names follow the HF BERT/RoBERTa
checkpoints (``embeddings.*``, ``encoder.layer.{i}.*``), so an HF state
dict loads as it is (``hf_roberta_state_dict``).

Selection's half (train.py:31-32,80-91): ``mean_pool``, ``TextEncoder``
(frozen RoBERTa + mean pooling), ``HashTextEncoder`` (a weight-free stand-in
with the same API), ``CachingTextEncoder`` (each expression encoded once,
rows padded to ``max_len``) and ``build_text_encoder``. Random tables and
weights come from seeded ``torch.Generator``s; they equal the JAX
package's only when carried across.
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


# ---------------------------------------------------------------------------
# Selection's frozen expression encoders
# ---------------------------------------------------------------------------

def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
              ) -> torch.Tensor:
    """Attention-mask mean pooling (train.py:86-89), clamp min 1e-9."""
    m = attention_mask.to(hidden.dtype)[..., None]
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)


def hf_roberta_state_dict(state: dict) -> dict:
    """An HF ``RobertaModel`` state dict restricted to ``RobertaEncoder``'s
    keys (the port's names are HF's; the pooler and position-id buffers
    are dropped)."""
    return {k: v for k, v in state.items()
            if k.startswith(("embeddings.", "encoder."))
            and not k.endswith("position_ids")}


def init_roberta(model: RobertaEncoder, seed: int = 0) -> None:
    """HF's random initialization from a seeded ``torch.Generator``:
    N(0, 0.02) weights and embeddings, zero biases, LayerNorm 1/0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * 0.02)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class TextEncoder:
    """Frozen text encoder: texts -> (lang_tokens (b, w, d), lang_mask
    (b, w) bool, pos_tokens (b, 1, d)) on ``device``. ``lang_tokens`` is
    the last hidden state; ``pos_tokens`` the mean-pooled sentence
    embedding, the alignment loss's positive (train.py:90)."""

    def __init__(self, model: RobertaEncoder, tokenizer=None,
                 max_len: int = 96):
        cfg = model.cfg
        self.cfg = cfg
        self.model = model.eval().requires_grad_(False)
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer or HashTokenizer(cfg.vocab_size,
                                                    cfg.pad_token_id)
        self.max_len = max_len

    @classmethod
    def random_init(cls, cfg: Optional[RobertaConfig] = None, seed: int = 0,
                    device="cpu") -> "TextEncoder":
        model = RobertaEncoder(cfg or RobertaConfig.tiny())
        init_roberta(model, seed)
        return cls(model.to(device))

    @classmethod
    def from_hf_torch(cls, state_dict: dict,
                      cfg: Optional[RobertaConfig] = None, tokenizer=None,
                      device="cpu") -> "TextEncoder":
        model = RobertaEncoder(cfg or RobertaConfig.large())
        model.load_state_dict(hf_roberta_state_dict(state_dict))
        return cls(model.to(device), tokenizer)

    @torch.no_grad()
    def encode_batch(self, texts: list):
        input_ids, mask = self.tokenizer(texts, max_len=self.max_len)
        ids = torch.from_numpy(np.asarray(input_ids)).to(self.device)
        mask = torch.from_numpy(np.asarray(mask)).to(self.device)
        hidden = self.model(ids, mask)
        return hidden, mask.bool(), mean_pool(hidden, mask)[:, None, :]


class HashTextEncoder:
    """Weight-free deterministic text embedder with the TextEncoder API:
    each token id looks up a fixed Gaussian table, made from a seeded
    generator or given as ``table`` (vocab, hidden), an array or a CPU
    tensor."""

    def __init__(self, hidden_size: int = 1024, vocab_size: int = 4096,
                 seed: int = 0, max_len: int = 96, table=None,
                 device="cpu"):
        self.hidden_size = hidden_size
        self.tokenizer = HashTokenizer(vocab_size)
        self.max_len = max_len
        if table is None:
            table = torch.randn(vocab_size, hidden_size,
                                generator=torch.Generator().manual_seed(seed))
        self.table = torch.from_numpy(np.array(table, np.float32)).to(device)

    @torch.no_grad()
    def encode_batch(self, texts: list):
        input_ids, mask = self.tokenizer(texts, max_len=self.max_len)
        dev = self.table.device
        ids = torch.from_numpy(input_ids.astype(np.int64)).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        hidden = self.table[ids % self.table.shape[0]]
        hidden = hidden * mask.to(hidden.dtype)[..., None]
        return hidden, mask.bool(), mean_pool(hidden, mask)[:, None, :]


class CachingTextEncoder:
    """Per-expression memoizing wrapper for a frozen text encoder.

    Each unique expression is encoded once and its rows stay on the
    device; rows are padded to the encoder's ``max_len``, so any mix of
    cached rows stacks into one shape (the mask-aware model ignores the
    padded words)."""

    def __init__(self, inner, max_entries: int = 100_000):
        self.inner = inner
        self.max_entries = max_entries
        self.max_len = int(getattr(inner, "max_len", 96))
        self._rows: dict = {}  # text -> (hidden, mask, pooled) rows

    def _pad_rows(self, hidden, mask, pooled):
        w = hidden.shape[1]
        if w > self.max_len:
            hidden, mask, w = (hidden[:, :self.max_len],
                               mask[:, :self.max_len], self.max_len)
        if w < self.max_len:
            hidden = F.pad(hidden, (0, 0, 0, self.max_len - w))
            mask = F.pad(mask, (0, self.max_len - w))
        return hidden, mask.bool(), pooled

    def encode_batch(self, texts: list):
        """(hidden (b, max_len, d), mask (b, max_len), pooled (b, 1, d))."""
        unseen = [t for t in dict.fromkeys(texts) if t not in self._rows]
        if unseen:
            hidden, mask, pooled = self._pad_rows(
                *self.inner.encode_batch(unseen))
            for i, t in enumerate(unseen):
                if len(self._rows) < self.max_entries:
                    self._rows[t] = (hidden[i], mask[i], pooled[i])
        rows = [self._rows.get(t) for t in texts]
        if any(r is None for r in rows):  # over capacity: encode directly
            return self._pad_rows(*self.inner.encode_batch(texts))
        return tuple(torch.stack([r[i] for r in rows]) for i in range(3))


def build_text_encoder(model_configs: dict, device="cpu"):
    """The configured frozen text encoder on ``device``.

    ``text_encoder: roberta_random`` builds the real 24-layer RoBERTa-large
    with seeded random weights and the hash tokenizer. Otherwise the HF
    checkpoint ``roberta_version`` is used when it and its tokenizer are on
    disk, and the deterministic hash encoder when they are not."""
    version = model_configs.get("roberta_version",
                                "sentence-transformers/all-roberta-large-v1")
    lang_dim = model_configs.get("lang_token_dim", 1024)
    if model_configs.get("text_encoder") == "roberta_random":
        return TextEncoder.random_init(RobertaConfig.large(), device=device)
    try:
        import os
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        from transformers import AutoModel, AutoTokenizer
        hf_model = AutoModel.from_pretrained(version, local_files_only=True)
        hf_tok = AutoTokenizer.from_pretrained(version, local_files_only=True)
    except Exception:  # no transformers, or the checkpoint is not on disk
        return HashTextEncoder(hidden_size=lang_dim, device=device)

    def tokenize(texts, max_len=None):
        out = hf_tok(texts, padding="longest",
                     truncation=max_len is not None, max_length=max_len,
                     return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))

    hf_cfg = hf_model.config
    cfg = RobertaConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        pad_token_id=hf_cfg.pad_token_id,
        type_vocab_size=hf_cfg.type_vocab_size)
    return TextEncoder.from_hf_torch(hf_model.state_dict(), cfg,
                                     tokenizer=tokenize, device=device)
