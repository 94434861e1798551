"""Training losses for track selection.

Counterpart of ``sola_tpu/train/loss.py``:

* weighted BCE on per-track logits with positive upweighting
  (train.py:98-104, mean reduction);
* the contrastive alignment loss (tools/loss.py:4-58): pooled score tokens
  against the mean-pooled sentence embedding (one positive) and the learned
  negative tokens, logits scaled by ``exp(temperature)``, with hard-negative
  mining (only the argmax negative logit of a track carries a positive
  target for non-referred tracks).

Both are mask-aware: padded tracks are left out of every mean.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    valid_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Mean binary cross-entropy with logits, torch-compatible weighting;
    with a validity mask the mean runs over valid elements only."""
    # numerically stable: max(x, 0) - x z + log(1 + exp(-|x|))
    per_elem = (logits.clamp_min(0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    if weight is not None:
        per_elem = per_elem * weight
    if valid_mask is None:
        return per_elem.mean()
    m = valid_mask.to(per_elem.dtype)
    return (per_elem * m).sum() / m.sum().clamp_min(1.0)


def selection_bce_loss(score_logits: torch.Tensor, labels: torch.Tensor,
                       positive_weight: float,
                       track_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Weighted BCE on (b, n) track logits (train.py:98-104)."""
    weight = 1.0 + (positive_weight - 1.0) * labels
    return bce_with_logits(score_logits, labels, weight, track_mask)


def alignment_loss(score_tokens: torch.Tensor,   # (b, n, d)
                   labels: torch.Tensor,         # (b, n) in {0, 1}
                   pos_tokens: torch.Tensor,     # (b, 1, d)
                   neg_tokens: torch.Tensor,     # (b, m, d)
                   temperature: float, positive_weight: float,
                   track_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Contrastive alignment loss (tools/loss.py:14-58)."""
    scale = torch.exp(torch.tensor(temperature, dtype=score_tokens.dtype))
    pos_logits = torch.einsum("bnd,bmd->bnm", score_tokens,
                              pos_tokens.to(score_tokens.dtype)) * scale
    neg_logits = torch.einsum("bnd,bmd->bnm", score_tokens,
                              neg_tokens) * scale
    # hard-negative mining: the target only at the argmax negative logit
    onehot = F.one_hot(neg_logits.argmax(dim=-1),
                       neg_tokens.shape[1]).to(neg_logits.dtype)
    neg_targets = (1.0 - labels)[..., None] * onehot
    pos_mask = neg_mask = None
    if track_mask is not None:
        pos_mask = track_mask[..., None]
        neg_mask = track_mask[..., None].expand_as(neg_logits)
    pos_loss = bce_with_logits(pos_logits, labels[..., None],
                               valid_mask=pos_mask)
    neg_loss = bce_with_logits(neg_logits, neg_targets, valid_mask=neg_mask)
    return positive_weight * pos_loss + neg_loss


def total_loss(score_logits: torch.Tensor, score_tokens: torch.Tensor,
               labels: torch.Tensor, pos_tokens: torch.Tensor,
               neg_tokens: torch.Tensor, *, temperature: float,
               positive_weight: float, alignment_weight: float,
               track_mask: Optional[torch.Tensor] = None):
    """bce + alignment_weight * alignment (train.py:113); returns
    (loss, parts)."""
    bce = selection_bce_loss(score_logits, labels, positive_weight,
                             track_mask)
    align = alignment_loss(score_tokens, labels, pos_tokens, neg_tokens,
                           temperature, positive_weight, track_mask)
    loss = bce + alignment_weight * align
    return loss, {"total": loss, "bce": bce, "alignment": align}
