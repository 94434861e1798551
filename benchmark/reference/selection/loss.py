"""Training losses for track selection.

Counterpart of ``sola_tpu/train/loss.py``:

* weighted BCE on per-track logits with positive upweighting
  (train.py:98-104, mean reduction);
* the contrastive alignment loss (tools/loss.py:4-58): pooled score tokens
  against the mean-pooled sentence embedding (one positive) and the learned
  negative tokens, logits scaled by ``exp(temperature)``, with hard-negative
  mining (only the argmax negative logit of a track carries a positive
  target for non-referred tracks).

Both are mask-aware: padded tracks are left out of every mean. Under data
parallelism (``total_loss(..., group=...)``) each rank divides its own sum
by the number of valid tracks over the whole group, held as a constant, so
the ranks' losses and gradients add up to the global batch's: ranks hold
different numbers of valid tracks (and rows padded to fill a shard hold
none), so an average of per-rank means would weigh them wrongly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    valid_mask: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy with logits, torch-compatible weighting;
    with a validity mask the mean runs over valid elements only.
    ``count`` replaces the number of (valid) elements as the divisor."""
    # numerically stable: max(x, 0) - x z + log(1 + exp(-|x|))
    per_elem = (logits.clamp_min(0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    if weight is not None:
        per_elem = per_elem * weight
    if valid_mask is None:
        return per_elem.mean() if count is None else per_elem.sum() / count
    m = valid_mask.to(per_elem.dtype)
    denom = m.sum() if count is None else count
    return (per_elem * m).sum() / denom.clamp_min(1.0)


def selection_bce_loss(score_logits: torch.Tensor, labels: torch.Tensor,
                       positive_weight: float,
                       track_mask: Optional[torch.Tensor] = None,
                       count: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Weighted BCE on (b, n) track logits (train.py:98-104); ``count``:
    the valid tracks to divide by."""
    weight = 1.0 + (positive_weight - 1.0) * labels
    return bce_with_logits(score_logits, labels, weight, track_mask, count)


def alignment_loss(score_tokens: torch.Tensor,   # (b, n, d)
                   labels: torch.Tensor,         # (b, n) in {0, 1}
                   pos_tokens: torch.Tensor,     # (b, 1, d)
                   neg_tokens: torch.Tensor,     # (b, m, d)
                   temperature: float, positive_weight: float,
                   track_mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Contrastive alignment loss (tools/loss.py:14-58); ``count``: the
    valid tracks to divide by."""
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
    m = neg_tokens.shape[1]
    pos_loss = bce_with_logits(pos_logits, labels[..., None],
                               valid_mask=pos_mask, count=count)
    neg_loss = bce_with_logits(neg_logits, neg_targets, valid_mask=neg_mask,
                               count=None if count is None else count * m)
    return positive_weight * pos_loss + neg_loss


def total_loss(score_logits: torch.Tensor, score_tokens: torch.Tensor,
               labels: torch.Tensor, pos_tokens: torch.Tensor,
               neg_tokens: torch.Tensor, *, temperature: float,
               positive_weight: float, alignment_weight: float,
               track_mask: Optional[torch.Tensor] = None, group=None):
    """bce + alignment_weight * alignment (train.py:113); returns
    (loss, parts). With a data-parallel ``group`` each mean divides by the
    valid tracks of the whole group, so the parts summed over the group
    are the global batch's."""
    count = None
    if group is not None:
        valid = (track_mask.sum() if track_mask is not None
                 else torch.tensor(labels.numel(), device=labels.device))
        count = valid.to(score_logits.dtype)
        dist.all_reduce(count, group=group)
    bce = selection_bce_loss(score_logits, labels, positive_weight,
                             track_mask, count)
    align = alignment_loss(score_tokens, labels, pos_tokens, neg_tokens,
                           temperature, positive_weight, track_mask, count)
    loss = bce + alignment_weight * align
    return loss, {"total": loss, "bce": bce, "alignment": align}
