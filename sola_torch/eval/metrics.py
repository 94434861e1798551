"""Track/expression selection-recall metrics (tools/metric.py:2-59).

Vectorized over tracks; kept for inventory parity (the reference imports but
never calls these — SURVEY.md §2.1 notes them as dead code; here they are
tested and usable).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def recall_per_track(gt_anno_ids: Sequence[int], preds, labels,
                     corresponding_gt_anno_ids: Sequence[int]) -> list[float]:
    """Per-GT-track recall: among positive-labelled tracks assigned to a GT
    anno, the fraction predicted positive. GT annos with no positive-labelled
    track are skipped."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    corr = np.asarray(corresponding_gt_anno_ids)
    out = []
    for gt_anno_id in gt_anno_ids:
        sel = (corr == gt_anno_id) & (labels == 1)
        total = int(sel.sum())
        if total == 0:
            continue
        tp = int((preds[sel] > 0).sum())
        out.append(tp / total)
    return out


def recall_per_exp(gt_anno_ids: Sequence[int], preds, labels,
                   corresponding_gt_anno_ids: Sequence[int]) -> float:
    """Fraction of GT annos detected by at least one positive prediction."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    corr = np.asarray(corresponding_gt_anno_ids)
    n_total = len(gt_anno_ids)
    n_detected = 0
    for gt_anno_id in gt_anno_ids:
        sel = (corr == gt_anno_id) & (labels == 1) & (preds > 0)
        if sel.any():
            n_detected += 1
    return n_detected / n_total
