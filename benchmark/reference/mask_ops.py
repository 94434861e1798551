"""Batched mask metrics and resizes on torch tensors.

Counterpart of ``sola_tpu/core/mask_ops.py``, with the reference's
empty-mask conventions, vectorized over frames and masks:

* IoU with union==0 -> 1.0 and precision/recall conventions:
  track_generation/utils.py:131-174 (compute_mask_metrics)
* partness P = |part & full| / |part|: track_generation/utils.py:177-192
* J (per-frame IoU mean, union==0 -> 1.0): evaluator.py:227-237
* F (pixel F-measure over the whole masklet, tp==0 -> 0.0):
  evaluator.py:239-247  (note: pixel F, NOT the DAVIS boundary F)
* reshape_masklet (bilinear resize, >0.5 binarize, 540/960 orientation rule):
  track_generation/seg_utils.py:145-160

Functions take tensors or numpy arrays with values in {0, 1} and reduce in
float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def resize_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Resize the last two axes of a float tensor, half-pixel centers.

    Matches ``jax.image.resize(method="linear")``: that resize widens its
    triangle kernel when it downscales (antialiasing) and is plain bilinear
    when it upscales, so torch's ``antialias`` is on exactly when an axis
    shrinks."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=(oh < h or ow < w))
    return y.reshape(*lead, oh, ow)


def mask_iou(mask_a, mask_b) -> torch.Tensor:
    """IoU of two (..., H, W) masks over the last two axes; union==0 -> 1.0."""
    a = _f32(mask_a)
    b = _f32(mask_b).to(a.device)
    inter = (a * b).sum(dim=(-2, -1))
    union = a.sum(dim=(-2, -1)) + b.sum(dim=(-2, -1)) - inter
    return torch.where(union == 0, torch.ones_like(union),
                       inter / union.clamp_min(1.0))


def masklet_iou(masklet_a, masklet_b) -> torch.Tensor:
    """Whole-masklet IoU: one scalar over all of (T, H, W); union==0 -> 1.0."""
    a, b = _f32(masklet_a), _f32(masklet_b)
    inter = (a * b).sum()
    union = a.sum() + b.sum() - inter
    return torch.where(union == 0, torch.ones_like(union),
                       inter / union.clamp_min(1.0))


def mask_metrics(pred_masks, gt_masks, reduction: str = "mean"):
    """Per-frame (precision, recall, iou) for (T, H, W) masklets with the
    empty-mask conventions:
        union == 0           -> iou 1.0
        n_pred==0, n_gt==0   -> precision 1.0, recall 1.0
        n_pred==0, n_gt>0    -> precision 1.0, recall 0.0
        n_pred>0,  n_gt==0   -> precision 0.0, recall 1.0
    """
    p = _f32(pred_masks)
    g = _f32(gt_masks).to(p.device)
    inter = (p * g).sum(dim=(-2, -1))
    n_pred = p.sum(dim=(-2, -1))
    n_gt = g.sum(dim=(-2, -1))
    union = n_pred + n_gt - inter
    one, zero = torch.ones_like(inter), torch.zeros_like(inter)
    iou = torch.where(union == 0, one, inter / union.clamp_min(1.0))
    precision = torch.where(n_pred == 0, one, inter / n_pred.clamp_min(1.0))
    precision = torch.where((n_pred > 0) & (n_gt == 0), zero, precision)
    recall = torch.where(n_gt == 0, one, inter / n_gt.clamp_min(1.0))
    recall = torch.where((n_gt > 0) & (n_pred == 0), zero, recall)
    if reduction == "mean":
        return precision.mean(), recall.mean(), iou.mean()
    if reduction == "none":
        return precision, recall, iou
    raise ValueError(f"Invalid reduction method: {reduction}")


def partness(part_masks, full_mask) -> torch.Tensor:
    """P = |part & full| / |part| for (N, H, W) parts vs one (H, W) mask."""
    parts = _f32(part_masks)
    n = parts.shape[0]
    parts = parts.reshape(n, -1)
    full = _f32(full_mask).reshape(-1, 1)
    inter = parts @ full
    return (inter / parts.sum(dim=1, keepdim=True)).squeeze(1)


def compute_J(pred_masklet, gt_masklet) -> torch.Tensor:
    """Region similarity J: mean per-frame IoU, union==0 -> 1.0."""
    return mask_iou(pred_masklet, gt_masklet).mean()


def compute_F(pred_masklet, gt_masklet) -> torch.Tensor:
    """Pixel F-measure over the whole masklet, tp==0 -> 0.0."""
    p, g = _f32(pred_masklet), _f32(gt_masklet)
    tp = (p * g).sum()
    fp = ((1.0 - g) * p).sum()
    fn = (g * (1.0 - p)).sum()
    precision = tp / (tp + fp).clamp_min(1.0)
    recall = tp / (tp + fn).clamp_min(1.0)
    f = 2.0 * precision * recall / (precision + recall).clamp_min(1e-38)
    return torch.where(tp == 0, torch.zeros_like(f), f)


def compute_JF(pred_masklet, gt_masklet):
    """(J, F) of two masklets in one pass."""
    return compute_J(pred_masklet, gt_masklet), compute_F(pred_masklet,
                                                          gt_masklet)


def reshape_hw(h: int, w: int) -> tuple[int, int]:
    """The reference's <=960x540 canonical size rule (seg_utils.py:153-155)."""
    return (540, 960) if h < w else (960, 540)


def resize_nearest_np(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Host-side nearest resize with half-pixel-center floor indexing, the
    rule of ``jax.image.resize(method='nearest')``."""
    oh, ow = out_hw
    h, w = x.shape[-2:]
    ri = np.floor((np.arange(oh) + 0.5) * h / oh).astype(np.int64)
    ci = np.floor((np.arange(ow) + 0.5) * w / ow).astype(np.int64)
    return x[..., ri[:, None], ci[None, :]]


def reshape_masklet(masklet, target_shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize a (T, H, W) masklet and binarize at 0.5
    (seg_utils.py:145-160)."""
    resized = resize_bilinear(_f32(masklet), target_shape)
    return (resized > 0.5).to(torch.float32)


def reshape_masklet_auto(masklet) -> torch.Tensor:
    """reshape_masklet with the 540/960 orientation rule applied."""
    _, h, w = masklet.shape
    return reshape_masklet(masklet, reshape_hw(h, w))
