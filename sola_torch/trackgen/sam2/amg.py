"""SAM2 automatic mask generator: dense point-grid proposal generation.

Counterpart of ``sola_tpu/trackgen/sam2/amg.py``, the grid-prompt source of
the pipeline (generate_prompts_grid.py:66-100 uses
``SAM2AutomaticMaskGenerator.generate``). The point grid decodes on the
device in chunks of ``points_per_batch`` (3 masks a point); the IoU and
stability filter runs there over low-res logits into a bounded survivor
buffer; only survivors are upscaled, thresholded and bit-packed. Box NMS
and the records stay on the host. Device results reach the host through
``HostCopy``: copies enqueued right behind the work that makes them, read
after their event.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from sola_torch.trackgen.sam2.image import (HostCopy, SAM2ImagePredictor,
                                            unpack_masks)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Normalized (n^2, 2) xy grid in (0, 1), SAM's AMG layout."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1.0 - offset, n_per_side, dtype=np.float32)
    xs, ys = np.meshgrid(pts, pts)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def box_from_mask(mask: np.ndarray) -> np.ndarray:
    """xyxy bounding box of a binary mask (zeros -> [0,0,0,0])."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                      np.float32)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_thresh: float) -> np.ndarray:
    """Greedy NMS; returns kept indices sorted by score desc."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    ious = box_iou(boxes, boxes)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= ious[i] > iou_thresh
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SAM2AutomaticMaskGenerator:
    def __init__(self, predictor: SAM2ImagePredictor,
                 points_per_side: int = 32,
                 # the JAX package's 256 points a chunk (upstream's 64 is a
                 # GPU memory default; a 256-point chunk's logits take
                 # 200 MB at 1024 px)
                 points_per_batch: int = 256,
                 pred_iou_thresh: float = 0.8,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 min_mask_region_area: int = 0,
                 # survivor buffer of the single-pass path; at the reference
                 # thresholds a frame keeps O(100), so 1024 (1/3 of the
                 # 32x32 grid's 3072 proposals) overflows only at near-zero
                 # thresholds, which then take the per-chunk path below
                 max_survivors: int = 1024):
        self.predictor = predictor
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area
        self.max_survivors = max_survivors

    def generate(self, image: np.ndarray) -> list[dict]:
        """(H, W, 3) uint8 -> list of mask records sorted by area desc, with
        the fields the grid-prompt CLI consumes (segmentation,
        stability_score, area; generate_prompts_grid.py:119-128).

        Encode, whole-grid propose/filter, finalize of the survivors' prefix
        of the score-sorted buffer, host NMS, then the kept masks. Survivors
        beyond ``max_survivors`` take the per-chunk path instead."""
        return self._finish(self._dispatch_finalize(self._enqueue(image)))

    def generate_many(self, images) -> Iterator[list[dict]]:
        """Pipelined AMG over a frame sequence, the same records as
        ``generate`` frame by frame: frame k's finalize is enqueued (after
        its survivor count, which waits only on its own propose) before
        frame k+1's encode and propose, and frame k's host work (NMS, the
        mask fetch, the records) runs while the card computes frame k+1
        (the per-frame loop of generate_prompts_grid.py:96-100)."""
        prev = None
        for image in images:
            fin = self._dispatch_finalize(prev) if prev is not None else None
            prev = self._enqueue(image)
            if fin is not None:
                yield self._finish(fin)
        if prev is not None:
            yield self._finish(self._dispatch_finalize(prev))

    def _enqueue(self, image: np.ndarray):
        """Device phase: encode + whole-grid propose/filter; the survivor
        count and scalars start their copies to the host right behind it."""
        h, w = image.shape[:2]
        self.predictor.set_image(image)
        grid = build_point_grid(self.points_per_side)
        coords = grid * np.asarray([w, h], np.float32)
        (_scores, low_dev, flat_all, iou_all, stab_all,
         n_valid) = self.predictor.propose_filter(
            coords[:, None, :], self.stability_score_offset,
            self.pred_iou_thresh, self.stability_score_thresh,
            chunk=self.points_per_batch, k_max=self.max_survivors)
        scalars = HostCopy(n_valid, flat_all, iou_all, stab_all)
        return (image, coords, grid, h, w, low_dev, scalars)

    def _dispatch_finalize(self, pending):
        """Boundary phase: read the survivor count (it waits only on this
        frame's propose) and enqueue the finalize of the buffer's leading
        rows, its outputs' host copies right behind it."""
        image, coords, grid, h, w, low_dev, scalars = pending
        n_valid, flat_all, iou_all, stab_all = scalars.get()
        k = int(n_valid)
        if k > self.max_survivors:
            # the predictor's features may already be a later frame's in
            # the pipelined path: encode this image again
            self.predictor.set_image(image)
            return ("records",
                    self._generate_multi_dispatch(image, coords, grid, h, w))
        if k == 0:
            return ("records", [])
        # the k survivors lead the score-sorted buffer: finalize the next
        # power of two (at least 64) rows, not the whole buffer
        k_fin = min(low_dev.shape[0], max(64, 1 << (k - 1).bit_length()))
        fin = HostCopy(*self.predictor.finalize_masks_dispatch(
            low_dev, h, w, k_fin=k_fin))
        return ("fin", fin, k, iou_all, stab_all, flat_all, coords, h, w)

    def _finish(self, fin) -> list[dict]:
        """Host phase: boxes and areas, NMS, the kept masks, the records."""
        if fin[0] == "records":
            return fin[1]
        _, copy, k, iou_all, stab_all, flat_all, coords, h, w = fin
        packed, boxes, areas = copy.get()
        kept_pts = [coords[i] for i in flat_all[:k] // 3]
        return self._select_and_emit(
            packed, boxes[:k], areas[:k], [float(x) for x in iou_all[:k]],
            [float(x) for x in stab_all[:k]], kept_pts, h, w)

    def _generate_multi_dispatch(self, image, coords, grid, h, w):
        """Per-chunk path, used only when the survivors overflow the
        single-pass buffer (near-zero thresholds): every chunk's ious and
        stabilities come to the host, the keep decision is made there, and
        the kept logits are gathered on the device in flat order."""
        bsz = self.points_per_batch
        n_pad = ((len(coords) + bsz - 1) // bsz) * bsz
        coords = np.concatenate(
            [coords, np.tile(coords[-1:], (n_pad - len(coords), 1))], axis=0)
        pending = []
        for start in range(0, len(coords), bsz):
            valid = min(bsz, len(grid) - start)
            if valid <= 0:
                break
            batch = coords[start:start + bsz]
            ious, stab, low = self.predictor.propose_device(
                batch[:, None, :], self.stability_score_offset)
            pending.append((batch, valid, ious, stab, low))

        kept_iou, kept_stab, kept_pts, kept_flat_idx = [], [], [], []
        for bi, (batch, valid, ious_dev, stab_dev, _) in enumerate(pending):
            ious, stab = _host(ious_dev), _host(stab_dev)
            keep = (ious > self.pred_iou_thresh) & (
                stab > self.stability_score_thresh)
            keep[valid:] = False
            idx_n, idx_k = np.nonzero(keep)
            kept_flat_idx.extend((bi * bsz + idx_n) * ious.shape[1] + idx_k)
            kept_iou.extend(float(x) for x in ious[idx_n, idx_k])
            kept_stab.extend(float(x) for x in stab[idx_n, idx_k])
            kept_pts.extend(batch[i] for i in idx_n)
        if not kept_flat_idx:
            return []
        low_full = torch.cat([p[4] for p in pending], dim=0)
        lh, lw = low_full.shape[-2:]
        idx = torch.as_tensor(np.asarray(kept_flat_idx, np.int64),
                              device=low_full.device)
        packed_dev, boxes, areas = self.predictor.finalize_masks_device(
            low_full.reshape(-1, lh, lw)[idx], h, w)
        return self._select_and_emit(packed_dev, boxes, areas, kept_iou,
                                     kept_stab, kept_pts, h, w)

    def _select_and_emit(self, packed, boxes, areas, kept_iou, kept_stab,
                         kept_pts, h, w) -> list[dict]:
        """Shared AMG tail: small-region postprocess, host NMS over the
        boxes, then the kept bit-packed masks. ``packed`` is a host array
        (the single-pass path copied its whole small buffer) or a device
        tensor (the per-chunk path's can hold ~3k masks, so only the kept
        rows are fetched)."""
        k = len(kept_iou)
        if self.min_mask_region_area > 0:
            # CCL edits need every mask on the host and change geometry
            masks = unpack_masks(_host(packed), h, w)[:k]
            masks, kept_iou, kept_stab, kept_pts = \
                self._postprocess_small_regions(masks, kept_iou, kept_stab,
                                                kept_pts)
            if len(masks) == 0:
                return []
            boxes = np.stack([box_from_mask(m) for m in masks], axis=0)
            areas = masks.reshape(len(masks), -1).sum(axis=1)
            fetch_masks = lambda keep: masks[keep]  # noqa: E731
        elif isinstance(packed, torch.Tensor):
            def fetch_masks(keep):
                rows = torch.as_tensor(keep, device=packed.device)
                return unpack_masks(packed[rows].cpu().numpy(), h, w)
        else:
            def fetch_masks(keep):
                return unpack_masks(packed[keep], h, w)

        nonempty = areas > max(self.min_mask_region_area, 0)
        idxs = np.nonzero(nonempty)[0]
        if len(idxs) == 0:
            return []
        keep = idxs[nms(boxes[idxs], np.asarray(kept_iou)[idxs],
                        self.box_nms_thresh)]
        kept_masks = fetch_masks(keep)

        records = []
        for j, i in enumerate(keep):
            records.append({
                "segmentation": kept_masks[j],
                "area": int(areas[i]),
                "bbox": boxes[i].tolist(),
                "predicted_iou": kept_iou[i],
                "stability_score": kept_stab[i],
                "point_coords": [kept_pts[i].tolist()],
            })
        records.sort(key=lambda r: r["area"], reverse=True)
        return records

    def _postprocess_small_regions(self, masks, ious, stabs, pts):
        """Upstream postprocess_small_regions: fill small holes, drop small
        islands, then NMS over the recomputed boxes preferring unchanged
        masks."""
        from sola_torch.core.ccl import remove_small_regions

        area = self.min_mask_region_area
        new_masks, unchanged_scores = [], []
        for m in masks:
            m2, ch1 = remove_small_regions(m, area, "holes")
            m3, ch2 = remove_small_regions(m2, area, "islands")
            new_masks.append(m3)
            unchanged_scores.append(float(not (ch1 or ch2)))
        new_masks = np.stack(new_masks, axis=0)
        boxes = np.stack([box_from_mask(m) for m in new_masks], axis=0)
        keep = nms(boxes, np.asarray(unchanged_scores), self.box_nms_thresh)
        keep = np.sort(keep)
        return (new_masks[keep], [ious[i] for i in keep],
                [stabs[i] for i in keep], [pts[i] for i in keep])
