"""SAM2 image predictor: single-image box/point -> mask prediction.

Counterpart of the box/point half of ``sola_tpu/trackgen/sam2/image.py``:
the surface the reference's prompt generators consume
(prompt_generator.py:59-117: set_image / predict with boxes,
multimask_output=False), the bit-packed ``predict_packed`` the GroundingDINO
prompt stage calls, the stability score helper
(prompt_generator.py:169-186), and the automatic mask generator's device
half (``propose*``, ``finalize*``): point prompts decode to low-res logits
on the device, the threshold survivors stay there in a bounded buffer, and
only the survivors are upscaled, thresholded and bit-packed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sola_torch.core.mask_ops import resize_bilinear
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.video import encode_raw

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def cast_for_image_compute(model: SAM2Model, compute_dtype) -> SAM2Model:
    """Cast ``model`` in place with the JAX image predictor's precision:
    every parameter and buffer is rounded through ``compute_dtype`` and the
    image enters the patch embedding in it, but Hiera's fp32 position
    embedding promotes everything after the patch embedding to fp32, and the
    fp32 image features promote the prompt encoder and mask decoder too. So
    the patch embedding computes in ``compute_dtype`` and the rest in fp32
    on the rounded weights (exact)."""
    model.to(compute_dtype)
    if compute_dtype != torch.float32:
        model.float()
        model.image_encoder.trunk.patch_embed.to(compute_dtype)
    return model


def _bitpack_masks(m: torch.Tensor) -> torch.Tensor:
    """(N, h, w) bool -> (N, h, ceil(w/8)) uint8, MSB-first rows (the
    layout ``unpack_masks`` reverses): 1 bit per pixel to the host."""
    n, h, w = m.shape
    w8 = (w + 7) // 8 * 8
    bits = torch.nn.functional.pad(m.to(torch.uint8), (0, w8 - w))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=m.device)
    return (bits.reshape(n, h, w8 // 8, 8) * weights).sum(
        dim=-1, dtype=torch.uint8)


def _stability_from_logits(low: torch.Tensor, offset: float) -> torch.Tensor:
    """|logit > +off| / |logit > -off| over the last two axes (SAM AMG
    stability rule; prompt_generator.py:169-186)."""
    inter = (low > offset).sum(dim=(-2, -1)).float()
    union = (low > -offset).sum(dim=(-2, -1)).float()
    return torch.where(union > 0, inter / union.clamp_min(1.0),
                       torch.zeros_like(inter))


class SAM2ImagePredictor:
    def __init__(self, model: SAM2Model, compute_dtype=torch.bfloat16):
        """``model`` is cast in place (``cast_for_image_compute``);
        ``compute_dtype=bfloat16`` mirrors the reference's autocast bf16
        around the image-predict path (generate_prompts_grid.py:57-63)."""
        self.model = cast_for_image_compute(model, compute_dtype).eval()
        self.cfg: SAM2Config = model.cfg
        self.device = next(model.parameters()).device
        self.compute_dtype = compute_dtype
        self._feats = None
        self._orig_hw = None

    def set_image(self, image: np.ndarray) -> None:
        """(H, W, 3) uint8; the raw image crosses to the device as uint8."""
        self._orig_hw = tuple(image.shape[:2])
        raw = torch.from_numpy(np.array(image, np.uint8)).to(self.device)
        self._feats = encode_raw(self.model, raw[None], self.compute_dtype)

    def snapshot_features(self):
        """Capture the current image's cached features, so a pipelined
        caller can ``set_image`` the next frame (enqueueing its encode) and
        later ``restore_features`` to predict against this one."""
        return (self._feats, self._orig_hw)

    def restore_features(self, snapshot) -> None:
        self._feats, self._orig_hw = snapshot

    def _scale_coords(self, coords: np.ndarray) -> np.ndarray:
        h, w = self._orig_hw
        s = self.cfg.image_size
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= s / w
        out[..., 1] *= s / h
        return out

    def _prep_prompts(self, point_coords, point_labels, box):
        """Box/point prompts -> padded (coords, labels, n_real). Box
        corners are labelled 2 and 3. The prompt axis is padded to a
        multiple of 4 by repeating the last row, as the JAX package does
        for its compiled shapes; callers slice the padding off."""
        prompts = []
        if box is not None:
            box = np.asarray(box, np.float32)
            if box.ndim == 1:
                box = box[None]
            corners = self._scale_coords(box.reshape(-1, 2, 2))
            labels = np.tile(np.asarray([2, 3], np.int32)[None],
                             (corners.shape[0], 1))
            prompts.append((corners, labels))
        if point_coords is not None:
            pts = self._scale_coords(
                np.asarray(point_coords, np.float32).reshape(
                    -1, point_coords.shape[-2]
                    if point_coords.ndim > 2 else 1, 2))
            lbl = np.asarray(point_labels, np.int32).reshape(pts.shape[:2])
            prompts.append((pts, lbl))
        if not prompts:
            raise ValueError("no prompts given")
        coords = np.concatenate([p[0] for p in prompts], axis=1)
        labels = np.concatenate([p[1] for p in prompts], axis=1)
        n_real = coords.shape[0]
        n_pad = ((n_real + 3) // 4) * 4
        if n_pad != n_real:
            reps = (n_pad - n_real, 1, 1)
            coords = np.concatenate([coords, np.tile(coords[-1:], reps)], 0)
            labels = np.concatenate([labels, np.tile(labels[-1:], reps[:2])],
                                    0)
        return coords, labels, n_real

    @torch.no_grad()
    def _heads(self, coords, labels, multimask: bool,
               compute_high_res: bool = True) -> dict:
        """SAM heads on the cached batch-1 features, broadcast over the N
        prompt sets (arrays or device tensors)."""
        if self._feats is None:
            raise RuntimeError("call set_image first")
        n = coords.shape[0]
        pix, s0, s1 = (self._feats[k].expand(n, *self._feats[k].shape[1:])
                       for k in ("pix", "s0", "s1"))
        return self.model.sam_heads(
            pix, s0, s1, torch.as_tensor(coords, device=self.device),
            torch.as_tensor(labels, device=self.device).long(), None,
            multimask, compute_high_res=compute_high_res)

    # ------------------------------------------------------------------
    # Automatic mask generator: propose on the device, finalize survivors
    # ------------------------------------------------------------------

    def propose(self, point_coords: np.ndarray,
                stability_offset: float = 1.0):
        """AMG proposal pass: (N, 1, 2) point prompts -> host (iou (N, 3),
        stability (N, 3)) and the device's low-res logits (N, 3, 4h, 4w)."""
        ious, stab, low = self.propose_device(point_coords, stability_offset)
        return ious.cpu().numpy(), stab.cpu().numpy(), low

    def propose_device(self, point_coords: np.ndarray,
                       stability_offset: float = 1.0):
        """(iou, stability, low-res logits) of three masks per point as
        device tensors, without a host sync. The high-res masks are never
        built."""
        coords = self._scale_coords(np.asarray(point_coords, np.float32))
        labels = np.ones(coords.shape[:2], np.int64)
        out = self._heads(coords, labels, True, compute_high_res=False)
        low = out["low_res_masks"].float()
        return (out["ious"].float(),
                _stability_from_logits(low, stability_offset), low)

    @torch.no_grad()
    def propose_filter(self, point_coords: np.ndarray,
                       stability_offset: float, iou_thresh: float,
                       stab_thresh: float, chunk: int, k_max: int):
        """Whole-grid AMG propose/filter: (N, 1, 2) image-space points ->
        device (scores, low-res logits, flat index, ious, stabilities,
        n_valid) of the top ``k_max`` threshold survivors, sorted by score
        descending.

        The points decode ``chunk`` at a time; a bounded buffer keeps the
        best ``k_max`` proposals by predicted IoU (-inf where a threshold
        fails). Equal scores keep their earlier position, buffer rows
        before the new chunk's, as ``jax.lax.top_k`` orders them: the
        survivors' order decides NMS ties and the prompt ids. Rows past
        ``n_valid`` (the survivor count, which may exceed ``k_max``) are
        padding: score -inf, flat index -1, zero logits until a rejected
        proposal displaces them."""
        if self._feats is None:
            raise RuntimeError("call set_image first")
        dev = self.device
        coords = self._scale_coords(np.asarray(point_coords, np.float32))
        n = coords.shape[0]
        n_chunks = (n + chunk - 1) // chunk
        pad = n_chunks * chunk - n
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad, 1, 1))])
        coords = torch.from_numpy(coords).to(dev).reshape(n_chunks, chunk, 1, 2)
        valid = torch.arange(n_chunks * chunk, device=dev).reshape(
            n_chunks, chunk) < n
        labels = torch.ones((chunk, 1), dtype=torch.long, device=dev)
        lh = lw = self.cfg.image_size // 4
        scores = torch.full((k_max,), -torch.inf, device=dev)
        low_k = torch.zeros((k_max, lh, lw), device=dev)
        flat_k = torch.full((k_max,), -1, dtype=torch.int32, device=dev)
        iou_k = torch.zeros((k_max,), device=dev)
        stab_k = torch.zeros((k_max,), device=dev)
        n_valid = torch.zeros((), dtype=torch.int32, device=dev)
        per_point = torch.arange(3, dtype=torch.int32, device=dev)
        for c in range(n_chunks):
            out = self._heads(coords[c], labels, True, compute_high_res=False)
            low = out["low_res_masks"].float()        # (chunk, 3, lh, lw)
            stab = _stability_from_logits(low, stability_offset)
            ious = out["ious"].float()                # (chunk, 3)
            keep = (ious > iou_thresh) & (stab > stab_thresh) & valid[c, :, None]
            flat = ((c * chunk + torch.arange(chunk, dtype=torch.int32,
                                              device=dev))[:, None] * 3
                    + per_point[None, :])
            cat_scores = torch.cat([scores, torch.where(
                keep, ious, -torch.inf).reshape(-1)])
            sel = torch.sort(cat_scores, descending=True,
                             stable=True).indices[:k_max]
            scores = cat_scores[sel]
            low_k = torch.cat([low_k, low.reshape(-1, lh, lw)])[sel]
            flat_k = torch.cat([flat_k, flat.reshape(-1)])[sel]
            iou_k = torch.cat([iou_k, ious.reshape(-1)])[sel]
            stab_k = torch.cat([stab_k, stab.reshape(-1)])[sel]
            n_valid = n_valid + keep.sum(dtype=torch.int32)
        return scores, low_k, flat_k, iou_k, stab_k, n_valid

    @torch.no_grad()
    def _finalize_packed(self, low_sel, h: int, w: int,
                         k_fin: Optional[int] = None):
        """Upscale + threshold + bit-pack on the device, with xyxy boxes
        (exclusive max; zeros for an empty mask) and areas from device
        reductions, so the host never scans a mask. ``k_fin`` finalizes
        only the leading rows of a score-sorted buffer."""
        low_sel = torch.as_tensor(low_sel, device=self.device)
        if k_fin is not None:
            low_sel = low_sel[:k_fin]
        m = resize_bilinear(low_sel.float(), (h, w)) > 0.0   # (K, h, w)
        areas = m.sum(dim=(1, 2), dtype=torch.int32)
        any_y, any_x = m.any(dim=2), m.any(dim=1)
        ys = torch.arange(h, dtype=torch.int32, device=m.device)
        xs = torch.arange(w, dtype=torch.int32, device=m.device)
        big = torch.tensor(1 << 30, dtype=torch.int32, device=m.device)
        none = torch.tensor(-1, dtype=torch.int32, device=m.device)
        y0 = torch.where(any_y, ys, big).amin(dim=1)
        y1 = torch.where(any_y, ys, none).amax(dim=1) + 1
        x0 = torch.where(any_x, xs, big).amin(dim=1)
        x1 = torch.where(any_x, xs, none).amax(dim=1) + 1
        boxes = torch.stack([x0, y0, x1, y1], dim=1)
        boxes = torch.where((areas == 0)[:, None], 0, boxes).float()
        return _bitpack_masks(m), boxes, areas

    @torch.no_grad()
    def finalize_masks(self, low_sel, h: int, w: int) -> np.ndarray:
        """Upscale selected (K, 4h, 4w) logits -> host (K, h, w) uint8."""
        low_sel = torch.as_tensor(low_sel, device=self.device).float()
        return (resize_bilinear(low_sel, (h, w)) > 0.0).to(
            torch.uint8).cpu().numpy()

    def finalize_masks_packed(self, low_sel, h: int, w: int):
        """AMG finalize: host (masks (K, h, w) bool, boxes (K, 4) xyxy,
        areas (K,)), the masks crossing bit-packed."""
        packed, boxes, areas = self._finalize_packed(low_sel, h, w)
        return (unpack_masks(packed.cpu().numpy(), h, w),
                boxes.cpu().numpy(), areas.cpu().numpy())

    def finalize_masks_dispatch(self, low_sel, h: int, w: int,
                                k_fin: Optional[int] = None):
        """Finalize without a host fetch: device (packed, boxes, areas)."""
        return self._finalize_packed(low_sel, h, w, k_fin)

    def finalize_masks_device(self, low_sel, h: int, w: int,
                              k_fin: Optional[int] = None):
        """(packed device masks, host boxes, host areas): callers NMS on the
        boxes, then fetch only the kept rows of the packed masks."""
        packed, boxes, areas = self._finalize_packed(low_sel, h, w, k_fin)
        return packed, boxes.cpu().numpy(), areas.cpu().numpy()

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                multimask_output: bool = False):
        """Returns (masks (N, K, H, W) bool, scores (N, K),
        low_res_logits (N, K, 4h, 4w)); N prompt sets, K=3 if multimask."""
        coords, labels, n_real = self._prep_prompts(point_coords,
                                                    point_labels, box)
        out = self._heads(coords, labels, multimask_output)
        high = resize_bilinear(out["high_res_masks"][:n_real].float(),
                               self._orig_hw)
        return ((high > 0.0).cpu().numpy(),
                out["ious"][:n_real].float().cpu().numpy(),
                out["low_res_masks"][:n_real].float().cpu().numpy())

    def predict_packed(self, point_coords: Optional[np.ndarray] = None,
                       point_labels: Optional[np.ndarray] = None,
                       box: Optional[np.ndarray] = None,
                       stability_offset: float = 1.0):
        """Single-mask predict with a bit-packed fetch and the stability
        score computed on the device: returns (masks (N, H, W) bool, scores
        (N,), stability (N,)). The same numbers as ``predict`` + host
        ``compute_stability_score``: linear resize of the high-res logits >
        0, stability from the low-res logits with the +-offset rule."""
        h, w = self._orig_hw
        coords, labels, n_real = self._prep_prompts(point_coords,
                                                    point_labels, box)
        out = self._heads(coords, labels, False)
        up = resize_bilinear(out["high_res_masks"][:, 0].float(), (h, w))
        stab = _stability_from_logits(out["low_res_masks"][:, 0].float(),
                                      stability_offset)
        packed = _bitpack_masks(up > 0.0).cpu().numpy()
        masks = unpack_masks(packed, h, w)[:n_real]
        return (masks, out["ious"][:n_real, 0].float().cpu().numpy(),
                stab[:n_real].cpu().numpy())


class HostCopy:
    """Device tensors on their way to the host without stalling the stream.

    On CUDA each tensor is copied with ``non_blocking=True`` into pinned
    host memory and an event is recorded behind the copies; ``get`` waits
    on that event alone, so work enqueued after the copies keeps running.
    Reading a pinned tensor before its event has completed gives stale
    bytes and no error, so ``get`` is the only way to the values. CPU
    tensors are already on the host."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors and tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for dst, src in zip(self.host, tensors):
                dst.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach() for t in tensors]

    def get(self) -> list:
        """The copies as numpy arrays, once they have landed."""
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


def unpack_masks(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """(K, h, ceil(w/8)) bit-packed uint8 -> (K, h, w) bool."""
    k = packed.shape[0]
    if k == 0:
        return np.zeros((0, h, w), bool)
    return np.unpackbits(
        packed.reshape(k, -1), axis=1,
        count=packed.shape[1] * packed.shape[2] * 8).reshape(
            k, h, -1)[:, :, :w].astype(bool)


def compute_stability_score(logits: np.ndarray, mask_threshold: float = 0.0,
                            threshold_offset: float = 1.0) -> np.ndarray:
    """Stability = |logit > thr+off| / |logit > thr-off| over the last two
    axes (prompt_generator.py:169-186 / SAM AMG semantics)."""
    logits = np.asarray(logits)
    inter = (logits > (mask_threshold + threshold_offset)).sum(
        axis=(-2, -1)).astype(np.float64)
    union = (logits > (mask_threshold - threshold_offset)).sum(
        axis=(-2, -1)).astype(np.float64)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)
