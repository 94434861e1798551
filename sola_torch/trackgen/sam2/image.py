"""SAM2 image predictor: single-image box/point -> mask prediction.

Counterpart of the box/point half of ``sola_tpu/trackgen/sam2/image.py``:
the surface the reference's prompt generators consume
(prompt_generator.py:59-117: set_image / predict with boxes,
multimask_output=False), the bit-packed ``predict_packed`` the GroundingDINO
prompt stage calls, and the stability score helper
(prompt_generator.py:169-186). The automatic-mask-generator surface
(``propose*``, ``finalize*``) comes with the grid-prompts slice.
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
        raw = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
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
    def _heads(self, coords: np.ndarray, labels: np.ndarray,
               multimask: bool) -> dict:
        """SAM heads on the cached batch-1 features, broadcast over the N
        prompt sets."""
        if self._feats is None:
            raise RuntimeError("call set_image first")
        n = coords.shape[0]
        pix, s0, s1 = (self._feats[k].expand(n, *self._feats[k].shape[1:])
                       for k in ("pix", "s0", "s1"))
        return self.model.sam_heads(
            pix, s0, s1, torch.from_numpy(coords).to(self.device),
            torch.from_numpy(labels).long().to(self.device), None, multimask)

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
