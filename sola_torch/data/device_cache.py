"""Device-resident object-token cache for the training input pipeline.

Counterpart of ``sola_tpu/data/device_cache.py``. A video's tokens are the
same for each of its expressions and every epoch, so each sample's padded
token block is uploaded to the device once and batches are stacked there,
instead of a multi-MB host-to-device copy per batch. ``dtype`` is the type
the blocks live in: bfloat16 when the config sets ``bf16_token_transfer``
(half the bytes; the model upcasts to its weights' type), float32 for
bit-parity.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

# the most bytes one cache holds before it evicts its oldest blocks
MAX_BYTES = 8 << 30


class DeviceTokenCache:
    """LRU cache of per-sample padded token blocks on ``device``, for one
    split: the key is the video id, so two splits that share video ids
    (MeViS's valid_u is drawn from train) each need a cache of their own.

    ``per_expression``: include the expression id in the key, required when
    a track root is per-expression (gdino-style), where the expressions of
    one video have different tracks."""

    def __init__(self, per_expression: bool = False,
                 dtype=torch.bfloat16, device="cpu"):
        self.per_expression = per_expression
        self.dtype = dtype
        self.device = torch.device(device)
        self._store: OrderedDict = OrderedDict()
        self._bytes = 0

    def _key(self, video_id: str, expression_id: str, shape: tuple):
        return (video_id,
                expression_id if self.per_expression else None, shape)

    def _rows(self, raw: dict) -> list:
        host_rows = raw.get("object_token_rows")
        if host_rows is None:
            tokens = raw["object_tokens"]  # (B, n, t, d) padded numpy
            host_rows = [tokens[i] for i in range(tokens.shape[0])]
        rows = []
        for i, (vid, eid) in enumerate(zip(raw["video_id"],
                                           raw["expression_id"])):
            shape = tuple(host_rows[i].shape)
            key = self._key(vid, eid, shape)
            row = self._store.get(key)
            if row is None:
                row = torch.from_numpy(np.ascontiguousarray(
                    host_rows[i])).to(self.device, self.dtype)
                self._store[key] = row
                self._bytes += row.numel() * row.element_size()
                # `rows` holds a reference, so an eviction never frees a
                # block this batch still needs
                while self._bytes > MAX_BYTES and len(self._store) > 1:
                    _, old = self._store.popitem(last=False)
                    self._bytes -= old.numel() * old.element_size()
            else:
                self._store.move_to_end(key)
            rows.append(row)
        return rows

    def batch_tokens(self, raw: dict) -> torch.Tensor:
        """(B, n_bucket, t_bucket, d) device tokens for a collated batch,
        stacked from cached per-sample blocks (host copy only on a miss)."""
        return torch.stack(self._rows(raw), dim=0)


def make_token_cache(dataset_cfg: Optional[dict], dtype=torch.float32,
                     device="cpu") -> DeviceTokenCache:
    """A cache for one split's dataset config."""
    per_expr = False
    if dataset_cfg:
        from sola_torch.data import tracks as tracks_lib
        dirs = [d for d in str(
            dataset_cfg.get("sam2_output_dirs", "")).split(",") if d]
        per_expr = any(tracks_lib.is_per_expression(d) for d in dirs)
    return DeviceTokenCache(per_expression=per_expr, dtype=dtype,
                            device=device)
