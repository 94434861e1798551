"""Operations of one selection training step, from the configuration and
the step's shapes.

The dense operations of the forward and the backward (projections, the
motion encoder's convolutions, the scoring head) are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
selector on the meta device at the step's padded shape; nothing runs. The
three attentions of each layer, which the flash route gives to the port's
kernels, are taken out of that count and counted by ``counts/attention.py``
(forward and backward) over the keys their masks leave: the valid tracks
for the inter-object attention, the valid downsampled frames for the motion
attention, the valid words and the negatives for the language attention.
"""

from __future__ import annotations

import functools

from benchmark.counts import attention as attn_counts

_SITE = "benchmark.reference.selection.attention"


def _passthrough():
    import torch

    class Passthrough(torch.autograd.Function):
        """An attention output with no operations, forward or backward."""

        @staticmethod
        def forward(ctx, q, k, v):
            ctx.shapes = (k.shape, v.shape)
            return q.new_empty(q.shape)

        @staticmethod
        def backward(ctx, g):
            ks, vs = ctx.shapes
            return g.new_empty(g.shape), g.new_empty(ks), g.new_empty(vs)

    return Passthrough


def downsampled(length: int, specs) -> int:
    for (_, _, k, s, p) in specs:
        length = (length + 2 * p - k) // s + 1
    return length


@functools.lru_cache(maxsize=None)
def dense(config_key: str, nb: int, tb: int, words: int, size: str):
    """(dense fp32 flops of forward + backward, attention call shapes)."""
    import importlib
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.models.sola_selection_mevis import selection_config
    from benchmark.reference.selection.model import SelectionModel
    config = json.loads(config_key)
    cfg = selection_config(config, size)
    with torch.device("meta"):
        model = SelectionModel(cfg)
    site = importlib.import_module(_SITE)
    calls = []
    fn = _passthrough()

    def record(q, k, v, key_mask=None, **_):
        calls.append((tuple(q.shape), int(k.shape[2])))
        return fn.apply(q, k, v)

    saved = site.fused_attention
    site.fused_attention = record
    try:
        meta = dict(device="meta")
        tokens = torch.empty(1, nb, tb, cfg.object_token_dim, **meta,
                             requires_grad=False)
        lang = torch.empty(1, words, cfg.lang_token_dim, **meta)
        with FlopCounterMode(display=False) as fc:
            logits, score_tokens = model(
                tokens, lang,
                track_mask=torch.ones(1, nb, dtype=torch.bool, **meta),
                frame_lengths=torch.full((1,), tb, dtype=torch.long, **meta),
                lang_mask=torch.ones(1, words, dtype=torch.bool, **meta),
                deterministic=True)
            (logits.sum() + score_tokens.sum()).backward()
    finally:
        site.fused_attention = saved
    return float(fc.get_total_flops()), calls, cfg.conv_specs(), \
        cfg.n_negative


def step_work(config: dict, shape, tracks: int, frames: int, words: int,
              size: str = "large") -> dict:
    """{"flops": {"fp32": n}, "attention": [(flops, bytes, "fp32")]} of
    one step at padded ``shape`` (tracks, frames) with ``tracks`` valid
    tracks, ``frames`` valid frames and ``words`` valid words."""
    import json
    nb, tb = shape
    key = json.dumps(config, sort_keys=True)
    flops, calls, specs, n_neg = dense(key, nb, tb, 96, size)
    t_valid = downsampled(frames, specs)
    valid_keys = [tracks, t_valid, words + n_neg]
    attn = []
    for i, ((b, h, lq, d), lk) in enumerate(calls):
        valid = [min(valid_keys[i % 3], lk)] * b
        ff, fb = attn_counts.forward_work(b, h, lq, lk, d, valid, "fp32")
        bf, bb = attn_counts.backward_work(b, h, lq, lk, d, valid, "fp32")
        attn += [(ff, fb, "fp32"), (bf, bb, "fp32")]
    total = flops + sum(f for f, _, _ in attn)
    return {"flops": {"fp32": total}, "attention": attn}
