"""``counts/`` against ``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference run on real CPU tensors at tiny sizes, and the memory-bank
simulation against the reference predictor's own key masks."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import manifest
from benchmark.counts import attention as attn_counts


def test_selection_step_counts_match_flop_counter():
    """Dense operations plus the attentions' analytic count (4 FLOPs a
    (q, k, d) forward; the backward's 10 less the 2 of recomputing S, which
    autograd does not do) equal FlopCounterMode's count of a forward and
    backward through the plain reference, with every key valid."""
    from benchmark.counts import sola_selection_mevis as counts
    from benchmark.models import sola_selection_mevis as weights
    from benchmark.reference.selection.model import SelectionModel
    cfg_json = manifest.config("sola_selection_mevis")
    cfg = weights.selection_config(cfg_json, "tiny")
    torch.manual_seed(0)
    model = SelectionModel(cfg)
    nb, tb, words = 8, 32, 96
    work = counts.step_work(cfg_json, (nb, tb), nb, tb, words, "tiny")
    with FlopCounterMode(display=False) as fc:
        logits, toks = model(
            torch.randn(1, nb, tb, cfg.object_token_dim),
            torch.randn(1, words, cfg.lang_token_dim),
            track_mask=torch.ones(1, nb, dtype=torch.bool),
            frame_lengths=torch.tensor([tb]),
            lang_mask=torch.ones(1, words, dtype=torch.bool))
        (logits.sum() + toks.sum()).backward()
    dense, calls, _, _ = counts.dense(json.dumps(cfg_json, sort_keys=True),
                                      nb, tb, 96, "tiny")
    attn_fwd = sum(f for i, (f, _, _) in enumerate(work["attention"])
                   if i % 2 == 0)
    attn_bwd = sum(f for i, (f, _, _) in enumerate(work["attention"])
                   if i % 2 == 1)
    assert len(calls) == 3 * cfg.n_layers
    expected = dense + attn_fwd + attn_bwd * 8 / 10
    assert fc.get_total_flops() == pytest.approx(expected, rel=1e-9)
    assert work["flops"]["fp32"] == pytest.approx(dense + attn_fwd
                                                  + attn_bwd)


def test_sam2_encode_count_matches_flop_counter():
    """The meta-device count of a frame encode equals
    FlopCounterMode's over the same reference modules on CPU tensors."""
    from benchmark.counts import sam2_hiera_l as counts
    from benchmark.models import sam2_hiera_l as weights
    from benchmark.reference.sam2.model import SAM2Model
    pt = counts.parts("tiny_test", 2)
    torch.manual_seed(0)
    model = SAM2Model(weights.sam2_config("tiny_test")).eval()
    cfg = model.cfg
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.encode_image(torch.randn(1, cfg.image_size, cfg.image_size, 3))
    assert fc.get_total_flops() == pytest.approx(
        sum(pt["encode"].values()), rel=1e-9)
    assert not pt["encode_attention"]   # no flash call at this size


def test_forward_count_of_one_masked_call():
    f, nb = attn_counts.forward_work(2, 4, 16, 64, 8, [10, 0], "bf16")
    assert f == 4.0 * 4 * 16 * 8 * (10 + 64)
    assert nb == (2 * (2 * 2 * 4 * 16 * 8 + 2 * 4 * 74 * 8)
                  + 4 * 2 * 4 * 16 + 2 * 64)


def test_bank_simulation_matches_the_reference_masks():
    """The valid memories and pointers ``bank_valid`` gives each tracked
    frame equal the key masks the reference predictor builds."""
    from benchmark.counts import sam2_hiera_l as counts
    from benchmark.models import sam2_hiera_l as weights
    from benchmark.reference.sam2 import video as video_mod
    from benchmark.reference.sam2.model import SAM2Model
    torch.manual_seed(0)
    model = SAM2Model(weights.sam2_config("tiny_test"))
    pred = video_mod.SAM2VideoPredictor(model, obj_batch=1,
                                        compute_dtype=torch.float32)
    seen = []
    orig = model.condition_features

    def spy(pix, pos, cond_mem, cond_valid, recent_mem, recent_valid,
            *rest):
        ptr_valid = rest[-1]
        seen.append((int(recent_valid[0].sum()), int(ptr_valid[0].sum())))
        return orig(pix, pos, cond_mem, cond_valid, recent_mem,
                    recent_valid, *rest)

    model.condition_features = spy
    n_frames, cond = 30, 9
    frames = [torch.randint(0, 255, (32, 48, 3), dtype=torch.uint8).numpy()
              for _ in range(n_frames)]
    state = pred.init_state(frames)
    mask = torch.zeros(32, 48, dtype=torch.uint8)
    mask[8:20, 10:30] = 1
    pred.add_new_mask(state, cond, 1, mask.numpy())
    for rev in (False, True):
        for _ in pred.propagate_in_video(state, reverse=rev,
                                         output_mode="none"):
            pass
    cfg = model.cfg
    assert seen == counts.bank_valid(n_frames, cond, cfg.num_recent,
                                     cfg.max_obj_ptrs)
