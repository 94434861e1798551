"""The port's GroundingDINO and its text-prompted path against the plain
reference the benchmark decides ``correct`` with (``benchmark/reference/
gdino``, ``benchmark/reference/trackgen_gdino.py``), on the benchmark's
seeded random weights at ``GDINOConfig.tiny_test()`` on the CPU.

The reference decodes the queries the port's top-k selection kept, so the
logits and boxes of one frame's expression chunk agree to rounding; SAM2's
box -> mask agrees on the port's boxes. A deformable sampling that starts
each level one row off, and a fusion layer left out, each fail the
comparison; a box whose score sits on ``box_threshold``, kept or dropped
by a rounding of the gate, passes it either way."""

import copy

import numpy as np
import pytest
import torch

from benchmark.core import manifest
from benchmark.drivers import trackgen_gdino as drv
from benchmark.models import gdino_swin_t as weights
from benchmark.reference import trackgen_gdino as ref
from sola_torch.trackgen import prompts_gdino
from sola_torch.trackgen.gdino import deformable, model as gdino
from sola_torch.trackgen.sam2.image import SAM2ImagePredictor
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model

SIZE = "tiny_test"
TEXTS = ["the red car on the left", "a small dog", "two people walking",
         "the white ball"]
LIMITS = manifest.config("gdino_swin_t")["limits"]["trackgen_gdino"]


def _frame(seed=3, hw=(48, 72)):
    rng = np.random.default_rng(seed)
    f = (rng.random(hw + (3,)) * 60 + 30).astype(np.uint8)
    f[8:30, 10:40] = (220, 60, 40)
    f[20:44, 44:66] = (40, 200, 90)
    return f


@pytest.fixture(scope="module")
def config():
    return copy.deepcopy(manifest.config("gdino_swin_t"))


@pytest.fixture(scope="module")
def gdino_weights(config):
    torch.set_num_threads(2)
    return weights.state_dict(config, "cpu", SIZE)


@pytest.fixture(scope="module")
def sam2_weights(config):
    return weights.sam2_state_dict(config, "cpu", SIZE)


def _port(state_dict):
    m = gdino.GroundingDINO(gdino.GDINOConfig.tiny_test())
    m.load_state_dict(state_dict)
    return m.eval()


def _program_chunk(state_dict, frame, texts):
    """The port's outputs of one forward over ``texts``: logits, boxes and
    its top-k indices, as the benchmark keeps them."""
    model = _port(state_dict)
    tap = drv.GroundingTap(model, seed=0)
    with tap.video("v", 1):
        gdino.GroundingModel(model).enqueue_boxes(
            frame, [prompts_gdino.normalize_expression(t) for t in texts])
    _, out = tap.kept["v"]
    return dict(out, texts=list(texts))


def _reference_chunk(state_dict, config, frame, topk):
    return ref.ground(state_dict, weights.gdino_config(config, SIZE), frame,
                      TEXTS, topk)


def _gaps(state_dict, config, frame):
    got = _program_chunk(state_dict, frame, TEXTS)
    return drv.grounding_gaps(got, _reference_chunk(
        state_dict, config, frame, got["topk_indices"]))


def test_logits_and_boxes_match_the_reference(gdino_weights, config):
    r = _gaps(gdino_weights, config, _frame())
    assert r["logit_gap"] < 1e-5 and r["box_gap"] < 1e-5, r
    assert r["pick_gap"] < 1e-3, r
    assert r["box_gate_flips"] == 0


def test_chunk_rows_and_tokens_match_the_port(gdino_weights):
    """The reference pads a chunk's rows and tokens as the port does."""
    gm = gdino.GroundingModel(_port(gdino_weights))
    from benchmark.reference.gdino.text import tokenize_chunk
    rows = ref.chunk_rows(TEXTS[:3])
    assert len(rows) == 4 and rows[3] == rows[0]
    ids, tmask, smask, pos = tokenize_chunk(
        rows, 512, 0, min(64, gm.cfg.max_text_len))
    toks = [gm._tokenize(t) for t in rows]
    n = max(t[0].shape[1] for t in toks)
    port = [np.concatenate([gdino._pad_tokens(t, n, 0)[i] for t in toks])
            for i in range(4)]
    for a, b in zip((ids, tmask, smask, pos), port):
        np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("fault", ["level_start", "no_fusion"])
def test_a_planted_fault_fails_the_comparison(gdino_weights, config, fault,
                                              monkeypatch):
    if fault == "level_start":
        core = deformable.ms_deform_attn

        def shifted(value, loc, w, shapes=None):
            return core(torch.roll(value, 1, dims=1), loc, w, shapes)
        monkeypatch.setattr(deformable, "ms_deform_attn", shifted)
    else:
        monkeypatch.setattr(
            gdino.FusionLayer, "forward",
            lambda self, vision, text, **_: (self.layer_norm_vision(vision),
                                             self.layer_norm_text(text)))
    r = _gaps(gdino_weights, config, _frame())
    assert (r["logit_gap"] > LIMITS["logit_gap"]
            or r["box_gap"] > LIMITS["box_gap"]), r


def _prompts(gdino_weights, sam2_weights, frame, box_threshold):
    """The port's prompts of one frame at ``box_threshold``."""
    scfg = SAM2Config.tiny_test()
    smodel = SAM2Model(scfg)
    smodel.load_state_dict(sam2_weights)
    gen = prompts_gdino.PromptGenerator(
        gdino.GroundingModel(_port(gdino_weights)),
        SAM2ImagePredictor(smodel), box_threshold=box_threshold)
    expressions = {str(i): {"exp": t} for i, t in enumerate(TEXTS)}
    return prompts_gdino.generate_video_prompts(gen, [frame], "v",
                                                expressions, 4)


def test_box_masks_match_and_a_flip_at_the_box_gate_passes(
        gdino_weights, sam2_weights, config, tmp_path):
    """A box whose score sits on the gate: with the gate a rounding below
    it the box is kept, a rounding above it dropped; the reference follows
    the program's boxes either way, and every gap passes."""
    frame = _frame()
    scores = sorted({max(p["token_score"]) for p in _prompts(
        gdino_weights, sam2_weights, frame, 0.0)["prompt_masks"]})
    edge = scores[len(scores) // 2]
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    from PIL import Image
    Image.fromarray(frame).save(frames_dir / "00000.png")
    n_boxes = []
    for thr in (np.nextafter(np.float32(edge), np.float32(-1)), edge):
        info = _prompts(gdino_weights, sam2_weights, frame, float(thr))
        boxes = {0: [p["pred_bbox"] for p in info["prompt_masks"]]}
        masks = ref.box_masks(sam2_weights, SIZE, str(frames_dir), boxes)
        r = drv.mask_gaps(info, masks)
        assert r["mask_gap"] <= LIMITS["mask_gap"], r
        r = drv.stability_gaps({"prompts": info, "keep": {
            p["prompt_id"] for p in info["prompt_masks"]
            if p["stability_score"] >= 0.5}, "gates": {
                "stability_score_thresh": 0.5, "bin_size": 4}}, masks)
        assert r["stability_gap"] < 1e-5, r
        assert r["stability_gate_gap"] < 1e-5, r
        n_boxes.append(len(info["prompt_masks"]))
    assert n_boxes[0] == n_boxes[1] + 1
    r = _gaps(gdino_weights, config, frame)
    assert all(r[k] <= LIMITS[k] for k in ("logit_gap", "box_gap",
                                           "pick_gap")), r
