"""SAM2's one propagation step (``sam2/track_step.py``) on both paths.

The sequential predictor's passes run the packed path's step with every
slot on the pass's frame: they give what a one-video packed round gives,
bit for bit. The predictor's banks and seed buffer, allocated once, carry
nothing from one batch, round or video to the next. ``trackgen.steps``
counts every step on both paths; the graph counters stay 0 on the CPU.

On a CUDA card (the tests taking ``cuda_card``, which skip here) whole
``generate_tracks`` and ``generate_tracks_packed`` runs replayed from the
step's CUDA graphs equal the eager runs bit for bit, with one capture per
direction. This file imports no JAX, so the card tests run on the card with
``python -m pytest --noconftest tests/test_torch_track_step_graph.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sola_torch.trackgen import engine, packed_engine
from sola_torch.trackgen.sam2 import packed, track_step
from sola_torch.trackgen.sam2.convert import load_sam2_video_predictor
from sola_torch.trackgen.sam2.model import SAM2Config
from sola_torch.utils import profiling

HW = (48, 64)          # upscales to the tiny model's 64 on both axes
T = 9


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's CUDA graphs are captured "
                    "and replayed only there")
    return torch.device("cuda")


def make_predictor(obj_batch: int = 4, stride: int = 1, device="cpu"):
    """A tiny SAM2 video predictor on seeded weights that track (seed 1)."""
    cfg = dataclasses.replace(SAM2Config.tiny_test(), memory_stride=stride)
    return load_sam2_video_predictor(None, obj_batch=obj_batch, cfg=cfg,
                                     device=device, seed=1)


def frames(t: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(t):
        f = rng.integers(0, 60, HW + (3,), dtype=np.uint8)
        x = (4 + 3 * i) % (HW[1] - 12)
        f[6:20, x:x + 10] = 220
        f[28:40, 50 - x // 2:60 - x // 2] = 170
        out.append(f)
    return out


def box(y0, y1, x0, x1) -> np.ndarray:
    m = np.zeros(HW, np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


BOXES = [box(6, 20, 10, 22), box(26, 42, 30, 50), box(2, 12, 40, 60),
         box(20, 30, 0, 16)]


def sequential(pred, state, frame: int, masks: list) -> dict:
    """One batch through the predictor's protocol, both passes: the
    (T, n, H, W) masks, tokens, small masklets, seed frames and the seed
    buffer the forward pass left (None without a forward pass)."""
    pred.reset_state(state)
    for i, m in enumerate(masks):
        pred.add_new_mask(state, frame, i, m)
    out = np.zeros((state.num_frames, len(masks)) + HW, np.uint8)
    for fidx, _, m in pred.propagate_in_video(state, output_mode="masks"):
        out[fidx] = m
    seed_buf = (None if state.seed_frames is None
                else pred.track_step().seed_buf.clone())
    for fidx, _, m in pred.propagate_in_video(state, reverse=True,
                                              output_mode="masks"):
        out[fidx] = m
    tokens = pred.get_output_tokens(state)
    return {"masks": out,
            "tokens": np.stack([tokens[f] for f in range(state.num_frames)]),
            "small": pred.get_small_masklets(state).cpu().numpy(),
            "seed_frames": state.seed_frames, "seed_buf": seed_buf}


def packed_round(pred, states: list, slots: list) -> dict:
    """One packed round of ``slots`` [(state index, frame, mask)], the rest
    padding: per slot the (T, H, W) masks, (T, d) tokens and small masklet,
    and the seed buffer the round left."""
    b, s_ = pred.obj_batch, pred.cfg.image_size
    video = np.full(b, -1, np.int64)
    cond = np.zeros(b, np.int64)
    length = np.ones(b, np.int64)
    cm = np.zeros((b, s_, s_), np.float32)
    for s, (v, f, m) in enumerate(slots):
        video[s], cond[s] = v, f
        length[s] = states[v].num_frames
        cm[s] = packed_engine._resize_prompt(m, s_)
    prop = packed.PackedPropagator(pred)
    out = prop.run_round(packed.PackedFeatures.build(states),
                         packed.SlotPlan(video=video, cond=cond,
                                         length=length), cm)
    per = []
    for s in range(len(slots)):
        t = int(length[s])
        per.append({"masks": np.stack([out["masks"][s][f]
                                       for f in range(t)]),
                    "tokens": np.stack([out["tokens"][s][f]
                                        for f in range(t)]),
                    "small": out["smalls"][s].cpu().numpy()})
    return {"slots": per, "seed_buf": prop.steps.seed_buf.clone()}


@pytest.mark.parametrize("direction", ["forward", "reverse", "both"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("obj_batch", [1, 4])
def test_sequential_pass_equals_a_one_video_packed_round(obj_batch, stride,
                                                         direction):
    """The conditioning frame first (forward pass only), last (reverse pass
    only) or inside; with obj_batch 4 one slot stays empty, a spare slot
    in the sequential batch and padding in the round."""
    pred = make_predictor(obj_batch, stride)
    state = pred.init_state(frames(T, 0))
    cond = {"forward": 0, "reverse": T - 1, "both": 4}[direction]
    masks = BOXES[:max(obj_batch - 1, 1)]
    seq = sequential(pred, state, cond, masks)
    rnd = packed_round(pred, [state], [(0, cond, m) for m in masks])
    for s, got in enumerate(rnd["slots"]):
        np.testing.assert_array_equal(got["masks"], seq["masks"][:, s])
        np.testing.assert_array_equal(got["tokens"], seq["tokens"][:, s])
        np.testing.assert_array_equal(got["small"], seq["small"][:, s])
    r = pred.cfg.num_recent
    want = [cond + stride * (i + 1) for i in range(r)
            if cond + stride * (i + 1) < T]
    if direction == "reverse":
        assert seq["seed_frames"] is None and seq["seed_buf"] is None
    else:
        assert seq["seed_frames"].tolist() == want and want
        n = len(masks)
        assert torch.equal(seq["seed_buf"][:len(want), :n],
                           rnd["seed_buf"][:len(want), :n])
        assert seq["seed_buf"][:len(want), :n].abs().sum() > 0
    # the objects are tracked: a mask off the prompt frame is not empty
    assert seq["masks"][[f for f in range(T) if f != cond]].any()


def _batches(pred):
    """Two batches of one video, the first wider and later in the video,
    then a batch of a second, shorter video."""
    a, b = pred.init_state(frames(T, 0)), pred.init_state(frames(6, 1))
    return [(a, 5, BOXES), (a, 2, BOXES[:2]), (b, 1, BOXES[1:])]


def _assert_equal_runs(got: dict, want: dict):
    for k in ("masks", "tokens", "small"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_banks_leave_nothing_behind_sequential():
    """Each batch on a predictor that ran the batches before it equals the
    batch on a fresh predictor."""
    pred = make_predictor()
    for i, (state, frame, masks) in enumerate(_batches(pred)):
        got = sequential(pred, state, frame, masks)
        fresh = make_predictor()
        fstate, _, _ = _batches(fresh)[i]
        want = sequential(fresh, fstate, frame, masks)
        _assert_equal_runs(got, want)
        assert got["masks"].any()


def test_banks_leave_nothing_behind_packed():
    """Rounds of one video, of two videos and of the other video alone on
    one predictor, each against the round on a fresh predictor; a
    sequential batch in between."""
    def rounds(pred):
        a, b = pred.init_state(frames(T, 0)), pred.init_state(frames(6, 1))
        return [([a], [(0, 5, m) for m in BOXES]),
                ([a, b], [(0, 2, BOXES[0]), (1, 1, BOXES[1])]),
                ([b], [(0, 4, BOXES[2])])]

    pred = make_predictor()
    todo = rounds(pred)
    for i, (states, slots) in enumerate(todo):
        got = packed_round(pred, states, slots)
        if i == 0:
            sequential(pred, states[0], 7, BOXES[:3])
        fresh = make_predictor()
        want = packed_round(fresh, *rounds(fresh)[i])
        for g, w in zip(got["slots"], want["slots"]):
            _assert_equal_runs(g, w)


def test_a_state_whose_banks_another_batch_took_raises():
    """The banks serve one batch at a time: a state's reverse pass after
    another state's conditioning cannot read memory that is no longer its
    own."""
    pred = make_predictor()
    a, b = pred.init_state(frames(T, 0)), pred.init_state(frames(6, 1))
    pred.add_new_mask(a, 3, 0, BOXES[0])
    list(pred.propagate_in_video(a, output_mode="masks"))
    sequential(pred, b, 1, BOXES[:2])
    with pytest.raises(RuntimeError, match="another batch"):
        list(pred.propagate_in_video(a, reverse=True, output_mode="masks"))
    # after a reset the state conditions anew
    assert sequential(pred, a, 3, BOXES[:1])["masks"].any()


def test_step_counters_count_every_step_on_both_paths():
    pred = make_predictor()
    state = pred.init_state(frames(T, 0))
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("test.traced_window"):
            sequential(pred, state, 4, BOXES[:2])
            packed_round(pred, [state], [(0, 2, BOXES[0]),
                                         (0, 6, BOXES[1])])
    snap = profiling.snapshot()
    c = snap["counters"]
    # sequential: T - 1 steps; packed: max(6, 2) forward, max(2, 6) reverse
    assert c["trackgen.steps"] == (T - 1) + 6 + 6
    assert c["trackgen.steps"] == sum(s["name"] == "trackgen.step"
                                      for s in snap["spans"])
    assert c.get("trackgen.graph_captures", 0) == 0
    assert c.get("trackgen.graph_replays", 0) == 0


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

def _prompts(frame_boxes: list) -> list:
    return [engine.PromptMask(prompt_id=i, frame_idx=f, segmentation=m)
            for i, (f, m) in enumerate(frame_boxes)]


VIDEO_PROMPTS = [
    (T, 0, [(0, BOXES[0]), (0, BOXES[1]), (4, BOXES[2]), (4, BOXES[3]),
            (6, BOXES[0])]),
    (6, 1, [(2, BOXES[1]), (2, BOXES[3]), (5, BOXES[0])])]


def _card_run(device, path: str) -> tuple:
    """Every video's tracks {(video, prompt): (masklet, tokens)} and
    censuses, on a fresh predictor."""
    pred = make_predictor(device=device)
    tracks, censuses = {}, []
    jobs = []
    for vi, (t, seed, fb) in enumerate(VIDEO_PROMPTS):
        state = pred.init_state(frames(t, seed))

        def on_track(r, vi=vi):
            tracks[(vi, r.prompt_id)] = (r.masklet, r.tokens)
        if path == "generate_tracks":
            censuses.append(engine.generate_tracks(
                pred, state, _prompts(fb), n_frames=t, batch_size=2,
                miou_thresh=0.95, n_max_tracks=16, on_track=on_track))
        else:
            jobs.append(packed_engine.VideoJob(
                video_id=f"v{vi}", state=state, prompts=_prompts(fb),
                n_frames=t, on_track=on_track, batch_size=2,
                miou_thresh=0.95, n_max_tracks=16))
    if jobs:
        censuses = packed_engine.generate_tracks_packed(pred, jobs)
    return tracks, [{k: v for k, v in c.items()
                     if k not in ("time", "fps")} for c in censuses]


@pytest.mark.parametrize("path", ["generate_tracks",
                                  "generate_tracks_packed"])
def test_replay_equals_eager_on_the_card(path, cuda_card, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(track_step, "usable", lambda device: False)
        eager, eager_census = _card_run(cuda_card, path)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("test.traced_window"):
            graphed, census = _card_run(cuda_card, path)
    c = profiling.snapshot()["counters"]
    assert census == eager_census
    assert sorted(graphed) == sorted(eager) and len(eager) >= 4
    for k in eager:
        np.testing.assert_array_equal(graphed[k][0], eager[k][0])
        np.testing.assert_array_equal(graphed[k][1], eager[k][1])
    # one slot count (obj_batch), both directions
    assert c["trackgen.graph_captures"] == 2
    assert c["trackgen.graph_replays"] == (c["trackgen.steps"]
                                           - c["trackgen.graph_captures"])
