"""The port's spans and counters on its hot paths, on the CPU at tiny size:
grid tracks (``tokens_grid.run_video``), packed GT tracks
(``tokens_gt.run_videos_packed_gt``) and selection training steps.

With tracing off nothing is recorded and no annotation is entered; with a
profiler running the outputs are bit for bit those of an untraced run,
every span is a profiler annotation at the same times, spans nest by
their parents, and the counters equal what the shapes and slot plans
give."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from sola_torch.core import rle
from sola_torch.models.selection import (SelectionConfig, SelectionModel,
                                         init_weights)
from sola_torch.models.text import HashTextEncoder
from sola_torch.trackgen import engine, gt_utils, tokens_grid, tokens_gt
from sola_torch.trackgen.sam2 import packed
from sola_torch.trackgen.sam2.convert import load_sam2_video_predictor
from sola_torch.trackgen.sam2.model import SAM2Config
from sola_torch.train import loop
from sola_torch.train import state as state_lib
from sola_torch.utils import profiling

HW = (48, 72)
GRID_T = 6
# (frame, y0, y1, x0, x1): four prompts on frame 0, two on frame 2
GRID_PROMPTS = [(0, 4, 14, 4, 16), (0, 20, 34, 30, 44), (0, 2, 10, 50, 68),
                (0, 36, 46, 4, 20), (2, 18, 30, 54, 70), (2, 38, 46, 40, 60)]
# (video, frames, {anno: (y0, y1, x0, x1, frames absent)})
GT_VIDEOS = [("gtA", 5, {"1": (6, 20, 4, 14, ()), "2": (24, 40, 30, 42, ())}),
             ("gtB", 7, {"3": (6, 20, 4, 14, ()),
                         "4": (22, 36, 20, 32, (2,)),
                         "5": (8, 22, 30, 44, (0, 1, 2))})]
PARENTS = {"trackgen.encode": {None}, "trackgen.decode": {"trackgen.encode"},
           "trackgen.track": {None}, "trackgen.round": {"trackgen.track"},
           "trackgen.cond": {"trackgen.track", "trackgen.round"},
           "trackgen.step": {"trackgen.track", "trackgen.round"},
           "trackgen.fetch": {"trackgen.track", "trackgen.round",
                              "trackgen.dedup"},
           "trackgen.dedup": {"trackgen.track"},
           "trackgen.emit": {"trackgen.track"},
           "trackgen.gt_masks": {None},
           "train.prepare": {None}, "train.step": {None},
           "train.forward": {"train.step"}, "train.backward": {"train.step"},
           "train.optimizer": {"train.step"}}
TRAIN_CFG = {"positive_metric": "iou", "positive_threshold": 0.5,
             "temperature": 0.07, "positive_weight": 1.5,
             "alignment_weight": 0.3}


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def predictor():
    """A tiny SAM2 video predictor on seeded weights, 4 object slots: the
    grid batches' width and the packed GT rounds'."""
    return load_sam2_video_predictor(None, obj_batch=4,
                                     cfg=SAM2Config.tiny_test(),
                                     device="cpu", seed=1)


def _frames(t, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(t):
        f = rng.integers(0, 60, HW + (3,), dtype=np.uint8)
        x = (4 + 3 * i) % (HW[1] - 12)
        f[6:20, x:x + 10] = 220
        out.append(f)
    return out


def _write_jpegs(frames_dir, frames):
    os.makedirs(frames_dir, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(frames_dir, f"{i:05d}.jpg"),
                                quality=95)


def _box(y0, y1, x0, x1):
    m = np.zeros(HW, np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


@pytest.fixture(scope="module")
def grid_video(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    frames_dir = str(root / "JPEGImages" / "vid")
    _write_jpegs(frames_dir, _frames(GRID_T, 0))
    prompt_path = str(root / "vid.json")
    with open(prompt_path, "w") as f:
        json.dump({"video_id": "vid", "bin_size": 1, "prompt_masks": [
            {"prompt_id": i, "frame_idx": fr,
             "segmentation": rle.encode(_box(*box))}
            for i, (fr, *box) in enumerate(GRID_PROMPTS)]}, f)
    return frames_dir, prompt_path


def _artifacts(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def run_grid(predictor, grid_video, out_root):
    frames_dir, prompt_path = grid_video
    census = tokens_grid.run_video(
        predictor, "vid", frames_dir, prompt_path, str(out_root), "mevis",
        "valid_u", bin_size=1, batch_size=4, miou_thresh=0.7,
        n_max_tracks=16, log=lambda s: None, track_root=str(out_root))
    return census, _artifacts(out_root)


def gt_items(predictor):
    items = []
    for i, (vid, t, objs) in enumerate(GT_VIDEOS):
        gt = {}
        for anno, (y0, y1, x0, x1, absent) in objs.items():
            m = np.zeros((t,) + HW, np.uint8)
            for f in range(t):
                if f not in absent:
                    x = (x0 + 2 * f) % (HW[1] - (x1 - x0))
                    m[f, y0:y1, x:x + (x1 - x0)] = 1
            gt[anno] = m
        items.append({"video_id": vid, "state": predictor.init_state(
            _frames(t, 10 + i)), "gt_masklets": gt, "n_frames": t})
    return items


def run_gt_packed(predictor, out_root):
    items = gt_items(predictor)
    tokens_gt.run_videos_packed_gt(predictor, items, str(out_root), "mevis",
                                   "train", log=lambda s: None)
    return items, _artifacts(out_root)


def _traced(fn, *args):
    """fn(*args) under a CPU profiler, inside an annotation of its own as
    the benchmark's traced window is (the first annotation after a
    profiler starts waits for the profiler's set-up of the thread before
    it reads its clock): (its result, the profiler, the program's
    snapshot)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.traced_window"):
            out = fn(*args)
    return out, prof, profiling.snapshot()


def _train_run(traced: bool):
    """Two training steps from seeded weights: (losses, parameters,
    snapshot or None)."""
    cfg = SelectionConfig(n_layers=1, object_token_dim=16, lang_token_dim=64,
                          n_negative=4, dropout_p=0.2, attn_dropout_p=0.1,
                          n_groups=4, n_groups_module=4)
    model = SelectionModel(cfg)
    init_weights(model, seed=3)
    optimizer = state_lib.make_optimizer(model.parameters(), lr=1e-3,
                                         grad_clip_norm=1.0)
    text = HashTextEncoder(hidden_size=64)
    gen = torch.Generator().manual_seed(42)
    rng = np.random.default_rng(0)

    def steps():
        losses = []
        for i in range(2):
            n, t = 6 + 2 * i, 8
            raw = {"expression": [f"the object {i} moving left"],
                   "object_tokens": rng.standard_normal(
                       (1, n, t, 16)).astype(np.float32),
                   "track_mask": np.arange(n)[None] < n - 1,
                   "frame_lengths": np.array([t - i]),
                   "labels": {"iou": rng.random((1, n))}}
            batch = loop.prepare_batch(raw, text, TRAIN_CFG, "cpu")
            losses.append(loop.train_step(model, optimizer, batch, TRAIN_CFG,
                                          gen)["total"])
        return losses

    if traced:
        losses, _, snap = _traced(steps)
    else:
        losses, snap = steps(), None
    return losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()}, snap


def test_tracing_off_records_nothing_and_enters_no_annotation(
        predictor, grid_video, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span entered an annotation or read a "
                             "clock with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    census, arts = run_grid(predictor, grid_video, tmp_path / "grid")
    assert census["n_tracked"] > 0 and arts
    _, arts = run_gt_packed(predictor, tmp_path / "gt")
    assert arts
    _train_run(traced=False)
    assert profiling.snapshot() == {"spans": [], "counters": {}}


def test_traced_grid_and_gt_outputs_equal_untraced(predictor, grid_video,
                                                   tmp_path):
    c_off, grid_off = run_grid(predictor, grid_video, tmp_path / "grid_off")
    (c_on, grid_on), _, snap = _traced(run_grid, predictor, grid_video,
                                       tmp_path / "grid_on")
    assert snap["spans"] and grid_on == grid_off
    assert len(grid_on) == 2 * c_on["n_tracked"]
    for k in ("n_tracked", "n_filtered", "tracked_prompt_ids"):
        assert c_on[k] == c_off[k]
    _, gt_off = run_gt_packed(predictor, tmp_path / "gt_off")
    (_, gt_on), _, snap = _traced(run_gt_packed, predictor, tmp_path / "gt_on")
    assert snap["spans"] and gt_on == gt_off and len(gt_on) == 2 * 6


def test_traced_training_equals_untraced():
    losses_off, params_off, _ = _train_run(traced=False)
    losses_on, params_on, snap = _train_run(traced=True)
    assert snap["spans"]
    for a, b in zip(losses_off, losses_on):
        assert torch.equal(a, b)
    for k in params_off:
        assert torch.equal(params_off[k], params_on[k]), k


def _annotations(prof) -> dict:
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            s = e.start_ns()
            out.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _check_against_trace(prof, snap):
    """Each span is one annotation of its name, in order. The span's clock
    is read just outside the annotation's, so it encloses the annotation
    (up to the profiler's clock conversion, a few microseconds), and both
    ends lie within 0.1 ms of the annotation's; a context switch between
    the two reads can widen one gap, so one span in a hundred (one at
    least) may lie further."""
    notes = _annotations(prof)
    mine: dict = {}
    for s in snap["spans"]:
        mine.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    assert set(mine) <= set(notes)
    gaps = []
    for name, spans in mine.items():
        assert len(spans) == len(notes[name]), name
        for (s, e), (ns, ne) in zip(sorted(spans), notes[name]):
            assert s <= ns + 10_000 and ne <= e + 10_000, (name, s - ns,
                                                            e - ne)
            gaps.append(max(ns - s, e - ne))
    assert sum(g > 100_000 for g in gaps) <= max(1, len(gaps) // 100), \
        sorted(gaps)[-10:]


def _check_tree(snap):
    by_id = {s["id"]: s for s in snap["spans"]}
    children: dict = {}
    for s in snap["spans"]:
        assert s["parent"] in PARENTS[s["name"]], (s["name"], s["parent"])
        if s["parent_id"] is None:
            continue
        p = by_id[s["parent_id"]]
        assert p["name"] == s["parent"] and p["thread"] == s["thread"]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        children[p["id"]] = (children.get(p["id"], 0)
                             + s["end_ns"] - s["start_ns"])
    for s in snap["spans"]:
        assert s["self_ns"] >= 0
        assert (s["self_ns"] + children.get(s["id"], 0)
                == s["end_ns"] - s["start_ns"])


def test_spans_are_profiler_annotations_and_nest(predictor, grid_video,
                                                 tmp_path):
    _, prof, snap = _traced(run_grid, predictor, grid_video, tmp_path / "grid")
    names = {s["name"] for s in snap["spans"]}
    assert names == {"trackgen.encode", "trackgen.decode", "trackgen.track",
                     "trackgen.cond", "trackgen.step", "trackgen.fetch",
                     "trackgen.dedup", "trackgen.emit"}
    _check_against_trace(prof, snap)
    _check_tree(snap)
    _, prof, snap = _traced(run_gt_packed, predictor, tmp_path / "gt")
    assert {s["name"] for s in snap["spans"]} == {
        "trackgen.encode", "trackgen.track", "trackgen.round",
        "trackgen.cond", "trackgen.step", "trackgen.fetch", "trackgen.emit"}
    _check_against_trace(prof, snap)
    _check_tree(snap)


def test_gt_masklet_loading_is_one_span_and_unchanged():
    """The GT masklets' RLE decode (``tokens_gt``'s ``gt_of``, and the
    benchmark's GT packs) is span ``trackgen.gt_masks``."""
    meta = {"videos": {"gtB": {"expressions": {
        "0": {"anno_id": ["3", "4"]}, "1": {"anno_id": ["4", "5"]}}}}}
    t, objs = GT_VIDEOS[1][1], GT_VIDEOS[1][2]
    mask_dict = {}
    for anno, (y0, y1, x0, x1, absent) in objs.items():
        m = np.zeros((t,) + HW, np.uint8)
        for f in range(t):
            if f not in absent:
                m[f, y0:y1, x0:x1] = 1
        mask_dict[anno] = rle.encode_masklet(m)
    off = gt_utils.get_masklets("gtB", meta, mask_dict)
    on, _, snap = _traced(gt_utils.get_masklets, "gtB", meta, mask_dict)
    assert sorted(on) == ["3", "4", "5"] == sorted(off)
    for k in on:
        assert np.array_equal(on[k], off[k])
    _check_tree(snap)
    assert [s["name"] for s in snap["spans"]] == ["trackgen.gt_masks"]


def test_training_spans_one_of_each_phase_in_each_step():
    _, _, snap = _train_run(traced=True)
    _check_tree(snap)
    steps = [s for s in snap["spans"] if s["name"] == "train.step"]
    assert len(steps) == 2
    assert sum(s["name"] == "train.prepare" for s in snap["spans"]) == 2
    for step in steps:
        inner = sorted((s["start_ns"], s["name"]) for s in snap["spans"]
                       if s["parent_id"] == step["id"])
        assert [n for _, n in inner] == ["train.forward", "train.backward",
                                         "train.optimizer"]


def test_grid_counters_equal_the_shapes(predictor, grid_video, tmp_path,
                                        monkeypatch):
    """Sequential grid tracks: each tracked batch of k prompts fetches its
    T full-resolution uint8 masks per prompt and T token rows of the
    obj_batch slots in fp32 (T - 1 propagated frames and the cond frame),
    each dedup call one fp32 IoU per remaining prompt; it steps T - 1
    times at obj_batch slots, k of them active."""
    seen = []
    orig = engine._batched_dedup_ious

    def spy(small, prompts, hw):
        seen.append(len(prompts))
        return orig(small, prompts, hw)
    monkeypatch.setattr(engine, "_batched_dedup_ious", spy)
    batches = []
    orig_select = engine.select_batch

    def select(*a, **k):
        batch, frame = orig_select(*a, **k)
        if batch:
            batches.append(len(batch))
        return batch, frame
    monkeypatch.setattr(engine, "select_batch", select)
    (census, arts), _, snap = _traced(run_grid, predictor, grid_video,
                                      tmp_path)
    t, b = GRID_T, predictor.obj_batch
    d = np.load(next(os.path.join(tmp_path, k) for k in arts
                     if k.endswith(".npy"))).shape[1]
    assert sum(batches) == census["n_tracked"]
    h, w = HW
    want = (census["n_tracked"] * t * h * w + len(batches) * t * b * d * 4
            + 4 * sum(seen))
    c = snap["counters"]
    assert c["trackgen.fetch_bytes"] == want
    # per batch: cond masks, tokens and masks of each non-empty pass,
    # the cond token; one dedup fetch per call
    fetch_spans = [s for s in snap["spans"] if s["name"] == "trackgen.fetch"]
    assert c["trackgen.fetches"] == len(fetch_spans) > 0
    assert c["trackgen.slots"] == len(batches) * (t - 1) * b
    assert c["trackgen.slots_active"] == sum(batches) * (t - 1)


def test_packed_gt_counters_equal_the_slot_plans(predictor, tmp_path,
                                                 monkeypatch):
    plans = []
    orig = packed.PackedPropagator.run_round

    def spy(self, pack, plan, cond_masks):
        plans.append(plan)
        return orig(self, pack, plan, cond_masks)
    monkeypatch.setattr(packed.PackedPropagator, "run_round", spy)
    (items, _), _, snap = _traced(run_gt_packed, predictor, tmp_path)
    b, d = predictor.obj_batch, predictor.cfg.d_model
    slots = active = tokens = masks = 0
    for plan in plans:
        on = plan.video >= 0
        tokens += b * d * 4                          # the cond tokens
        for lens in (np.maximum(plan.length - 1 - plan.cond, 0) * on,
                     plan.cond * on):
            if lens.max() > 0:
                slots += b * int(lens.max())
                active += int(lens.sum())
                tokens += int(lens.max()) * b * d * 4
        masks += int((plan.length * on).sum()) * HW[0] * HW[1]
    assert len(plans) == 2 and active > 0
    c = snap["counters"]
    assert c["trackgen.slots"] == slots
    assert c["trackgen.slots_active"] == active
    assert c["trackgen.fetch_bytes"] == masks + tokens
    # one slot a seed: every frame of a seed's video is fetched once
    seeds = sum(len(tokens_gt.gt_seed_units(it["gt_masklets"]))
                for it in items)
    assert sum(int(on.sum()) for on in (p.video >= 0 for p in plans)) \
        == seeds


def test_a_span_on_another_thread_has_no_parent_from_this_one(monkeypatch):
    """Parents are per thread: a worker's span (as the prefetcher's encode)
    does not nest under the span the main thread has open."""
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    done = threading.Event()
    with profiling.span("outer"):
        def work():
            with profiling.span("worker"):
                pass
            done.set()
        th = threading.Thread(target=work)
        th.start()
        th.join()
    assert done.is_set()
    spans = {s["name"]: s for s in profiling.snapshot()["spans"]}
    assert spans["worker"]["parent"] is None
    assert spans["worker"]["thread"] != spans["outer"]["thread"]
    assert spans["outer"]["self_ns"] == (spans["outer"]["end_ns"]
                                         - spans["outer"]["start_ns"])
