"""The text-prompted path's spans and counters on the CPU at tiny size:
``prompts_gdino`` (grounding, its post-processing, box prompts) and
``tokens_gdino`` (prompts past the gates), as the benchmark's
``trackgen_l.gdino`` reads them.

With a profiler running, the spans ``trackgen.grounding``,
``trackgen.grounding_post`` and ``trackgen.box_prompt`` are entered once a
binned frame, ``trackgen.grounded_pairs`` counts (binned frame,
expression) pairs, ``trackgen.boxes`` the boxes the grounding model
returned and ``trackgen.prompts_kept`` the prompts past the bin and
stability gates, and each track's write is a ``trackgen.emit`` span; the
outputs equal an untraced run's. With tracing off nothing is recorded."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from sola_torch.trackgen import prompts_gdino, tokens_gdino
from sola_torch.trackgen.sam2.convert import (load_sam2_image_predictor,
                                              load_sam2_video_predictor)
from sola_torch.trackgen.sam2.model import SAM2Config
from sola_torch.utils import profiling

HW = (48, 72)
T, BIN = 7, 2
EXPRESSIONS = {"0": {"exp": "the red box"}, "1": {"exp": "a green thing"},
               "2": {"exp": "the object on the right moving"}}
NAMES = ("trackgen.grounding", "trackgen.grounding_post",
         "trackgen.box_prompt")


class FakeGrounding:
    """``enqueue_boxes``/``harvest_boxes`` with a fixed number of boxes per
    (frame, expression): 1 + (frame call + expression) % 3."""

    def __init__(self):
        self.calls = 0
        self.returned = 0

    def enqueue_boxes(self, image, texts):
        self.calls += 1
        return self.calls, list(texts)

    def harvest_boxes(self, pending, box_threshold, text_threshold):
        call, texts = pending
        out = []
        for i, _ in enumerate(texts):
            n = 1 + (call + i) % 3
            self.returned += n
            out.append([{"bbox": np.array([4 + 6 * k, 6, 30 + 8 * k, 40],
                                          np.float32),
                         "phrase": "", "token_score": [0.5]}
                        for k in range(n)])
        return out


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("gdino")
    frames_dir = root / "JPEGImages" / "vid"
    frames_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(T):
        f = rng.integers(0, 60, HW + (3,), dtype=np.uint8)
        f[6:30, 4 + 3 * t:24 + 3 * t] = (220, 60, 40)
        Image.fromarray(f).save(frames_dir / f"{t:05d}.jpg", quality=95)
    return root, str(frames_dir)


@pytest.fixture(scope="module")
def predictors():
    cfg = SAM2Config.tiny_test()
    return (load_sam2_image_predictor(None, cfg=cfg, device="cpu", seed=1),
            load_sam2_video_predictor(None, obj_batch=4, cfg=cfg,
                                      device="cpu", seed=1))


def _run(video, predictors, out, traced: bool):
    """prompts_gdino.prompt_video then tokens_gdino.run_video_packed: (the
    prompts JSON, the censuses, the fake's box count, the snapshot)."""
    root, frames_dir = video
    image, vpred = predictors
    profiling.reset()
    fake = FakeGrounding()
    gen = prompts_gdino.PromptGenerator(fake, image)
    os.makedirs(out, exist_ok=True)
    prompt_path = os.path.join(out, "vid.json")

    def work():
        info = prompts_gdino.prompt_video(gen, frames_dir, "vid",
                                          EXPRESSIONS, BIN, prompt_path)
        thr = float(np.median([p["stability_score"]
                               for p in info["prompt_masks"]]))
        state = vpred.init_state(None, video_path=frames_dir)
        censuses = tokens_gdino.run_video_packed(
            vpred, state, "vid", list(EXPRESSIONS), prompt_path, out,
            "mevis", "valid", T, expr_pack=2, bin_size=BIN, batch_size=2,
            stability_score_thresh=thr, n_max_tracks=2, log=lambda s: None)
        return info, censuses, thr

    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            with torch.profiler.record_function("test.traced_window"):
                info, censuses, thr = work()
    else:
        info, censuses, thr = work()
    return info, censuses, thr, fake.returned, profiling.snapshot()


def _strip(censuses):
    return {e: {k: v for k, v in c.items() if k not in ("time", "fps")}
            for e, c in censuses.items()}


def test_spans_and_counters_of_the_text_prompted_path(video, predictors,
                                                      tmp_path):
    info, censuses, thr, boxes, snap = _run(video, predictors,
                                            str(tmp_path / "t"), True)
    bins = len(range(0, T, BIN))
    spans = [s for s in snap["spans"] if s["name"] in NAMES]
    for name in NAMES:
        got = [s for s in spans if s["name"] == name]
        assert len(got) == bins, name
        assert all(s["parent"] is None and s["end_ns"] >= s["start_ns"]
                   for s in got)
    counters = snap["counters"]
    assert counters["trackgen.grounded_pairs"] == bins * len(EXPRESSIONS)
    assert counters["trackgen.boxes"] == boxes == len(info["prompt_masks"])
    kept = sum(p["stability_score"] >= thr and p["frame_idx"] % BIN == 0
               for p in info["prompt_masks"])
    assert 0 < kept < boxes
    assert counters["trackgen.prompts_kept"] == kept
    assert kept == sum(c["n_total"] - c["n_not_used"]
                       for c in censuses.values())
    emits = [s for s in snap["spans"] if s["name"] == "trackgen.emit"]
    assert len(emits) == sum(c["n_tracked"] for c in censuses.values()) > 0
    assert {s["parent"] for s in emits} == {"trackgen.track"}

    plain = _run(video, predictors, str(tmp_path / "u"), False)
    assert plain[4] == {"spans": [], "counters": {}}
    assert json.dumps(plain[0]) == json.dumps(info)
    assert _strip(plain[1]) == _strip(censuses)
