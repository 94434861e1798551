"""The text-prompted cell ``trackgen_l.gdino``: it resolves from its files,
a driver unit runs end to end at tiny sizes on the CPU and every check is
computed, the counts agree with ``chip_smoke.py``'s deformable bound, and
its new readers read nothing where the program recorded nothing. On a
card: a traced run reads every new metric."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark.core import env, manifest, window
from benchmark.core.record import Record

CELL = "trackgen_l.gdino"
NEW = ("prompt_ms_per_frame.trackgen", "grounding_host_ms_per_pair.trackgen",
       "box_prompt_ms_per_box.trackgen", "deform_roofline_pct.trackgen")
CHECKS = ("logit_gap", "box_gap", "pick_gap", "box_gate_gap", "mask_gap",
          "stability_gap", "stability_gate_gap", "token_gap", "dedup_gap",
          "track_count_gap", "feature_gap")
TINY_MIX = {"height": 48, "width": 72, "videos": [[8, 3], [10, 9]],
            "objects": 2, "warmup": [6, 2], "cycle": [1, 0]}


def test_the_cell_resolves_and_reports():
    man = manifest.manifest()
    cell = manifest.cell(CELL)
    assert cell["entry"] == "trackgen_gdino"
    config = manifest.config(cell["config"])
    assert config["reduced"] == [] and set(config["limits"][
        "trackgen_gdino"]) == set(CHECKS)
    assert manifest.traffic(cell["traffic"])["generator"] == "gdino_videos"
    assert manifest.kernels("ms_deform_attn_fwd")["patterns"] == [
        "ms_deform_fwd_kernel"]
    e2e = [m["name"] for m in manifest.end_to_end_for(man, CELL)]
    assert e2e == ["track_object_fps", "setup_s"]
    layer = {m["name"] for m in manifest.per_layer_for(man, CELL)}
    assert set(NEW) <= layer and "encode_ms_per_frame.trackgen" in layer


def _record(seed: int) -> Record:
    cell = manifest.cell(CELL)
    config = copy.deepcopy(manifest.config(cell["config"]))
    # random tiny SAM2 weights give stabilities of about 0.2 to 0.5
    config["tokens"]["stability_score_thresh"] = 0.3
    mix = dict(manifest.traffic(cell["traffic"]), **TINY_MIX)
    return Record(CELL, cell, config, mix, seed)


def test_a_unit_runs_end_to_end_and_every_check_is_computed(cpu_harness):
    from benchmark.core import device as device_lib
    from benchmark.drivers import trackgen_gdino as tg
    rec = _record(2 ** 31 + 21)
    cell = tg.Cell(rec, size="tiny_test", device="cpu")
    cell.setup()
    window.run(rec, 0.0, cell.unit, min_units=2)
    tg.add_counts(rec, "tiny_test")
    u = max(rec.units, key=lambda x: x["expressions"])
    assert u["pairs"] == 3 * 9 and u["objects"] > 0
    assert u["flops"]["fp32"] > 0 and u["deform_least_s"] > 0
    vid = u["video"]
    got = cell.program_outputs(vid)
    cell.free_program()
    ref = cell.reference_outputs(vid, got)
    r = tg.compare_video(got, ref)
    limits = rec.config["limits"]["trackgen_gdino"]
    checks = [device_lib.check(k, r[k], float(v)) for k, v in limits.items()]
    assert len(checks) == len(CHECKS) and all(c["ok"] for c in checks), r
    assert r["status_mismatch"] == 0 and len(ref["tracks"]) == u["objects"]
    assert r["token_gap"] < 1e-4 and r["mask_gap"] < 1e-3
    assert r["logit_gap"] < 1e-5 and r["box_gap"] < 1e-5
    cell.cleanup()


def test_an_altered_box_mask_fails_mask_gap(cpu_harness, monkeypatch):
    """A prompt mask altered where the image predictor makes it."""
    import numpy as np

    from benchmark.drivers import trackgen_gdino as tg
    from sola_torch.trackgen.sam2 import image
    orig = image.SAM2ImagePredictor.predict_packed

    def altered(self, *a, **k):
        masks, scores, stabs = orig(self, *a, **k)
        masks = masks.copy()
        masks[:, ::2] = ~masks[:, ::2]
        return masks, scores, stabs

    monkeypatch.setattr(image.SAM2ImagePredictor, "predict_packed", altered)
    rec = _record(2 ** 31 + 22)
    cell = tg.Cell(rec, size="tiny_test", device="cpu")
    cell.setup(warmup=False)
    window.run(rec, 0.0, cell.unit)
    vid = rec.units[0]["video"]
    got = cell.program_outputs(vid)
    r = tg.mask_gaps(got["prompts"], cell.reference_outputs(
        vid, got)["box_masks"])
    assert np.isfinite(r["mask_gap"])
    assert r["mask_gap"] > rec.config["limits"]["trackgen_gdino"]["mask_gap"]
    cell.cleanup()


def test_every_seed_walks_the_same_videos_in_the_cycle(tmp_path):
    """The same videos and expressions for every seed, in the mix's cycle
    from a starting point the seed draws."""
    from benchmark.gen import gdino_videos
    mix = dict(manifest.traffic("gdino_mevis"), **TINY_MIX)
    mix.update(cycle=[1, 0, 2], videos=[[4, 2], [5, 3], [6, 1]])
    seen = {}
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3, 2 ** 31 + 4):
        out = gdino_videos.generate(str(tmp_path / str(seed)), mix, seed)
        ids = [v["video_id"] for v in out["videos"]]
        k = ids.index("v001")
        assert ids[k:] + ids[:k] == ["v001", "v000", "v002"]
        for v in out["videos"]:
            seen.setdefault(v["video_id"], set()).add(
                json.dumps(v["expressions"], sort_keys=True))
    assert all(len(x) == 1 for x in seen.values())


def test_deformable_bytes_are_chip_smokes_bound():
    """At the E = 4 encoder shape of PERF.md's kernel table: the values,
    locations, weights and output read or written once, 0.0951 ms at
    3.35 TB/s."""
    from benchmark.counts import gdino_swin_t as counts
    from benchmark.counts import peaks
    b, lq, heads, levels, points, hd = 4, 22223, 8, 4, 4, 32
    flops, nbytes = counts.deform_work(b, lq, lq, heads, levels, points, hd)
    value = b * lq * heads * hd * 4
    loc = b * lq * heads * levels * points * 2 * 4
    wgt = b * lq * heads * levels * points * 4
    assert nbytes == value + loc + wgt + value
    assert flops == 2.0 * 4 * b * lq * heads * levels * points * hd
    assert nbytes / peaks.PEAK_BYTES * 1e3 == pytest.approx(0.0951,
                                                            abs=5e-5)
    calls = counts.grounding_work(manifest.config("gdino_swin_t"), "large",
                                  4, 16)["deform"]
    assert len(calls) == 12 and calls[0] == (flops, nbytes)


def test_new_readers_read_nothing_without_program_spans():
    from benchmark.core import program_spans
    rec = _record(1)
    saved = program_spans.snapshot
    program_spans.snapshot = lambda: None
    try:
        for name in NEW:
            assert manifest.load_reader(name)(rec) is None, name
    finally:
        program_spans.snapshot = saved


@pytest.mark.card
def test_traced_run_reads_every_new_metric(cuda_card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 103), "--seconds", "5", "--trace", "1"],
        cwd=env.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    for name in NEW:
        assert result["metrics"][name]["value"] is not None, name
    assert 0 < result["metrics"]["deform_roofline_pct.trackgen"][
        "value"] <= 100


@pytest.mark.parametrize("gate", ["box", "stability", "dedup", "cap"])
def test_a_moved_gate_fails_its_check(cpu_harness, monkeypatch, gate):
    """The program run with one gate moved from the configuration's (the
    box threshold 0.2 -> 0.9, which the tiny model's sampled chunk has a
    query under, the stability threshold 0.3 -> 0.2, the dedup IoU 0.7 ->
    1.0, the track cap 2 -> 16, where the tiny model tracks 2-4 prompts an
    expression) while the reference holds the configured one: that gate's
    check fails and reads the move."""
    from benchmark.drivers import trackgen_gdino as tg
    moved = {"stability": ("stability_score_thresh", 0.2),
             "dedup": ("miou_thresh", 1.0), "cap": ("n_max_tracks", 16)}
    if gate in moved:
        key, value = moved[gate]
        run = tg.run_video_packed
        monkeypatch.setattr(tg, "run_video_packed",
                            lambda *a, **k: run(*a, **dict(k, **{key: value})))
    rec = _record(2 ** 31 + 23)
    rec.config["tokens"]["n_max_tracks"] = 2
    cell = tg.Cell(rec, size="tiny_test", device="cpu")
    cell.setup(warmup=False)
    if gate == "box":
        cell.generator.box_threshold = 0.9
    window.run(rec, 0.0, cell.unit)
    vid = rec.units[0]["video"]
    got = cell.program_outputs(vid)
    r = tg.compare_video(got, cell.reference_outputs(vid, got))
    limits = rec.config["limits"]["trackgen_gdino"]
    check = {"box": "box_gate_gap", "stability": "stability_gate_gap",
             "dedup": "dedup_gap", "cap": "track_count_gap"}[gate]
    failed = {k for k, v in limits.items() if not r[k] <= v}
    assert check in failed, r
    if gate == "stability":
        assert 0.04 < r[check] <= 0.1, r
    cell.cleanup()


@pytest.mark.parametrize("cols,status,cap,gap", [
    (336, 2, 4, 0.0), (240, 2, 4, 0.2), (384, 1, 4, 0.1), (384, 1, 1, 0.0)])
def test_the_dedup_walk_passes_a_flip_and_reads_a_move(cols, status, cap,
                                                       gap):
    """One frame at the canonical 540x960: track 0's masklet and prompt
    are its left 480 columns, prompt 1 the left ``cols`` (IoU cols / 480)
    with the program's ``status`` (1 tracked in a second batch, 2
    filtered). IoU 0.7 filtered is a rounding flip and reads ~0; 0.5
    filtered reads 0.2 from the threshold, 0.8 tracked 0.1; a track past
    the program's cap is a count mismatch."""
    from benchmark.drivers import trackgen_gdino as tg
    from benchmark.gen import rle
    masks = []
    for c in (480, cols):
        m = np.zeros((540, 960), np.uint8)
        m[:, :c] = 1
        masks.append(m)
    tracked = [0, 1] if status == 1 else [0]
    got = {"gates": {"miou_thresh": 0.7, "n_max_tracks": cap,
                     "batch_size": 1, "n_frames": 1},
           "census": {"0": {"tracked": tracked,
                            "filtered": [1] if status == 2 else [],
                            "open": [], "n_tracked": len(tracked)}},
           "tracks": {i: (masks[i][None], None) for i in tracked}}
    ref = {"prompts": {"prompt_masks": [
        {"prompt_id": i, "frame_idx": 0, "expression_id": "0",
         "segmentation": rle.encode(m)} for i, m in enumerate(masks)]},
        "tracks": got["tracks"]}
    r = tg.dedup_gaps(got, ref)
    assert r["dedup_gap"] == pytest.approx(gap, abs=1e-6), r
    assert r["track_count_gap"] == (1.0 if cap < len(tracked) else 0.0)
    assert r["dedup_iou_gap"] == 0.0
