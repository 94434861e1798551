"""Rates and tails run over every unit of the window: a stall in one unit
moves both, and the window ends at the first unit boundary at or after
its length."""

from __future__ import annotations

import time

import pytest

from benchmark.core import readers, window
from benchmark.core.record import Record


def _run(durations, seconds):
    rec = Record("w", {}, {}, {}, 0)

    def unit(i):
        time.sleep(durations[i])
        return {"pairs": 1, "frames": 2}

    window.run(rec, seconds, unit)
    return rec


def test_percentile_matches_numpy_linear_rule():
    np = pytest.importorskip("numpy")
    values = [5.0, 1.0, 3.0, 2.0, 8.0, 13.0, 21.0]
    for q in (0, 25, 50, 95, 100):
        assert window.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)))


def test_window_ends_at_first_boundary_after_its_length(cpu_harness):
    rec = _run([0.02] * 20, 0.05)
    assert 3 <= len(rec.units) <= 4
    assert rec.window[1] == rec.units[-1]["t1"]
    assert rec.window_seconds() >= 0.05


def test_a_stall_moves_the_rate_and_the_tail(cpu_harness):
    steady = _run([0.01] * 120, 0.8)
    stalled = _run([0.01] * 10 + [0.1] * 4 + [0.01] * 106, 0.8)
    rate = lambda r: r.total("pairs") / r.window_seconds()  # noqa: E731
    p95 = lambda r: window.percentile(  # noqa: E731
        [u["t1"] - u["t0"] for u in r.units], 95)
    assert rate(stalled) < 0.8 * rate(steady)
    assert p95(stalled) > 2 * p95(steady)
    # the tail is over every step: four stalled steps of ~44 reach p95
    assert len(stalled.units) >= 20


def test_span_reader_sums_every_span(cpu_harness):
    rec = Record("w", {}, {}, {}, 0)
    for d in (0.01, 0.03):
        with rec.span("data"):
            time.sleep(d)
    rec.units = [{"pairs": 1}, {"pairs": 1}]
    assert readers.span_ms_per(rec, "data", "pairs") == pytest.approx(
        20.0, rel=0.5)
    assert readers.span_ms_per(rec, "missing", "pairs") is None
    assert readers.device_idle_pct(rec) is None
    assert readers.roofline_pct(rec, ["flash_attn_fwd"]) is None


def test_window_runs_at_least_min_units(cpu_harness):
    rec = Record("w", {}, {}, {}, 0)
    window.run(rec, 0.0, lambda i: {"pairs": 1}, min_units=3)
    assert len(rec.units) == 3


def test_every_seed_and_pack_gets_the_same_work():
    """The trackgen mixes draw an order from the seed, never the sizes:
    grid_dense's video lengths, and each of gt_packed's packs."""
    from benchmark.core import manifest
    from benchmark.gen import mevis_gt_videos, videos
    grid = manifest.traffic("grid_dense")
    gt = manifest.traffic("gt_packed")
    n = len(gt["group"])
    for seed in (1, 2 ** 31 + 5):
        assert sorted(videos.lengths(grid, seed)) == sorted(
            videos.lengths(grid, 0))
        specs = mevis_gt_videos.videos(gt, seed)
        assert len(specs) == n * int(gt["n_groups"])
        for k in range(0, len(specs), n):
            assert sorted(specs[k:k + n]) == sorted(
                tuple(v) for v in gt["group"])
