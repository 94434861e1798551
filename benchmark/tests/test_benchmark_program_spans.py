"""The readers of the program's own spans and counters
(``core/program_spans.py`` and the nine ``metrics/*`` that use it) on a
synthetic record and snapshot: each gives the number worked out by hand,
and None where the program has no recorder or recorded nothing."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark.core import manifest
from benchmark.core.record import Record

MS = 1_000_000          # nanoseconds in a millisecond

READERS = ["decode_ms_per_frame.trackgen", "step_host_ms.trackgen",
           "fetch_ms_per_objframe.trackgen",
           "fetch_bytes_per_objframe.trackgen",
           "emit_ms_per_objframe.trackgen", "slot_fill_pct.trackgen",
           "forward_ms_per_step.train", "backward_ms_per_step.train",
           "optimizer_ms_per_step.train"]


def _span(name, sid, start_ms, end_ms, parent=None, self_ms=None):
    return {"name": name, "id": sid, "parent": parent and parent[0],
            "parent_id": parent and parent[1], "thread": 1,
            "start_ns": start_ms * MS, "end_ns": end_ms * MS,
            "self_ns": (end_ms - start_ms if self_ms is None
                        else self_ms) * MS}


def _record(units):
    rec = Record("synthetic", {}, {}, {}, 0)
    rec.units = units
    return rec


# one traced trackgen unit of 40 frames and 400 object-frames, and an
# untraced one the readers must not count
TRACK_UNITS = [{"traced": True, "frames": 40, "object_frames": 400},
               {"traced": False, "frames": 50, "object_frames": 800}]
TRACK_SNAP = {
    "spans": [
        _span("trackgen.decode", 1, 0, 120, ("trackgen.encode", 0)),
        _span("trackgen.encode", 0, 0, 300, self_ms=180),
        _span("trackgen.step", 3, 310, 340, ("trackgen.track", 2)),
        _span("trackgen.step", 4, 340, 360, ("trackgen.track", 2)),
        _span("trackgen.fetch", 5, 360, 400, ("trackgen.track", 2)),
        _span("trackgen.fetch", 7, 405, 407, ("trackgen.dedup", 6)),
        _span("trackgen.dedup", 6, 400, 410, ("trackgen.track", 2),
              self_ms=8),
        _span("trackgen.emit", 8, 410, 500, ("trackgen.track", 2)),
        _span("trackgen.track", 2, 300, 500, self_ms=8)],
    "counters": {"trackgen.fetches": 3, "trackgen.fetch_bytes": 164_000_000,
                 "trackgen.slots": 16, "trackgen.slots_active": 12}}
TRACK_WANT = {"decode_ms_per_frame.trackgen": 120 / 40,
              "step_host_ms.trackgen": (30 + 20) / 2,
              "fetch_ms_per_objframe.trackgen": (40 + 2) / 400,
              "fetch_bytes_per_objframe.trackgen": 164_000_000 / 400,
              "emit_ms_per_objframe.trackgen": 90 / 400,
              "slot_fill_pct.trackgen": 75.0}

TRAIN_UNITS = [{"traced": True, "pairs": 1}, {"traced": True, "pairs": 1},
               {"traced": False, "pairs": 1}]
TRAIN_SNAP = {"spans": [], "counters": {}}
for i, t in enumerate((0, 100)):
    step = ("train.step", 10 * i)
    TRAIN_SNAP["spans"] += [
        _span("train.prepare", 10 * i + 5, t, t + 5),
        _span("train.forward", 10 * i + 1, t + 5, t + 15 + i, step),
        _span("train.backward", 10 * i + 2, t + 15 + i, t + 35, step),
        _span("train.optimizer", 10 * i + 3, t + 35, t + 43, step),
        _span("train.step", 10 * i, t + 5, t + 45, self_ms=2)]
TRAIN_WANT = {"forward_ms_per_step.train": (10 + 11) / 2,
              "backward_ms_per_step.train": (20 + 19) / 2,
              "optimizer_ms_per_step.train": 8.0}


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the program's snapshot with the one a test gives."""
    from sola_torch.utils import profiling

    def use(snap):
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return use


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_gives_the_hand_computed_number(metric, recorder):
    read = manifest.load_reader(metric)
    if metric.endswith(".train"):
        recorder(TRAIN_SNAP)
        got, want = read(_record(TRAIN_UNITS)), TRAIN_WANT[metric]
    else:
        recorder(TRACK_SNAP)
        got, want = read(_record(TRACK_UNITS)), TRACK_WANT[metric]
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("recorder_module", ["none", "no_snapshot", "empty"])
def test_readers_give_none_without_a_recording(recorder_module,
                                               monkeypatch):
    """No recorder module, one without ``snapshot`` (a checkout from before
    the recorder), and a recorder that recorded nothing."""
    import sola_torch.utils as package
    from sola_torch.utils import profiling
    name = "sola_torch.utils.profiling"
    if recorder_module == "none":
        monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.delattr(package, "profiling")
    elif recorder_module == "no_snapshot":
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        monkeypatch.setattr(package, "profiling", sys.modules[name])
    else:
        profiling.reset()
    for metric in READERS:
        units = TRAIN_UNITS if metric.endswith(".train") else TRACK_UNITS
        assert manifest.load_reader(metric)(_record(units)) is None, metric


def test_readers_give_none_without_traced_units(recorder):
    recorder(TRACK_SNAP)
    untraced = [dict(u, traced=False) for u in TRACK_UNITS]
    for metric in ("decode_ms_per_frame.trackgen",
                   "fetch_ms_per_objframe.trackgen",
                   "fetch_bytes_per_objframe.trackgen",
                   "emit_ms_per_objframe.trackgen"):
        assert manifest.load_reader(metric)(_record(untraced)) is None
