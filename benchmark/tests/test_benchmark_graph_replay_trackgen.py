"""The reader of ``graph_replay_pct.trackgen`` on synthetic snapshots of the
program's recorder: 100 x trackgen.graph_replays / trackgen.steps, and None
where the program counted no step (a checkout whose step has no counter)
or replayed none."""

from __future__ import annotations

import pytest

from benchmark.core import manifest
from benchmark.core.record import Record

METRIC = "graph_replay_pct.trackgen"


def _record():
    rec = Record("synthetic", {}, {}, {}, 0)
    rec.units = [{"traced": True, "frames": 40, "object_frames": 400}]
    return rec


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the program's snapshot with the one a test gives."""
    from sola_torch.utils import profiling

    def use(counters):
        monkeypatch.setattr(profiling, "snapshot",
                            lambda: {"spans": [], "counters": counters})
    return use


@pytest.mark.parametrize("counters, want", [
    ({"trackgen.steps": 188, "trackgen.graph_replays": 188}, 100.0),
    ({"trackgen.steps": 190, "trackgen.graph_captures": 2,
      "trackgen.graph_replays": 188}, 100.0 * 188 / 190),
    ({"trackgen.steps": 64, "trackgen.slots": 256}, None),
    ({"trackgen.graph_replays": 12}, None),
    ({"trackgen.slots": 256, "trackgen.slots_active": 192}, None)])
def test_reads_replays_over_steps(counters, want, recorder):
    recorder(counters)
    got = manifest.load_reader(METRIC)(_record())
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)
