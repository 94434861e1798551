"""The port's ``utils/profiling`` (torch.profiler) beside the JAX
package's (jax.profiler): the JAX package's stage timer, the trace as a
no-op without a directory, a CPU trace that ``device_trace`` writes,
holding a ``span`` region, with the spans beside it as ``spans.json``;
and the port's recorder: spans and counters only while a profiler
records, self times, ``spanned``, ``fetch`` and ``reset``."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from sola_tpu.utils import profiling as jprof
from sola_torch.utils import profiling as tprof


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


@pytest.mark.parametrize("pkg", [jprof], ids=["jax"])
def test_stage_timer(pkg, tmp_path):
    t = pkg.StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)
    path = tmp_path / "stages.json"
    t.dump(str(path))
    assert json.loads(path.read_text()) == s


def test_device_trace_noop(monkeypatch, tmp_path):
    monkeypatch.delenv("SOLA_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with jprof.device_trace(None):
        with jprof.annotate("region"):
            _ = jnp.ones(4).sum()
    with tprof.device_trace(None):
        with tprof.span("region"):
            _ = torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("from_env", [False, True], ids=["arg", "env"])
def test_device_trace_writes_cpu_trace(monkeypatch, tmp_path, from_env):
    """A trace of a CPU run lands in the directory given, or in
    SOLA_TRACE_DIR, as Chrome/Perfetto JSON that holds the span's region
    and the ops inside it, with the span in ``spans.json`` beside it."""
    trace_dir = tmp_path / "trace"
    if from_env:
        monkeypatch.setenv("SOLA_TRACE_DIR", str(trace_dir))
    with tprof.device_trace(None if from_env else str(trace_dir)):
        with tprof.span("sola_region"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    spans = json.loads((trace_dir / "spans.json").read_text())["spans"]
    assert [s["name"] for s in spans] == ["sola_region"]
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, list(trace_dir.iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "sola_region"]
    assert region and region[0].get("dur", 0) > 0
    start, end = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    assert any(e.get("name") == "aten::mm" and start <= e["ts"] <= end
               for e in events)


def test_span_is_one_shared_noop_without_a_profiler():
    assert not tprof.enabled()
    assert tprof.span("a") is tprof.span("b")
    with tprof.span("a"):
        tprof.count("c", 3)
    assert tprof.snapshot() == {"spans": [], "counters": {}}


def test_spans_nest_with_self_times_and_counters_add():
    with profile(activities=[ProfilerActivity.CPU]):
        assert tprof.enabled()
        with tprof.span("outer"):
            with tprof.span("inner"):
                tprof.count("n")
            with tprof.span("inner"):
                tprof.count("n", 4)
    snap = tprof.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["inner", "inner", "outer"]
    outer = snap["spans"][2]
    inner = snap["spans"][:2]
    assert outer["parent"] is None and outer["parent_id"] is None
    for s in inner:
        assert (s["parent"], s["parent_id"]) == ("outer", outer["id"])
        assert s["self_ns"] == s["end_ns"] - s["start_ns"]
    assert outer["self_ns"] == (outer["end_ns"] - outer["start_ns"]
                                - sum(s["end_ns"] - s["start_ns"]
                                      for s in inner))
    assert snap["counters"] == {"n": 5}
    tprof.reset()
    assert tprof.snapshot() == {"spans": [], "counters": {}}


def test_a_span_closes_when_its_block_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tprof.span("outer"):
                with tprof.span("failing"):
                    raise ValueError("stage failed")
        with tprof.span("after"):
            pass
    spans = {s["name"]: s for s in tprof.snapshot()["spans"]}
    assert spans["failing"]["parent"] == "outer"
    assert spans["after"]["parent"] is None


def test_spanned_wraps_calls_and_keeps_the_function():
    @tprof.spanned("work")
    def work(x, *, y=1):
        """Adds."""
        return x + y
    assert work(1, y=2) == 3 and work.__name__ == "work"
    assert work.__doc__ == "Adds." and not tprof.snapshot()["spans"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert work(2) == 3
    assert [s["name"] for s in tprof.snapshot()["spans"]] == ["work"]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fetch_equals_cpu_numpy_and_counts_bytes(dtype):
    t = (torch.arange(60).reshape(3, 4, 5) % 7).to(dtype)
    off = tprof.fetch(t)
    with profile(activities=[ProfilerActivity.CPU]):
        on = tprof.fetch(t)
        tprof.fetch(t[:1])
    want = t.cpu().numpy()
    for got in (off, on):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    snap = tprof.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["trackgen.fetch"] * 2
    assert snap["counters"] == {"trackgen.fetches": 2,
                                "trackgen.fetch_bytes": 4 * want.nbytes // 3}
