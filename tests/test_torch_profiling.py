"""The port's ``utils/profiling`` (torch.profiler) against the JAX
package's (jax.profiler): the stage timer's summary and dump, the trace as
a no-op without a directory, and a CPU trace that ``device_trace`` writes,
holding an ``annotate`` region."""

import json

import pytest
import torch

import jax.numpy as jnp

from sola_tpu.utils import profiling as jprof
from sola_torch.utils import profiling as tprof


@pytest.mark.parametrize("pkg", [jprof, tprof], ids=["jax", "torch"])
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


def test_stage_timer_matches_jax():
    """The same stages give the same summary layout in both packages, and
    a stage that raises is still counted."""
    summaries = []
    for pkg in (jprof, tprof):
        t = pkg.StageTimer()
        with t.stage("encode"):
            pass
        with pytest.raises(ValueError):
            with t.stage("propagate"):
                raise ValueError("stage failed")
        summaries.append({k: sorted(v) + [v["count"]]
                          for k, v in t.summary().items()})
    assert summaries[0] == summaries[1]


def test_device_trace_noop(monkeypatch, tmp_path):
    monkeypatch.delenv("SOLA_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with jprof.device_trace(None):
        with jprof.annotate("region"):
            _ = jnp.ones(4).sum()
    with tprof.device_trace(None):
        with tprof.annotate("region"):
            _ = torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("from_env", [False, True], ids=["arg", "env"])
def test_device_trace_writes_cpu_trace(monkeypatch, tmp_path, from_env):
    """A trace of a CPU run lands in the directory given, or in
    SOLA_TRACE_DIR, as Chrome/Perfetto JSON that holds the annotated
    region and the ops inside it."""
    trace_dir = tmp_path / "trace"
    if from_env:
        monkeypatch.setenv("SOLA_TRACE_DIR", str(trace_dir))
    with tprof.device_trace(None if from_env else str(trace_dir)):
        with tprof.annotate("sola_region"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, list(trace_dir.iterdir())
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "sola_region"]
    assert region and region[0].get("dur", 0) > 0
    start, end = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    assert any(e.get("name") == "aten::mm" and start <= e["ts"] <= end
               for e in events)
