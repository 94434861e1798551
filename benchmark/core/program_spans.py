"""The program's own spans and counters (``sola_torch.utils.profiling``),
read by the per-layer metric readers after the window.

The program records only while the profiler does, so every quantity here
is divided by the traced units' counts. Each helper returns None where the
program has no recorder (a checkout from before it had one) or recorded
nothing to read.
"""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    """The program's snapshot, or None without a recorder."""
    try:
        from sola_torch.utils import profiling
        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def _spans(name: str) -> list:
    snap = snapshot()
    return [s for s in (snap or {}).get("spans", []) if s["name"] == name]


def _counter(name: str):
    snap = snapshot()
    return (snap or {}).get("counters", {}).get(name)


def span_ms(name: str, self_time: bool = False) -> Optional[float]:
    """Milliseconds in span ``name``, summed over its entries (their self
    times with ``self_time``)."""
    spans = _spans(name)
    if not spans:
        return None
    return 1e-6 * sum(s["self_ns"] if self_time
                      else s["end_ns"] - s["start_ns"] for s in spans)


def span_ms_per(record, name: str, key: str,
                self_time: bool = False) -> Optional[float]:
    """Milliseconds in span ``name`` per unit of ``key`` summed over the
    traced units."""
    ms = span_ms(name, self_time)
    n = record.total(key, traced_only=True)
    return ms / n if ms is not None and n else None


def span_ms_per_unit(record, name: str) -> Optional[float]:
    """Milliseconds in span ``name`` per traced unit."""
    ms = span_ms(name)
    n = len(record.traced_units())
    return ms / n if ms is not None and n else None


def span_mean_ms(name: str) -> Optional[float]:
    """Mean milliseconds of one entry of span ``name``."""
    spans = _spans(name)
    return span_ms(name) / len(spans) if spans else None


def counter_per(record, name: str, key: str) -> Optional[float]:
    """Counter ``name`` per unit of ``key`` summed over the traced units."""
    value = _counter(name)
    n = record.total(key, traced_only=True)
    return value / n if value is not None and n else None


def counter_pct(part: str, whole: str) -> Optional[float]:
    """100 x counter ``part`` / counter ``whole``."""
    num, den = _counter(part), _counter(whole)
    return 100.0 * num / den if num is not None and den else None
