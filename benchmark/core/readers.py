"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

Each reader returns a number, or None where its run holds nothing to read
(no trace, no such span, no unit with the count); a share of a roofline or
a peak is never returned as 0 for want of a reading.
"""

from __future__ import annotations

from benchmark.core import manifest
from benchmark.counts import peaks


def span_ms_per(record, span: str, count_key: str):
    """Milliseconds of ``span`` summed over the window, per unit of
    ``count_key`` summed over the window's units."""
    n = record.total(count_key)
    spans = record.spans.get(span)
    if not spans or not n:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in spans) / n


def _untraced(record) -> list:
    units = [u for u in record.units if not u.get("traced")]
    return units or list(record.units)


def mfu_pct(record):
    """Least time of the finished work at the peak of each part's stated
    precision, over the host-clock time of those units: the units the
    profiler did not cover (all of them in an untraced run)."""
    units = [u for u in _untraced(record) if "flops" in u]
    if not units:
        return None
    least = sum(peaks.least_seconds(u["flops"]) for u in units)
    span = units[-1]["t1"] - units[0]["t0"]
    return 100.0 * least / span if span > 0 else None


def device_idle_pct(record):
    tr = record.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(record, kernel_lists, least_key: str = "attention_least_s"):
    """Least time of the traced units' work in these kernels over the
    kernels' device time in the trace."""
    tr = record.trace
    units = record.traced_units()
    if tr is None or not units or any(least_key not in u for u in units):
        return None
    patterns = [p for name in kernel_lists
                for p in manifest.kernels(name)["patterns"]]
    busy = tr.kernel_seconds(patterns)
    if busy <= 0:
        return None
    return 100.0 * sum(u[least_key] for u in units) / busy


def unit_ms_percentile(record, q: float):
    """The q-th percentile of the untraced units' durations, in ms."""
    from benchmark.core.window import percentile
    units = [u for u in record.units if not u.get("traced")]
    if not units:
        return None
    return percentile([1e3 * (u["t1"] - u["t0"]) for u in units], q)


def launches_per(record, count_key: str):
    tr = record.trace
    n = record.total(count_key, traced_only=True)
    if tr is None or not n:
        return None
    return tr.kernel_launches() / n


def peak_mem_gb(record):
    if record.memory_peak_bytes is None:
        return None
    return record.memory_peak_bytes / 1e9
