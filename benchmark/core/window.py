"""The measured window: whole units of work (a video, a step, a frame) run
back to back from its start, and the window ends at the first unit boundary
at or after ``--seconds``. Each unit ends in a ``torch.cuda.synchronize()``,
so its host-clock end is the end of its device work.

In a traced run the profiler covers the window's first ``trace_units``
units; the rest of the window runs untraced.
"""

from __future__ import annotations

import time

from benchmark.core import trace as trace_lib


def run(record, seconds: float, unit_fn, *, trace: bool = False,
        trace_units: int = 1, min_units: int = 1) -> None:
    """``unit_fn(i)`` does unit ``i`` and returns a dict of the work it
    finished (counts a metric reads); the window stops at the first unit
    boundary at or after ``seconds`` that has ``min_units`` behind it."""
    import torch
    torch.cuda.synchronize()
    prof = None
    if trace:
        prof = trace_lib.start()
        record._tracing = True
        note = torch.profiler.record_function(trace_lib.WINDOW_NAME)
        note.__enter__()
    t0 = time.perf_counter()
    i = 0
    while True:
        u0 = time.perf_counter()
        work = dict(unit_fn(i) or {})
        torch.cuda.synchronize()
        u1 = time.perf_counter()
        work.update(t0=u0, t1=u1, traced=prof is not None)
        record.units.append(work)
        i += 1
        if prof is not None and i >= trace_units:
            note.__exit__(None, None, None)
            record._tracing = False
            record.trace = trace_lib.summarize(prof, u1 - t0,
                                               list(record.spans))
            prof = None
        if prof is None and u1 - t0 >= seconds and i >= min_units:
            break
    record.window = (t0, u1)


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
