"""Tracing / profiling utilities.

Counterpart of ``sola_tpu/utils/profiling.py`` on ``torch.profiler``. The
reference's only instrumentation is wall-clock deltas dumped into
``runtime_info*.json`` (generate_tokens_grid.py:293-307), which the
trackgen CLIs keep; this module adds a device trace, named regions that
show in it, and a small stage timer.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the host, and the card when there is one, with torch.profiler
    while the block runs, and write the trace as Chrome/Perfetto JSON
    (``*.pt.trace.json``, which TensorBoard also reads) into ``log_dir``,
    or into ``SOLA_TRACE_DIR`` when that is set; a no-op otherwise."""
    log_dir = log_dir or os.environ.get("SOLA_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the handler writes the trace when the profiler stops, on an error too
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def annotate(name: str):
    """Named region that shows up in ``device_trace``'s trace."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulating wall-clock timer for pipeline stages."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / self.counts[name]}
                for name in self.totals}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=4)
