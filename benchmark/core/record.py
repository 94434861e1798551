"""What a run records: the harness's spans, the program's counters, the
units of work finished in the measured window, and the profiler's trace.

Spans and units are taken by the host clock around work that ends in a
``torch.cuda.synchronize()``. The metric readers (``metrics/*.py``) read
only this object.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional


class Record:
    def __init__(self, workload: str, cell: dict, config: dict, mix: dict,
                 seed: int):
        self.workload = workload
        self.cell = cell
        self.config = config
        self.mix = mix
        self.seed = seed
        self.spans: dict = defaultdict(list)      # name -> [(t0, t1)]
        self.counters: dict = {}
        self.units: list = []                     # one dict per finished unit
        self.window: Optional[tuple] = None       # (t0, t1) host seconds
        self.trace = None                         # core.trace.TraceSummary
        self.memory_peak_bytes: Optional[int] = None
        self._tracing = False

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span ended by a synchronize; inside a traced portion
        also a profiler annotation, so idle gaps can be named by it."""
        import torch
        ctx = (torch.profiler.record_function(name) if self._tracing
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
            torch.cuda.synchronize()
        self.spans[name].append((t0, time.perf_counter()))

    # ------------------------------------------------------------------
    def window_seconds(self) -> float:
        return self.window[1] - self.window[0]

    def total(self, key: str, traced_only: bool = False) -> float:
        return sum(u.get(key, 0) for u in self.units
                   if u.get("traced") or not traced_only)

    def traced_units(self) -> list:
        return [u for u in self.units if u.get("traced")]
