"""Tracing: named spans and counters of the port's hot paths.

Counterpart of ``sola_tpu/utils/profiling.py`` on ``torch.profiler``. The
reference's only instrumentation is wall-clock deltas dumped into
``runtime_info*.json`` (generate_tokens_grid.py:293-307), which the
trackgen CLIs keep. This module is the port's one tracing module:

* ``enabled()`` is true exactly while a torch profiler records on this
  thread: ``device_trace`` below, or any ``torch.profiler.profile`` around
  the work (the benchmark's traced units). No flag turns it on.
* ``span(name)``: with tracing off, one check and a shared no-op context
  (no clock read, no annotation). With tracing on, a
  ``torch.profiler.record_function`` annotation, so the span shows in the
  device trace and names its idle gaps, and an entry of an in-memory list
  on the trace's clock (Unix nanoseconds), read just outside the
  annotation so the entry encloses it. A span's parent is the innermost
  span still open on its thread. A span never synchronizes: it times the
  host, and the device's side of the same interval is in the trace.
  Spans close before a generator yields.
* ``spanned(name)``: a function decorator, each call inside ``span(name)``.
* ``count(name, n)`` adds to a counter while tracing is on.
* ``fetch(t)``: ``t.cpu().numpy()``, the blocking device-to-host copies of
  the track path, inside span ``trackgen.fetch`` and counted.
* ``snapshot()`` / ``reset()``: the spans (with self times) and counters
  recorded so far, and clearing them.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
from time import time_ns as _clock
from typing import Optional

import numpy as np
import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_local = threading.local()
_ids = itertools.count()
# (id, name, parent id, parent name, start ns, end ns, thread)
_spans: list = []
_counters: dict = {}
# the first annotation of a process resolves the profiler's ops (about a
# millisecond); done here, with no profiler running, no traced span pays it
with torch.profiler.record_function("sola_torch.profiling"):
    pass


def enabled() -> bool:
    """Whether a torch profiler is recording on this thread."""
    return _profiler_enabled()


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "start", "note")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        # the annotation is built before the clock is read, so the entry
        # brackets only its enter and exit
        self.note = torch.profiler.record_function(self.name)
        self.start = _clock()
        self.note.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.note.__exit__(*exc)
        end = _clock()
        _open().pop()
        p = self.parent
        _spans.append((self.id, self.name, p.id if p else None,
                       p.name if p else None, self.start, end,
                       threading.get_ident()))
        return False


def span(name: str):
    """Named host span: a profiler annotation and an in-memory entry while
    tracing is on, a shared no-op context otherwise."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``
    (for functions, not generators)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``; while tracing is on, inside span
    ``trackgen.fetch`` and counted in ``trackgen.fetches`` and
    ``trackgen.fetch_bytes``."""
    if not _profiler_enabled():
        return t.cpu().numpy()
    with _Span("trackgen.fetch"):
        out = t.cpu().numpy()
    count("trackgen.fetches")
    count("trackgen.fetch_bytes", out.nbytes)
    return out


def snapshot() -> dict:
    """{"spans": [...], "counters": {...}}: every closed span in the order
    it closed, with its parent's name and id, its thread, its start and
    end on the trace's clock and its self time (its duration less the
    durations of its children), and a copy of the counters."""
    spans = list(_spans)
    children: dict = {}
    for _, _, pid, _, s, e, _ in spans:
        if pid is not None:
            children[pid] = children.get(pid, 0) + (e - s)
    return {"spans": [{"name": name, "id": sid, "parent": pname,
                       "parent_id": pid, "thread": thread, "start_ns": s,
                       "end_ns": e, "self_ns": e - s - children.get(sid, 0)}
                      for sid, name, pid, pname, s, e, thread in spans],
            "counters": dict(_counters)}


def reset() -> None:
    """Forget the recorded spans and counters."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the host, and the card when there is one, with torch.profiler
    while the block runs, and write the trace as Chrome/Perfetto JSON
    (``*.pt.trace.json``, which TensorBoard also reads) into ``log_dir``,
    or into ``SOLA_TRACE_DIR`` when that is set, with the block's spans
    and counters beside it as ``spans.json``; a no-op otherwise."""
    log_dir = log_dir or os.environ.get("SOLA_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    try:
        # the handler writes the trace when the profiler stops, on an
        # error too
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(log_dir))):
            yield
    finally:
        os.makedirs(str(log_dir), exist_ok=True)
        with open(os.path.join(str(log_dir), "spans.json"), "w") as f:
            json.dump(snapshot(), f)
