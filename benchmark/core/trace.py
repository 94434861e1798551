"""The profiler's trace of the first units of a traced run, reduced to what
the per-layer metrics and the result line need: device busy time (the union
of kernel, copy and set intervals), device time by kernel name, and the idle
gaps named by what the host was doing (the innermost annotation and the
innermost host op at the gap's start).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_NAME = "benchmark.traced_window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host-clock length of the traced portion
    busy_s: float                   # union of device intervals in it
    kernels: dict                   # kernel name -> (launches, device s)
    device_ops: list                # [[name, s]] most time first, <= 10
    idle_gaps: list                 # [[host activity, s]] longest first
    n_records: int
    kinds: dict                     # records by kind, all of the trace

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(p in name for p in patterns))

    def kernel_launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _kind(e, span_names) -> str:
    """kernel / gpu_memcpy / gpu_memset on the device; user_annotation for
    an annotation (a span's, on the host or mirrored on the device);
    cpu_op otherwise. Torch versions differ in what a kineto event tells,
    so a span's name counts as an annotation wherever it appears, and
    ``_drop_enclosing`` removes the other annotations mirrored on the
    device."""
    import torch
    name = e.name()
    note = getattr(e, "is_user_annotation", None)
    if name in span_names or (note is not None and note()):
        return "user_annotation"
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind())
        return "user_annotation" if "annotation" in kind else kind
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "kernel"
    return "cpu_op"


def _drop_enclosing(device):
    """Device records that enclose two or more others whole are
    annotations mirrored on the device, not work: drop them."""
    device = sorted(device, key=lambda x: (x[0], -x[1]))
    out = []
    for i, (s, e, n) in enumerate(device):
        inside = 0
        for s2, e2, _ in device[i + 1:i + 64]:
            if s2 >= e:
                break
            if e2 <= e:
                inside += 1
                if inside >= 2:
                    break
        if inside < 2:
            out.append((s, e, n))
    return out


def _events(prof, span_names):
    """(kind, name, start_ns, end_ns) of every record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = int(e.start_ns()), int(e.duration_ns())
        else:
            start, dur = int(e.start_us()) * 1000, int(e.duration_us()) * 1000
        out.append((_kind(e, span_names), e.name(), start, start + dur))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost_at(spans, starts, t):
    """The shortest span of ``spans`` (sorted by start) that holds ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in spans[max(0, i - 4096):i]:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(prof, window_s: float, span_names=()) -> TraceSummary:
    prof.stop()
    events = _events(prof, set(span_names) | {WINDOW_NAME})
    win = [(s, e) for k, n, s, e in events if n == WINDOW_NAME]
    if win:
        w0, w1 = win[0]
        window_s = (w1 - w0) / 1e9
    else:
        w0 = min(s for _, _, s, _ in events)
        w1 = max(e for _, _, _, e in events)
    device = _drop_enclosing([(max(s, w0), min(e, w1), n)
                              for k, n, s, e in events
                              if k in DEVICE_KINDS and e > w0 and s < w1])
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for s, e, n in device:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) / 1e9
    merged = _merge([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged) / 1e9

    notes = sorted((s, e, n) for k, n, s, e in events
                   if k == "user_annotation" and n != WINDOW_NAME)
    ops = sorted((s, e, n) for k, n, s, e in events if k == "cpu_op")
    note_starts = [s for s, _, _ in notes]
    op_starts = [s for s, _, _ in ops]
    gaps: dict = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        note = _innermost_at(notes, note_starts, g0) or "no span"
        op = _innermost_at(ops, op_starts, g0) or "no host op"
        gaps[f"{note} / {op}"] += (g1 - g0) / 1e9
    top_ops = sorted(((n, v[1]) for n, v in kernels.items()),
                     key=lambda x: -x[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:10]
    return TraceSummary(
        window_s=window_s, busy_s=busy,
        kernels={n: (v[0], v[1]) for n, v in kernels.items()},
        device_ops=[[n, s] for n, s in top_ops],
        idle_gaps=[[n, s] for n, s in top_gaps], n_records=len(events),
        kinds=dict(Counter(k for k, _, _, _ in events)))
