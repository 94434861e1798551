"""Milliseconds of the harness's track span (run_video on encoded states) per object-frame."""

from benchmark.core import readers


def read(record):
    return readers.span_ms_per(record, "track", "object_frames")
