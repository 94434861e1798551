"""Milliseconds of the harness's encode span (init_state, ended by a synchronize) per frame."""

from benchmark.core import readers


def read(record):
    return readers.span_ms_per(record, "encode", "frames")
