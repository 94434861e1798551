"""Milliseconds of the program's trackgen.decode span (the JPEG decode inside init_state) per frame of the traced units."""

from benchmark.core import program_spans


def read(record):
    return program_spans.span_ms_per(record, "trackgen.decode", "frames")
