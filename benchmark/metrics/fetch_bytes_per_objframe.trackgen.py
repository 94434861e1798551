"""Bytes of the program's trackgen.fetch_bytes counter (every blocking device-to-host copy of the track path) per object-frame of the traced units."""

from benchmark.core import program_spans


def read(record):
    return program_spans.counter_per(record, "trackgen.fetch_bytes",
                                     "object_frames")
