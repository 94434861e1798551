"""Milliseconds of the program's trackgen.emit spans (each track's RLE encode and file writes) per object-frame of the traced units."""

from benchmark.core import program_spans


def read(record):
    return program_spans.span_ms_per(record, "trackgen.emit",
                                     "object_frames", self_time=True)
