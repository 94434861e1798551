"""Milliseconds of the program's trackgen.fetch spans (blocking device-to-host copies of masks, tokens and IoUs) per object-frame of the traced units."""

from benchmark.core import program_spans


def read(record):
    return program_spans.span_ms_per(record, "trackgen.fetch",
                                     "object_frames", self_time=True)
