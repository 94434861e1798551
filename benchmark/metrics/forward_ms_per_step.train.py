"""Host milliseconds of the program's train.forward span per traced step."""

from benchmark.core import program_spans


def read(record):
    return program_spans.span_ms_per_unit(record, "train.forward")
