"""Milliseconds of the harness's data span (the loader's next batch and prepare_batch, ended by a synchronize) per step."""

from benchmark.core import readers


def read(record):
    return readers.span_ms_per(record, "data", "pairs")
