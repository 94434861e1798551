"""Kernels launched per step in the traced steps (profiler records; the profiler can drop a few)."""

from benchmark.core import readers


def read(record):
    return readers.launches_per(record, "pairs")
