"""Training's model FLOPs (forward and backward) at the fp32 peak over the window's time."""

from benchmark.core import readers


def read(record):
    return readers.mfu_pct(record)
