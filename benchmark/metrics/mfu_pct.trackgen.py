"""Track generation's model FLOPs at each part's stated precision peak over the window's time."""

from benchmark.core import readers


def read(record):
    return readers.mfu_pct(record)
