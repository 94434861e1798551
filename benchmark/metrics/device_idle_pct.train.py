"""Share of the traced window in which no kernel, copy or set ran on the card."""

from benchmark.core import readers


def read(record):
    return readers.device_idle_pct(record)
