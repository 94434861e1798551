"""Least time of the traced units' flash attention work over the flash forward kernels' device time."""

from benchmark.core import readers


def read(record):
    return readers.roofline_pct(record, ["flash_attn_fwd"])
