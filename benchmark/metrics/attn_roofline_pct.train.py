"""Least time of the traced steps' attention work, forward and backward, over the flash forward and backward kernels' device time."""

from benchmark.core import readers


def read(record):
    return readers.roofline_pct(record, ["flash_attn_fwd", "flash_attn_bwd"])
