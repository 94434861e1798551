"""Least time of the traced units' deformable sampling (bytes at 3.35 TB/s) over the deformable kernel's device time."""

from benchmark.core import readers


def read(record):
    return readers.roofline_pct(record, ["ms_deform_attn_fwd"],
                                least_key="deform_least_s")
