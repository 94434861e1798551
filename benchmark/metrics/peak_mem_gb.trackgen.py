"""torch.cuda.max_memory_allocated over set-up and window, in GB."""

from benchmark.core import readers


def read(record):
    return readers.peak_mem_gb(record)
