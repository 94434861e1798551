"""95th percentile of the step time (fetch, prepare_batch, train_step, ended
by a synchronize) over every step the profiler did not cover."""

from benchmark.core import readers


def read(record):
    return readers.unit_ms_percentile(record, 95)
