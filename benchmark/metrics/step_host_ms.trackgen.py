"""Mean host milliseconds of one trackgen.step span: the time the host takes to launch one propagation step of every slot."""

from benchmark.core import program_spans


def read(record):
    return program_spans.span_mean_ms("trackgen.step")
