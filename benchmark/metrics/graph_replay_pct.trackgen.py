"""Share of the traced propagation steps that replayed the CUDA graph captured at an earlier step: the program's trackgen.graph_replays over trackgen.steps."""

from benchmark.core import program_spans


def read(record):
    return program_spans.counter_pct("trackgen.graph_replays",
                                     "trackgen.steps")
