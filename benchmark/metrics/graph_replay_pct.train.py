"""Share of the traced training steps that replayed CUDA graphs captured at an earlier step: the program's train.graph_replays over train.steps."""

from benchmark.core import program_spans


def read(record):
    return program_spans.counter_pct("train.graph_replays", "train.steps")
