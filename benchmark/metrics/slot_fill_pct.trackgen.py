"""Share of the propagation steps' object slots that tracked an object: the program's trackgen.slots_active over trackgen.slots."""

from benchmark.core import program_spans


def read(record):
    return program_spans.counter_pct("trackgen.slots_active",
                                     "trackgen.slots")
