"""Milliseconds of the program's trackgen.grounding spans (the host's issue of the GroundingDINO forwards) per (binned frame, expression) pair of its trackgen.grounded_pairs counter."""

from benchmark.core import program_spans


def read(record):
    ms = program_spans.span_ms("trackgen.grounding")
    pairs = ((program_spans.snapshot() or {}).get("counters", {})
             .get("trackgen.grounded_pairs"))
    return ms / pairs if ms is not None and pairs else None
