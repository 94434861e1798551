"""Milliseconds of the program's trackgen.box_prompt spans (SAM2's box -> mask call) per box of its trackgen.boxes counter."""

from benchmark.core import program_spans


def read(record):
    ms = program_spans.span_ms("trackgen.box_prompt")
    boxes = ((program_spans.snapshot() or {}).get("counters", {})
             .get("trackgen.boxes"))
    return ms / boxes if ms is not None and boxes else None
