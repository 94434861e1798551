"""Milliseconds of the harness's prompts span (prompts_gdino.prompt_video: JPEG decode, GroundingDINO, box prompts, the prompts JSON) per binned frame."""

from benchmark.core import readers


def read(record):
    return readers.span_ms_per(record, "prompts", "binned_frames")
