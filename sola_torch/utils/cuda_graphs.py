"""Capturing a CUDA graph in a process that holds other CUDA graphs.

The port captures graphs in two places, the selection training step
(``sola_torch/train/graphs.py``) and SAM2's propagation step
(``sola_torch/trackgen/sam2/track_step.py``), and one process may run
both. A graph that has become garbage inside a reference cycle is
destroyed when Python's collector next runs. If that happens inside
another graph's capture, the destruction is an operation CUDA forbids
while a stream captures, and the capture fails
(``cudaErrorStreamCaptureInvalidated``). ``capture`` holds the collector
off for the capture; the cycle is collected after it.
"""

from __future__ import annotations

import contextlib
import gc

import torch


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool, mode: str = "global"):
    """Capture into ``graph`` what the block launches on the current stream
    (``capture_begin(pool=pool, capture_error_mode=mode)``, then
    ``capture_end()``), with the garbage collector off inside and as it
    was after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(pool=pool, capture_error_mode=mode)
        try:
            yield graph
        finally:
            graph.capture_end()
    finally:
        if enabled:
            gc.enable()
