"""The selection training step replayed from CUDA graphs.

On a CUDA device and outside a mesh, ``train_step`` runs a step from three
CUDA graphs instead of launching its ~1400 kernels from Python one by one:
the forward with ``total_loss``, the backward, and the clip with AdamW.
The first two are captured once per padded batch shape (the loader pads
tracks and frames to buckets and the text encoder pads words to its
length), the third once for every shape. A step copies the batch into its
shape's static inputs and the step's host draws (``DropoutRng.draw``) into
one device buffer in one copy, re-seeds the mask generator that the
forward graphs were captured with, and replays the three graphs, each in
the span the eager step gives its phase.

A replayed step equals the eager step on the same device bit for bit:

* the host generator gives the same draws in the same order: the mask
  generator's seed, then one seed an attention call;
* the flash kernels read their seeds from the buffer, so a replay reads
  the step's own; the mask generator is registered with every forward
  graph, so its philox stream starts at the step's seed, as a new
  generator seeded alike would;
* each parameter's gradient is one buffer (``p.grad``), which a backward
  graph fills and the optimizer graph reads;
* AdamW is capturable on CUDA (``state.Optimizer``), eager or captured, so
  both run the same kernels, and ``set_learning_rate`` writes the device
  learning rate the graph reads.

A shape's first step warms the shape's forward and backward up eagerly
on the capture stream (throwaway generators, gradients through
``torch.autograd.grad``, so no weight, moment or gradient buffer
changes), captures the two graphs, each in an extra span of its phase,
and then replays like any later step. The optimizer graph is captured at the first step
whose AdamW already holds state: a fresh optimizer's first update is
AdamW's own eager one, which creates that state.

All graphs share one memory pool. A step replays one shape's forward, its
backward and then the optimizer, and reads each graph's outputs before the
next graph replays (the loss parts right after the forward, the norm right
after the optimizer), so no graph's temporaries overwrite what another
still needs.
"""

from __future__ import annotations

from typing import Callable

import torch

from sola_torch.models.layers import DropoutRng
from sola_torch.utils import profiling
from sola_torch.utils.cuda_graphs import capture

PARTS = ("total", "bce", "alignment")


def usable(batch: dict, mesh) -> bool:
    """Whether ``train_step`` runs this batch from graphs: on a CUDA device
    without a mesh (whose collectives stay eager)."""
    return mesh is None and batch["object_tokens"].is_cuda


def shape_key(batch: dict) -> tuple:
    """What a captured step is specific to: each input's shape and dtype,
    and the math flags the capture saw."""
    return (tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(batch.items())),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)


class _Shape:
    """One padded shape's static inputs, forward graph with its stacked
    loss parts, and backward graph."""

    def __init__(self, inputs, forward, parts, backward):
        self.inputs = inputs
        self.forward = forward
        self.parts = parts
        self.backward = backward


class StepGraphs:
    """The graphs of one model and its optimizer (``Optimizer.graphs``)."""

    def __init__(self, model, optimizer):
        self.model = model
        self.optimizer = optimizer
        self.params = optimizer.params
        self.device = self.params[0].device
        self.grads = [torch.zeros_like(p) for p in self.params]
        for p, g in zip(self.params, self.grads):
            p.grad = g
        self.seeds = torch.zeros(1 + model.kernel_seed_calls(),
                                 dtype=torch.int64, device=self.device)
        self.mask_gen = torch.Generator(device=self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.shapes: dict = {}
        self.update = None   # the optimizer graph
        self.norm = None     # its static output

    def _capture_forward(self, batch: dict, losses: Callable) -> tuple:
        """Warm the shape's forward and backward up and capture the
        forward: (its graphs, the captured loss for
        ``_capture_backward``)."""
        inputs = {k: v.clone() for k, v in batch.items()}
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # every library, cuBLAS handle and cuDNN plan of the shape made
            # before the capture, on the capture stream
            warm_loss, _ = losses(inputs, DropoutRng.fresh(
                torch.Generator().manual_seed(0), self.device,
                self.seeds.numel() - 1))
            torch.autograd.grad(warm_loss, self.params)
            del warm_loss
            forward = torch.cuda.CUDAGraph()
            forward.register_generator_state(self.mask_gen)
            with capture(forward, self.pool):
                loss, parts = losses(inputs, DropoutRng(self.seeds,
                                                        self.mask_gen))
                parts = torch.stack([parts[k].detach() for k in PARTS])
        current.wait_stream(self.stream)
        return _Shape(inputs, forward, parts, None), loss

    def _capture_backward(self, shape: _Shape, loss) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            backward = torch.cuda.CUDAGraph()
            with capture(backward, self.pool):
                torch._foreach_copy_(
                    self.grads, list(torch.autograd.grad(loss, self.params)))
        current.wait_stream(self.stream)
        shape.backward = backward

    def _capture_update(self) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            update = torch.cuda.CUDAGraph()
            with capture(update, self.pool):
                norm = self.optimizer.step()
        current.wait_stream(self.stream)
        self.update, self.norm = update, norm

    def step(self, batch: dict, generator: torch.Generator,
             losses: Callable) -> dict:
        """One training step of ``batch``; ``losses(inputs, rng)`` is the
        forward and ``total_loss``: (loss, parts). Returns fresh tensors:
        the loss parts and the gradient norm."""
        draws = DropoutRng.draw(generator, self.seeds.numel() - 1)
        key = shape_key(batch)
        shape = self.shapes.get(key)
        replayed = shape is not None
        if shape is None:
            # both captured before the static inputs change: the captured
            # autograd graph saved some of them
            with profiling.span("train.forward"):
                shape, loss = self._capture_forward(batch, losses)
            with profiling.span("train.backward"):
                self._capture_backward(shape, loss)
            del loss
            self.shapes[key] = shape
            profiling.count("train.graph_captures")
        with profiling.span("train.forward"):
            torch._foreach_copy_(list(shape.inputs.values()),
                                 [batch[k] for k in shape.inputs])
            self.seeds.copy_(draws, non_blocking=True)
            self.mask_gen.manual_seed(int(draws[0]))
            shape.forward.replay()
            parts = shape.parts.clone()
        with profiling.span("train.backward"):
            shape.backward.replay()
        with profiling.span("train.optimizer"):
            if self.update is None and all(
                    self.optimizer.adamw.state.get(p) for p in self.params):
                self._capture_update()
                replayed = False
            if self.update is None:
                norm = self.optimizer.step()
            else:
                self.update.replay()
                norm = self.norm.clone()
        if replayed:
            profiling.count("train.graph_replays")
        return {**dict(zip(PARTS, parts.unbind())), "total_grad_norm": norm}
