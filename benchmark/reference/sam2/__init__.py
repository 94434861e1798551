"""Frozen plain copy of the port's SAM2 modules, the trackgen cells' reference.

Each file here is the port's ``trackgen/sam2`` module of the commit that
defined the benchmark, with its imports pointed inside this package and the
flash-attention kernel replaced by ``benchmark.reference.attention``'s plain
attention (fp32 scores and softmax, as the kernel's own plain version). A
later change to the port does not reach this copy, so the cells hold the port
to the model as it computed when the benchmark was set.
"""
