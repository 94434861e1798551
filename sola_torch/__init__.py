"""SOLA on PyTorch and CUDA: the port of ``sola_tpu`` to an NVIDIA H100.

Mirrors ``sola_tpu``'s module paths; kernels written by hand for Hopper live
in ``sola_torch/csrc`` and are built at first use. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
