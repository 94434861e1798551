"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), the
yardstick of every roofline and MFU share.

fp32 is held to 165 TFLOP/s: 495 TF32 / 3, the 3xTF32 rate at which an
implementation keeps fp32 accuracy with TF32 off, so no fp32-accurate
implementation reads over 100%. The rates assume the card's full 700 W
power limit; a run reports the card's own limit beside them.
"""

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 165e12}
PEAK_BYTES = 3.35e12


def least_seconds(flops_by_dtype: dict) -> float:
    """The least time the card needs for these operations, each part at its
    precision's peak."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of operations over peak FLOP/s and bytes over peak bytes/s."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
