"""Operations and bytes of one attention call, from its shapes and the
keys its mask leaves (the rule of the port's kernel table, copied here).

Forward: 4 FLOPs per (query, key that takes part, d); Q read and O written
once, K and V read once over the keys that take part, lse written and the
mask read once. Backward: 10 FLOPs per (query, key, d); Q, dO read and dQ
written once, K and V read once over the keys that take part, dK and dV
written over all keys, lse and delta read, the mask read once. An entry
with no valid key averages all keys, so all of them take part.
"""

from __future__ import annotations

ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def keys_taking_part(valid_per_entry, lk: int) -> int:
    """Keys that take part, summed over the batch entries."""
    return sum(v if v > 0 else lk for v in valid_per_entry)


def forward_work(b, h, lq, lk, d, valid_per_entry, dtype, masked=True):
    """(flops, bytes) of a forward call; ``valid_per_entry`` lists each of
    the ``b`` entries' valid keys (``lk`` each when there is no mask)."""
    keys = keys_taking_part(valid_per_entry, lk)
    item = ITEMSIZE[dtype]
    flops = 4.0 * h * lq * d * keys
    nbytes = (item * (2 * b * h * lq * d + 2 * h * keys * d)
              + 4 * b * h * lq + (b * lk if masked else 0))
    return flops, nbytes


def backward_work(b, h, lq, lk, d, valid_per_entry, dtype, masked=True):
    keys = keys_taking_part(valid_per_entry, lk)
    item = ITEMSIZE[dtype]
    qo = b * h * lq * d * item
    return (10.0 * h * lq * d * keys,
            3 * qo + 2 * h * keys * d * item + 2 * b * h * lk * d * item
            + 2 * 4 * b * h * lq + (b * lk if masked else 0))
