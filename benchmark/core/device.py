"""The card's identity and memory peak, and the result's compared numbers."""

from __future__ import annotations

import subprocess


def info(count: int = 1) -> dict:
    import torch
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """``name, power limit`` of card 0 as nvidia-smi reads them, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def check(name: str, value: float, limit: float) -> dict:
    """A number compared for ``correct``: it passes at or under its limit."""
    return {"name": name, "value": value, "limit": limit,
            "ok": value == value and value <= limit}


def free_cuda() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
