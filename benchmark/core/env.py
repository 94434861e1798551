"""Process environment of a benchmark run, set before torch is imported.

Every build and kernel cache lives at a fixed path inside the checkout, so
only a cell's first run in a checkout builds; libraries that could pull in
JAX or Flax are told not to.
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")


def setup() -> None:
    caches = {
        "TRITON_CACHE_DIR": "triton",
        "TORCH_EXTENSIONS_DIR": "torch_extensions",
        "CUDA_CACHE_PATH": "cuda_jit",
    }
    for var, sub in caches.items():
        path = os.path.join(CACHE_DIR, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    for var in ("USE_FLAX", "USE_JAX", "USE_TF", "USE_TORCH_XLA"):
        os.environ[var] = "0"
    os.environ["USE_TORCH"] = "1"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")


def scratch_dir(name: str) -> str:
    """A directory for the run's generated inputs and outputs, under the
    run's TMPDIR, named by the caller (a fixed name per cell and seed)."""
    base = os.environ.get("TMPDIR") or os.path.join(BENCH_DIR, "_tmp")
    path = os.path.join(base, "sola_benchmark", name)
    os.makedirs(path, exist_ok=True)
    return path
