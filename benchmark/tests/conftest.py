"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

The CPU tests drive the harness at tiny sizes with the card's calls
replaced (``cpu_harness``). Tests marked ``card`` need a CUDA card and
skip inside the ``cuda_card`` fixture when there is none, so every worker
collects the same tests.
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 through the chip "
                    "tool)")
    return torch.device("cuda")


@pytest.fixture
def cpu_harness(monkeypatch, tmp_path):
    """The harness on the CPU: no synchronize, no memory counter, no nvcc,
    the run's scratch under ``tmp_path``."""
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu")
    from sola_torch.ops import kernel_build
    monkeypatch.setattr(kernel_build, "build_all", lambda: None)
    return tmp_path
