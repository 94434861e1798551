"""On the card: each cell runs and reads correct, and each cell's control
(the reference in the precision below the configuration's, put in the
program's place) fails at least one of the cell's numbers.

    python -m pytest benchmark/tests -m card   (on a machine with a card)
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import pytest

from benchmark.core import device as device_lib
from benchmark.core import env, manifest
from benchmark.core.record import Record

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]

@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(cuda_card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "5", "--trace", "0"],
        cwd=env.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(cuda_card, workload):
    cell = manifest.cell(workload)
    driver = importlib.import_module(f"benchmark.drivers.{cell['entry']}")
    config = manifest.config(cell["config"])
    rec = Record(workload, cell, config, manifest.traffic(cell["traffic"]),
                 2 ** 31 + 102)
    out = driver.readings(rec, control=True)
    limits = config["limits"][cell["entry"]]
    checks = [device_lib.check(k, out["control"][k], float(v))
              for k, v in limits.items()]
    assert not all(c["ok"] for c in checks), out
