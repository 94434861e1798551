"""Finds everything a run needs by name: the manifest (``BENCHMARK.json``),
a cell (``cells/<cell>.json``), its configuration (``configs/<config>.json``),
its traffic mix (``traffic/<mix>.json``), the per-layer metric readers
(``metrics/<metric>.py``) and the kernel lists (``kernels/<name>.json``).
A new cell, configuration, mix, metric or kernel list is a new file plus an
entry in the manifest; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

from benchmark.core.env import BENCH_DIR, ROOT

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench_dir: str = BENCH_DIR) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    return _load(os.path.join(bench_dir, "cells", f"{name}.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load(os.path.join(bench_dir, "traffic", f"{name}.json"))


def kernels(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load(os.path.join(bench_dir, "kernels", f"{name}.json"))


def workload_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"workload {name!r} is not in BENCHMARK.json")


def end_to_end_for(man: dict, workload: str) -> list:
    """The end-to-end metrics this cell reports: those without a
    ``workloads`` key and those that list it."""
    return [m for m in man["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_for(man: dict, workload: str) -> list:
    """The per-layer metrics read in this cell's traced run: those that list
    it, and those without a list whose ``moves`` metric the cell reports."""
    reported = {m["name"] for m in end_to_end_for(man, workload)}
    out = []
    for m in man["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read(record)`` function of ``metrics/<metric>.py``; a metric
    name may hold dots, so the file is loaded by its path."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
