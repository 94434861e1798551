"""The manifest keeps the contract's names, units and limits, and a new
configuration, mix, cell, metric or kernel list is found from its files
alone."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark.core import env, manifest

MAN = manifest.manifest()
NAMED = ([m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
         + [w["name"] for w in MAN["workloads"]]
         + [c["name"] for c in MAN["configs"]])


@pytest.mark.parametrize("name", NAMED + [w["traffic"] for w in
                                          MAN["workloads"]])
def test_names_use_allowed_characters(name):
    assert manifest.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert manifest.UNIT_RE.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MAN["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert os.path.exists(os.path.join(env.BENCH_DIR, "metrics",
                                           metric["name"] + ".py"))
    assert set(metric) <= allowed
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in MAN["workloads"]}


def test_no_duplicate_names():
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names))
    assert not ({m["name"] for m in MAN["end_to_end"]}
                & {m["name"] for m in MAN["per_layer"]})


@pytest.mark.parametrize("work", MAN["workloads"], ids=lambda w: w["name"])
def test_cells_resolve_and_report(work):
    cell = manifest.cell(work["name"])
    assert cell["config"] == work["config"]
    assert cell["traffic"] == work["traffic"]
    assert work["chips"] in (1, 4) and len(work["why"]) <= 200
    manifest.config(cell["config"])
    manifest.traffic(cell["traffic"])
    e2e = {m["name"] for m in manifest.end_to_end_for(MAN, work["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer_for(MAN, work["name"])


def test_contract_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert json.load(open(os.path.join(env.ROOT, c["file"])))
    n_cells = 24
    total = 2 + 14 * n_cells
    assert total * (MAN["run_seconds"] + 60) + n_cells * 180 + 1200 <= 43200


def test_a_new_cell_metric_config_mix_and_kernel_are_found(tmp_path):
    """Files and manifest entries alone: no code is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(env.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("_cache", "_tmp",
                                                  "__pycache__"))
    (bench / "configs" / "new_config.json").write_text(
        json.dumps({"name": "new_config", "limits": {}}))
    (bench / "traffic" / "new_mix.json").write_text(
        json.dumps({"generator": "videos", "n_videos": 1}))
    (bench / "cells" / "new_config.new_mix.json").write_text(json.dumps(
        {"config": "new_config", "traffic": "new_mix",
         "entry": "trackgen_grid", "params": {}, "why": "a test cell"}))
    (bench / "kernels" / "new_kernel.json").write_text(
        json.dumps({"patterns": ["new_kernel_name"]}))
    (bench / "metrics" / "units_seen.new.py").write_text(
        "def read(record):\n    return float(len(record.units))\n")
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "new_config.new_mix",
                             "config": "new_config", "traffic": "new_mix",
                             "chips": 1, "why": "a test cell"})
    man["end_to_end"][0].setdefault("workloads", []).append(
        "new_config.new_mix")
    man["per_layer"].append({"name": "units_seen.new", "unit": "units",
                             "better": "higher", "source": "host_clock",
                             "layer": "device",
                             "moves": man["end_to_end"][0]["name"],
                             "workloads": ["new_config.new_mix"]})
    cell = manifest.cell("new_config.new_mix", str(bench))
    assert manifest.config(cell["config"], str(bench))["name"] == "new_config"
    assert manifest.traffic(cell["traffic"], str(bench))["n_videos"] == 1
    assert manifest.kernels("new_kernel", str(bench))["patterns"] == [
        "new_kernel_name"]
    layer = [m["name"] for m in manifest.per_layer_for(man,
                                                       "new_config.new_mix")]
    assert layer == ["units_seen.new"]
    assert [m["name"] for m in manifest.end_to_end_for(
        man, "new_config.new_mix")] == [man["end_to_end"][0]["name"],
                                        "setup_s"]

    class Rec:
        units = [{}, {}, {}]
    assert manifest.load_reader("units_seen.new", str(bench))(Rec()) == 3.0
