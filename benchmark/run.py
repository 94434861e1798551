"""Runs one benchmark cell once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``benchmark/cells/<cell>.json``) names its configuration, traffic
mix and entry (``benchmark/drivers/<entry>.py``). The driver builds the
system under test from the seed, warms it up, runs the measured window and
checks what the window produced against the plain reference. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/metrics/<metric>.py``).
The last line of standard output is one JSON object; the numbers compared
for ``correct`` are the last lines of standard error and the result's last
key. Without a CUDA card, or with fewer cards than the cell asks for, it
exits 2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.core import env  # noqa: E402

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sola_tpu")


def process_start_time() -> float:
    """The process's start on the wall clock, from /proc (the import time
    of this file where /proc does not say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's, Optax's, Orbax's or the JAX package's, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    env.setup()     # before torch is imported
    args = parse_args(argv)
    t_start = process_start_time()
    from benchmark.core import manifest
    from benchmark.core.record import Record
    man = manifest.manifest()
    entry = manifest.workload_entry(man, args.workload)
    cell = manifest.cell(args.workload)
    chips = int(entry["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2

    record = Record(args.workload, cell, manifest.config(cell["config"]),
                    manifest.traffic(cell["traffic"]), args.seed)
    driver = importlib.import_module(f"benchmark.drivers.{cell['entry']}")
    out = driver.run(record, seconds=args.seconds, trace=bool(args.trace),
                     t_start=t_start)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in manifest.per_layer_for(man, args.workload):
            value = manifest.load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in manifest.end_to_end_for(man, args.workload):
            value = out["end_to_end"].get(m["name"])
            if value is None:
                print(f"benchmark: no value for {m['name']}; no result",
                      file=sys.stderr)
                return 4
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = out["device"]
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace and record.trace is not None:
        device["busy_s"] = record.trace.busy_s
        device["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.device_ops,
                               "idle_gaps": record.trace.idle_gaps}
    if record.trace is not None:
        out.setdefault("notes", []).append(
            f"trace: {record.trace.n_records} records {record.trace.kinds}, "
            f"{record.trace.kernel_launches()} device records kept")
    for line in out.get("notes", []):
        print(f"benchmark: {line}", file=sys.stderr)
    checks = {}
    for c in out["checks"]:
        checks[c["name"]] = {"value": c["value"], "limit": c["limit"]}
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
