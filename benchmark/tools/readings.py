"""Readings for a cell's limits: the program against the plain reference
on many seeds, and the control (the reference in the precision below the
configuration's) against the reference on some of them, all in one
process at the cell's own size.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control_seeds 1,2 [--encoder_only] [--out readings.jsonl]

``--encoder_only`` (the trackgen cells) reads ``feature_gap`` alone: one
video's encode, no tracking.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import env  # noqa: E402


def main() -> None:
    env.setup()     # before torch is imported
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--encoder_only", action="store_true")
    args = p.parse_args()
    from benchmark.core import device as device_lib
    from benchmark.core import manifest
    from benchmark.core.record import Record
    cell = manifest.cell(args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{cell['entry']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    print(f"card: {device_lib.power_limit()}", flush=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        record = Record(args.workload, cell, manifest.config(cell["config"]),
                        manifest.traffic(cell["traffic"]), seed)
        t0 = time.time()
        kw = {"tracks": False} if args.encoder_only else {}
        out = driver.readings(record, seed in controls, **kw)
        out.update(seed=seed, workload=args.workload,
                   seconds=time.time() - t0)
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        device_lib.free_cuda()


if __name__ == "__main__":
    main()
