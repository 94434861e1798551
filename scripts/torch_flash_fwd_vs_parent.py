"""Time the port's flash-attention forward of this checkout beside another
checkout's (the parent commit's, unpacked with ``git archive``), in turns
other, this, this, other, at every shape of chip_smoke.py's phase 2 and
phase 8. Needs one CUDA card.

    python3 scripts/torch_flash_fwd_vs_parent.py OTHER_DIR [--out FILE]

Each turn is a subprocess that makes the same seeded inputs, imports
``sola_torch`` from one checkout, builds its forward library and times
``flash_attention._launch`` with CUDA events (chip_smoke.cuda_ms). Prints a
table (ms of each checkout, the mean of its two turns) after the card's
name and power limit, and writes every turn to --out (default
chiprun_out/flash_fwd_vs_parent.json).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> None:
    """Times one checkout's forward; prints {shape: ms} as its last line."""
    import torch
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    runs = []  # (name, q, k, v, mask, rate, seed)
    for name, _, dtype, b, h, lq, lk, d, mask in cs.attention_cases(gen):
        q, k, v = (torch.randn(b, h, n, d, generator=gen).cuda().to(dtype)
                   for n in (lq, lk, lk))
        runs.append((name, q, k, v, mask, 0.0, None))
    for name, _, dtype, b, lq, lk, mask in cs.selection_attention_cases(gen):
        h, d = cs.SEL_HEADS, cs.SEL_D
        q, k, v = (torch.randn(b, h, n, d, generator=gen).cuda().to(dtype)
                   for n in (lq, lk, lk))
        runs.append((f"{name}_dropout", q, k, v, mask, cs.SEL_RATE,
                     cs.SEL_SEED))
        runs.append((name, q, k, v, mask, 0.0, None))
    sys.path.insert(0, root)
    from sola_torch.ops import flash_attention as fa
    assert os.path.dirname(fa.__file__).startswith(os.path.abspath(root))
    times = {}
    for name, q, k, v, mask, rate, seed in runs:
        big = q.shape[2] * k.shape[2] >= 1 << 24
        times[name] = cs.cuda_ms(
            lambda: fa._launch(q, k, v, mask, rate, seed), 5 if big else 20)
    print(json.dumps(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout (e.g. the parent's)")
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "flash_fwd_vs_parent.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    other = os.path.abspath(args.other)
    turns = []
    for tree, root in (("other", other), ("this", HERE), ("this", HERE),
                       ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.other,
             "--worker", root], cwd=root, capture_output=True, text=True,
            check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} turn failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        turns.append({"tree": tree, "root": root,
                      "ms": json.loads(proc.stdout.strip().splitlines()[-1])})
    print(_chip_smoke().smi_line())
    rows = []
    for shape in turns[0]["ms"]:
        mean = {tree: sum(t["ms"][shape] for t in turns if t["tree"] == tree)
                / 2 for tree in ("other", "this")}
        rows.append({"shape": shape, "other_ms": mean["other"],
                     "this_ms": mean["this"],
                     "turns_ms": [t["ms"][shape] for t in turns]})
        print(f"{shape:>28}  other {mean['other']:9.4f} ms  this "
              f"{mean['this']:9.4f} ms  ratio "
              f"{mean['other'] / mean['this']:7.2f}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"order": [t["tree"] for t in turns], "rows": rows,
                   "roots": {"other": other, "this": HERE}}, f, indent=1)


if __name__ == "__main__":
    main()
