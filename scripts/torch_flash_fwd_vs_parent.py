"""Time one of the port's kernels in this checkout beside another
checkout's (the parent commit's, unpacked with ``git archive``), in turns
other, this, this, other, on the same seeded inputs. Needs one CUDA card.

    python3 scripts/torch_flash_fwd_vs_parent.py OTHER_DIR [--out FILE]
    python3 scripts/torch_flash_fwd_vs_parent.py OTHER_DIR --kernel deform
    python3 scripts/torch_flash_fwd_vs_parent.py OTHER_DIR --kernel flash_bwd

``--kernel flash_fwd`` (the default) times ``flash_attention._launch`` at
every shape of chip_smoke.py's phase 2 and phase 8. ``--kernel deform``
times ``deformable_interp._launch`` at every shape of phase 5, and checks
that the two checkouts' outputs are ``torch.equal`` at each (the script
exits nonzero if one is not). ``--kernel flash_bwd`` times
``flash_attention._launch_bwd`` (delta, then the backward kernels) at
every phase-8 shape with and without dropout, and holds each checkout's
dQ, dK and dV within phase 8's limits of the plain version (a turn that
breaks them fails, and the script exits nonzero).

Each turn is a subprocess that makes the same seeded inputs, imports
``sola_torch`` from one checkout, builds its library and times the kernel's
launch with CUDA events (chip_smoke.cuda_ms). Prints a table (ms of each
checkout, the mean of its two turns) after the card's name and power
limit, and writes every turn to --out (default
chiprun_out/<kernel>_vs_parent.json). ``deform`` and ``flash_bwd`` also
time the kernels alone (``device_ms``, torch.profiler: per call, the sum of
the kernels whose name holds ``ms_deform`` or ``flash_bwd_``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> None:
    """Times one checkout's flash forward; prints {shape: ms} as its last
    line."""
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


def deform_worker(root: str, save: str) -> None:
    """Times one checkout's deformable sampling kernel, by CUDA events over
    back-to-back calls (ms) and by the profiler's kernel time alone
    (device_ms); writes each shape's output to SAVE/<shape>.pt when SAVE is
    given; prints {shape: {"ms": .., "device_ms": ..}} as its last line."""
    import torch
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    runs = []  # (name, levels, value, loc, weights)
    for (name, _, dtype, b, lq, levels, heads, hd, points, encoder,
         outside) in cs.deform_cases():
        runs.append((name, levels, *cs.deform_inputs(
            gen, b, lq, levels, heads, hd, points, dtype, encoder, outside)))
    sys.path.insert(0, root)
    from sola_torch.ops import deformable_interp as di
    assert os.path.dirname(di.__file__).startswith(os.path.abspath(root))
    times = {}
    for name, levels, value, loc, wgt in runs:
        if save:
            torch.save(di._launch(value, levels, loc, wgt).cpu(),
                       os.path.join(save, f"{name}.pt"))

        def fn():
            return di._launch(value, levels, loc, wgt)
        times[name] = {"ms": cs.cuda_ms(fn, 20), "device_ms": cs.device_ms(
            fn, 20, "ms_deform") or float("nan")}
    print(json.dumps(times))


def bwd_worker(root: str) -> None:
    """Times one checkout's backward (``_launch_bwd``) by CUDA events over
    calls (ms) and its kernels alone (device_ms); raises if its gradients
    break phase 8's limits; prints {shape: {"ms": .., "device_ms": ..,
    "err_over_tol": ..}} as its last line (the largest of the max and RMS
    errors of dq, dk and dv over their limits)."""
    import torch
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    runs = []  # (name, q, k, v, do, mask)
    for name, _, dtype, b, h, lq, lk, d, mask in cs.backward_cases(gen):
        runs.append((name, *(torch.randn(b, h, n, d, generator=gen).cuda()
                             .to(dtype) for n in (lq, lk, lk, lq)), mask))
    sys.path.insert(0, root)
    from sola_torch.ops import flash_attention as fa
    assert os.path.dirname(fa.__file__).startswith(os.path.abspath(root))
    times, broken = {}, []
    for name, q, k, v, do, mask in runs:
        for rate in (cs.SEL_RATE, 0.0):
            seed = cs.SEL_SEED if rate else None
            out, lse = fa._launch(q, k, v, mask, rate, seed)
            refs = fa.attention_bwd_reference(q, k, v, mask, out, lse, do,
                                              rate, seed)
            grads = fa._launch_bwd(q, k, v, mask, out, lse, do, rate, seed)
            errs = [cs.out_errors(g, r.float(), q.dtype)
                    for g, r in zip(grads, refs)]
            if cs.grad_limits_fail(grads, refs, q.dtype):
                broken.append((name, rate, errs))

            def fn():
                return fa._launch_bwd(q, k, v, mask, out, lse, do, rate,
                                      seed)
            key = f"{name}_dropout" if rate else name
            times[key] = {
                "ms": cs.cuda_ms(fn, 20),
                "device_ms": cs.device_ms(fn, 20, "flash_bwd_")
                or float("nan"),
                "err_over_tol": max(max(e / t, r / rt)
                                    for e, t, r, rt in errs)}
    if broken:
        raise AssertionError(f"gradients break phase 8's limits: {broken}")
    print(json.dumps(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout (e.g. the parent's)")
    ap.add_argument("--kernel", choices=("flash_fwd", "deform", "flash_bwd"),
                    default="flash_fwd")
    ap.add_argument("--out", help="JSON of every turn (default "
                    "chiprun_out/<kernel>_vs_parent.json)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        if args.kernel == "deform":
            deform_worker(args.worker, args.save)
        elif args.kernel == "flash_bwd":
            bwd_worker(args.worker)
        else:
            worker(args.worker)
        return
    out = args.out or os.path.join(HERE, "chiprun_out",
                                   f"{args.kernel}_vs_parent.json")
    other = os.path.abspath(args.other)
    saved = tempfile.mkdtemp(prefix="vs_parent_")
    turns = []
    try:
        for tree, root in (("other", other), ("this", HERE), ("this", HERE),
                           ("other", other)):
            save = ""
            if args.kernel == "deform" and not any(t["tree"] == tree
                                                   for t in turns):
                save = os.path.join(saved, tree)  # each tree's first turn
                os.makedirs(save)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.other,
                 "--kernel", args.kernel, "--worker", root, "--save", save],
                cwd=root, capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{tree} turn failed ({proc.returncode}):\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            turns.append({"tree": tree, "root": root, "ms": {
                k: v if isinstance(v, dict) else {"ms": v}
                for k, v in times.items()}})
        print(_chip_smoke().smi_line())
        rows = []
        for shape, metrics in turns[0]["ms"].items():
            row, line = {"shape": shape}, f"{shape:>28}"
            for key in metrics:  # ms; device_ms, err_over_tol if measured
                turn_ms = [t["ms"][shape][key] for t in turns]
                if key == "err_over_tol":
                    row["err_over_tol"] = turn_ms
                    continue
                mean = {tree: sum(v for t, v in zip(turns, turn_ms)
                                  if t["tree"] == tree) / 2
                        for tree in ("other", "this")}
                row.update({f"other_{key}": mean["other"],
                            f"this_{key}": mean["this"],
                            f"turns_{key}": turn_ms})
                line += (f"  {key}: other {mean['other']:9.4f} this "
                         f"{mean['this']:9.4f} ratio "
                         f"{mean['other'] / mean['this']:6.2f}")
            if args.kernel == "deform":
                import torch
                a, b = (torch.load(os.path.join(saved, tree, f"{shape}.pt"))
                        for tree in ("other", "this"))
                row["equal"] = bool(torch.equal(a, b))
                line += f"  equal {row['equal']}"
            rows.append(row)
            print(line)
    finally:
        shutil.rmtree(saved, ignore_errors=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"kernel": args.kernel,
                   "order": [t["tree"] for t in turns], "rows": rows,
                   "roots": {"other": other, "this": HERE}}, f, indent=1)
    unequal = [r["shape"] for r in rows if r.get("equal") is False]
    if unequal:
        sys.exit(f"outputs differ between the checkouts at {unequal}")


if __name__ == "__main__":
    main()
