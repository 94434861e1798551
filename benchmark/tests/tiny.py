"""Tiny runs of the cells on the CPU: the same driver objects as a card
run, at the configurations' test sizes and small mixes."""

from __future__ import annotations

from benchmark.core import manifest, window
from benchmark.core.record import Record

TINY_MIX = {
    "trackgen_l.grid_dense": {"height": 48, "width": 72, "frames": [16, 20],
                              "n_videos": 3, "warmup_frames": 16},
    "select_mevis.train_b1": {"n_videos": 6, "tracks": [8, 12],
                              "frames": [24, 40], "expressions": [3, 5],
                              "mask_hw": [48, 72], "num_workers": 2},
    "trackgen_l.gt_packed": {"height": 48, "width": 72,
                             "group": [[12, 2, 1], [16, 1, 0]],
                             "n_groups": 2, "warmup_frames": 12},
}


def record(workload: str, seed: int) -> Record:
    cell = manifest.cell(workload)
    mix = dict(manifest.traffic(cell["traffic"]))
    mix.update(TINY_MIX[workload])
    return Record(workload, cell, manifest.config(cell["config"]), mix, seed)


def trackgen(seed: int, units: int = 1):
    """(record, cell, program outputs, reference outputs) of a tiny
    trackgen run of ``units`` videos."""
    from benchmark.drivers import trackgen_grid as tg
    rec = record("trackgen_l.grid_dense", seed)
    cell = tg.Cell(rec, size="tiny_test", device="cpu")
    cell.setup()
    window.run(rec, 0.0, cell.unit)
    while len(rec.units) < units:
        rec.units.append(cell.unit(len(rec.units)))
    vid = rec.units[0]["video"]
    got = cell.program_outputs(vid)
    ref = cell.reference_outputs(vid)
    return rec, cell, got, ref


def train(seed: int):
    """(record, cell, program outputs, reference outputs) of a tiny
    training run: its set-up steps and the window's compared steps."""
    from benchmark.drivers import train_select as ts
    rec = record("select_mevis.train_b1", seed)
    cell = ts.Cell(rec, size="tiny", device="cpu")
    cell.setup()
    window.run(rec, 0.0, cell.unit, min_units=ts.COMPARED_STEPS)
    got = cell.program_outputs()
    cell._cudnn.__exit__(None, None, None)
    ref = cell.reference_outputs()
    return rec, cell, got, ref


def gt_packed(seed: int):
    """(record, cell, program outputs, reference outputs) of a tiny packed
    GT run: one pack of two videos."""
    from benchmark.drivers import trackgen_gt_packed as gp
    rec = record("trackgen_l.gt_packed", seed)
    rec.cell = dict(rec.cell, params={"video_pack": 2, "obj_batch": 4})
    cell = gp.Cell(rec, size="tiny_test", device="cpu")
    cell.setup()
    window.run(rec, 0.0, cell.unit)
    vid = rec.units[0]["videos"][0]
    return rec, cell, cell.program_outputs(vid), cell.reference_outputs(vid)
