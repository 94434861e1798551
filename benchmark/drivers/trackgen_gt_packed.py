"""Entry ``trackgen_gt_packed``: GT-prompted track generation with videos
packed into shared propagation rounds, as ``tokens_gt --video_pack N``
runs a MeViS train split with ``--prefetch_videos 0``.

Set-up builds the port's SAM2 video predictor (``obj_batch`` slots) on
weights drawn from the seed, writes the mix's videos and GT masklets, and
runs one warm-up pack. A unit of the window is one pack of ``video_pack``
videos: each video's ``init_state`` (span ``encode``), then
``tokens_gt.run_videos_packed_gt`` over the pack (span ``track``), which
writes every seed's masklet and tokens. The window cycles through the mix's
packs. After the window one finished video, drawn from the seed, is tracked
again seed by seed by the plain reference, and every track the program
wrote for it is compared, as is the image encoder's fp32 output of one of
its frames, kept from the window's own encode.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from benchmark.core import device as device_lib
from benchmark.core import window
from benchmark.drivers import trackgen_grid
from benchmark.drivers.trackgen_grid import (FeatureTap, _program_predictor,
                                             cell_readings, compare,
                                             feature_frame, read_tracks)
from benchmark.gen import mevis_gt_videos

DATASET, DATA_TYPE = "mevis", "train"


class Cell(trackgen_grid.Cell):
    """``trackgen_grid.Cell``'s encode, weights, reference feature and
    clean-up; its own set-up, units and outputs."""

    def setup(self, warmup: bool = True) -> None:
        import torch

        from benchmark.models import sam2_hiera_l
        from sola_torch.ops import kernel_build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(self.root, ignore_errors=True)
        t = time.perf_counter()
        self.setup_s = {}

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            self.setup_s[name] = now - t
            t = now

        kernel_build.build_all()
        lap("kernels")
        self.traffic = mevis_gt_videos.generate(self.root, self.record.mix,
                                                self.record.seed)
        with open(os.path.join(self.traffic["data_dir"],
                               "meta_expressions.json")) as f:
            self.meta = json.load(f)
        with open(os.path.join(self.traffic["data_dir"],
                               "mask_dict.json")) as f:
            self.mask_dict = json.load(f)
        lap("traffic")
        sd = sam2_hiera_l.state_dict(self.record.config, self.record.seed,
                                     self.device, self.size)
        self.predictor = _program_predictor(sd, self.size,
                                            int(self.params["obj_batch"]))
        self.tap = FeatureTap(self.predictor, self.record.seed)
        del sd
        lap("weights")
        self.track_root = os.path.join(self.root, "out", "sam2_tracks")
        self.censuses = {}
        if warmup:
            self.pack(self.traffic["warmup"], spans=False)
            torch.cuda.synchronize()
            lap("warmup")

    def pack(self, videos: list, spans: bool = True) -> dict:
        import contextlib

        from sola_torch.trackgen import gt_utils, tokens_gt
        span = (self.record.span if spans
                else lambda name: contextlib.nullcontext())
        items = []
        with span("encode"):
            for v in videos:
                items.append({"video_id": v["video_id"],
                              "state": self.encode(v),
                              "n_frames": v["n_frames"],
                              "gt_masklets": gt_utils.get_masklets(
                                  v["video_id"], self.meta,
                                  self.mask_dict)})
        with span("track"):
            censuses = tokens_gt.run_videos_packed_gt(
                self.predictor, items, self.track_root, DATASET, DATA_TYPE,
                log=lambda s: None)
        self.censuses.update(censuses)
        return censuses

    def unit(self, i: int) -> dict:
        n = int(self.params["video_pack"])
        k = i % (len(self.traffic["videos"]) // n)
        vids = self.traffic["videos"][k * n:(k + 1) * n]
        censuses = self.pack(vids)
        tracks = sum(len(censuses[v["video_id"]]) for v in vids)
        return {"videos": [v["video_id"] for v in vids],
                "frames": sum(v["n_frames"] for v in vids),
                "objects": tracks,
                "object_frames": sum(len(censuses[v["video_id"]])
                                     * v["n_frames"] for v in vids),
                "video_frames": [
                    (v["n_frames"], [e["seed_frame"] for e in
                                     censuses[v["video_id"]].values()])
                    for v in vids]}

    def program_outputs(self, video_id: str) -> dict:
        ids = sorted(int(k) for k in self.censuses[video_id])
        frame, feature = self.tap.get(video_id)
        return {"tracks": read_tracks(self.track_root, video_id, ids,
                                      "gt_tracks", DATA_TYPE),
                "tracked": ids, "filtered": [],
                "feature_frame": frame, "feature": feature}

    def reference_outputs(self, video_id: str, lower: bool = False) -> dict:
        from benchmark.reference import trackgen_gt as ref
        v = self._video(video_id)
        out = ref.run_video(self._weights(), self.size, v["frames_dir"],
                            self.traffic["data_dir"], video_id,
                            int(self.params["obj_batch"]), lower=lower,
                            feature_frame=feature_frame(self.record.seed,
                                                        v["n_frames"]))
        return {"tracks": out["tracks"], "tracked": sorted(out["tracks"]),
                "filtered": [], "feature": out["feature"]}


def add_counts(record, size: str, obj_batch: int) -> None:
    """Each pack's operations: every frame encoded, and each seed tracked
    from its onset over its video's frames as one slot of an
    ``obj_batch``-slot step (the count charges a seed its slot's share;
    idle slots are not work)."""
    from benchmark.counts import sam2_hiera_l
    for u in record.units:
        flops = {"fp32": 0.0, "bf16": 0.0}
        for n_frames, seed_frames in u["video_frames"]:
            w = sam2_hiera_l.video_work(n_frames, seed_frames, size,
                                        obj_batch)
            enc = w["encode_flops"]
            flops["fp32"] += enc["fp32"]
            flops["bf16"] += enc["bf16"] + w["track_flops"]["bf16"] / obj_batch
        u["flops"] = flops


def sample_video(record) -> str:
    rng = np.random.default_rng([record.seed % (1 << 63), 7])
    u = record.units[int(rng.integers(len(record.units)))]
    return u["videos"][int(rng.integers(len(u["videos"])))]


def run(record, seconds: float, trace: bool, t_start: float) -> dict:
    cell = Cell(record)
    cell.setup()
    setup_s = time.time() - t_start
    window.run(record, seconds, cell.unit, trace=trace,
               trace_units=int(record.cell.get("trace_units", 1)))
    obj_frames = record.total("object_frames")
    fps = obj_frames / record.window_seconds()
    dev = device_lib.info(1)
    record.memory_peak_bytes = dev["memory_peak_bytes"]
    add_counts(record, cell.size, int(cell.params["obj_batch"]))

    vid = sample_video(record)
    got = cell.program_outputs(vid)
    cell.free_program()
    ref = cell.reference_outputs(vid)
    readings = compare(got, ref)
    limits = record.config["limits"]["trackgen_gt_packed"]
    checks = [device_lib.check(k, readings[k], float(limits[k]))
              for k in limits]
    cell.cleanup()
    notes = ["set-up s: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in cell.setup_s.items()),
             f"video {vid} compared: {len(ref['tracks'])} seeds, encoder "
             f"output of frame {got['feature_frame']}",
             f"window {record.window_seconds():.3f} s, {len(record.units)} "
             f"packs, {obj_frames} object-frames",
             f"card: {device_lib.power_limit()}"]
    return {"end_to_end": {"track_object_fps": fps, "setup_s": setup_s},
            "attempted": len(record.units), "failed": 0,
            "device": dev, "checks": checks, "notes": notes}


def readings(record, control: bool, tracks: bool = True) -> dict:
    """As ``trackgen_grid.readings``: the first pack's first video."""
    return cell_readings(Cell(record), control, tracks,
                         lambda unit: unit["videos"][0])
