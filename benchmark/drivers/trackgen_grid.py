"""Entry ``trackgen_grid``: grid-prompt track generation, one video after
another, as ``tokens_grid`` runs a dataset with ``--prefetch_videos 0``.

Set-up builds the port's SAM2 video predictor on weights drawn from the
seed, writes the mix's videos and prompts JSONs, and runs one warm-up video
through the same calls. A unit of the window is one video: the predictor's
``init_state`` on its JPEG directory (span ``encode``), then
``tokens_grid.run_video`` on that state (span ``track``), which writes the
tracks' masklets and tokens. The window cycles through the mix's videos.
After the window one finished video, drawn from the seed, is tracked again
by the plain reference, and every track the program wrote for it is
compared with the reference's, as is the image encoder's fp32 output of one
of its frames, kept from the window's own encode.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time

import numpy as np

from benchmark.core import device as device_lib
from benchmark.core import env, window
from benchmark.gen import rle
from benchmark.gen import videos as videos_gen

DATASET, DATA_TYPE = "mevis", "valid_u"


def _program_predictor(state_dict: dict, size: str, obj_batch: int):
    import torch

    from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
    from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
    cfg = SAM2Config.large() if size == "large" else SAM2Config.tiny_test()
    with torch.device("meta"):
        model = SAM2Model(cfg)
    model.load_state_dict(state_dict, assign=True)
    return SAM2VideoPredictor(model.eval(), obj_batch=obj_batch)


def read_tracks(track_root: str, video_id: str, ids,
                out_dir: str = "grid_tracks", data_type: str = DATA_TYPE
                ) -> dict:
    """{track id: (masklet, tokens)} of the tracks the program wrote."""
    base = os.path.join(track_root, out_dir, DATASET, data_type)
    out = {}
    for i in ids:
        with open(os.path.join(base, "sam2_masklets", video_id,
                               f"{i:05d}.json")) as f:
            frames = json.load(f)["rle"]
        masklet = np.stack([rle.decode(r) for r in frames], axis=0)
        tokens = np.load(os.path.join(base, "sam2_object_tokens", video_id,
                                      f"{i:05d}.npy"))
        out[int(i)] = (masklet, tokens)
    return out


def feature_frame(seed: int, n_frames: int) -> int:
    """The frame of a video whose encoder output is kept and compared."""
    rng = np.random.default_rng([seed % (1 << 63), 13])
    return int(rng.integers(n_frames))


class FeatureTap:
    """Keeps, for each video the predictor encodes, the image encoder's
    stride-16 output of one frame (``feature_frame``) in fp32, before the
    predictor stores frame features in bf16: a forward hook on the image
    encoder, armed around each ``init_state``. A device copy of 4 MB a
    video at the large size."""

    def __init__(self, predictor, seed: int):
        self.seed = seed
        self.kept = {}          # video id -> (frame, (h, w, d) tensor)
        self._armed = None      # [video id, frame, first frame of the call]
        predictor.model.image_encoder.register_forward_hook(self._hook)

    @contextlib.contextmanager
    def video(self, video_id: str, n_frames: int):
        self._armed = [video_id, feature_frame(self.seed, n_frames), 0]
        try:
            yield
        finally:
            self._armed = None

    def _hook(self, module, args, out):
        if self._armed is None:
            return
        vid, frame, start = self._armed
        x = out["backbone_fpn"][2]
        if start <= frame < start + x.shape[0]:
            self.kept[vid] = (frame, x[frame - start].detach().clone())
        self._armed[2] = start + x.shape[0]

    def get(self, video_id: str):
        frame, x = self.kept[video_id]
        return frame, x.float().cpu()


def feature_gap(got, ref) -> float:
    """Relative L2 gap of the program's encoder output of the compared
    frame to the reference's; infinite when either is missing."""
    import torch
    if got is None or ref is None or got.shape != ref.shape:
        return float("inf")
    ref = ref.double()
    return float(torch.linalg.vector_norm(got.double() - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-30))


def compare(got: dict, ref: dict) -> dict:
    """Readings of one video. The numbers compared: ``token_gap``, the
    widest relative L2 gap of a frame's object token over every track the
    reference emits, infinite when the two sides track or filter other
    prompts, or a track's shape differs; ``feature_gap``, that of the
    image encoder's output of the compared frame. Beside them, for the
    record: the prompts whose status differs, the mean token gap, and the
    share of a track's masklet pixels on which the two disagree (of the
    pixels either marks), widest and mean."""
    status = (len(set(got["tracked"]) ^ set(ref["tracked"]))
              + len(set(got["filtered"]) ^ set(ref["filtered"])))
    tok, mask = [], []
    for i, (rm, rt) in ref["tracks"].items():
        if i not in got["tracks"]:
            status += 1
            continue
        gm, gt = got["tracks"][i]
        if gm.shape != rm.shape or gt.shape != rt.shape:
            status += 1
            continue
        num = np.linalg.norm(gt.astype(np.float64) - rt, axis=-1)
        den = np.maximum(np.linalg.norm(rt.astype(np.float64), axis=-1),
                         1e-6)
        tok.extend((num / den).tolist())
        union = np.count_nonzero(gm | rm)
        mask.append(np.count_nonzero(gm ^ rm) / max(union, 1))
    return {"token_gap": (float("inf") if status or not tok
                          else float(max(tok))),
            "status_mismatch": float(status),
            "token_gap_mean": float(np.mean(tok)) if tok else 0.0,
            "mask_gap": float(max(mask, default=0.0)),
            "mask_gap_mean": float(np.mean(mask)) if mask else 0.0,
            "feature_gap": feature_gap(got.get("feature"),
                                       ref.get("feature"))}


class Cell:
    """Set-up, units and outputs of one run; the readings tool drives the
    same object."""

    def __init__(self, record, size: str = "large", device: str = "cuda"):
        self.record = record
        self.size = size
        self.device = device
        self.params = record.cell["params"]
        self.root = env.scratch_dir(f"{record.workload}.{record.seed}")

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
        self.traffic = videos_gen.generate(
            os.path.join(self.root, "data"), self.record.mix,
            self.record.seed)
        lap("traffic")
        sd = sam2_hiera_l.state_dict(self.record.config, self.record.seed,
                                     self.device, self.size)
        self.predictor = _program_predictor(
            sd, self.size, int(self.params["batch_size"]))
        self.tap = FeatureTap(self.predictor, self.record.seed)
        del sd
        lap("weights")
        self.track_root = os.path.join(self.root, "out", "sam2_tracks")
        self.out_root = os.path.join(self.track_root, "grid_tracks",
                                     DATASET, DATA_TYPE)
        self.censuses = {}
        if warmup:
            self.video(self.traffic["warmup"], spans=False)
            torch.cuda.synchronize()
            lap("warmup")

    def encode(self, v: dict):
        """The predictor's ``init_state`` on the video's JPEG directory,
        its compared frame's encoder output kept."""
        with self.tap.video(v["video_id"], v["n_frames"]):
            return self.predictor.init_state(None,
                                             video_path=v["frames_dir"])

    def video(self, v: dict, spans: bool = True) -> dict:
        from sola_torch.trackgen import tokens_grid
        p = self.params
        span = (self.record.span if spans
                else lambda name: contextlib.nullcontext())
        with span("encode"):
            state = self.encode(v)
        with span("track"):
            census = tokens_grid.run_video(
                self.predictor, v["video_id"], v["frames_dir"],
                v["prompt_path"], self.out_root, DATASET, DATA_TYPE,
                bin_size=int(p["bin_size"]), batch_size=int(p["batch_size"]),
                miou_thresh=float(p["miou_thresh"]),
                n_max_tracks=int(p["n_max_tracks"]), state=state,
                log=lambda s: None, track_root=self.track_root)
        self.censuses[v["video_id"]] = census
        return census

    def unit(self, i: int) -> dict:
        vids = self.traffic["videos"]
        v = vids[i % len(vids)]
        census = self.video(v)
        return {"video": v["video_id"], "frames": v["n_frames"],
                "objects": census["n_tracked"],
                "object_frames": census["n_tracked"] * v["n_frames"]}

    def program_outputs(self, video_id: str) -> dict:
        c = self.censuses[video_id]
        ids = c["tracked_prompt_ids"]
        frame, feature = self.tap.get(video_id)
        return {"tracks": read_tracks(self.track_root, video_id, ids),
                "tracked": sorted(ids),
                "filtered": sorted(c["filtered_prompt_ids"]),
                "feature_frame": frame, "feature": feature}

    def _video(self, video_id: str) -> dict:
        return next(x for x in self.traffic["videos"]
                    if x["video_id"] == video_id)

    def _weights(self) -> dict:
        from benchmark.models import sam2_hiera_l
        return sam2_hiera_l.state_dict(self.record.config, self.record.seed,
                                       self.device, self.size)

    def reference_outputs(self, video_id: str, lower: bool = False) -> dict:
        from benchmark.reference import trackgen as ref
        v = self._video(video_id)
        return ref.run_video(self._weights(), self.size, v["frames_dir"],
                             v["prompt_path"], self.params, lower=lower,
                             feature_frame=feature_frame(self.record.seed,
                                                         v["n_frames"]))

    def reference_feature(self, video_id: str, tf32: bool = False):
        """The reference's encoder output of the video's compared frame;
        ``tf32`` is the encoder's control."""
        from benchmark.reference import trackgen as ref
        v = self._video(video_id)
        return ref.encode_frame(self._weights(), self.size, v["frames_dir"],
                                feature_frame(self.record.seed,
                                              v["n_frames"]), tf32=tf32)

    def free_program(self) -> None:
        self.predictor = self.tap = None
        device_lib.free_cuda()

    def cleanup(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def add_counts(record, size: str, obj_batch: int, prompt_frames) -> None:
    """Each unit's operations and its flash attention's least time, from
    the configuration and the unit's shapes (``counts/sam2_hiera_l.py``)."""
    from benchmark.counts import peaks, sam2_hiera_l
    for u in record.units:
        n_batches = -(-u["objects"] // obj_batch) if u["objects"] else 0
        conds = sorted(prompt_frames)[:n_batches]
        w = sam2_hiera_l.video_work(u["frames"], conds, size, obj_batch)
        u["flops"] = w["flops"]
        u["attention_least_s"] = sum(peaks.bound_seconds(f, b, dt)
                                     for f, b, dt in w["attention"])


def sample_video(record) -> str:
    rng = np.random.default_rng([record.seed % (1 << 63), 7])
    return record.units[int(rng.integers(len(record.units)))]["video"]


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
    add_counts(record, cell.size, int(cell.params["batch_size"]),
               record.mix["prompt_frames"])

    vid = sample_video(record)
    got = cell.program_outputs(vid)
    cell.free_program()
    ref = cell.reference_outputs(vid)
    readings = compare(got, ref)
    limits = record.config["limits"]["trackgen_grid"]
    checks = [device_lib.check(k, readings[k], float(limits[k]))
              for k in limits]
    cell.cleanup()
    notes = ["set-up s: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in cell.setup_s.items()),
             f"video {vid} compared: {len(ref['tracks'])} tracks, "
             f"{len(got['tracked'])} written by the program, encoder "
             f"output of frame {got['feature_frame']}",
             f"window {record.window_seconds():.3f} s, "
             f"{len(record.units)} videos, {obj_frames} object-frames",
             f"card: {device_lib.power_limit()}"]
    return {"end_to_end": {"track_object_fps": fps, "setup_s": setup_s},
            "attempted": len(record.units), "failed": 0,
            "device": dev, "checks": checks, "notes": notes}


def readings(record, control: bool, tracks: bool = True) -> dict:
    """One seed's readings at the cell's size: the program's first video
    against the reference, and with ``control`` each control against the
    reference: the reference in lower precision for the tracks, TF32 in
    the encoder alone for ``feature_gap``. ``tracks=False`` reads the
    encoder alone: the first video's ``init_state``, no tracking."""
    return cell_readings(Cell(record), control, tracks,
                         lambda unit: unit["video"])


def cell_readings(cell, control: bool, tracks: bool, unit_video) -> dict:
    """``readings`` of a trackgen cell; ``unit_video(unit)`` names the
    video of the first unit that is compared."""
    cell.setup(warmup=tracks)
    if tracks:
        window.run(cell.record, 0.0, cell.unit)
        vid = unit_video(cell.record.units[0])
        got = cell.program_outputs(vid)
    else:
        vid = cell.traffic["videos"][0]["video_id"]
        cell.encode(cell._video(vid))
        got = {"feature": cell.tap.get(vid)[1]}
    cell.free_program()
    if tracks:
        ref = cell.reference_outputs(vid)
        out = {"program": compare(got, ref), "tracks": len(ref["tracks"])}
    else:
        ref = {"feature": cell.reference_feature(vid)}
        out = {"program": {"feature_gap": feature_gap(got["feature"],
                                                      ref["feature"])}}
    if control:
        low = (compare(cell.reference_outputs(vid, lower=True), ref)
               if tracks else {})
        low["feature_gap"] = feature_gap(
            cell.reference_feature(vid, tf32=True), ref["feature"])
        out["control"] = low
    cell.cleanup()
    return out
