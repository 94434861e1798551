"""Entry ``trackgen_gdino``: text-prompted track generation, one video after
another, as ``prompts_gdino`` then ``tokens_gdino --expr_pack 8`` run a
MeViS valid split (``--prefetch_videos 0``).

Set-up builds the port's GroundingDINO (fp32, TF32 off), SAM2's image
predictor and its video predictor (8 object slots) on weights drawn from
the configuration's fixed seed, writes the mix's videos and expressions,
and runs one warm-up video through the same calls. A unit of the window is
one video: ``prompts_gdino.prompt_video`` (span ``prompts``: the JPEG
decode, GroundingDINO on every binned frame, the box -> mask prompts, the
prompts JSON), the video predictor's ``init_state`` (span ``encode``),
then ``tokens_gdino.run_video_packed`` over its expressions in groups of 8
(span ``track``), which writes every track's masklet and tokens.

After the window one finished video, drawn from the seed, is redone by the
plain reference from the program's choice at each gate
(``reference/trackgen_gdino.py``): GroundingDINO on one binned frame and
expression chunk of it, drawn from the seed and kept from the window's own
forward, decoding the program's top-900 queries (``logit_gap``,
``box_gap``), with its own selection checked against the program's
(``pick_gap``) and its box gate against the boxes the program wrote for
the chunk (``box_gate_gap``); SAM2's mask and stability score of every box
the program kept (``mask_gap``, ``stability_gap``), its stability gate
against the prompts the program kept (``stability_gate_gap``); every track
the program wrote, propagated from the program's prompts (``token_gap``);
the dedup and track-count gates walked on those tracks (``dedup_gap``,
``track_count_gap``); and the image encoder's output of one frame
(``feature_gap``). Each gate's gap is the widest distance from its
threshold, in the gate's own score, of anything the two sides decide
apart (0 when they agree), so a rounding flip at a gate reads tiny and a
moved gate reads its move.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import time

import numpy as np

from benchmark.core import device as device_lib
from benchmark.core import window
from benchmark.drivers import trackgen_grid
from benchmark.drivers.trackgen_grid import (FeatureTap, compare,
                                             feature_frame, feature_gap,
                                             read_tracks)
from benchmark.gen import gdino_videos, rle
from sola_torch.trackgen.prompts_gdino import PromptGenerator, prompt_video
from sola_torch.trackgen.tokens_gdino import run_video_packed

DATASET, DATA_TYPE = "mevis", "valid"


def _rng(seed: int, *keys):
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


class GroundingTap:
    """Keeps, for each video, one GroundingDINO call's outputs (logits,
    boxes and the query selection's indices, device copies of 8 MB): the
    call of one binned frame and expression chunk, drawn from the seed. A
    forward hook on the model, armed around each video's prompts."""

    def __init__(self, model, seed: int):
        self.seed = seed
        self.kept = {}          # video id -> (call index, outputs)
        self._armed = None      # [video id, call to keep, calls so far]
        model.register_forward_hook(self._hook)

    def pick(self, video_id: str, n_calls: int) -> int:
        return int(_rng(self.seed, 17, sum(map(ord, video_id)))
                   .integers(n_calls))

    @contextlib.contextmanager
    def video(self, video_id: str, n_calls: int):
        self._armed = [video_id, self.pick(video_id, n_calls), 0]
        try:
            yield
        finally:
            self._armed = None

    def _hook(self, module, args, out):
        if self._armed is None:
            return
        vid, keep, seen = self._armed
        if seen == keep:
            self.kept[vid] = (keep, {
                k: out[k].detach().clone()
                for k in ("pred_logits", "pred_boxes", "topk_indices")})
        self._armed[2] = seen + 1


def n_chunks(n_expr: int, cap: int = 8) -> int:
    return -(-n_expr // cap)


def chunk_shapes(texts: list, config: dict, cap: int = 8) -> list:
    """(rows, text tokens) of each GroundingDINO forward over a frame's
    expressions."""
    from benchmark.reference.gdino.text import hash_ids
    from benchmark.reference.trackgen_gdino import chunk_rows
    vocab = int(config["sizes"]["text_vocab_size"])
    out = []
    for c0 in range(0, len(texts), cap):
        rows = chunk_rows(texts[c0:c0 + cap])
        out.append((len(rows), max(len(hash_ids(t, vocab)[:64])
                                   for t in rows)))
    return out


class Cell(trackgen_grid.Cell):
    """``trackgen_grid.Cell``'s encode and clean-up; its own set-up,
    weights, units and outputs."""

    def setup(self, warmup: bool = True) -> None:
        import torch

        from benchmark.models import gdino_swin_t
        from sola_torch.ops import kernel_build
        from sola_torch.trackgen.gdino.model import GroundingModel
        from sola_torch.trackgen.sam2.image import SAM2ImagePredictor
        from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(self.root, ignore_errors=True)
        cfg = self.record.config
        self.prompt_params = cfg["prompts"]
        self.token_params = cfg["tokens"]
        t = time.perf_counter()
        self.setup_s = {}

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            self.setup_s[name] = now - t
            t = now

        kernel_build.build_all()
        lap("kernels")
        self.traffic = gdino_videos.generate(self.root, self.record.mix,
                                             self.record.seed)
        lap("traffic")
        gmodel = self._port_gdino(gdino_swin_t.state_dict(
            cfg, self.device, self.size))
        self.grounding = GroundingModel(gmodel)
        self.gtap = GroundingTap(gmodel, self.record.seed)
        sd = gdino_swin_t.sam2_state_dict(cfg, self.device, self.size)
        scfg = (SAM2Config.large() if self.size == "large"
                else SAM2Config.tiny_test())
        with torch.device("meta"):
            smodel = SAM2Model(scfg)
        smodel.load_state_dict(sd, assign=True)
        self.generator = PromptGenerator(
            self.grounding, SAM2ImagePredictor(smodel),
            box_threshold=float(self.prompt_params["box_threshold"]),
            text_threshold=float(self.prompt_params["text_threshold"]))
        self.predictor = trackgen_grid._program_predictor(
            sd, self.size, int(self.token_params["obj_batch"]))
        self.tap = FeatureTap(self.predictor, self.record.seed)
        del sd
        lap("weights")
        out = os.path.join(self.root, "out")
        self.prompt_dir = os.path.join(out, "sam2_prompts", "gdino_prompts",
                                       DATASET, DATA_TYPE)
        os.makedirs(self.prompt_dir, exist_ok=True)
        self.track_root = os.path.join(out, "sam2_tracks")
        self.censuses = {}
        if warmup:
            self.video(self.traffic["warmup"], spans=False)
            torch.cuda.synchronize()
            lap("warmup")

    def _port_gdino(self, state_dict: dict):
        import torch

        from sola_torch.trackgen.gdino.model import GroundingDINO
        cfg = port_config(self.record.config, self.size)
        with torch.device("meta"):
            model = GroundingDINO(cfg)
        model.load_state_dict(state_dict, assign=True)
        return model.eval()

    def prompt_path(self, video_id: str) -> str:
        return os.path.join(self.prompt_dir, f"{video_id}.json")

    def video(self, v: dict, spans: bool = True) -> dict:
        pp, tp = self.prompt_params, self.token_params
        span = (self.record.span if spans
                else lambda name: contextlib.nullcontext())
        vid, n = v["video_id"], v["n_frames"]
        exprs = v["expressions"]
        bins = len(range(0, n, int(pp["bin_size"])))
        with span("prompts"):
            with self.gtap.video(vid, bins * n_chunks(len(exprs))):
                info = prompt_video(
                    self.generator, v["frames_dir"], vid, exprs,
                    int(pp["bin_size"]), self.prompt_path(vid))
        with span("encode"):
            state = self.encode(v)
        with span("track"):
            censuses = run_video_packed(
                self.predictor, state, vid, list(exprs),
                self.prompt_path(vid), self.track_root, DATASET, DATA_TYPE,
                n, expr_pack=int(tp["expr_pack"]),
                bin_size=int(pp["bin_size"]),
                batch_size=int(tp["batch_size"]),
                miou_thresh=float(tp["miou_thresh"]),
                stability_score_thresh=float(tp["stability_score_thresh"]),
                n_max_tracks=int(tp["n_max_tracks"]), log=lambda s: None)
        self.censuses[vid] = censuses
        tracks = sum(c["n_tracked"] for c in censuses.values())
        return {"video": vid, "frames": n, "binned_frames": bins,
                "pairs": bins * len(exprs), "expressions": len(exprs),
                "boxes": len(info["prompt_masks"]),
                "prompts_kept": sum(c["n_total"] - c["n_not_used"]
                                    for c in censuses.values()),
                "objects": tracks, "object_frames": tracks * n,
                "track_frames": [
                    (n, [p["frame_idx"] for p in info["prompt_masks"]
                         if p["prompt_id"] in c["tracked_prompt_ids"]])
                    for c in censuses.values()],
                "chunks": chunk_shapes([e["exp"] for e in exprs.values()],
                                       self.record.config)}

    def unit(self, i: int) -> dict:
        vids = self.traffic["videos"]
        return self.video(vids[i % len(vids)])

    def _video(self, video_id: str) -> dict:
        return next(x for x in self.traffic["videos"]
                    if x["video_id"] == video_id)

    def gates(self, n_frames: int) -> dict:
        """The thresholds and sizes of the gates the readings check."""
        pp, tp = self.prompt_params, self.token_params
        return {"box_threshold": float(pp["box_threshold"]),
                "bin_size": int(pp["bin_size"]),
                "stability_score_thresh": float(
                    tp["stability_score_thresh"]),
                "miou_thresh": float(tp["miou_thresh"]),
                "n_max_tracks": int(tp["n_max_tracks"]),
                "batch_size": int(tp["batch_size"]), "n_frames": n_frames}

    def program_outputs(self, video_id: str) -> dict:
        v = self._video(video_id)
        with open(self.prompt_path(video_id)) as f:
            info = json.load(f)
        tracks, census = {}, {}
        for expr, c in self.censuses[video_id].items():
            census[expr] = {"tracked": c["tracked_prompt_ids"],
                            "filtered": c["filtered_prompt_ids"],
                            "open": c["not_tracked_prompt_ids"],
                            "n_tracked": c["n_tracked"]}
            tracks.update(read_tracks(self.track_root, f"{video_id}/{expr}",
                                      c["tracked_prompt_ids"],
                                      "gdino_tracks", DATA_TYPE))
        call, out = self.gtap.kept[video_id]
        chunks = n_chunks(len(v["expressions"]))
        bin_size = int(self.prompt_params["bin_size"])
        ids = list(v["expressions"])
        c = call % chunks
        frame = (call // chunks) * bin_size
        mix = self.record.mix
        boxes = [[p["pred_bbox"] for p in info["prompt_masks"]
                  if p["frame_idx"] == frame and p["expression_id"] == e]
                 for e in ids[8 * c:8 * c + 8]]
        tap_frame, feature = self.tap.get(video_id)
        return {"prompts": info, "tracks": tracks, "census": census,
                "tracked": [i for x in census.values()
                            for i in x["tracked"]],
                "filtered": [i for x in census.values()
                             for i in x["filtered"]],
                "keep": {i for x in census.values()
                         for k in ("tracked", "filtered", "open")
                         for i in x[k]},
                "gates": self.gates(v["n_frames"]),
                "ground": {"frame": frame,
                           "texts": [v["expressions"][e]["exp"]
                                     for e in ids[8 * c:8 * c + 8]],
                           "boxes": boxes,
                           "hw": (int(mix["height"]), int(mix["width"])),
                           **{k: x.cpu() for k, x in out.items()}},
                "feature_frame": tap_frame, "feature": feature}

    def _gdino_weights(self) -> dict:
        from benchmark.models import gdino_swin_t
        return gdino_swin_t.state_dict(self.record.config, self.device,
                                       self.size)

    def _weights(self) -> dict:
        from benchmark.models import gdino_swin_t
        return gdino_swin_t.sam2_state_dict(self.record.config, self.device,
                                            self.size)

    def reference_outputs(self, video_id: str, got: dict,
                          lower: bool = False) -> dict:
        """The reference's outputs of the video from the program's choices
        in ``got``; ``lower``: each part's control."""
        from benchmark.models import gdino_swin_t
        from benchmark.reference import trackgen_gdino as ref
        from benchmark.reference.trackgen import _frames
        v = self._video(video_id)
        g = got["ground"]
        frame = _frames(v["frames_dir"])[g["frame"]]
        grounded = ref.ground(
            self._gdino_weights(),
            gdino_swin_t.gdino_config(self.record.config, self.size), frame,
            g["texts"], g["topk_indices"], tf32=lower)
        sam = self._weights()
        boxes: dict = {}
        for p in got["prompts"]["prompt_masks"]:
            boxes.setdefault(p["frame_idx"], []).append(p["pred_bbox"])
        masks = ref.box_masks(sam, self.size, v["frames_dir"], boxes,
                              tf32=lower)
        by_id = {p["prompt_id"]: p for p in got["prompts"]["prompt_masks"]}
        prompts = [(i, by_id[i]["frame_idx"],
                    rle.decode(by_id[i]["segmentation"]))
                   for i in got["tracked"]]
        tracked = ref.track(sam, self.size, v["frames_dir"], prompts,
                            int(self.token_params["obj_batch"]), lower=lower,
                            feature_frame=feature_frame(self.record.seed,
                                                        v["n_frames"]))
        return {"ground": grounded, "box_masks": masks,
                "prompts": got["prompts"], "tracks": tracked["tracks"],
                "feature": tracked["feature"]}

    def reference_feature(self, video_id: str, tf32: bool = False):
        from benchmark.reference import trackgen as ref
        v = self._video(video_id)
        return ref.encode_frame(self._weights(), self.size, v["frames_dir"],
                                feature_frame(self.record.seed,
                                              v["n_frames"]), tf32=tf32)

    def free_program(self) -> None:
        self.predictor = self.tap = self.grounding = None
        self.generator = self.gtap = None
        device_lib.free_cuda()


def port_config(config: dict, size: str):
    """The port's ``GDINOConfig`` of the configuration."""
    import dataclasses

    from sola_torch.models.text import RobertaConfig
    from sola_torch.trackgen.gdino.model import GDINOConfig
    from sola_torch.trackgen.gdino.swin import SwinConfig
    if size != "large":
        return GDINOConfig.tiny_test()
    s = config["sizes"]
    text = dataclasses.replace(
        RobertaConfig.bert_base(), vocab_size=s["text_vocab_size"],
        hidden_size=s["text_hidden_size"], num_layers=s["text_num_layers"],
        num_heads=s["text_num_heads"],
        intermediate_size=s["text_intermediate_size"])
    return GDINOConfig(
        swin=SwinConfig(embed_dim=s["swin_embed_dim"],
                        depths=tuple(s["swin_depths"]),
                        num_heads=tuple(s["swin_num_heads"]),
                        window_size=s["swin_window_size"]),
        text=text, d_model=s["hidden_dim"], n_heads=s["nheads"],
        n_levels=s["num_feature_levels"], enc_n_points=s["enc_n_points"],
        dec_n_points=s["dec_n_points"], enc_layers=s["enc_layers"],
        dec_layers=s["dec_layers"], dim_feedforward=s["dim_feedforward"],
        num_queries=s["num_queries"], max_text_len=s["max_text_len"],
        size_target=s["canvas"][0], size_max=s["canvas"][1])


# ---------------------------------------------------------------------------
# Readings
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if a.shape != b.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def _gate_gap(items) -> tuple:
    """(widest distance from the threshold, count) over (decided apart,
    distance) pairs; (0, 0) when the two sides agree on every one."""
    apart = [d for a, d in items if a]
    return max(apart, default=0.0), len(apart)


def _row_max(logits):
    """Each query's highest finite logit over its text tokens."""
    import torch
    return torch.where(torch.isfinite(logits), logits,
                       torch.tensor(-1e30)).amax(-1)


def written_boxes(ground: dict):
    """Each real row's queries whose boxes the program wrote (``boxes``,
    xyxy pixels from the prompts JSON), found by their boxes among the
    forward's ``pred_boxes``; None if a written box is no query's."""
    h, w = ground["hw"]
    cx, cy, bw, bh = np.moveaxis(ground["pred_boxes"].float().numpy(), -1,
                                 0)
    px = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                   (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
    out = []
    for r, boxes in enumerate(ground["boxes"]):
        qs = set()
        for box in boxes:
            d = np.abs(px[r] - np.float32(box)).max(-1)
            q = int(d.argmin())
            if d[q] > 1e-3 or q in qs:
                return None
            qs.add(q)
        out.append(qs)
    return out


def grounding_gaps(got: dict, ref: dict, box_threshold: float = 0.2
                   ) -> dict:
    """``logit_gap`` and ``box_gap``: relative L2 gaps of the chunk's real
    rows' logits (the entries finite on both sides; infinite where the
    two sides' finite entries differ) and boxes; ``pick_gap``: the widest
    distance from the reference's own top-k cut, over the standard
    deviation of the row's selection scores, of a proposal the two
    selections disagree on (0 when they agree); ``box_gate_gap``: the
    widest distance, in logits, of the reference's score (a query's highest
    text logit) from ``box_threshold``'s logit, of a query on one side of
    the box gate only: the program's side is the boxes it wrote for the
    chunk (``got["boxes"]``; infinite if one is no query's), or, without
    them, its own logits over the gate. For the record: the gate score's
    widest gap (``box_score_gap``), each side's boxes and the queries
    decided apart."""
    import torch
    rows = len(got["texts"])
    gl, rl = got["pred_logits"][:rows], ref["pred_logits"][:rows]
    fin = torch.isfinite(gl)
    logit_gap = (_rel(gl[fin], rl[fin]) if torch.equal(fin,
                                                        torch.isfinite(rl))
                 else float("inf"))
    box_gap = _rel(got["pred_boxes"][:rows], ref["pred_boxes"][:rows])
    nq = got["topk_indices"].shape[1]
    pick = 0.0
    for r in range(rows):
        s = ref["scores"][r].double()
        order = torch.sort(s, descending=True, stable=True).values
        cut = 0.5 * (order[nq - 1] + order[min(nq, len(order) - 1)])
        scale = s[s > -1e29].std().clamp_min(1e-30)
        diff = (set(got["topk_indices"][r].tolist())
                ^ set(ref["own_topk"][r].tolist()))
        for q in diff:
            pick = max(pick, float((s[q] - cut).abs() / scale))
    thr = _logit(box_threshold)
    gmax, rmax = _row_max(gl).double(), _row_max(rl).double()
    ref_pass = [set(torch.nonzero(rmax[r] > thr).flatten().tolist())
                for r in range(rows)]
    got_pass = (written_boxes(got) if "boxes" in got else
                [set(torch.nonzero(gmax[r] > thr).flatten().tolist())
                 for r in range(rows)])
    if got_pass is None:
        gate, apart = float("inf"), -1
    else:
        gate, apart = _gate_gap(
            (True, abs(float(rmax[r, q]) - thr))
            for r in range(rows) for q in got_pass[r] ^ ref_pass[r])
    return {"logit_gap": logit_gap, "box_gap": box_gap, "pick_gap": pick,
            "box_gate_gap": gate,
            "box_score_gap": float((gmax - rmax).abs().max()),
            "boxes_program": (-1 if got_pass is None
                              else sum(map(len, got_pass))),
            "boxes_reference": sum(map(len, ref_pass)),
            "box_gate_flips": apart}


def mask_gaps(prompts: dict, ref_masks: dict) -> dict:
    """``mask_gap``: the widest share of a box's mask pixels on which the
    program's prompt mask and the reference's disagree (of the pixels
    either marks)."""
    gap = 0.0
    for p, (m, _) in _by_box(prompts, ref_masks):
        gm = rle.decode(p["segmentation"]).astype(bool)
        if gm.shape != m.shape:
            return {"mask_gap": float("inf")}
        gap = max(gap, np.count_nonzero(gm ^ m)
                  / max(np.count_nonzero(gm | m), 1))
    return {"mask_gap": float(gap)}


def _by_box(prompts: dict, ref_masks: dict) -> list:
    """(prompt, (reference mask, reference stability)) of every box, the
    reference's in the order of the frame's boxes in the prompts JSON."""
    by_frame: dict = {}
    for p in prompts["prompt_masks"]:
        by_frame.setdefault(p["frame_idx"], []).append(p)
    out = []
    for f, ps in by_frame.items():
        masks, stabs = ref_masks[f]
        out += [(p, (m, float(s))) for p, m, s in zip(ps, masks, stabs)]
    return out


def stability_gaps(got: dict, ref_masks: dict) -> dict:
    """``stability_gap``: the widest gap of a box's stability score;
    ``stability_gate_gap``: the widest distance from the threshold of the
    reference's score of a prompt the program kept (``got["keep"]``, past
    its stability and bin gates) and the reference's gate did not, or the
    other way (infinite for one off the bin frames); beside, the count
    decided apart."""
    g = got["gates"]
    thr = g["stability_score_thresh"]
    gap, items = 0.0, []
    for p, (_, s) in _by_box(got["prompts"], ref_masks):
        gap = max(gap, abs(s - p["stability_score"]))
        on_bin = p["frame_idx"] % g["bin_size"] == 0
        kept = p["prompt_id"] in got["keep"]
        items.append((kept != (on_bin and s >= thr),
                      abs(s - thr) if on_bin else float("inf")))
    gate, apart = _gate_gap(items)
    return {"stability_gap": gap, "stability_gate_gap": gate,
            "stability_gate_flips": apart}


def dedup_gaps(got: dict, ref: dict) -> dict:
    """The dedup and track-count gates, walked per expression through the
    program's choices (``census``) on the reference's tracks
    (``reference/trackgen_gdino.dedup``). ``dedup_gap``: the widest
    distance from ``miou_thresh`` of the reference's IoU of a prompt
    decided apart: the program's choice, or, with ``dedup_by_iou``, the
    other side's own IoU over the threshold (a control); ``track_count_gap``:
    the prompts whose program status the engine's loop cannot reach (a
    track past the cap, an open prompt before it), plus any census whose
    track count is not its tracked list's. Beside: the IoUs' widest gap
    (``dedup_iou_gap``), the count decided apart, and the walk's tracked
    and filtered ids."""
    from benchmark.reference import trackgen_gdino as ref_lib
    g = got["gates"]
    thr = g["miou_thresh"]
    prompts = ref["prompts"]["prompt_masks"]
    ref_m = {i: m for i, (m, _) in ref["tracks"].items()}
    got_m = {i: m for i, (m, _) in got["tracks"].items()}
    items, mismatch, tracked, filtered = [], 0, [], []
    for expr, c in got["census"].items():
        status = {**{i: 1 for i in c["tracked"]},
                  **{i: 2 for i in c["filtered"]},
                  **{i: 0 for i in c["open"]}}
        walk = ref_lib.dedup(
            [(p["prompt_id"], p["frame_idx"], rle.decode(p["segmentation"]))
             for p in prompts if p["expression_id"] == expr
             and p["prompt_id"] in status], status, [ref_m, got_m],
            g["n_frames"], batch_size=g["batch_size"],
            n_max_tracks=g["n_max_tracks"], miou_thresh=thr)
        mismatch += walk["mismatch"] + abs(c["n_tracked"]
                                           - len(c["tracked"]))
        tracked += walk["tracked"]
        filtered += walk["filtered"]
        items += walk["items"]
    by_iou = got.get("dedup_by_iou", False)
    gate, apart = _gate_gap(
        ((s_got > thr if by_iou else filt) != (s_ref > thr),
         abs(s_ref - thr)) for _, filt, (s_ref, s_got) in items)
    return {"dedup_gap": gate, "track_count_gap": float(mismatch),
            "dedup_iou_gap": max((abs(a - b) for _, _, (a, b) in items),
                                 default=0.0),
            "dedup_flips": apart, "tracked": tracked, "filtered": filtered}


def compare_video(got: dict, ref: dict) -> dict:
    """Every reading of one video (``trackgen_grid.compare`` for its
    tracks, whose masklet share is ``masklet_gap`` here, against the
    tracked and filtered prompts of the dedup walk)."""
    walk = dedup_gaps(got, ref)
    tracks = compare(got, dict(ref, tracked=walk.pop("tracked"),
                               filtered=walk.pop("filtered")))
    tracks["masklet_gap"] = tracks.pop("mask_gap")
    tracks["masklet_gap_mean"] = tracks.pop("mask_gap_mean")
    out = dict(tracks)
    out.update(walk)
    out.update(grounding_gaps(got["ground"], ref["ground"],
                              got["gates"]["box_threshold"]))
    out.update(mask_gaps(got["prompts"], ref["box_masks"]))
    out.update(stability_gaps(got, ref["box_masks"]))
    return out


# ---------------------------------------------------------------------------
# Counts, run, readings
# ---------------------------------------------------------------------------

def add_counts(record, size: str) -> None:
    """Each unit's operations and the deformable kernel's least time
    (``counts/gdino_swin_t.py``)."""
    from benchmark.counts import gdino_swin_t as counts
    for u in record.units:
        w = counts.video_work(record.config, u, size)
        u["flops"] = w["flops"]
        u["deform_least_s"] = w["deform_least_s"]
        u["attention_least_s"] = w["attention_least_s"]


def sample_video(record) -> str:
    rng = _rng(record.seed, 7)
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
    add_counts(record, cell.size)

    vid = sample_video(record)
    got = cell.program_outputs(vid)
    cell.free_program()
    ref = cell.reference_outputs(vid, got)
    readings = compare_video(got, ref)
    limits = record.config["limits"]["trackgen_gdino"]
    checks = [device_lib.check(k, readings[k], float(limits[k]))
              for k in limits]
    cell.cleanup()
    units = record.units
    per_pair = record.total("boxes") / max(record.total("pairs"), 1)
    per_expr = record.total("objects") / max(record.total("expressions"), 1)
    notes = ["set-up s: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in cell.setup_s.items()),
             f"video {vid} compared: {len(ref['tracks'])} tracks, "
             f"{len(got['prompts']['prompt_masks'])} boxes, grounding of "
             f"frame {got['ground']['frame']} x "
             f"{len(got['ground']['texts'])} expressions, encoder output of "
             f"frame {got['feature_frame']}",
             "readings: " + json.dumps(readings),
             f"window {record.window_seconds():.3f} s, {len(units)} videos, "
             f"{obj_frames} object-frames; boxes a (frame, expression) "
             f"{per_pair:.3f}, tracks an expression {per_expr:.3f}",
             "units: " + ", ".join(
                 f"{u['video']} {u['object_frames']} obj-frames "
                 f"{u['objects']} tracks {u['boxes']} boxes "
                 f"{u['t1'] - u['t0']:.3f} s" for u in units),
             f"card: {device_lib.power_limit()}"]
    return {"end_to_end": {"track_object_fps": fps, "setup_s": setup_s},
            "attempted": len(units), "failed": 0,
            "device": dev, "checks": checks, "notes": notes}


def readings(record, control: bool, tracks: bool = True) -> dict:
    """One seed's readings at the cell's size: the program's first video
    against the reference, and with ``control`` each part's control
    against the reference (TF32 in Swin and the deformable encoder for the
    grounding gaps and the box gate, TF32 in the image predictor for
    ``mask_gap`` and the stability gate, the lower reference of
    ``reference/trackgen.py`` for ``token_gap`` and the dedup gate, whose
    control decides by its own IoUs on the program's walk, TF32 in the
    encoder alone for ``feature_gap``). ``tracks=False`` reads
    ``feature_gap`` alone, from the first video's encode."""
    cell = Cell(record)
    if not tracks:
        return trackgen_grid.cell_readings(cell, control, False, None)
    cell.setup()
    window.run(cell.record, 0.0, cell.unit)
    u = cell.record.units[0]
    vid = u["video"]
    got = cell.program_outputs(vid)
    cell.free_program()
    ref = cell.reference_outputs(vid, got)
    out = {"program": compare_video(got, ref), "tracks": len(ref["tracks"]),
           "unit": {k: u[k] for k in ("frames", "pairs", "boxes",
                                      "prompts_kept", "objects",
                                      "expressions")}}
    if control:
        low = cell.reference_outputs(vid, got, lower=True)
        low["ground"] = dict(low["ground"], texts=got["ground"]["texts"],
                             topk_indices=low["ground"]["own_topk"])
        low["prompts"] = {"prompt_masks": [
            dict(p, segmentation=rle.encode(m.astype(np.uint8)),
                 stability_score=float(s))
            for f, (ms, ss) in sorted(low["box_masks"].items())
            for p, m, s in zip([q for q in got["prompts"]["prompt_masks"]
                                if q["frame_idx"] == f], ms, ss)]}
        g = got["gates"]
        low.update(
            {k: got[k] for k in ("census", "gates", "tracked", "filtered")},
            dedup_by_iou=True, keep={
                p["prompt_id"] for p in low["prompts"]["prompt_masks"]
                if p["frame_idx"] % g["bin_size"] == 0
                and p["stability_score"] >= g["stability_score_thresh"]})
        c = compare_video(low, ref)
        c["feature_gap"] = feature_gap(cell.reference_feature(vid, True),
                                       ref["feature"])
        out["control"] = c
    cell.cleanup()
    return out
