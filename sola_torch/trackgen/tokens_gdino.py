"""GroundingDINO-prompt token generation: per-expression tracking.

Counterpart of ``sola_tpu/trackgen/tokens_gdino.py`` (generate_tokens_gdino.py),
sequential path: prompts are filtered per expression_id and by stability
score (>= 0.85), tracked with ``n_max_tracks=16``, and written under
``<video>/<expression>/``, the nesting the data layer keys on
(dataloader.py:122-124). Resumable per (video, expression) through
``runtime_info.json`` (generate_tokens_gdino.py:138-145). The predictor runs
on ``--device`` (CUDA by default).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from sola_torch.core import mask_ops, rle
from sola_torch.data import meta as meta_lib
from sola_torch.data import tracks as tracks_lib
from sola_torch.trackgen import engine, gt_utils
from sola_torch.trackgen.prefetch import StatePrefetcher
from sola_torch.trackgen.tokens_grid import (DATA_DIR_DICT,
                                             _default_predictor_factory)


def load_expression_prompts(prompt_path: str, video_id: str, bin_size: int,
                            expression_id: str,
                            stability_score_thresh: float = 0.85):
    with open(prompt_path, "r") as f:
        info = json.load(f)
    assert info["video_id"] == video_id
    assert bin_size == info["bin_size"], (
        f"bin size mismatch: {bin_size} != {info['bin_size']}")
    prompts, n_not_used, n_total = [], 0, 0
    for p in info["prompt_masks"]:
        if p.get("expression_id") != expression_id:
            continue
        n_total += 1
        pm = engine.PromptMask(
            prompt_id=p["prompt_id"],
            frame_idx=int(p["frame_idx"]),
            segmentation=rle.decode(p["segmentation"]),
        )
        bad_bin = pm.frame_idx % bin_size != 0
        bad_stab = p.get("stability_score", 1.0) < stability_score_thresh
        if bad_bin or bad_stab:
            # gated prompts are counted but not added to the expression
            # list: the reference's runtime_info therefore always has an
            # empty not_used_prompt_ids here even when n_not_used > 0
            # (generate_tokens_gdino.py:160-167 appends only non-gated
            # prompts, :315 lists status==3 over that list), and drop-in
            # artifact parity means reproducing that
            n_not_used += 1
            continue
        prompts.append(pm)
    return prompts, n_not_used, n_total


def run_expression(predictor, state, video_id: str, expression_id: str,
                   prompt_path: str, track_root: str, dataset: str,
                   data_type: str, n_frames: int, *,
                   bin_size: int = 4, batch_size: int = 4,
                   miou_thresh: float = 0.7,
                   stability_score_thresh: float = 0.85,
                   n_max_tracks: int = 16,
                   gt_masklets: Optional[dict] = None,
                   output_dir_name: str = "gdino_tracks",
                   log: Callable[[str], None] = print) -> dict:
    prompts, n_not_used, n_total = load_expression_prompts(
        prompt_path, video_id, bin_size, expression_id,
        stability_score_thresh)

    def on_track(result: engine.TrackResult) -> None:
        metrics = None
        if gt_masklets is not None:
            metrics = gt_utils.metrics_vs_gt(result.masklet_small,
                                             gt_masklets)
        tracks_lib.save_track(
            track_root, output_dir_name, dataset, data_type, video_id,
            result.prompt_id, rle.encode_masklet(result.masklet),
            "SAM2 AMG MASK", result.tokens, expression_id=expression_id,
            metrics=metrics)

    census = engine.generate_tracks(
        predictor, state, prompts, n_frames=n_frames,
        batch_size=batch_size, miou_thresh=miou_thresh,
        n_max_tracks=n_max_tracks, on_track=on_track,
        scan_all_for_same_frame=False, log=log)
    census["n_not_used"] = n_not_used
    census["n_total"] = n_total
    return census


def main(argv=None, predictor_factory=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mevis")
    parser.add_argument("--data_type", type=str, default="valid_u")
    parser.add_argument("--bin_size", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--miou_thresh", type=float, default=0.7)
    parser.add_argument("--stability_score_thresh", type=float, default=0.85)
    parser.add_argument("--n_max_tracks", type=int, default=16)
    parser.add_argument("--sam2_cfg", type=str, default=None,
                        help="accepted for reference CLI compatibility; the architecture is code-defined")
    parser.add_argument("--sam2_ckpt", type=str,
                        default="pretrained_models/sam2_hiera_large.pt")
    parser.add_argument("--save_prec_rec_iou", action="store_true")
    parser.add_argument("--pid", type=int, default=0)
    parser.add_argument("--n_pids", "--n_pid", dest="n_pids",
                        type=int, default=1)
    parser.add_argument("--prefetch_videos", type=int, default=1,
                        help="encode the next video while the current one "
                             "propagates (0 to serialize)")
    parser.add_argument("--expr_pack", type=int, default=1,
                        help="expressions per packed propagation round; only "
                             "1 (sequential) is ported so far")
    parser.add_argument("--obj_batch", type=int, default=0,
                        help="SAM2 object slots per propagation pass; 0 = "
                             "batch_size")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the SAM2 predictor")
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--output_root", type=str, default=".")
    args = parser.parse_args(argv)
    if args.expr_pack > 1:
        raise NotImplementedError(
            "--expr_pack > 1 needs the packed engine, not yet ported")

    assert args.data_type in meta_lib.DATA_TYPES[args.dataset]
    data_dir = os.path.join(args.data_root, DATA_DIR_DICT[args.dataset],
                            args.data_type)
    prompt_dir = os.path.join(args.output_root, "sam2_prompts/gdino_prompts",
                              args.dataset, args.data_type)
    out_dir = os.path.join(args.output_root, "sam2_tracks/gdino_tracks",
                           args.dataset, args.data_type)
    track_root = os.path.join(args.output_root, "sam2_tracks")

    if args.dataset == "mevis":
        with open(os.path.join(data_dir, "meta_expressions.json")) as f:
            meta = json.load(f)
    else:
        with open(os.path.join(args.data_root, DATA_DIR_DICT[args.dataset],
                               "meta_expressions", args.data_type,
                               "meta_expressions.json")) as f:
            meta = json.load(f)

    mask_dict = None
    if args.save_prec_rec_iou and args.dataset == "mevis":
        with open(os.path.join(data_dir, "mask_dict.json")) as f:
            mask_dict = json.load(f)

    if predictor_factory is None:
        predictor_factory = _default_predictor_factory(
            args.sam2_ckpt, args.obj_batch or args.batch_size, args.device)
    predictor = predictor_factory()

    runtime_path = os.path.join(out_dir, "runtime_info.json")
    done_snapshot = {}
    if os.path.exists(runtime_path):
        with open(runtime_path) as f:
            done_snapshot = json.load(f)
    # resume-aware work list: videos whose expressions are all done are
    # skipped up front so the look-ahead never encodes a finished video
    work = [(v, m) for i, (v, m) in enumerate(meta["videos"].items())
            if i % args.n_pids == args.pid
            and any(e not in done_snapshot.get(v, {})
                    for e in m["expressions"])]

    def frames_dir_of(video_id):
        return os.path.join(data_dir, "JPEGImages", video_id)

    prefetcher = StatePrefetcher(predictor,
                                 enabled=bool(args.prefetch_videos))
    for work_idx, (video_id, video_meta) in enumerate(work):
        prefetcher.schedule(video_id, frames_dir_of(video_id))
        if work_idx + 1 < len(work):
            prefetcher.schedule(work[work_idx + 1][0],
                                frames_dir_of(work[work_idx + 1][0]))
        frames_dir = frames_dir_of(video_id)
        n_frames = len(os.listdir(frames_dir))

        runtime_info = {}
        if os.path.exists(runtime_path):
            with open(runtime_path) as f:
                runtime_info = json.load(f)
        runtime_info.setdefault(video_id, {})

        gt_masklets = None
        if args.save_prec_rec_iou:
            if args.dataset == "mevis":
                gt = gt_utils.get_masklets(video_id, meta, mask_dict)
                gt_masklets = {
                    k: np.asarray(mask_ops.reshape_masklet_auto(v))
                    for k, v in gt.items()}
            else:
                gt_masklets = gt_utils.get_masklets_ytbvos(
                    os.path.join(data_dir, "Annotations", video_id),
                    reshape=True)

        state = prefetcher.get(video_id, frames_dir)
        pending = [e for e in video_meta["expressions"]
                   if e not in runtime_info[video_id]]
        for expression_id in pending:
            start = time.time()
            census = run_expression(
                predictor, state, video_id, expression_id,
                os.path.join(prompt_dir, f"{video_id}.json"), track_root,
                args.dataset, args.data_type, n_frames,
                bin_size=args.bin_size, batch_size=args.batch_size,
                miou_thresh=args.miou_thresh,
                stability_score_thresh=args.stability_score_thresh,
                n_max_tracks=args.n_max_tracks, gt_masklets=gt_masklets)
            census["time"] = time.time() - start
            census["fps"] = n_frames / max(census["time"], 1e-9)
            runtime_info[video_id][expression_id] = census
            os.makedirs(out_dir, exist_ok=True)
            with open(runtime_path, "w") as f:
                json.dump(runtime_info, f, indent=4)
    prefetcher.close()


if __name__ == "__main__":
    main()
