"""GroundingDINO-prompt token generation: per-expression tracking.

Counterpart of ``sola_tpu/trackgen/tokens_gdino.py`` (generate_tokens_gdino.py):
prompts are filtered per expression_id and by stability score (>= 0.85),
tracked with ``n_max_tracks=16``, and written under
``<video>/<expression>/``, the nesting the data layer keys on
(dataloader.py:122-124). Resumable per (video, expression) through
``runtime_info.json`` (generate_tokens_gdino.py:138-145). The predictor runs
on ``--device`` (CUDA by default); every expression goes through
``packed_engine``, ``--expr_pack N`` expressions of a video sharing its
propagation rounds (the default 1: one expression at a time, the
reference's order). Counter ``trackgen.prompts_kept``: prompts past the bin
and stability gates, over every expression loaded; span ``trackgen.emit``
(``tokens_grid.make_on_track``): each track's RLE encode and file writes.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

from sola_torch.core import rle
from sola_torch.data import meta as meta_lib
from sola_torch.trackgen import engine, gt_utils
from sola_torch.trackgen.prefetch import StatePrefetcher
from sola_torch.trackgen.tokens_grid import (_default_predictor_factory,
                                             make_on_track)
from sola_torch.utils import profiling


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
    profiling.count("trackgen.prompts_kept", len(prompts))
    return prompts, n_not_used, n_total


def run_expressions_packed(predictor, state, video_id: str,
                           expression_ids: list, prompt_path: str,
                           track_root: str, dataset: str, data_type: str,
                           n_frames: int, *,
                           bin_size: int = 4, batch_size: int = 4,
                           miou_thresh: float = 0.7,
                           stability_score_thresh: float = 0.85,
                           n_max_tracks: int = 16,
                           gt_masklets: Optional[dict] = None,
                           output_dir_name: str = "gdino_tracks",
                           log: Callable[[str], None] = print) -> dict:
    """Pack several expressions of one video into shared propagation
    rounds: they share the encoded frame features (one device region) and
    their prompt batches fill the propagation batch's object slots
    together. Per-expression artifacts and censuses do not depend on the
    packing: one expression alone is the reference's per-expression run
    (generate_tokens_gdino.py:169-304)."""
    from sola_torch.trackgen import packed_engine

    jobs, extras = [], {}
    for expression_id in expression_ids:
        prompts, n_not_used, n_total = load_expression_prompts(
            prompt_path, video_id, bin_size, expression_id,
            stability_score_thresh)
        extras[expression_id] = (n_not_used, n_total)
        jobs.append(packed_engine.VideoJob(
            video_id=f"{video_id}/{expression_id}", state=state,
            prompts=prompts, n_frames=n_frames, batch_size=batch_size,
            miou_thresh=miou_thresh, n_max_tracks=n_max_tracks,
            scan_all_for_same_frame=False,
            on_track=make_on_track(track_root, output_dir_name, dataset,
                                   data_type, video_id, gt_masklets,
                                   expression_id)))
    censuses = packed_engine.generate_tracks_packed(predictor, jobs,
                                                    log=log)
    out = {}
    for expression_id, census in zip(expression_ids, censuses):
        census["n_not_used"], census["n_total"] = extras[expression_id]
        out[expression_id] = census
    return out


def run_video_packed(predictor, state, video_id: str, expression_ids: list,
                     prompt_path: str, track_root: str, dataset: str,
                     data_type: str, n_frames: int, *, expr_pack: int,
                     on_group: Optional[Callable[[dict], None]] = None,
                     **params) -> dict:
    """One encoded video of ``main --expr_pack N``: its expressions in
    groups of ``expr_pack``, each group through ``run_expressions_packed``
    (``params`` are its keyword arguments), each census given its fps;
    ``on_group(censuses)`` after each group. Returns every census."""
    out = {}
    for g0 in range(0, len(expression_ids), expr_pack):
        censuses = run_expressions_packed(
            predictor, state, video_id, expression_ids[g0:g0 + expr_pack],
            prompt_path, track_root, dataset, data_type, n_frames, **params)
        for census in censuses.values():
            census["fps"] = n_frames / max(census["time"], 1e-9)
        out.update(censuses)
        if on_group is not None:
            on_group(censuses)
    return out


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
                        help="expressions per packed propagation round: >1 "
                             "packs several expressions' prompt batches "
                             "into one SAM2 propagation batch over the "
                             "shared video features (results match)")
    parser.add_argument("--obj_batch", type=int, default=0,
                        help="SAM2 object slots per propagation pass; 0 = "
                             "batch_size (sequential) or 8 (packed)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the SAM2 predictor")
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--output_root", type=str, default=".")
    args = parser.parse_args(argv)

    assert args.data_type in meta_lib.DATA_TYPES[args.dataset]
    data_root = os.path.join(args.data_root, "datasets")
    prompt_dir = os.path.join(args.output_root, "sam2_prompts/gdino_prompts",
                              args.dataset, args.data_type)
    out_dir = os.path.join(args.output_root, "sam2_tracks/gdino_tracks",
                           args.dataset, args.data_type)
    track_root = os.path.join(args.output_root, "sam2_tracks")

    meta = meta_lib.load_meta(data_root, args.dataset, args.data_type)
    mask_dict = None
    if args.save_prec_rec_iou and args.dataset == "mevis":
        mask_dict = meta_lib.read_mask_dict(data_root, args.dataset,
                                            args.data_type)

    obj_batch = args.obj_batch or (
        args.batch_size if args.expr_pack <= 1 else 8)
    if predictor_factory is None:
        predictor_factory = _default_predictor_factory(
            args.sam2_ckpt, obj_batch, args.device)
    predictor = predictor_factory()

    runtime_path = os.path.join(out_dir, "runtime_info.json")
    done_snapshot = {}
    if os.path.exists(runtime_path):
        with open(runtime_path) as f:
            done_snapshot = json.load(f)
    # resume-aware work list: videos whose expressions are all done are
    # skipped up front so the look-ahead never encodes a finished video
    work = [v for i, (v, m) in enumerate(meta["videos"].items())
            if i % args.n_pids == args.pid
            and any(e not in done_snapshot.get(v, {})
                    for e in m["expressions"])]

    def frames_dir_of(video_id):
        return meta_lib.frames_dir(data_root, args.dataset, args.data_type,
                                   video_id)

    prefetcher = StatePrefetcher(predictor,
                                 enabled=bool(args.prefetch_videos))
    for (video_id,), (state,) in prefetcher.groups(work, 1, frames_dir_of):
        runtime_info = {}
        if os.path.exists(runtime_path):
            with open(runtime_path) as f:
                runtime_info = json.load(f)
        runtime_info.setdefault(video_id, {})

        def on_group(censuses, video_id=video_id, runtime_info=runtime_info):
            runtime_info[video_id].update(censuses)
            os.makedirs(out_dir, exist_ok=True)
            with open(runtime_path, "w") as f:
                json.dump(runtime_info, f, indent=4)

        gt_masklets = None
        if args.save_prec_rec_iou:
            gt_masklets = gt_utils.load_gt_masklets(
                data_root, args.dataset, args.data_type, video_id, meta,
                mask_dict, reshape=True)
        pending = [e for e in meta["videos"][video_id]["expressions"]
                   if e not in runtime_info[video_id]]
        run_video_packed(
            predictor, state, video_id, pending,
            os.path.join(prompt_dir, f"{video_id}.json"), track_root,
            args.dataset, args.data_type,
            len(os.listdir(frames_dir_of(video_id))),
            expr_pack=max(args.expr_pack, 1), on_group=on_group,
            bin_size=args.bin_size, batch_size=args.batch_size,
            miou_thresh=args.miou_thresh,
            stability_score_thresh=args.stability_score_thresh,
            n_max_tracks=args.n_max_tracks, gt_masklets=gt_masklets)
    prefetcher.close()


if __name__ == "__main__":
    main()
