"""GT-prompted token generation (training labels).

Counterpart of ``sola_tpu/trackgen/tokens_gt.py``
(generate_tokens_GT_{mevis,ytbvos}.py): each GT object yields one seed per
appearance onset (gt_utils.get_prompt_masks, the function the reference
calls but never defines, SURVEY.md §2.5); each seed is a slot of a
bidirectional ``PackedPropagator`` round and saved as a ``gt_tracks``
artifact named by a running (object, seed) counter with ``prompt_type: "GT
MASK"``, the reference's output scheme (generate_tokens_GT_mevis.py:95-160;
not keyed by GT anno id: that mapping lives in runtime_info's
``gt_anno_id`` field). ``--video_pack N`` packs N videos' seeds into shared
rounds; the default, one video and one slot a round, is the reference's
one seed a pass. The predictor runs on ``--device`` (CUDA by default).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np

from sola_torch.core import rle
from sola_torch.data import meta as meta_lib
from sola_torch.data import tracks as tracks_lib
from sola_torch.trackgen import gt_utils
from sola_torch.trackgen.prefetch import StatePrefetcher
from sola_torch.utils import profiling


def gt_seed_units(gt_masklets: dict) -> list:
    """[(out_anno_id, gt_anno_id, seed)] in the reference's output order:
    GT objects in dict order, seeds in onset order, one running counter
    (the artifact files are named by this counter, not the GT anno id;
    generate_tokens_GT_mevis.py:95-160)."""
    units = []
    out_id = 0
    for gt_anno_id, gt in gt_masklets.items():
        seeds = gt_utils.get_prompt_masks(gt)
        assert seeds, f"GT masklet for anno {gt_anno_id} is empty"
        for seed in seeds:
            units.append((out_id, gt_anno_id, seed))
            out_id += 1
    return units


@profiling.spanned("trackgen.emit")
def _save(track_root, output_dir_name, dataset, data_type, video_id,
          out_id, out, gt_masklets, save_prec_rec_iou) -> None:
    metrics = None
    if save_prec_rec_iou:
        # the GT scripts score at full resolution (no reshape_masklet,
        # unlike the grid/gdino paths; generate_tokens_GT_mevis.py:142-155
        # compares pred_masklet to the raw decoded GT)
        metrics = gt_utils.metrics_vs_gt(out["masklet"], gt_masklets)
    tracks_lib.save_track(
        track_root, output_dir_name, dataset, data_type, video_id, out_id,
        rle.encode_masklet(out["masklet"]), "GT MASK", out["tokens"],
        metrics=metrics)


def _entry(elapsed, n_frames, gt_anno_id, seed) -> dict:
    return {"time": elapsed, "n_frames": n_frames,
            "gt_anno_id": str(gt_anno_id),
            "seed_frame": int(seed["frame_idx"])}


@profiling.spanned("trackgen.track")
def run_videos_packed_gt(predictor, items, track_root: str, dataset: str,
                         data_type: str, *, save_prec_rec_iou: bool = False,
                         output_dir_name: str = "gt_tracks",
                         log: Callable[[str], None] = print) -> dict:
    """Pack several videos' GT seeds into shared propagation rounds.

    The reference tracks one seed per propagation pass
    (generate_tokens_GT_mevis.py:110-116, obj_id=0), one slot of the
    object batch. Every seed is a single-cond (video, object) slot, so
    ``PackedPropagator`` rounds carry up to ``obj_batch`` of them at once,
    across videos and across a re-appearing object's onsets. Artifacts do
    not depend on the packing: at ``obj_batch`` 1 and one video a call,
    each round is the reference's per-seed pass.

    ``items``: [{"video_id", "state", "gt_masklets", "n_frames"}], states
    already encoded.
    """
    from sola_torch.trackgen.packed_engine import _resize_prompt
    from sola_torch.trackgen.sam2.packed import (PackedFeatures,
                                                 PackedPropagator, SlotPlan)
    b = predictor.obj_batch
    size = predictor.cfg.image_size
    prop = PackedPropagator(predictor)
    pack = PackedFeatures.build([it["state"] for it in items])
    censuses = {it["video_id"]: {} for it in items}

    units = [(vi, out_id, gt_anno_id, seed)
             for vi, it in enumerate(items)
             for out_id, gt_anno_id, seed in gt_seed_units(
                 it["gt_masklets"])]
    # longest first: a round runs as many steps as its longest slot, so
    # grouping similar lengths leaves fewer idle steps (packed_engine's
    # policy). Artifacts are per seed and do not depend on the grouping.
    units.sort(key=lambda u: -items[u[0]]["n_frames"])

    for g0 in range(0, len(units), b):
        group = units[g0:g0 + b]
        start = time.time()
        video = np.full((b,), -1, np.int64)
        cond = np.zeros((b,), np.int64)
        length = np.ones((b,), np.int64)
        cond_masks = np.zeros((b, size, size), np.float32)
        for s, (vi, out_id, gt_anno_id, seed) in enumerate(group):
            video[s] = vi
            cond[s] = seed["frame_idx"]
            length[s] = items[vi]["n_frames"]
            cond_masks[s] = _resize_prompt(seed["mask"], size)
        log(f"gt pack: {len(group)}/{b} slots from "
            f"{sorted({items[vi]['video_id'] for vi, _, _, _ in group})}")
        out = prop.run_round(
            pack, SlotPlan(video=video, cond=cond, length=length),
            cond_masks)
        # per-seed cost: the round's wall time is shared by its slots, as
        # sequential runs report per-seed times
        share = (time.time() - start) / max(len(group), 1)
        for s, (vi, out_id, gt_anno_id, seed) in enumerate(group):
            it = items[vi]
            t = it["n_frames"]
            res = {"masklet": np.stack(
                       [np.asarray(out["masks"][s][f], np.uint8)
                        for f in range(t)], axis=0),
                   "tokens": np.stack(
                       [np.asarray(out["tokens"][s][f], np.float32)
                        for f in range(t)], axis=0)}
            _save(track_root, output_dir_name, dataset, data_type,
                  it["video_id"], out_id, res, it["gt_masklets"],
                  save_prec_rec_iou)
            censuses[it["video_id"]][str(out_id)] = _entry(
                share, t, gt_anno_id, seed)
    return censuses


@profiling.device_trace()
def main(argv=None, predictor_factory=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mevis",
                        choices=["mevis", "ref-ytbvos", "ref-davis"])
    parser.add_argument("--data_type", type=str, default="train")
    parser.add_argument("--sam2_cfg", type=str, default=None,
                        help="accepted for reference CLI compatibility; the architecture is code-defined")
    parser.add_argument("--sam2_ckpt", type=str,
                        default="pretrained_models/sam2_hiera_large.pt")
    parser.add_argument("--save_prec_rec_iou", action="store_true")
    parser.add_argument("--pid", type=int, default=0)
    parser.add_argument("--prefetch_videos", type=int, default=1,
                        help="encode the next video while the current one "
                             "propagates (0 to serialize)")
    parser.add_argument("--video_pack", type=int, default=1,
                        help="videos per packed GT round: >1 packs several "
                             "videos' single-seed GT objects into one SAM2 "
                             "propagation batch (the reference runs "
                             "obj_id=0 alone per pass; results match)")
    parser.add_argument("--obj_batch", type=int, default=0,
                        help="SAM2 object slots per propagation pass; 0 = 1 "
                             "(sequential) or 8 (packed)")
    parser.add_argument("--n_pids", "--n_pid", dest="n_pids",
                        type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the SAM2 predictor")
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--output_root", type=str, default=".")
    args = parser.parse_args(argv)

    assert args.data_type in meta_lib.DATA_TYPES[args.dataset]
    data_root = os.path.join(args.data_root, "datasets")
    track_root = os.path.join(args.output_root, "sam2_tracks")
    out_dir = os.path.join(track_root, "gt_tracks", args.dataset,
                           args.data_type)

    meta = meta_lib.load_meta(data_root, args.dataset, args.data_type)
    mask_dict = None
    if args.dataset == "mevis":
        mask_dict = meta_lib.read_mask_dict(data_root, args.dataset,
                                            args.data_type)

    pack = max(args.video_pack, 1)
    obj_batch = args.obj_batch or (1 if pack == 1 else 8)
    if predictor_factory is None:
        from sola_torch.trackgen.tokens_grid import _default_predictor_factory
        predictor_factory = _default_predictor_factory(
            args.sam2_ckpt, obj_batch, args.device)
    predictor = predictor_factory()

    runtime_path = os.path.join(out_dir, "runtime_info.json")
    runtime_info = {}
    if os.path.exists(runtime_path):
        with open(runtime_path) as f:
            runtime_info = json.load(f)

    work = [v for i, v in enumerate(meta["videos"])
            if i % args.n_pids == args.pid and v not in runtime_info]

    def frames_dir_of(video_id):
        return meta_lib.frames_dir(data_root, args.dataset, args.data_type,
                                   video_id)

    prefetcher = StatePrefetcher(predictor,
                                 enabled=bool(args.prefetch_videos))
    for group, states in prefetcher.groups(work, pack, frames_dir_of):
        items = [{"video_id": vid, "state": state,
                  "gt_masklets": gt_utils.load_gt_masklets(
                      data_root, args.dataset, args.data_type, vid, meta,
                      mask_dict, reshape=False),
                  "n_frames": len(os.listdir(frames_dir_of(vid)))}
                 for vid, state in zip(group, states)]
        runtime_info.update(run_videos_packed_gt(
            predictor, items, track_root, args.dataset, args.data_type,
            save_prec_rec_iou=args.save_prec_rec_iou))
        os.makedirs(out_dir, exist_ok=True)
        with open(runtime_path, "w") as f:
            json.dump(runtime_info, f, indent=4)
    prefetcher.close()


if __name__ == "__main__":
    main()
