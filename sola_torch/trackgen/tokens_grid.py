"""Grid-prompt token generation: prompts JSON -> tracked masklets + tokens.

Library + CLI port of generate_tokens_grid.py: loads per-video grid prompt
JSONs (sam2_prompts/grid_prompts layout), runs the tracking engine over a
video predictor, and writes sam2_tracks/grid_tracks artifacts plus
``runtime_info_{bin}.json`` (generate_tokens_grid.py:280-307).

Canonical sharding flags are ``--pid/--n_pids`` (the reference mixes
``--n_pid``/``args.n_pids`` and crashes, SURVEY.md §2.5). Counterpart of
``sola_tpu/trackgen/tokens_grid.py``: the predictor runs on ``--device``
(CUDA by default); ``--video_pack N`` packs N videos' prompt batches into
shared propagation rounds (``packed_engine``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional


from sola_torch.core import rle
from sola_torch.data import meta as meta_lib
from sola_torch.data import tracks as tracks_lib
from sola_torch.trackgen import engine, gt_utils
from sola_torch.trackgen.prefetch import StatePrefetcher
from sola_torch.utils import profiling

def load_prompt_masks(prompt_path: str, video_id: str,
                      bin_size: int, exact_bin: bool = False):
    """Parse a prompts JSON into engine PromptMask objects + raw infos."""
    with open(prompt_path, "r") as f:
        info = json.load(f)
    assert info["video_id"] == video_id, (
        f"video id mismatch: {info['video_id']} != {video_id}")
    if exact_bin:
        assert bin_size == info["bin_size"], (
            f"bin size mismatch: {bin_size} != {info['bin_size']}")
    else:
        assert bin_size % info["bin_size"] == 0, (
            f"bin size mismatch: {bin_size} % {info['bin_size']} != 0")
    raw = info["prompt_masks"]
    prompts = [
        engine.PromptMask(
            prompt_id=p["prompt_id"],
            frame_idx=int(p["frame_idx"]),
            segmentation=rle.decode(p["segmentation"]),
        )
        for p in raw
    ]
    return prompts, raw


def run_video(predictor, video_id: str, frames_dir: str, prompt_path: str,
              output_root: str, dataset: str, data_type: str, *,
              bin_size: int = 4, batch_size: int = 4,
              miou_thresh: float = 0.7, n_max_tracks: int = 64,
              gt_masklets: Optional[dict] = None,
              output_dir_name: str = "grid_tracks",
              log: Callable[[str], None] = print,
              state: Optional[object] = None,
              track_root: Optional[str] = None) -> dict:
    """``output_root`` is <track_root>/<output_dir_name>/<dataset>/<type>;
    pass ``track_root`` explicitly to skip the path derivation."""
    if frames_dir is not None:
        n_frames = len(os.listdir(frames_dir))
    elif state is not None:
        n_frames = state.num_frames
    else:
        raise ValueError("need frames_dir or a pre-initialized state")
    with profiling.span("trackgen.track"):
        prompts, _ = load_prompt_masks(prompt_path, video_id, bin_size)
        n_not_used = engine.mark_not_used(prompts, bin_size)
    if state is None:
        state = predictor.init_state(None, video_path=frames_dir)

    if track_root is None:
        track_root = os.path.dirname(os.path.dirname(os.path.dirname(
            output_root)))

    census = engine.generate_tracks(
        predictor, state, prompts,
        n_frames=n_frames, batch_size=batch_size, miou_thresh=miou_thresh,
        n_max_tracks=n_max_tracks,
        on_track=make_on_track(track_root, output_dir_name, dataset,
                               data_type, video_id, gt_masklets),
        log=log)
    census["n_not_used"] = n_not_used
    if census["n_tracked"] < n_max_tracks:
        assert not census["not_tracked_prompt_ids"], (
            f"untracked prompts remain: {census['not_tracked_prompt_ids']}")
    return census


def make_on_track(track_root, output_dir_name, dataset, data_type,
                  video_id, gt_masklets, expression_id=None):
    """The engines' ``on_track`` of the grid and gdino routes: each track's
    RLE and tokens (and its prec/rec/iou against ``gt_masklets``) written
    under ``<video>``, or ``<video>/<expression_id>`` for gdino."""
    @profiling.spanned("trackgen.emit")
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
    return on_track


def run_videos_packed(predictor, video_ids, frames_dirs, prompt_paths,
                      output_root, dataset, data_type, *,
                      bin_size: int = 4, batch_size: int = 4,
                      miou_thresh: float = 0.7, n_max_tracks: int = 64,
                      gt_masklets_by_video: Optional[dict] = None,
                      output_dir_name: str = "grid_tracks",
                      log: Callable[[str], None] = print,
                      states: Optional[dict] = None,
                      track_root: Optional[str] = None) -> dict:
    """Pack several videos into shared propagation rounds
    (packed_engine.generate_tracks_packed): slots the per-video batches
    would leave idle carry other videos' objects. Artifacts and censuses
    match per-video ``run_video`` calls."""
    from sola_torch.trackgen import packed_engine
    if track_root is None:
        track_root = os.path.dirname(os.path.dirname(os.path.dirname(
            output_root)))
    jobs = []
    n_not_used = {}
    for video_id, frames_dir, prompt_path in zip(video_ids, frames_dirs,
                                                 prompt_paths):
        with profiling.span("trackgen.track"):
            prompts, _ = load_prompt_masks(prompt_path, video_id, bin_size)
            n_not_used[video_id] = engine.mark_not_used(prompts, bin_size)
        state = (states or {}).get(video_id)
        if state is None:
            state = predictor.init_state(None, video_path=frames_dir)
        gt = (gt_masklets_by_video or {}).get(video_id)
        jobs.append(packed_engine.VideoJob(
            video_id=video_id, state=state, prompts=prompts,
            n_frames=state.num_frames, batch_size=batch_size,
            miou_thresh=miou_thresh, n_max_tracks=n_max_tracks,
            on_track=make_on_track(track_root, output_dir_name, dataset,
                                   data_type, video_id, gt)))
    censuses = packed_engine.generate_tracks_packed(predictor, jobs,
                                                    log=log)
    out = {}
    for job, census in zip(jobs, censuses):
        census["n_not_used"] = n_not_used[job.video_id]
        if census["n_tracked"] < n_max_tracks:
            assert not census["not_tracked_prompt_ids"], (
                f"untracked prompts remain in {job.video_id}: "
                f"{census['not_tracked_prompt_ids']}")
        out[job.video_id] = census
    return out


@profiling.device_trace()
def main(argv=None, predictor_factory=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mevis")
    parser.add_argument("--data_type", type=str, default="valid_u")
    parser.add_argument("--bin_size", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--miou_thresh", type=float, default=0.7)
    parser.add_argument("--n_max_tracks", type=int, default=64)
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
    parser.add_argument("--video_pack", type=int, default=1,
                        help="videos per packed propagation round: >1 packs "
                             "several videos' prompt batches into one SAM2 "
                             "propagation batch (results match sequential)")
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
    prompt_dir = os.path.join(args.output_root, "sam2_prompts/grid_prompts",
                              args.dataset, args.data_type)
    out_dir = os.path.join(args.output_root, "sam2_tracks/grid_tracks",
                           args.dataset, args.data_type)

    meta = meta_lib.load_meta(data_root, args.dataset, args.data_type)
    mask_dict = None
    if args.save_prec_rec_iou and args.dataset == "mevis":
        mask_dict = meta_lib.read_mask_dict(data_root, args.dataset,
                                            args.data_type)

    packed = args.video_pack > 1
    obj_batch = args.obj_batch or (8 if packed else args.batch_size)
    if predictor_factory is None:
        predictor_factory = _default_predictor_factory(args.sam2_ckpt,
                                                       obj_batch, args.device)
    predictor = predictor_factory()

    runtime_info = {}
    runtime_path = os.path.join(out_dir, f"runtime_info_{args.bin_size}.json")
    work = [v for i, v in enumerate(meta["videos"])
            if i % args.n_pids == args.pid]

    def frames_dir_of(video_id: str) -> str:
        return meta_lib.frames_dir(data_root, args.dataset, args.data_type,
                                   video_id)

    def gt_for(video_id: str):
        if not args.save_prec_rec_iou:
            return None
        return gt_utils.load_gt_masklets(data_root, args.dataset,
                                         args.data_type, video_id, meta,
                                         mask_dict, reshape=True)

    kw = dict(bin_size=args.bin_size, batch_size=args.batch_size,
              miou_thresh=args.miou_thresh, n_max_tracks=args.n_max_tracks)
    prefetcher = StatePrefetcher(predictor,
                                 enabled=bool(args.prefetch_videos))
    for group, states in prefetcher.groups(
            work, args.video_pack if packed else 1, frames_dir_of):
        if packed:
            runtime_info.update(run_videos_packed(
                predictor, group, [frames_dir_of(v) for v in group],
                [os.path.join(prompt_dir, f"{v}.json") for v in group],
                out_dir, args.dataset, args.data_type,
                gt_masklets_by_video={v: gt_for(v) for v in group},
                states=dict(zip(group, states)), **kw))
        else:
            video_id, = group
            start = time.time()
            census = run_video(
                predictor, video_id, frames_dir_of(video_id),
                os.path.join(prompt_dir, f"{video_id}.json"),
                out_dir, args.dataset, args.data_type,
                gt_masklets=gt_for(video_id), state=states[0], **kw)
            census["time"] = time.time() - start
            runtime_info[video_id] = census
        os.makedirs(out_dir, exist_ok=True)
        with open(runtime_path, "w") as f:
            json.dump(runtime_info, f, indent=4)
    prefetcher.close()


def _default_predictor_factory(ckpt_path: str, obj_batch: int = 4,
                               device: str = "cuda", seed: int = 0):
    """SAM2 video predictor factory of the track-generation CLIs; ``seed``
    draws the random weights when ``ckpt_path`` does not exist."""
    def factory():
        from sola_torch.trackgen.sam2.convert import load_sam2_video_predictor
        return load_sam2_video_predictor(ckpt_path, obj_batch=obj_batch,
                                         device=device, seed=seed)
    return factory


if __name__ == "__main__":
    main()
