"""Grid prompt generation: AMG proposals + part suppression -> prompt JSONs.

Counterpart of ``sola_tpu/trackgen/prompts_grid.py`` (the reference's
generate_prompts_grid.py): every ``bin_size``-th frame (or just 2 frames
when bin_size == 0, eval mode) runs the automatic mask generator; "part"
masks mostly contained in a larger mask (partness P > 0.7, utils.compute_P)
are suppressed; survivors are RLE-encoded, globally area-sorted, and
assigned prompt ids (generate_prompts_grid.py:100-137). The generator runs
on ``--device`` (CUDA by default).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sola_torch.core import mask_ops, rle
from sola_torch.data import meta as meta_lib
from sola_torch.device import resolve_device
from sola_torch.trackgen.tokens_grid import DATA_DIR_DICT


def suppress_parts(masks: np.ndarray, thresh: float = 0.7,
                   device="cpu") -> np.ndarray:
    """masks (N, H, W) sorted by area desc -> bool keep array.

    Reference semantics (generate_prompts_grid.py:105-116): walk masks from
    largest; each not-yet-suppressed mask marks every mask with partness
    P > thresh against it as a part (clearing itself).
    """
    n = masks.shape[0]
    is_part = np.zeros(n, bool)
    masks_t = torch.as_tensor(np.asarray(masks, np.float32), device=device)
    for i in range(n - 1):
        if is_part[i]:
            continue
        p = mask_ops.partness(masks_t, masks_t[i]).cpu().numpy()
        is_part[p > thresh] = True
        is_part[i] = False
    return ~is_part


def generate_video_prompts(amg, frames: list, frame_names: list,
                           video_id: str, bin_size: int,
                           partness_thresh: float = 0.7) -> dict:
    """Run AMG over binned frames of one video -> prompts JSON dict."""
    if bin_size > 0:
        eff_bin = bin_size
    else:
        eff_bin = max(len(frames) // 2, 1)
    sel = list(range(0, len(frames), eff_bin))
    # pipelined: frame k+1 encodes on the device while the host
    # post-processes frame k (sam2/amg.py generate_many)
    infos_iter = amg.generate_many(frames[fi] for fi in sel)

    prompt_masks = []
    for fi, infos in zip(sel, infos_iter):
        frame = frames[fi]
        frame_area = frame.shape[0] * frame.shape[1]
        if not infos:
            continue
        infos = sorted(infos, key=lambda x: x["area"], reverse=True)
        masks = np.stack([np.asarray(i["segmentation"], np.float32)
                          for i in infos], axis=0)
        keep = suppress_parts(masks, partness_thresh,
                               amg.predictor.device)
        for info, k in zip(infos, keep):
            if not k:
                continue
            prompt_masks.append({
                "segmentation": rle.encode(
                    np.asarray(info["segmentation"], np.uint8)),
                "stability_score": float(info["stability_score"]),
                "area": int(info["area"]),
                "area_ratio": float(info["area"]) / frame_area,
                "frame_idx": fi,
            })

    prompt_masks.sort(key=lambda x: x["area"], reverse=True)
    for prompt_id, pm in enumerate(prompt_masks):
        pm["prompt_id"] = prompt_id
    return {"video_id": video_id, "bin_size": eff_bin,
            "prompt_masks": prompt_masks}


def main(argv=None, amg_factory=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mevis")
    parser.add_argument("--data_type", type=str, default="valid_u")
    parser.add_argument("--bin_size", type=int, default=8)
    parser.add_argument("--sam2_cfg", type=str, default=None,
                        help="accepted for reference CLI compatibility; the architecture is code-defined")
    parser.add_argument("--sam2_ckpt", type=str,
                        default="pretrained_models/sam2_hiera_large.pt")
    parser.add_argument("--pid", type=int, default=0)
    parser.add_argument("--n_pids", "--n_pid", dest="n_pids",
                        type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the SAM2 mask generator")
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--output_root", type=str, default=".")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    assert args.data_type in meta_lib.DATA_TYPES[args.dataset]
    data_dir = os.path.join(args.data_root, DATA_DIR_DICT[args.dataset],
                            args.data_type, "JPEGImages")
    prompt_dir = os.path.join(args.output_root, "sam2_prompts/grid_prompts",
                              args.dataset, args.data_type)
    os.makedirs(prompt_dir, exist_ok=True)

    if amg_factory is None:
        def amg_factory():
            from sola_torch.trackgen.sam2.amg import \
                SAM2AutomaticMaskGenerator
            from sola_torch.trackgen.sam2.convert import \
                load_sam2_image_predictor
            return SAM2AutomaticMaskGenerator(
                load_sam2_image_predictor(args.sam2_ckpt, device=device))
    amg = amg_factory()

    from PIL import Image
    videos = sorted(os.listdir(data_dir))[args.pid::args.n_pids]
    for video_id in videos:
        out_path = os.path.join(prompt_dir, f"{video_id}.json")
        if os.path.exists(out_path):
            continue  # resumability (generate_prompts_grid.py:74-75)
        names = sorted(os.listdir(os.path.join(data_dir, video_id)))
        frames = [np.asarray(Image.open(
            os.path.join(data_dir, video_id, n)).convert("RGB"))
            for n in names]
        info = generate_video_prompts(amg, frames, names, video_id,
                                      args.bin_size)
        with open(out_path, "w") as f:
            json.dump(info, f, indent=4)


if __name__ == "__main__":
    main()
