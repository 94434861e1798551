"""Inference/export: threshold scores, merge selected masklets, write PNGs.

Counterpart of ``sola_tpu/eval/inference.py`` (inference.py:15-92): the
per-frame PNG masks (mask * 255) under
``<out>/<video_id>/<expression_id>/<frame>.png`` are the MeViS / Ref-YTVOS
leaderboard submission format.
"""

from __future__ import annotations

import os

import numpy as np

from sola_torch.data.dataset import get_loader_dict
from sola_torch.models.selection import SelectionModel
from sola_torch.models.text import build_text_encoder
from sola_torch.train.loop import eval_step, prepare_batch


def run_inference(model: SelectionModel, configs: dict, output_dir: str,
                  text_encoder=None, write_pngs: bool = True) -> dict:
    """Returns the pred_dict; writes PNG masks when ``write_pngs``. The
    model runs on the device it lives on."""
    device = next(model.parameters()).device
    text_encoder = text_encoder or build_text_encoder(configs["model"],
                                                      device)
    loader_dict = get_loader_dict(configs["dataset"], only_inference=True)
    pred_threshold = float(configs["eval"]["pred_threshold"])

    pred_dict: dict = {}
    for raw in loader_dict["test"]:
        batch = prepare_batch(raw, text_encoder, configs["train"], device)
        out = eval_step(model, batch, configs["train"], pred_threshold)
        preds = out["pred"].cpu().numpy()
        scores = out["pred_score"].cpu().numpy()
        for i, video_id in enumerate(raw["video_id"]):
            n = int(raw["n_tracks"][i])
            expression_id = raw["expression_id"][i]
            pred_dict.setdefault(video_id, {})[expression_id] = {
                "expression": raw["expression"][i],
                "pred": preds[i, :n],
                "pred_score": scores[i, :n],
                "root_type": raw["root_type"][i],
                "prompt_type": raw["prompt_type"][i],
                "sam2_anno_id": raw["sam2_anno_id"][i],
            }

    if write_pngs:
        from PIL import Image
        dataset = loader_dict["test"].dataset
        for video_id in pred_dict:
            frames = dataset.get_frames(video_id)
            for expression_id, pred_info in pred_dict[video_id].items():
                pred_masklet = dataset.get_sam2_masklet(
                    video_id=video_id, expression_id=expression_id,
                    preds=pred_info["pred"],
                    root_types=pred_info["root_type"],
                    prompt_types=pred_info["prompt_type"],
                    sam2_anno_ids=pred_info["sam2_anno_id"])
                assert pred_masklet is not None, (
                    f"pred_masklet is None for {video_id}/{expression_id}")
                out = os.path.join(output_dir, video_id, expression_id)
                os.makedirs(out, exist_ok=True)
                for frame_id, mask in zip(frames, pred_masklet):
                    img = (mask * 255).astype(np.uint8)
                    Image.fromarray(img).save(
                        os.path.join(out, f"{frame_id}.png"))
    return pred_dict
