"""GroundingDINO prompt generation: text -> boxes -> SAM2 masks -> JSONs.

Counterpart of ``sola_tpu/trackgen/prompts_gdino.py`` (prompt_generator.py +
generate_prompts_gdino.py): per video, per binned frame, per expression, the
grounding model proposes boxes above ``box_threshold``; SAM2's image
predictor turns each box into a mask with a mask score and a stability
score; prompts are tagged with expression_id (and, when GT is available,
per-anno IoU), area-sorted, and given prompt ids.

The grounding model comes from a factory implementing ``get_boxes(image,
text) -> [{"bbox": xyxy, "phrase": str, "token_score": [...]}]``, which the
port's GroundingDINO (``trackgen.gdino.model.GroundingModel``) or a test fake
satisfies. The models run on ``--device`` (CUDA by default).

Spans: ``trackgen.grounding`` (the grounding forward's host issue),
``trackgen.grounding_post`` (its fetch, sigmoid, gates and phrases) and
``trackgen.box_prompt`` (SAM2's box -> mask call); counters
``trackgen.grounded_pairs`` ((frame, expression) pairs grounded) and
``trackgen.boxes`` (boxes over ``box_threshold``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from sola_torch.core import mask_ops, rle
from sola_torch.data import meta as meta_lib
from sola_torch.trackgen.sam2.image import compute_stability_score
from sola_torch.utils import profiling


def normalize_expression(text: str) -> str:
    """lowercase, strip, ensure trailing period (prompt_generator.py:127-130)."""
    text = text.lower().strip()
    if not text.endswith("."):
        text += "."
    return text


class PromptGenerator:
    """Grounded box -> mask prompt generation over one image."""

    def __init__(self, grounding_model, sam2_image_predictor,
                 box_threshold: float = 0.2, text_threshold: float = 0.25):
        self.grounding = grounding_model
        self.sam2 = sam2_image_predictor
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold

    def generate_prompts(self, image: np.ndarray,
                         raw_texts: Sequence[str]) -> dict:
        """Returns {text_idx: {"expression", "preds": [{"phrase", "bbox",
        "token_score", "sam2_mask", "mask_score", "stability_score"}]}}."""
        return self.harvest(self.enqueue(image, raw_texts))

    def enqueue(self, image: np.ndarray, raw_texts: Sequence[str]):
        """Device phase: launch this frame's GroundingDINO forward(s) and
        the SAM2 image encode without fetching any result, so the next
        frame's work can be enqueued before this frame's results are read
        (one-frame look-ahead in ``generate_video_prompts``)."""
        texts = [normalize_expression(t) for t in raw_texts]
        pending_g = None
        if hasattr(self.grounding, "enqueue_boxes"):
            # one forward for all expressions of the frame: the Swin trunk
            # runs once, the text-fused encoder/decoder batch over
            # expressions (the reference pays a full forward per (frame,
            # expression), prompt_generator.py:132-140)
            with profiling.span("trackgen.grounding"):
                pending_g = self.grounding.enqueue_boxes(image, texts)
        self.sam2.set_image(image)
        feats = (self.sam2.snapshot_features()
                 if hasattr(self.sam2, "snapshot_features") else None)
        return (image, texts, pending_g, feats)

    def harvest(self, pending) -> dict:
        image, texts, pending_g, feats = pending
        # restore this frame's cached features (a later enqueue may have
        # replaced them with the next frame's); fake predictors without the
        # snapshot surface are stateless per predict call
        if feats is not None:
            self.sam2.restore_features(feats)
        if pending_g is not None:
            with profiling.span("trackgen.grounding_post"):
                preds_many = self.grounding.harvest_boxes(
                    pending_g, box_threshold=self.box_threshold,
                    text_threshold=self.text_threshold)
        else:
            with profiling.span("trackgen.grounding"):
                preds_many = [self.grounding.get_boxes(
                    image, t, box_threshold=self.box_threshold,
                    text_threshold=self.text_threshold) for t in texts]

        outputs = {}
        for text_idx, (text, preds) in enumerate(zip(texts, preds_many)):
            outputs[str(text_idx)] = {"expression": text, "preds": preds}
        # one box -> mask call for every expression's boxes
        flat = [(ti, p) for ti, preds in enumerate(preds_many)
                for p in preds]
        profiling.count("trackgen.grounded_pairs", len(texts))
        profiling.count("trackgen.boxes", len(flat))
        if flat:
            boxes = np.stack([p["bbox"] for _, p in flat], axis=0)
            with profiling.span("trackgen.box_prompt"):
                masks, scores, stabs = self._box_masks(boxes)
            for i, (_, pred) in enumerate(flat):
                pred.update({
                    "sam2_mask": masks[i],
                    "mask_score": float(scores[i]),
                    "stability_score": float(stabs[i]),
                })
        return outputs

    def _box_masks(self, boxes: np.ndarray):
        """(masks (N, H, W), mask scores (N,), stability scores (N,)) of
        SAM2's single-mask prediction for N xyxy boxes."""
        if hasattr(self.sam2, "predict_packed"):
            # bit-packed mask fetch + stability on the device
            return self.sam2.predict_packed(box=boxes)
        masks, scores, logits = self.sam2.predict(box=boxes,
                                                  multimask_output=False)
        if masks.ndim >= 4:
            masks = masks[:, 0]
            scores = scores[:, 0]
            logits = logits[:, 0]
        return masks, scores, [compute_stability_score(lg) for lg in logits]


def generate_video_prompts(prompt_generator: PromptGenerator, frames: list,
                           video_id: str, expressions: dict, bin_size: int,
                           gt_masklets: Optional[dict] = None,
                           anno_ids_by_expr: Optional[dict] = None) -> dict:
    """Run grounded prompting over binned frames -> prompts JSON dict
    (schema of generate_prompts_gdino.py:206-213)."""
    eff_bin = bin_size if bin_size > 0 else max(len(frames) // 2, 1)
    sel = list(range(0, len(frames), eff_bin))
    expr_ids = list(expressions.keys())
    texts = [expressions[e]["exp"] for e in expr_ids]

    # one-frame look-ahead: frame k+1's GroundingDINO forward and SAM2
    # encode are enqueued before frame k's results are fetched (needs the
    # real predictors' enqueue / feature-cache surface; test fakes run
    # sequentially)
    can_pipeline = (hasattr(prompt_generator.grounding, "enqueue_boxes")
                    and hasattr(prompt_generator.sam2, "snapshot_features"))

    def frame_outputs():
        if not can_pipeline:
            for fi in sel:
                yield fi, prompt_generator.generate_prompts(frames[fi],
                                                            texts)
            return
        prev = None
        for fi in sel:
            cur = (fi, prompt_generator.enqueue(frames[fi], texts))
            if prev is not None:
                yield prev[0], prompt_generator.harvest(prev[1])
            prev = cur
        if prev is not None:
            yield prev[0], prompt_generator.harvest(prev[1])

    prompt_masks = []
    for fi, outputs in frame_outputs():
        frame = frames[fi]
        frame_area = frame.shape[0] * frame.shape[1]
        for text_idx, expr_id in enumerate(expr_ids):
            for pred in outputs[str(text_idx)]["preds"]:
                if "sam2_mask" not in pred:
                    continue
                mask = np.asarray(pred["sam2_mask"], np.uint8)
                has_gt = (gt_masklets is not None
                          and anno_ids_by_expr is not None)
                # reference schema (generate_prompts_gdino.py:177-204):
                # pred_bbox/pred_phrase/score names, nested per-anno
                # "metrics" with iou 0.0 when the GT frame is absent, and a
                # float "area" on the GT branch vs int otherwise (the
                # reference's .item() on a float tensor sum vs int())
                entry = {
                    "segmentation": rle.encode(mask),
                    "stability_score": pred.get("stability_score", 0.0),
                    "score": pred.get("mask_score", 0.0),
                    "area": (float(mask.sum()) if has_gt
                             else int(mask.sum())),
                    "area_ratio": float(mask.sum()) / frame_area,
                    "frame_idx": fi,
                    "pred_bbox": np.asarray(pred["bbox"]).tolist(),
                    "pred_phrase": pred.get("phrase", ""),
                    "token_score": pred.get("token_score", []),
                    "expression_id": expr_id,
                    "metrics": {},
                }
                if has_gt:
                    for anno_id in anno_ids_by_expr.get(expr_id, []):
                        gt = gt_masklets.get(str(anno_id),
                                             gt_masklets.get(anno_id))
                        row = None if gt is None else gt[fi]
                        if row is None:
                            entry["metrics"][str(anno_id)] = {"iou": 0.0}
                            continue
                        if isinstance(row, dict):  # lazy RLE row
                            row = rle.decode(row)
                        entry["metrics"][str(anno_id)] = {"iou": float(
                            mask_ops.mask_iou(
                                mask.astype(np.float32),
                                np.asarray(row, np.float32)))}
                prompt_masks.append(entry)

    prompt_masks.sort(key=lambda x: x["area"], reverse=True)
    for prompt_id, pm in enumerate(prompt_masks):
        pm["prompt_id"] = prompt_id
    return {"video_id": video_id, "bin_size": eff_bin,
            "prompt_masks": prompt_masks}


def main(argv=None, generator_factory=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mevis")
    parser.add_argument("--data_type", type=str, default="valid_u")
    parser.add_argument("--bin_size", type=int, default=4)
    parser.add_argument("--box_threshold", type=float, default=0.2)
    parser.add_argument("--text_threshold", type=float, default=0.25)
    parser.add_argument("--sam2_cfg", type=str, default=None,
                        help="accepted for reference CLI compatibility; the architecture is code-defined")
    parser.add_argument("--sam2_ckpt", type=str,
                        default="pretrained_models/sam2_hiera_large.pt")
    parser.add_argument("--gdino_cfg", type=str, default=None,
                        help="accepted for reference CLI compatibility; the architecture is code-defined")
    parser.add_argument("--gdino_ckpt", type=str,
                        default="pretrained_models/groundingdino_swint_ogc.pth")
    parser.add_argument("--save_iou", action="store_true",
                        help="accepted for backward compatibility; GT "
                             "IoU tagging is automatic exactly when the "
                             "reference's is (mevis train/valid_u, "
                             "generate_prompts_gdino.py:99-104)")
    # bf16 compute for the grounding forward (fp32 default = upstream parity)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--pid", type=int, default=0)
    parser.add_argument("--n_pids", "--n_pid", dest="n_pids",
                        type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of GroundingDINO and SAM2")
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--output_root", type=str, default=".")
    args = parser.parse_args(argv)

    assert args.data_type in meta_lib.DATA_TYPES[args.dataset]
    data_root = os.path.join(args.data_root, "datasets")
    prompt_dir = os.path.join(args.output_root, "sam2_prompts/gdino_prompts",
                              args.dataset, args.data_type)
    os.makedirs(prompt_dir, exist_ok=True)

    meta = meta_lib.load_meta(data_root, args.dataset, args.data_type)
    mask_dict = meta_lib.load_mask_dict(data_root, args.dataset,
                                        args.data_type)

    if generator_factory is None:
        generator_factory = _default_generator_factory(args)
    generator = generator_factory()

    video_ids = list(meta["videos"].keys())
    for video_idx, video_id in enumerate(video_ids):
        if video_idx % args.n_pids != args.pid:
            continue
        out_path = os.path.join(prompt_dir, f"{video_id}.json")
        if os.path.exists(out_path):
            continue
        prompt_video(generator,
                     meta_lib.frames_dir(data_root, args.dataset,
                                         args.data_type, video_id),
                     video_id, meta["videos"][video_id]["expressions"],
                     args.bin_size, out_path, mask_dict)


def prompt_video(generator: PromptGenerator, frames_dir: str, video_id: str,
                 expressions: dict, bin_size: int, out_path: str,
                 mask_dict: Optional[dict] = None) -> dict:
    """One video of ``main``: decode its frames, run
    ``generate_video_prompts`` (tagged with GT IoUs when ``mask_dict`` is
    given) and write the prompts JSON to ``out_path``; returns it."""
    from PIL import Image
    names = sorted(os.listdir(frames_dir))
    frames = [np.array(Image.open(
        os.path.join(frames_dir, n)).convert("RGB")) for n in names]
    gt_masklets = None
    anno_ids_by_expr = None
    if mask_dict is not None:
        gt_masklets = {}
        anno_ids_by_expr = {}
        for expr_id, em in expressions.items():
            anno_ids_by_expr[expr_id] = em.get("anno_id", [])
            for anno_id in em.get("anno_id", []):
                if str(anno_id) not in gt_masklets:
                    # raw RLE rows, decoded lazily per visited frame (the
                    # reference decodes only binned frames,
                    # generate_prompts_gdino.py:158-165); absent frames
                    # stay None, which the reference scores iou 0.0
                    gt_masklets[str(anno_id)] = mask_dict[str(anno_id)]
    info = generate_video_prompts(generator, frames, video_id, expressions,
                                  bin_size, gt_masklets, anno_ids_by_expr)
    with open(out_path, "w") as f:
        json.dump(info, f, indent=4)
    return info


def _default_generator_factory(args):
    def factory():
        import torch

        from sola_torch.trackgen.gdino.model import load_grounding_dino
        from sola_torch.trackgen.sam2.convert import \
            load_sam2_image_predictor
        return PromptGenerator(
            load_grounding_dino(
                args.gdino_ckpt, device=args.device,
                compute_dtype=torch.bfloat16 if args.bf16 else None),
            load_sam2_image_predictor(args.sam2_ckpt, device=args.device),
            box_threshold=args.box_threshold,
            text_threshold=args.text_threshold)
    return factory


if __name__ == "__main__":
    main()
