"""Evaluator: selection metrics + J&F over merged masklets.

Counterpart of ``sola_tpu/eval/evaluator.py`` (the reference Evaluator,
evaluator.py:15-247): a validation pass collecting losses, confusion
counts, and score distributions; then per (video, expression) the selected
tracks' masklets are OR-merged and scored against the OR-merged GT with J
(per-frame IoU, union==0 -> 1) and pixel F (tp==0 -> 0). Two JSON artifacts
are written with the reference's filenames and schemas:
``{split}_metrics_{epoch}epoch.json`` and
``{split}_JF_metrics_{epoch}epoch.json`` (evaluator.py:171-172,224-225).

J&F runs on the model's device over (T, H, W) uint8 masklets
(``mask_ops.compute_JF``); RLE decode runs on a host thread one expression
ahead, so it overlaps the device.

In a process group each process scores its ``shard_for_host`` share of the
valid batches (batch i on process i % n); the confusion counts go through
``all_sum``, the per-batch records are gathered to rank 0 in batch order,
and rank 0 computes J&F and writes the JSONs, so the result equals one
process's. (``sola_tpu``'s evaluator runs the whole split in every process
and then sums the counts, which counts each track n times; the port follows
the JAX package's multi-process rehearsal instead.)

INTENTIONAL DIVERGENCE (DIVERGENCES.md #1, kept from the JAX package): the
reference computes its eval "loss" as BCE-with-logits over *sigmoided*
scores (evaluator.py:107), unlike training (train.py:100-104). Here eval
uses the train-time definition (logits), so reported eval losses will not
match reference logs; J&F, selection decisions, and every other metric are
unaffected.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from sola_torch.core import mask_ops
from sola_torch.data.dataset import get_loader_dict
from sola_torch.models.selection import SelectionModel
from sola_torch.models.text import build_text_encoder
from sola_torch.parallel.distributed import (all_sum, process_count,
                                             process_index)
from sola_torch.train.loop import eval_step, prepare_batch


class Evaluator:
    def __init__(self, model: SelectionModel, configs: dict,
                 eval_weight_epoch: int, text_encoder=None,
                 eval_output_dir: str | None = None):
        """``model`` is evaluated on the device it lives on."""
        self.model = model
        self.device = next(model.parameters()).device
        self.configs = configs
        self.eval_weight_epoch = eval_weight_epoch
        self.pred_threshold = float(configs["eval"]["pred_threshold"])
        self.train_cfg = configs["train"]
        self.data_type = configs["dataset"]["valid"]["data_type"]
        self.eval_output_dir = (eval_output_dir
                                or configs["results"]["eval_output_dir"])
        self.text_encoder = text_encoder or build_text_encoder(
            configs["model"], self.device)
        self.loader_dict = get_loader_dict(configs["dataset"], only_eval=True)
        self.metrics: dict = {}
        self.pred_dict: dict = {}

    # ------------------------------------------------------------------
    def evaluate(self) -> dict:
        """Scores this process's share of the valid batches; returns the
        metrics (every process gets rank 0's)."""
        rank, world = process_index(), process_count()
        counts = {"tp": 0, "fp": 0, "tn": 0, "fn": 0}
        records = []  # (batch index, its losses, scores and predictions)
        for index, raw in enumerate(self.loader_dict["valid"]):
            if index % world != rank:  # shard_for_host's assignment
                continue
            batch = prepare_batch(raw, self.text_encoder, self.train_cfg,
                                  self.device)
            out = eval_step(self.model, batch, self.train_cfg,
                            self.pred_threshold)
            for k in counts:
                counts[k] += int(out[k])
            preds = out["pred"].cpu().numpy()
            scores = out["pred_score"].cpu().numpy()
            labels = batch["labels"].cpu().numpy()
            track_mask = np.asarray(raw["track_mask"])
            rec = {"total_loss": float(out["total"]),
                   "bce_loss": float(out["bce"]),
                   "alignment_loss": float(out["alignment"]), "pred": []}
            for k, p, l in (("tp_score", 1, 1), ("fp_score", 1, 0),
                            ("tn_score", 0, 0), ("fn_score", 0, 1)):
                sel = (preds == p) & (labels == l) & track_mask
                rec[k] = scores[sel].tolist()
            # per-sample pred_dict entries (evaluator.py:135-147)
            for i, video_id in enumerate(raw["video_id"]):
                n = int(raw["n_tracks"][i])
                rec["pred"].append((video_id, raw["expression_id"][i], {
                    "expression": raw["expression"][i],
                    "anno_ids": raw["anno_ids"][i],
                    "pred": preds[i, :n],
                    "pred_score": scores[i, :n],
                    "root_type": raw["root_type"][i],
                    "prompt_type": raw["prompt_type"][i],
                    "sam2_anno_id": raw["sam2_anno_id"][i],
                }))
            records.append((index, rec))
        summed = all_sum(counts)
        counts = {k: int(summed[k]) for k in counts}
        if world > 1:
            shards = [None] * world
            dist.all_gather_object(shards, records)
            records = sorted((r for shard in shards for r in shard),
                             key=lambda r: r[0])
            if rank != 0:
                result = [None]
                dist.broadcast_object_list(result, src=0)
                self.metrics = result[0]
                return self.metrics

        m = {"total_loss": [], "bce_loss": [], "alignment_loss": [],
             **counts,
             "tp_score": [], "fp_score": [], "tn_score": [], "fn_score": []}
        self.pred_dict = {}
        for _, rec in records:
            for k in ("total_loss", "bce_loss", "alignment_loss"):
                m[k].append(rec[k])
            for k in ("tp_score", "fp_score", "tn_score", "fn_score"):
                m[k] += rec[k]
            for video_id, expression_id, entry in rec["pred"]:
                self.pred_dict.setdefault(video_id, {})[expression_id] = entry
        m["total_loss"] = float(np.mean(m["total_loss"]))
        m["bce_loss"] = float(np.mean(m["bce_loss"]))
        m["alignment_loss"] = float(np.mean(m["alignment_loss"]))
        denom = m["tp"] + m["tn"] + m["fp"] + m["fn"]
        m["accuracy"] = (m["tp"] + m["tn"]) / max(denom, 1)
        m["precision"] = m["tp"] / (m["tp"] + m["fp"] + 1e-6)
        m["recall"] = m["tp"] / (m["tp"] + m["fn"] + 1e-6)
        m["f1"] = 2 * m["precision"] * m["recall"] / (
            m["precision"] + m["recall"] + 1e-6)
        for k in ("tp_score", "fp_score", "tn_score", "fn_score"):
            vals = m[k]
            m[k] = (float(np.mean(vals)) if vals else float("nan"),
                    float(np.std(vals)) if vals else float("nan"))
        self.metrics = m

        self.compute_JF_metrics()

        os.makedirs(self.eval_output_dir, exist_ok=True)
        path = os.path.join(
            self.eval_output_dir,
            f"{self.data_type}_metrics_{self.eval_weight_epoch}epoch.json")
        with open(path, "w") as f:
            json.dump(self.metrics, f, indent=4)
        if world > 1:
            dist.broadcast_object_list([self.metrics], src=0)
        return self.metrics

    # ------------------------------------------------------------------
    def compute_JF_metrics(self) -> dict:
        dataset = self.loader_dict["valid"].dataset
        JF_dict: dict = {}
        Js, Fs, JFs = [], [], []

        def fetch(video_id, expression_id, pred_info):
            gt = dataset.get_gt_masklet(video_id, expression_id)
            pred = dataset.get_sam2_masklet(
                video_id=video_id, expression_id=expression_id,
                preds=pred_info["pred"], root_types=pred_info["root_type"],
                prompt_types=pred_info["prompt_type"],
                sam2_anno_ids=pred_info["sam2_anno_id"])
            return gt, pred

        def to_device(masklet):
            # uint8 across the host link; compute_JF reduces in float32
            return torch.from_numpy(np.asarray(masklet, np.uint8)).to(
                self.device)

        with cf.ThreadPoolExecutor(2) as pool:
            for video_id in self.pred_dict:
                JF_dict[video_id] = {}
                dataset.set_video(video_id)
                items = list(self.pred_dict[video_id].items())
                future = pool.submit(fetch, video_id, items[0][0],
                                     items[0][1]) if items else None
                for idx, (expression_id, pred_info) in enumerate(items):
                    gt, pred = future.result()
                    if idx + 1 < len(items):
                        future = pool.submit(fetch, video_id,
                                             items[idx + 1][0],
                                             items[idx + 1][1])
                    if pred is None:
                        J = F = JF = 0.0
                    else:
                        j, f = mask_ops.compute_JF(to_device(pred),
                                                   to_device(gt))
                        J, F = float(j), float(f)
                        JF = (J + F) / 2
                    JF_dict[video_id][expression_id] = {
                        "expression": pred_info["expression"],
                        "J": J, "F": F, "JF": JF,
                    }
                    Js.append(J)
                    Fs.append(F)
                    JFs.append(JF)

        self.metrics["mean_J"] = float(np.mean(Js)) if Js else 0.0
        self.metrics["mean_F"] = float(np.mean(Fs)) if Fs else 0.0
        self.metrics["mean_JF"] = float(np.mean(JFs)) if JFs else 0.0
        os.makedirs(self.eval_output_dir, exist_ok=True)
        path = os.path.join(
            self.eval_output_dir,
            f"{self.data_type}_JF_metrics_{self.eval_weight_epoch}epoch.json")
        with open(path, "w") as f:
            json.dump(JF_dict, f, indent=4)
        return JF_dict
