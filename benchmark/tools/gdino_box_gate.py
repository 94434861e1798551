"""GroundingDINO's box gate over a text-prompted cell's mix: measure the
boxes it passes, or set the bias that makes it pass a target.

    python3 benchmark/tools/gdino_box_gate.py [--target 2.5] [--out gate.json]

Runs the port's GroundingDINO on the weights of ``trackgen_l.gdino``'s
configuration (fp32, TF32 off) over every binned frame of its mix's videos
with all the video's expressions, as ``prompts_gdino`` does, and prints,
over the (binned frame, expression) pairs: the boxes a pair over
``box_threshold``, the share of pairs with none, and the share of
expressions with a box on at least one frame. Without ``--target`` it
runs at the configuration's ``box_gate``. With ``--target N`` it runs
with ``query_norm_bias`` 0 and prints the ``query_norm_bias`` that puts N
boxes a pair over the gate: a contrastive logit takes the bias as width
x ``text_norm_bias`` x ``query_norm_bias`` (``models/gdino_swin_t.py``),
so the counts it prints beside are those of the logits shifted by that
term. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.core import env  # noqa: E402

CELL = "trackgen_l.gdino"


def main() -> None:
    env.setup()     # before torch is imported
    p = argparse.ArgumentParser()
    p.add_argument("--target", type=float, default=0.0)
    p.add_argument("--out", default="")
    args = p.parse_args()

    import numpy as np
    import torch
    from PIL import Image

    from benchmark.core import device as device_lib
    from benchmark.core import manifest
    from benchmark.core.record import Record
    from benchmark.drivers import trackgen_gdino as tg
    from benchmark.gen import gdino_videos
    from benchmark.models import gdino_swin_t
    from sola_torch.ops import kernel_build
    from sola_torch.trackgen.gdino.model import GroundingModel
    from sola_torch.trackgen.prompts_gdino import normalize_expression
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(CELL)
    config = manifest.config(cell["config"])
    record = Record(CELL, cell, config, manifest.traffic(cell["traffic"]),
                    seed=1)
    print(f"card: {device_lib.power_limit()}", flush=True)
    driver = tg.Cell(record)
    kernel_build.build_all()
    traffic = gdino_videos.generate(driver.root, record.mix, record.seed)
    gate = dict(config["assumed"]["box_gate"])
    if args.target:
        gate["query_norm_bias"] = 0.0
    grounding = GroundingModel(driver._port_gdino(gdino_swin_t.state_dict(
        config, "cuda", "large", box_gate=gate)))
    bin_size = int(config["prompts"]["bin_size"])
    scores, exprs = [], []
    with torch.no_grad():
        for v in traffic["videos"]:
            names = sorted(os.listdir(v["frames_dir"]))
            texts = [normalize_expression(e["exp"])
                     for e in v["expressions"].values()]
            for f in range(0, v["n_frames"], bin_size):
                image = np.array(Image.open(os.path.join(
                    v["frames_dir"], names[f])).convert("RGB"))
                _, pending = grounding.enqueue_boxes(image, texts)
                for chunk, _, _, out in pending:
                    scores.append(tg._row_max(
                        out["pred_logits"][:len(chunk)].float().cpu()))
                exprs += [(v["video_id"], e) for e in v["expressions"]]
    m = torch.cat(scores).double().numpy()
    thr = tg._logit(float(config["prompts"]["box_threshold"]))
    result = {"pairs": int(m.shape[0])}
    if args.target:
        flat = np.sort(m.ravel())[::-1]
        k = int(round(args.target * m.shape[0]))
        shift = thr - 0.5 * (flat[k - 1] + flat[k])
        m = m + shift
        result["query_norm_bias"] = shift / (
            int(config["sizes"]["hidden_dim"]) * float(gate["text_norm_bias"]))
    count = (m > thr).sum(1)
    with_box = {}
    for e, n in zip(exprs, count):
        with_box[e] = with_box.get(e, False) or bool(n)
    result.update(
        boxes_per_pair=float(count.mean()),
        pairs_without_box=float((count == 0).mean()),
        expressions=len(with_box),
        expressions_with_box=float(np.mean(list(with_box.values()))),
        boxes_per_pair_quantiles=np.quantile(
            count, [0.5, 0.75, 0.9, 0.99, 1.0]).tolist())
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    driver.cleanup()


if __name__ == "__main__":
    main()
