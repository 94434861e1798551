"""Inference CLI: ``python -m sola_torch.cli.inference --config
mevis/default --eval_weight_epoch N [--eval_pred_threshold t] [--device
cuda]`` (reference inference.py:149-152). Writes leaderboard PNG masks.

Counterpart of ``sola_tpu/cli/inference.py``; without CUDA it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os

from sola_torch import config as config_lib
from sola_torch.cli.eval import get_configs, load_weights
from sola_torch.cli.train import set_seed


def main(argv=None) -> None:
    from sola_torch.device import resolve_device
    from sola_torch.eval.inference import run_inference
    configs, device = get_configs(argv)
    device = resolve_device(device)
    set_seed(42)
    model = load_weights(configs, device)
    out_dir = config_lib.inference_output_dir(
        configs, configs["eval"]["pred_threshold"],
        configs["eval_weight_epoch"])
    os.makedirs(out_dir, exist_ok=True)
    print(f"INFERENCE OUTPUTS WILL BE SAVED IN {out_dir}")
    run_inference(model, configs, out_dir)


if __name__ == "__main__":
    main()
