"""Eval CLI: ``python -m sola_torch.cli.eval --config mevis/default
--eval_weight_epoch N [--eval_pred_threshold t] [--device cuda]``
(reference eval.py:95-98).

Counterpart of ``sola_tpu/cli/eval.py``: loads a reference-named
``epoch_N.pth`` (or the JAX package's ``epoch_N.npz`` export) from the
train output dir, then runs the Evaluator on ``--device`` (CUDA by
default; without CUDA the CLI raises unless ``--device cpu`` is given).
Unknown ``--key value`` flags fold into the config. Under torchrun (or
its environment variables) each process scores its share of the valid
batches and rank 0 writes the JSONs; ``--backend`` as in ``cli.train``.
"""

from __future__ import annotations

import argparse
import os

from sola_torch import config as config_lib
from sola_torch.cli.train import init_distributed, set_seed


def get_configs(argv=None) -> tuple:
    """(configs, device) from the command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval_weight_epoch", type=int, default=-1)
    parser.add_argument("--eval_pred_threshold", type=float, default=0.5)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the selection model")
    args, unknown = parser.parse_known_args(argv)
    configs = config_lib.load_config(args.config, overrides=unknown)
    configs["eval"]["pred_threshold"] = args.eval_pred_threshold
    configs["eval_weight_epoch"] = args.eval_weight_epoch
    return configs, args.device


def load_weights(configs: dict, device):
    """The selection model of the eval epoch, from the train output dir,
    on ``device``."""
    from sola_torch.models.selection import SelectionConfig
    from sola_torch.train.loop import build_model

    epoch = configs["eval_weight_epoch"]
    out_dir = config_lib.train_output_dir(configs)
    cfg = SelectionConfig.from_dict(configs["model"])
    orbax_path = os.path.join(out_dir, f"epoch_{epoch}")
    if os.path.isdir(orbax_path):
        raise ValueError(
            f"{orbax_path} is an orbax checkpoint of the JAX package; export "
            f"it to epoch_{epoch}.npz (sola_tpu.train.state.export_torch_npz)"
            f" or save epoch_{epoch}.pth")
    for name in (f"epoch_{epoch}.pth", f"epoch_{epoch}.npz"):
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            return build_model(cfg, device, init_weights_path=path)
    raise FileNotFoundError(
        f"no checkpoint for epoch {epoch} under {out_dir}")


def main(argv=None) -> None:
    from sola_torch.device import resolve_device
    from sola_torch.eval.evaluator import Evaluator
    from sola_torch.parallel import distributed
    configs, device = get_configs(init_distributed(argv))
    device = resolve_device(distributed.rank_device(device))
    set_seed(42)
    model = load_weights(configs, device)
    eval_dir = config_lib.eval_output_dir(
        configs, configs["eval"]["pred_threshold"],
        configs["eval_weight_epoch"])
    os.makedirs(eval_dir, exist_ok=True)
    rank0 = distributed.process_index() == 0
    if rank0:
        print(f"EVAL OUTPUTS WILL BE SAVED IN {eval_dir}")
    evaluator = Evaluator(model, configs,
                          eval_weight_epoch=configs["eval_weight_epoch"],
                          eval_output_dir=eval_dir)
    metrics = evaluator.evaluate()
    if rank0:
        print(f"MEAN J: {metrics['mean_J']:.4f} "
              f"MEAN F: {metrics['mean_F']:.4f} "
              f"MEAN JF: {metrics['mean_JF']:.4f}")


if __name__ == "__main__":
    main()
