"""Train CLI: ``python -m sola_torch.cli.train --config mevis/default [...]``.

Counterpart of ``sola_tpu/cli/train.py`` (reference surface: train.py:294-297
/ scripts/train.sh). Unknown ``--key value`` flags fold into the config, and
dotted keys (``--train.lr 1e-5``) reach nested entries. ``--device`` is the
torch device (CUDA by default; without CUDA the CLI raises unless
``--device cpu`` is given).

Several processes train one model on a (data, model) mesh when the
environment names a group of more than one (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them)::

    torchrun --nproc_per_node 4 -m sola_torch.cli.train --config ... \
        --train.n_model 2 --device cpu

``--backend`` picks the process group's backend: NCCL by default where
each rank has a card of its own, gloo on the CPU or for ranks that share
one card.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from sola_torch import config as config_lib
from sola_torch.utils import profiling


def set_seed(seed: int) -> None:
    """Host RNG seeding (train.py:248-252); the model's randomness comes
    from explicit generators."""
    random.seed(seed)
    np.random.seed(seed)


def get_configs(argv=None) -> tuple:
    """(configs, resume, device) from the command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest epoch checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args, unknown = parser.parse_known_args(argv)
    return (config_lib.load_config(args.config, overrides=unknown),
            args.resume, args.device)


def init_distributed(argv=None) -> list:
    """Join the process group the environment names (``--backend``: nccl
    or gloo; by default ``distributed.default_backend`` of ``--device``);
    returns the arguments without ``--backend``."""
    from sola_torch.parallel import distributed
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--backend", type=str, default=None)
    args, rest = parser.parse_known_args(argv)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", type=str, default="cuda")
    distributed.initialize(backend=args.backend,
                           device=device.parse_known_args(rest)[0].device)
    return rest


@profiling.device_trace()
def main(argv=None) -> None:
    from sola_torch.device import resolve_device
    from sola_torch.parallel.distributed import rank_device
    from sola_torch.train.loop import train
    configs, resume, device = get_configs(init_distributed(argv))
    device = resolve_device(rank_device(device))
    set_seed(42)
    train(configs, resume=resume, device=device)


if __name__ == "__main__":
    main()
