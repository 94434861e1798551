#!/bin/bash
# usage: bash scripts/torch/train.sh CONFIG [extra flags...]
# Trains on the first CUDA card; extra flags pass through, so
# `--device cpu` trains on the CPU. Mesh training over several processes
# goes through torchrun, which sets the group's environment, e.g.
#   torchrun --nproc_per_node 4 -m sola_torch.cli.train --config CONFIG \
#       --train.n_model 2
CONFIG=${1:?usage: train.sh CONFIG [flags]}
shift
python -m sola_torch.cli.train --config "$CONFIG" "$@"
