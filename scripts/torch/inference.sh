#!/bin/bash
# usage: bash scripts/torch/inference.sh CONFIG EPOCH [extra flags...]
CONFIG=${1:?usage: inference.sh CONFIG EPOCH [flags]}
EPOCH=${2:?usage: inference.sh CONFIG EPOCH [flags]}
shift 2
python -m sola_torch.cli.inference --config "$CONFIG" --eval_weight_epoch "$EPOCH" "$@"
