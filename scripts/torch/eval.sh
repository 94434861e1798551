#!/bin/bash
# usage: bash scripts/torch/eval.sh CONFIG EPOCH [extra flags...]
CONFIG=${1:?usage: eval.sh CONFIG EPOCH [flags]}
EPOCH=${2:?usage: eval.sh CONFIG EPOCH [flags]}
shift 2
python -m sola_torch.cli.eval --config "$CONFIG" --eval_weight_epoch "$EPOCH" "$@"
