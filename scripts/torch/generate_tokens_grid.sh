#!/bin/bash
# usage: bash scripts/torch/generate_tokens_grid.sh PID N_PIDS [flags...]
# canonical hyperparameters per README.md:91-123 of the reference
PID=${1:-0}; N_PIDS=${2:-1}; shift 2 2>/dev/null
python -m sola_torch.trackgen.tokens_grid --pid "$PID" --n_pids "$N_PIDS" \
  --bin_size 4 --batch_size 4 --miou_thresh 0.7 --n_max_tracks 64 "$@"
