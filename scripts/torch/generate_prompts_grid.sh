#!/bin/bash
# usage: bash scripts/torch/generate_prompts_grid.sh PID N_PIDS [flags...]
PID=${1:-0}; N_PIDS=${2:-1}; shift 2 2>/dev/null
python -m sola_torch.trackgen.prompts_grid --pid "$PID" --n_pids "$N_PIDS" --bin_size 8 "$@"
