#!/bin/bash
PID=${1:-0}; N_PIDS=${2:-1}; shift 2 2>/dev/null
python -m sola_torch.trackgen.prompts_gdino --pid "$PID" --n_pids "$N_PIDS" \
  --bin_size 4 --box_threshold 0.2 --text_threshold 0.25 "$@"
