#!/bin/bash
PID=${1:-0}; N_PIDS=${2:-1}; shift 2 2>/dev/null
python -m sola_torch.trackgen.tokens_gdino --pid "$PID" --n_pids "$N_PIDS" \
  --bin_size 4 --batch_size 4 --miou_thresh 0.7 --stability_score_thresh 0.85 \
  --n_max_tracks 16 "$@"
