#!/bin/bash
PID=${1:-0}; N_PIDS=${2:-1}; shift 2 2>/dev/null
python -m sola_torch.trackgen.tokens_gt --pid "$PID" --n_pids "$N_PIDS" \
  --save_prec_rec_iou "$@"
