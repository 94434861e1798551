#!/bin/bash
# Canonical preset: GT-prompted tracks for MeViS train
# (reference track_generation/scripts/generate_tokens_GT_mevis.sh).
python -m sola_torch.trackgen.tokens_gt \
    --dataset mevis \
    --data_type train \
    --save_prec_rec_iou \
    --pid 0 \
    --n_pids 1 \
    "$@"
