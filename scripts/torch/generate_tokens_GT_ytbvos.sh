#!/bin/bash
# Canonical preset: GT-prompted tracks for Ref-YouTube-VOS train
# (reference track_generation/scripts/generate_tokens_GT_ytbvos.sh).
python -m sola_torch.trackgen.tokens_gt \
    --dataset ref-ytbvos \
    --data_type train \
    --save_prec_rec_iou \
    --pid 0 \
    --n_pid 1 \
    "$@"
