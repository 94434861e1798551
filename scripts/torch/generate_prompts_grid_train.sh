#!/bin/bash
# Canonical preset: grid prompts over the MeViS TRAIN split
# (reference track_generation/scripts/generate_prompts_grid_train.sh).
python -m sola_torch.trackgen.prompts_grid \
    --dataset mevis \
    --data_type train \
    --bin_size 4 \
    --pid 0 \
    --n_pid 1 \
    "$@"
