#!/bin/bash
# Canonical preset: grid prompts over the MeViS VALID split, every frame
# (reference track_generation/scripts/generate_prompts_grid_eval.sh).
python -m sola_torch.trackgen.prompts_grid \
    --dataset mevis \
    --data_type valid \
    --bin_size 0 \
    --pid 0 \
    --n_pid 1 \
    "$@"
