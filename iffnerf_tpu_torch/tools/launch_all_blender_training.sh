#!/bin/bash
# Train all 8 NeRF-synthetic objects one after another with the port's
# training CLI (reference tools/launch_all_blender_training.sh:1-9). Run
# from the repository's root.
set -e
DATA=${IFFNERF_DATA:-./data/nerf_synthetic}
for obj in chair drums ficus hotdog lego materials mic ship; do
    python -m iffnerf_tpu_torch.train_cli --config configs/lego.txt \
        --datadir "$DATA/$obj" --expname "tensorf_${obj}_VM"
done
