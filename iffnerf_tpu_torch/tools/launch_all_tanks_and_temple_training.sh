#!/bin/bash
# Train the 5 Tanks&Temples scenes one after another with the port's
# training CLI (reference tools/launch_all_tanks_and_temple_training.sh:
# 1-7). Run from the repository's root.
set -e
DATA=${IFFNERF_DATA:-./data/TanksAndTemple}
for obj in Barn Caterpillar Family Ignatius Truck; do
    python -m iffnerf_tpu_torch.train_cli --config configs/truck.txt \
        --datadir "$DATA/$obj" --expname "tensorf_${obj}_VMtt"
done
