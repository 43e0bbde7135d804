"""Dataset-vs-checkpoint scale check of the port (the JAX package's
``tools/compute_scaling_factor.py``; reference
tools/compute_scaling_factor.py): for each trained experiment, the
checkpoint's (possibly shrunk) AABB against the dataset's scene bbox and
their ratio. The checkpoints load on the CUDA card unless ``--device
cpu``.

    python -m iffnerf_tpu_torch.tools.compute_scaling_factor \\
        --exp_patch ./log --datadir ./data/nerf_synthetic --data_type blender
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from iffnerf_tpu_torch.data import dataset_dict
from iffnerf_tpu_torch.pose.eval_utils import parse_exp_dir
from iffnerf_tpu_torch.pose.model_utils import load_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp_patch", type=str, required=True)
    ap.add_argument("--datadir", type=str, required=True)
    ap.add_argument("--data_type", type=str, default="blender",
                    choices=["blender", "tankstemple", "mip360"])
    ap.add_argument("--downsample", type=float, default=1.0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    suffix = "_VM" if args.data_type == "blender" else "_VMtt"
    loader = dataset_dict[args.data_type]
    for exp in parse_exp_dir(args.exp_patch, suffix).values():
        config, _, _ = load_model(exp["checkpoint_filepath"],
                                  device=args.device)
        data_path = os.path.join(args.datadir, exp["sequence_id"])
        if not os.path.isdir(data_path):
            data_path = args.datadir
        ds = loader(data_path, split="test", downsample=args.downsample,
                    is_stack=True)
        ckpt_size = config.aabb_np[1] - config.aabb_np[0]
        data_size = np.asarray(ds.scene_bbox[1] - ds.scene_bbox[0])
        print(
            f"{exp['sequence_id']}: ckpt aabb {ckpt_size.tolist()} vs "
            f"dataset bbox {data_size.tolist()} -> "
            f"ratio {(ckpt_size / data_size).tolist()}"
        )


if __name__ == "__main__":
    main()
