"""Pose evaluation over trained objects: the test half of the JAX package's
``train_eval_pose_est.py`` (reference train_eval_pose_est.py:24-269).

For each ``tensorf_<obj>_VM`` run dir in ``--exp_patch`` it loads the field
checkpoint and the ``id_module.npz`` beside it, regenerates the candidate
rays from the field, and evaluates single-image pose on the test split
twice (as the reference does after training, both passes reseeded with
starting_seed=55176280), writing the JSON rows of every frame to
``--out_path``. An object whose evaluation raises a ``RuntimeError`` is
skipped with its traceback printed, as in train_eval_pose_est.py. It never
trains: without an ``id_module.npz`` it raises.

    python -m iffnerf_tpu_torch.pose_cli --datadir DATA --exp_patch LOG \\
        --out_path pose_eval.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

import numpy as np
import torch

from iffnerf_tpu_torch.checkpoint import load_pytree
from iffnerf_tpu_torch.data import dataset_dict
from iffnerf_tpu_torch.device import resolve_device
from iffnerf_tpu_torch.pose.eval_utils import parse_exp_dir
from iffnerf_tpu_torch.pose.id_module import IDConfig
from iffnerf_tpu_torch.pose.model_utils import load_model
from iffnerf_tpu_torch.pose.sampling import explore_field
from iffnerf_tpu_torch.pose.test import test_pose_estimation
from iffnerf_tpu_torch.pose.vit import ViTConfig

STARTING_SEED = 55176280


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--datadir", type=str, required=True)
    p.add_argument("--exp_patch", type=str, required=True)
    p.add_argument("--out_path", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="blender",
                   choices=sorted(dataset_dict),
                   help="the port's loaders; tankstemple comes later")
    p.add_argument("--downsample_train", type=float, default=1.0)
    p.add_argument("--gen_points", type=int, default=20000)
    p.add_argument("--id_backbone_depth", type=int, default=12)
    p.add_argument("--pose_f32", action="store_true",
                   help="float32 pose inference (default: bfloat16 matmul "
                        "inputs, float32 accumulation)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit_categories", type=str, nargs="+", default=[])
    p.add_argument("--save_debug", type=int, default=0,
                   help="dump per-image solver intermediates next to "
                        "--out_path: 1 = first test image, 2 = every image")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def evaluate_object(args, data_path: str, ckpt_path: str, sequence_id: str,
                    dev: torch.device) -> list:
    """Both test passes for one object -> the second pass's JSON rows."""
    loader = dataset_dict[args.dataset_name]
    train_dataset = loader(data_path, split="train",
                           downsample=args.downsample_train, is_stack=True)
    test_dataset = loader(data_path, split="test",
                          downsample=args.downsample_train, is_stack=True)
    config, params, mask = load_model(ckpt_path, device=dev)

    id_ckpt_path = os.path.join(os.path.dirname(ckpt_path), "id_module.npz")
    if not os.path.exists(id_ckpt_path):
        raise FileNotFoundError(
            f"{id_ckpt_path} is missing: the port does not train the ID "
            f"module yet (ROADMAP slice 3); train it with "
            f"train_eval_pose_est.py")
    id_params, _ = load_pytree(id_ckpt_path, device=dev)
    id_config = IDConfig(
        backbone=ViTConfig(depth=args.id_backbone_depth),
        compute_dtype="float32" if args.pose_f32 else "bfloat16")
    model_up = np.asarray(train_dataset.poses)[:, :3, 1].mean(axis=0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def gen_rays():
        return explore_field(gen, config, params, mask,
                             gen_points=args.gen_points, device=dev)

    print("Testing performances on same points...")
    np.random.seed(STARTING_SEED)
    _, val_t, val_a, _, _ = test_pose_estimation(
        test_dataset, id_params, id_config, *gen_rays(), model_up,
        sequence_id=sequence_id, device=dev)
    print("Val AVG translation error:", val_t)
    print("Val AVG angular error:", val_a)

    print("Testing real performances on real data...")
    np.random.seed(STARTING_SEED)
    results, test_t, test_a, _, _ = test_pose_estimation(
        test_dataset, id_params, id_config, *gen_rays(), model_up,
        sequence_id=sequence_id, save=args.save_debug > 0,
        save_all=args.save_debug > 1,
        save_dir=os.path.dirname(os.path.abspath(args.out_path)) or ".",
        device=dev)
    print("Test AVG translation error:", test_t)
    print("Test AVG angular error:", test_a)
    return results


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out_path = os.path.abspath(args.out_path)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = []
    for exp in parse_exp_dir(args.exp_patch, "_VM").values():
        if args.limit_categories and \
                exp["sequence_id"] not in args.limit_categories:
            continue
        data_path = os.path.join(args.datadir, exp["sequence_id"])
        if not os.path.isdir(data_path):
            data_path = args.datadir
        # as train_eval_pose_est.py does: one failing object (a bad
        # checkpoint, an out-of-memory error) loses its own rows, not the
        # whole sweep
        try:
            results.extend(evaluate_object(args, data_path,
                                           exp["checkpoint_filepath"],
                                           exp["sequence_id"], dev))
        except RuntimeError:
            traceback.print_exc()
    print("Saving results")
    with open(out_path, "w") as fh:
        json.dump(results, fh)
    return results


if __name__ == "__main__":
    main()
