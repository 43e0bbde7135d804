"""Pose CLI of the port: the counterpart of the JAX package's
``train_eval_pose_est.py`` (reference train_eval_pose_est.py:24-269).

For each ``tensorf_<obj>_VM`` run dir (``_VMtt`` for Tanks&Temples) in
``--exp_patch`` it loads the field checkpoint, trains the Identification
Module against the frozen field (or resumes it from the ``id_module.npz``
beside the checkpoint, at its ``epoch``), saves it there, then evaluates
single-image pose on the test split twice (as the reference does after
training, both passes reseeded with starting_seed=55176280), each frame
refined by iNeRF against the field with ``--algorithm_type inerf_dice``,
writing the JSON rows of every frame to ``--out_path``. An object whose
run raises a ``RuntimeError`` is skipped with its traceback printed. Flags
come from the command line over a ``--config`` file (``config.py``).

    python -m iffnerf_tpu_torch.pose_cli --config configs/lego.txt \\
        --datadir DATA --exp_patch LOG --out_path pose_eval.json [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import traceback

import numpy as np
import torch

from iffnerf_tpu_torch.checkpoint import load_pytree, save_pytree
from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.data import dataset_dict
from iffnerf_tpu_torch.device import resolve_device
from iffnerf_tpu_torch.pose.eval_utils import parse_exp_dir
from iffnerf_tpu_torch.pose.id_module import IDConfig, init_id_module
from iffnerf_tpu_torch.pose.model_utils import load_model
from iffnerf_tpu_torch.pose.sampling import explore_field
from iffnerf_tpu_torch.pose.test import test_pose_estimation
from iffnerf_tpu_torch.pose.trainer import train_id_module
from iffnerf_tpu_torch.pose.vit import ViTConfig

STARTING_SEED = 55176280


def add_pose_args(parser):
    """The pose flags (reference pose_estimation/args.py:4-53, and those of
    the JAX package's ``train_eval_pose_est.py``)."""
    parser.add_argument("--gpu", default="0",
                        help="accepted for reference-CLI parity (unused)")
    parser.add_argument("--resume", default=None,
                        help="accepted for reference-CLI parity (unused)")
    parser.add_argument("--exp_patch", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--resize_factor", type=float, default=1.0,
                        help="accepted for reference-CLI parity (unused, "
                             "as in the reference CLI)")
    parser.add_argument("--seed", type=int, default=42,
                        help="seeds the ID module's initialisation, the "
                             "training image stream and the ray generator")
    parser.add_argument("--algorithm_type", type=str, default="inerf",
                        help="inerf_dice refines each test frame's estimate "
                             "with iNeRF against the field")
    parser.add_argument("--starting_pose_strategy", type=str,
                        default="histogram_comparison",
                        help="accepted for reference-CLI parity (unused, "
                             "as in the reference CLI)")
    parser.add_argument("--limit_categories", type=str, nargs="+", default=[],
                        help="restrict the per-object loop to these "
                             "sequence ids")
    parser.add_argument("--backbone_ckpt", type=str, default=None,
                        help="npz of converted DINOv2 ViT-S/14 weights "
                             "(python -m iffnerf_tpu_torch.tools."
                             "convert_dinov2); random init if unset")
    parser.add_argument("--id_iters", type=int, default=1500)
    parser.add_argument("--id_backbone_depth", type=int, default=12)
    parser.add_argument("--gen_points", type=int, default=20000)
    parser.add_argument("--accum_steps", type=int, default=32)
    parser.add_argument("--id_scan_steps", type=int, default=10,
                        help="accepted for parity with train_eval_pose_est.py, "
                             "whose steps run in chunks of one dispatch; the "
                             "port runs one optimizer step at a time")
    parser.add_argument("--save_debug", type=int, default=0,
                        help="dump per-image solver intermediates next to "
                             "--out_path: 1 = first test image, 2 = every image")
    parser.add_argument("--pose_f32", action="store_true",
                        help="float32 pose inference (default: bfloat16 matmul "
                             "inputs, float32 accumulation); training is "
                             "always float32")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")


def parse_args(argv=None):
    return config_parser(argv, extra_parser_hook=add_pose_args,
                         known_only=True)


def pretrain_single_object(args, data_path: str, loader, ckpt_path: str,
                           sequence_id: str, dev: torch.device) -> list:
    """Train (or resume) and test one object -> the second test pass's JSON
    rows (reference train_eval_pose_est.py:24-156)."""
    print("data_path:", data_path)
    train_dataset = loader(data_path, split="train",
                           downsample=args.downsample_train, is_stack=True)
    test_dataset = loader(data_path, split="test",
                          downsample=args.downsample_train, is_stack=True)
    config, params, mask = load_model(ckpt_path, device=dev)
    nerf = (config, params, mask)
    inerf_refinement = args.algorithm_type == "inerf_dice"

    id_config = IDConfig(backbone=ViTConfig(depth=args.id_backbone_depth))
    id_params = init_id_module(torch.Generator().manual_seed(args.seed),
                               id_config, device=dev)
    if args.backbone_ckpt:
        id_params["backbone"], _ = load_pytree(args.backbone_ckpt, device=dev)

    id_ckpt_path = os.path.join(os.path.dirname(ckpt_path), "id_module.npz")
    start_iterations = 0
    if os.path.exists(id_ckpt_path):
        print("Checkpoint already exist, skip training phase")
        id_params, meta = load_pytree(id_ckpt_path, device=dev)
        start_iterations = int(meta.get("epoch", args.id_iters))

    # a fresh surface resampling each call (reference resampling=True,
    # train_eval_pose_est.py:68-72), drawn from one seeded stream
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def gen_rays():
        return explore_field(gen, config, params, mask,
                             gen_points=args.gen_points, device=dev)

    id_params, model_up = train_id_module(
        id_params, id_config, gen_rays, train_dataset, test_dataset,
        sequence_id=sequence_id, n_iterations=args.id_iters,
        gradient_accumulation_steps=args.accum_steps,
        start_iterations=start_iterations,
        rng=np.random.default_rng(args.seed), device=dev)
    save_pytree(id_ckpt_path, id_params, {"epoch": args.id_iters})

    print("Training complete starting testing phase...")
    test_config = dataclasses.replace(
        id_config, compute_dtype="float32" if args.pose_f32 else "bfloat16")

    print("Testing performances on same points...")
    np.random.seed(STARTING_SEED)
    _, val_t, val_a, _, _ = test_pose_estimation(
        test_dataset, id_params, test_config, *gen_rays(), model_up,
        sequence_id=sequence_id, inerf_refinement=inerf_refinement,
        nerf=nerf, device=dev)
    print("Val AVG translation error:", val_t)
    print("Val AVG angular error:", val_a)

    print("Testing real performances on real data...")
    np.random.seed(STARTING_SEED)
    results, test_t, test_a, _, _ = test_pose_estimation(
        test_dataset, id_params, test_config, *gen_rays(), model_up,
        sequence_id=sequence_id, inerf_refinement=inerf_refinement,
        nerf=nerf, save=args.save_debug > 0,
        save_all=args.save_debug > 1,
        save_dir=os.path.dirname(os.path.abspath(args.out_path)) or ".",
        device=dev)
    print("Test AVG translation error:", test_t)
    print("Test AVG angular error:", test_a)
    return results


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    out_path = os.path.abspath(args.out_path)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # as train_eval_pose_est.py: blender runs end in _VM, every other
    # dataset is read as Tanks&Temples from _VMtt runs
    if args.dataset_name == "blender":
        loader, suffix = dataset_dict["blender"], "_VM"
    else:
        loader, suffix = dataset_dict["tankstemple"], "_VMtt"

    results = []
    for exp in parse_exp_dir(args.exp_patch, suffix).values():
        if args.limit_categories and \
                exp["sequence_id"] not in args.limit_categories:
            continue
        data_path = os.path.join(args.datadir, exp["sequence_id"])
        if not os.path.isdir(data_path):
            data_path = args.datadir
        # one failing object (a bad checkpoint, an out-of-memory error)
        # loses its own rows, not the whole sweep
        try:
            results.extend(pretrain_single_object(
                args, data_path, loader, exp["checkpoint_filepath"],
                exp["sequence_id"], dev))
        except RuntimeError:
            traceback.print_exc()
    print("Saving results")
    with open(out_path, "w") as fh:
        json.dump(results, fh)
    return results


if __name__ == "__main__":
    np.random.seed(500661008)
    main()
