"""Config/flag system with reference CLI parity (reference opt.py:4-202),
a copy of the JAX package's ``config.py`` (argparse only).

The reference uses configargparse (``--config file.txt`` with ``key = value``
lines, ``#`` comments, ``[a, b, c]`` lists for append-actions). That package
is not a dependency, so a small compatible shim layers config-file values
under CLI flags on top of plain argparse: precedence CLI > config file >
defaults, matching configargparse semantics for the flag surface we need.
The flags of the JAX package's field trainer are all kept, so one config
file serves both packages; the port's pose CLI reads the ones it uses.
"""

from __future__ import annotations

import argparse
import shlex
import sys


def parse_config_file(path: str) -> dict:
    """configargparse-compatible ``key = value`` file parser."""
    values = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key, val = key.strip(), val.strip()
            if val.startswith("[") and val.endswith("]"):
                items = [v.strip() for v in val[1:-1].split(",") if v.strip()]
                values[key] = items
            else:
                values[key] = val
    return values


def build_argparse() -> argparse.ArgumentParser:
    """Flag-for-flag parity with reference opt.py:4-194."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None,
                        help="config file path")
    parser.add_argument("--expname", type=str)
    parser.add_argument("--basedir", type=str, default="./log")
    parser.add_argument("--add_timestamp", type=int, default=0)
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")
    parser.add_argument("--progress_refresh_rate", type=int, default=10)

    parser.add_argument("--with_depth", action="store_true")
    parser.add_argument("--downsample_train", type=float, default=1.0)
    parser.add_argument("--downsample_test", type=float, default=1.0)

    parser.add_argument("--model_name", type=str, default="TensorVMSplit",
                        choices=["TensorVMSplit", "TensorCP"])

    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--train_batch_size", type=int, default=-1)
    parser.add_argument("--test_batch_size", type=int, default=-1)
    parser.add_argument("--n_iters", type=int, default=30000)

    parser.add_argument(
        "--dataset_name", type=str, default="blender",
        choices=["blender", "mip360", "llff", "nsvf", "dtu", "tankstemple",
                 "repair", "co3d", "co3d_metashape", "own_data"],
    )

    parser.add_argument("--lr_init", type=float, default=0.02)
    parser.add_argument("--lr_basis", type=float, default=1e-3)
    parser.add_argument("--lr_decay_iters", type=int, default=-1)
    parser.add_argument("--lr_decay_target_ratio", type=float, default=0.1)
    parser.add_argument("--lr_upsample_reset", type=int, default=1)

    parser.add_argument("--L1_weight_inital", type=float, default=0.0)
    parser.add_argument("--L1_weight_rest", type=float, default=0.0)
    parser.add_argument("--Ortho_weight", type=float, default=0.0)
    parser.add_argument("--TV_weight_density", type=float, default=0.0)
    parser.add_argument("--TV_weight_app", type=float, default=0.0)

    parser.add_argument("--n_lamb_sigma", type=int, action="append")
    parser.add_argument("--n_lamb_sh", type=int, action="append")
    parser.add_argument("--data_dim_color", type=int, default=27)

    parser.add_argument("--rm_weight_mask_thre", type=float, default=0.0001)
    parser.add_argument("--alpha_mask_thre", type=float, default=0.0001)
    parser.add_argument("--distance_scale", type=float, default=25.0)
    parser.add_argument("--density_shift", type=float, default=-10.0)
    parser.add_argument("--contraction_type", type=str, default="aabb",
                        choices=["aabb", "unisphere"])

    parser.add_argument("--shadingMode", type=str, default="MLP_PE")
    parser.add_argument("--pos_pe", type=int, default=6)
    parser.add_argument("--view_pe", type=int, default=6)
    parser.add_argument("--fea_pe", type=int, default=6)
    parser.add_argument("--featureC", type=int, default=128)

    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--render_only", type=int, default=0)
    parser.add_argument("--render_test", type=int, default=0)
    parser.add_argument("--render_train", type=int, default=0)
    parser.add_argument("--render_path", type=int, default=0)
    parser.add_argument("--export_mesh", type=int, default=0)

    parser.add_argument("--lindisp", default=False, action="store_true")
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--accumulate_decay", type=float, default=0.998)
    parser.add_argument("--fea2denseAct", type=str, default="softplus")
    parser.add_argument("--ndc_ray", type=int, default=0)
    parser.add_argument("--nSamples", type=int, default=int(1e6))
    parser.add_argument("--step_ratio", type=float, default=0.5)

    parser.add_argument("--white_bkgd", action="store_true")

    parser.add_argument("--N_voxel_init", type=int, default=100 ** 3)
    parser.add_argument("--N_voxel_final", type=int, default=300 ** 3)
    parser.add_argument("--upsamp_list", type=int, action="append")
    parser.add_argument("--update_AlphaMask_list", type=int, action="append")

    parser.add_argument("--idx_view", type=int, default=0)
    # flags of the JAX package's field trainer (train.py), accepted so that
    # its config files parse here too
    parser.add_argument("--train_scan", type=int, default=0)
    parser.add_argument("--adaptive_compact", type=int, default=1)
    # the data mesh over a torchrun launch's ranks (train/trainer.py::
    # data_mesh): -1 on when there is more than one rank, 0 off, 1 on
    parser.add_argument("--data_mesh", type=int, default=-1)
    parser.add_argument("--resume_iter", type=int, default=0)
    parser.add_argument("--ckpt_every", type=int, default=2000)
    parser.add_argument("--N_vis", type=int, default=5)
    parser.add_argument("--vis_every", type=int, default=10000)
    return parser


def _apply_config_file(parser: argparse.ArgumentParser, args, cmd_tokens):
    """Layer config-file values under explicit CLI flags."""
    if args.config is None:
        return args
    file_values = parse_config_file(args.config)
    explicit = {
        tok.split("=", 1)[0][2:]
        for tok in cmd_tokens
        if tok.startswith("--")
    }
    type_by_dest = {a.dest: a for a in parser._actions}
    for key, val in file_values.items():
        if key in explicit or key not in type_by_dest:
            continue
        action = type_by_dest[key]
        if isinstance(val, list):
            setattr(args, key, [action.type(v) for v in val])
        elif isinstance(action, argparse._StoreTrueAction):
            setattr(args, key, val.lower() in ("1", "true", "yes"))
        elif action.type is not None:
            setattr(args, key, action.type(val))
        else:
            setattr(args, key, val)
    return args


def config_parser(cmd=None, extra_parser_hook=None, known_only: bool = False):
    """(reference opt.py:197-202). ``cmd`` may be a string or token list."""
    parser = build_argparse()
    if extra_parser_hook is not None:
        extra_parser_hook(parser)
    if isinstance(cmd, str):
        cmd = shlex.split(cmd)
    tokens = cmd if cmd is not None else sys.argv[1:]
    if known_only:
        args, _ = parser.parse_known_args(tokens)
    else:
        args = parser.parse_args(tokens)
    return _apply_config_file(parser, args, tokens)
