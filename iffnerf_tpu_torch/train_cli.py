"""TensoRF training CLI of the port, with ``train.py``'s flags (reference
train.py:126-521) read through the port's ``config.py``.

    python -m iffnerf_tpu_torch.train_cli --config configs/lego.txt
    python -m iffnerf_tpu_torch.train_cli --config configs/lego.txt \\
        --render_only 1 --render_test 1 --ckpt <ckpt.npz>

It trains on the CUDA card unless ``--device cpu`` is given. The Blender
and Tanks-and-Temples loaders are ported; ``--export_mesh``,
``--render_path`` and NDC rays are not, and raise.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.device import resolve_device


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")


def parse_args(argv=None):
    return config_parser(argv, extra_parser_hook=add_device_arg)


def render_test(args, log_fn=print) -> dict:
    """Evaluation of a checkpoint (reference train.py:53-123) -> {split:
    mean PSNR}, or {} when the checkpoint does not exist."""
    from iffnerf_tpu_torch.checkpoint import load_field
    from iffnerf_tpu_torch.data import dataset_dict
    from iffnerf_tpu_torch.train.trainer import final_renders

    dev = resolve_device(args.device)
    if args.ckpt is None or not os.path.exists(args.ckpt):
        log_fn("the ckpt path does not exist!")
        return {}
    if args.ckpt.endswith(".th"):
        from iffnerf_tpu_torch.checkpoint import load_torch_checkpoint

        config, params, mask = load_torch_checkpoint(args.ckpt, device=dev)
    else:
        config, params, mask = load_field(args.ckpt, device=dev)
    test_dataset = dataset_dict[args.dataset_name](
        args.datadir, split="test", downsample=args.downsample_train,
        is_stack=True)
    return final_renders(args, config, params, mask,
                         os.path.dirname(args.ckpt), test_dataset,
                         log_fn=log_fn, device=dev)


def main(argv=None):
    np.random.seed(20211202)
    args = parse_args(argv)
    print(args)
    if args.export_mesh:
        raise NotImplementedError("mesh export is not ported")
    if args.render_only and (args.render_test or args.render_path):
        return render_test(args)
    from iffnerf_tpu_torch.train.trainer import reconstruction

    return reconstruction(args, seed=20211202, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
