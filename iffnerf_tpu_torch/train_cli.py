"""TensoRF training CLI of the port, with ``train.py``'s flags (reference
train.py:126-521) read through the port's ``config.py``.

    python -m iffnerf_tpu_torch.train_cli --config configs/lego.txt
    python -m iffnerf_tpu_torch.train_cli --config configs/lego.txt \\
        --render_only 1 --render_test 1 --ckpt <ckpt.npz>

    python -m iffnerf_tpu_torch.train_cli --config configs/flower.txt
    python -m iffnerf_tpu_torch.train_cli --config configs/co3d.txt \
        --export_mesh 1 --ckpt <ckpt.npz>

It trains on the CUDA card unless ``--device cpu`` is given, with every
loader of the JAX package's registry. ``--export_mesh 1`` writes
``<ckpt stem>.ply``, the marching-cubes surface of the checkpoint's dense
alpha at its grid (``utils/mesh.py``), then renders when ``--render_only``
asks for it, and trains only when neither is asked for.

Under ``torchrun`` with more than one process (``runtime.setup``)
``--data_mesh`` splits each batch's and each render's rays over the
ranks, as the JAX package's flag splits them over its devices: -1 (the
default) on when there is more than one rank, 0 off, 1 on
(``train/trainer.py::data_mesh``); only rank 0 logs and writes:

    torchrun --nproc_per_node=4 -m iffnerf_tpu_torch.train_cli \\
        --config configs/lego.txt --data_mesh 1
"""

from __future__ import annotations

import os
import sys

import numpy as np

from iffnerf_tpu_torch import runtime
from iffnerf_tpu_torch.config import config_parser
from iffnerf_tpu_torch.device import resolve_device


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")


def parse_args(argv=None):
    return config_parser(argv, extra_parser_hook=add_device_arg)


def load_checkpoint(path: str, device):
    """A field checkpoint, ``.npz`` or a reference ``.th`` -> (config,
    params, mask) on ``device``."""
    if path.endswith(".th"):
        from iffnerf_tpu_torch.checkpoint import load_torch_checkpoint

        return load_torch_checkpoint(path, device=device)
    from iffnerf_tpu_torch.checkpoint import load_field

    return load_field(path, device=device)


def render_test(args, log_fn=print) -> dict:
    """Evaluation of a checkpoint (reference train.py:53-123) -> {split:
    mean PSNR}, or {} when the checkpoint does not exist."""
    from iffnerf_tpu_torch.data import dataset_dict
    from iffnerf_tpu_torch.train.trainer import data_mesh, final_renders

    dev = resolve_device(args.device)
    if args.ckpt is None or not os.path.exists(args.ckpt):
        log_fn("the ckpt path does not exist!")
        return {}
    config, params, mask = load_checkpoint(args.ckpt, dev)
    test_dataset = dataset_dict[args.dataset_name](
        args.datadir, split="test", downsample=args.downsample_train,
        is_stack=True)
    return final_renders(args, config, params, mask,
                         os.path.dirname(args.ckpt), test_dataset,
                         log_fn=log_fn, device=dev,
                         mesh=data_mesh(args, log_fn))


def export_mesh(args) -> str:
    """Marching-cubes PLY of a checkpoint's dense alpha at its grid
    (reference train.py:39-49) -> the PLY's path, ``<ckpt stem>.ply``."""
    from iffnerf_tpu_torch.utils.mesh import export_mesh_from_field

    config, params, mask = load_checkpoint(args.ckpt,
                                           resolve_device(args.device))
    path = args.ckpt.rsplit(".", 1)[0] + ".ply"
    export_mesh_from_field(config, params, mask, path)
    return path


def main(argv=None):
    np.random.seed(20211202)
    args = parse_args(argv)
    runtime.setup(args.device)
    print(args)
    if args.export_mesh and int(os.environ.get("RANK", "0")) == 0:
        export_mesh(args)
    if args.render_only and (args.render_test or args.render_path):
        return render_test(args)
    if args.export_mesh:
        return None
    from iffnerf_tpu_torch.train.trainer import reconstruction

    return reconstruction(args, seed=20211202, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
