"""Runtime set-up shared by the CLIs: the process group of a multi-process
run, the counterpart of the JAX package's ``runtime.setup``.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the
environment, ``WORLD_SIZE`` above 1) ``setup`` starts the default process
group from torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL when the
run is on the card, gloo for ``device="cpu"``; on the card it binds
``cuda:LOCAL_RANK`` first, so that ``device.resolve_device(None)`` gives
each rank its own card. A single process needs no group, and there
``setup`` does nothing.

The JAX package's persistent XLA compilation cache has no counterpart:
the port's compiled code is ``ops/_build.py``'s libraries, each named by
a hash of its sources and flags and built once into ``build/kernels``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def setup(device=None) -> None:
    """Starts the default process group of a ``torchrun`` launch of more
    than one process (NCCL on the card unless ``device`` is the CPU, then
    gloo); nothing for a single process or a group already started."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or dist.is_initialized():
        return
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if on_card else "gloo",
                            rank=int(os.environ["RANK"]), world_size=world)
