"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
with ``device="cpu"`` (as the CPU tests do). Without a card they raise:
nothing falls back to the CPU on its own.

On the card, TF32 is switched off for matmuls and cuDNN convolutions, so
every float32 product runs in full float32: the parity checks against the
JAX package hold float32 results to tolerances that TF32's ten-bit
mantissa would break.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` (or any explicit device)
    is taken as given. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "iffnerf_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def tree_to(tree, device):
    """Moves every tensor of a nested dict/tuple/list to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(tree_to(v, device) for v in tree)
    return tree.to(device=device)


def leaves(tree) -> list:
    """The tensors of a nested dict/tuple, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/tuple; lists become tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def trainable(params, device):
    """Float32 copies of ``params`` on ``device`` that require grad. An
    optimizer must hold the very tensors a step reads, so they are made
    before it and never moved again: ``tree_to`` rebuilds the containers
    and ``.to`` another device returns new tensors."""
    return tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32)
                    .clone().requires_grad_(True), params)


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy array / tensor / sequence -> tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)
