"""PyTorch/CUDA port of iffnerf_tpu, beside the JAX package it is held to.

It imports torch, numpy and the standard library, never JAX or
iffnerf_tpu. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the kernels of ``csrc/`` are built with nvcc at first use.
Several cards (or CPU processes) split the ray axis over a data mesh of
``torch.distributed`` ranks (``parallel/``), which the CLIs start under
torchrun (``runtime.setup``).
"""

from iffnerf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
