"""Plain float32 PyTorch references of what the cells time.

Written from the published descriptions (DINOv2, IFFNeRF, TensoRF,
Ref-NeRF) in plain ``torch`` operations. Nothing here imports
``iffnerf_tpu_torch``, its kernels, their plain versions or its tests.
``precision(tf32)`` switches TensorFloat-32 products on for the control
runs and off for the reference itself.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full float32 (``tf32=False``, the reference) or
    in TF32 (the control), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
