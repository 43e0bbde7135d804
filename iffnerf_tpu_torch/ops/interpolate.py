"""align_corners=True linear and bilinear resize for grid upsampling
(reference models/tensoRF.py:258-278, ``F.interpolate(..., mode='bilinear',
align_corners=True)``), in the JAX package's arithmetic
(``iffnerf_tpu/ops/interpolate.py``): each axis is a product with a
[dst, src] interpolation matrix built in numpy, so that an upsample gives
the JAX package's values to float rounding. It runs only at the upsample
events of training.
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] linear interpolation matrix, align_corners=True."""
    m = np.zeros((dst, src), dtype=np.float32)
    if dst == 1 or src == 1:
        m[:, 0] = 1.0
        return m
    coords = np.arange(dst) * (src - 1) / (dst - 1)
    i0 = np.floor(coords).astype(np.int64)
    i0 = np.clip(i0, 0, src - 2)
    w = coords - i0
    m[np.arange(dst), i0] = 1.0 - w
    m[np.arange(dst), i0 + 1] = w
    return m


def resize_linear_ac(x: torch.Tensor, new_len: int, axis: int = 0) -> torch.Tensor:
    """Linearly resize ``x`` along ``axis`` to ``new_len``
    (align_corners=True), in float32."""
    src = x.shape[axis]
    if src == new_len:
        return x
    m = torch.as_tensor(_interp_matrix(src, new_len), device=x.device)
    moved = torch.movedim(x, axis, 0)
    out = (m @ moved.reshape(src, -1)).reshape((new_len,) + moved.shape[1:])
    return torch.movedim(out, 0, axis).contiguous()


def resize_bilinear_ac(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinearly resize [H, W, C] -> [new_h, new_w, C] (align_corners=True)."""
    x = resize_linear_ac(x, new_h, axis=0)
    return resize_linear_ac(x, new_w, axis=1)
