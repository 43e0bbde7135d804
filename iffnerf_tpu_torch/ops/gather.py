"""Row gather ``out[n, :] = table[idx[n], :]``, the texel fetch of the field.

``gather_rows`` launches the kernel of ``csrc/gather_rows.cu`` for CUDA
tensors (it replaces the TPU kernel ``pallas_gather`` of
``extra/pallas_gather_bench.py``; the source says what bounds it on an H100
and how its threads map onto rows) and ``gather_rows_plain`` for CPU
tensors. Every texel fetch of ``ops/grid_sample.py`` goes through it.

Indices follow ``jnp.take``'s default, which the JAX package's samplers
use: ``-R <= i < 0`` wraps to ``i + R`` and any other index outside
``[0, R)`` gives a row of NaN. The samplers only pass clamped indices.
"""

from __future__ import annotations

import ctypes

import torch

from iffnerf_tpu_torch.ops import _build

_SIGNATURES = {
    "iff_gather_rows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
BLOCKS_PER_SM = 16  # grid cap of the grid-stride loop


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: [N, C] rows of ``table``."""
    r = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + r, i)
    ok = (i >= 0) & (i < r)
    rows = table[i.clamp(0, r - 1)]
    return torch.where(ok[:, None], rows, torch.nan)


def _check(table, idx):
    if table.dim() != 2 or table.dtype != torch.float32 or table.shape[1] < 1:
        raise ValueError(f"table must be [R, C] float32 with C >= 1, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not 0 < table.shape[0] < 2 ** 31:
        raise ValueError(f"table must have 1 to 2^31 - 1 rows, got "
                         f"{table.shape[0]}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be [N] int32, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError("table and idx must share one device")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]`` -> [N, C] float32 for ``table`` [R, C] float32
    and ``idx`` [N] int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel (none for N = 0) or raise."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no row-gather kernel for {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    r, c = table.shape
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    lib = _build.load("gather_rows", _SIGNATURES)
    vec = c % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.iff_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                             r, n, c, int(vec), BLOCKS_PER_SM * sms, stream)
    _build.check(rc, "gather_rows kernel launch")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
