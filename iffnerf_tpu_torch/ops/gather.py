"""Row gather ``out[n, :] = table[idx[n], :]``, the texel fetch of the field.

``gather_rows`` launches the kernel of ``csrc/gather_rows.cu`` for CUDA
tensors (it replaces the TPU kernel ``pallas_gather`` of
``extra/pallas_gather_bench.py``; the source says what bounds it on an H100
and how its threads map onto rows) and ``gather_rows_plain`` for CPU
tensors. Each grid sampler of ``ops/grid_sample.py`` makes one call.

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
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}
# The bucketed route is taken for tables above this size (beyond what L2
# keeps) whose rows are at least this wide and that the indices read more
# than once on average; 4-byte rows (the mask) stay on the direct route,
# where scattered stores would write a 32-byte sector a row. A bucket spans
# BUCKET_BYTES of the table (tuned on an H100, PERF.md).
BUCKET_BYTES = 8 << 20
BUCKET_MIN_TABLE_BYTES = 32 << 20
BUCKET_MIN_ROW_BYTES = 64
MAX_BUCKETS = 64


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: [N, C] rows of ``table``."""
    r = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + r, i)
    ok = (i >= 0) & (i < r)
    # index_select: its backward is an index_add, which the CPU runs many
    # times faster than advanced indexing's accumulating index_put
    rows = torch.index_select(table, 0, i.clamp(0, r - 1))
    if bool(ok.all()):  # the samplers' clamped indices
        return rows
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


def rows_per_bucket(r: int, c: int, n: int) -> int:
    """Table rows a bucket of the bucketed route spans for a table [r, c]
    float32 and n indices, or 0 for the direct route."""
    row_bytes, table_bytes = 4 * c, 4 * r * c
    if (table_bytes <= BUCKET_MIN_TABLE_BYTES or row_bytes < BUCKET_MIN_ROW_BYTES
            or n <= r or n >= 2 ** 31):
        return 0
    return max(BUCKET_BYTES // row_bytes, -(-r // MAX_BUCKETS))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]`` -> [N, C] float32 for ``table`` [R, C] float32
    and ``idx`` [N] int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel (none for N = 0) or raise."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no row-gather kernel for {table.device}")
    _build.refuse_grad("gather_rows", (table,))
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    r, c = table.shape
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    lib = _build.load("gather_rows", _SIGNATURES)
    vec = c % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    per_bucket = rows_per_bucket(r, c, n)
    counts = perm = None
    if per_bucket:
        buckets = -(-r // per_bucket)
        counts = torch.zeros(2 * (buckets + 1), dtype=torch.int32,
                             device=table.device)
        perm = torch.empty(n, dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.iff_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), r, n, c, int(vec),
        _build.sm_count(table.device), per_bucket,
        None if counts is None else counts.data_ptr(),
        None if perm is None else perm.data_ptr(), stream)
    _build.check(rc, "gather_rows kernel launch")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
