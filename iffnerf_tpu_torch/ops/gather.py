"""Row gather ``out[n, :] = table[idx[n], :]``, the texel fetch of the field.

``gather_rows`` launches the kernel of ``csrc/gather_rows.cu`` for CUDA
tensors (it replaces the TPU kernel ``pallas_gather`` of
``extra/pallas_gather_bench.py``; the source says what bounds it on an H100
and how its threads map onto rows) and ``gather_rows_plain`` for CPU
tensors. Each grid sampler of ``ops/grid_sample.py`` makes one call.

Indices follow ``jnp.take``'s default, which the JAX package's samplers
use: ``-R <= i < 0`` wraps to ``i + R`` and any other index outside
``[0, R)`` gives a row of NaN. The samplers only pass clamped indices.

On CUDA ``gather_rows`` is differentiable in the table: an
``autograd.Function`` whose backward launches ``iff_gather_rows_bwd``
(the wrapper ``gather_rows_backward``), which merges each run of equal
rows before it adds into the table's row in device memory
(``backward_plan`` sets its launch); a NaN row's upstream is dropped, as
XLA's scatter drops it. Its plain version,
``gather_rows_backward_plain``, is an ``index_add_``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from iffnerf_tpu_torch.ops import _build

_SIGNATURES = {
    "iff_gather_rows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    "iff_gather_rows_bwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p],
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
# The backward's plan (csrc/gather_rows.cu, namespace bwd): column slices
# of at most BWD_MAX_SLICE columns; at most BWD_BLOCKS_PER_SM blocks of
# BWD_WARPS warps an SM (32 warps an SM: at 16 the samplers' step took
# 1.28 times as long, PERF.md); a lane holds at most BWD_MAX_Q words of an
# entry; a unit holds BWD_UNIT_MIN to BWD_UNIT_MAX entries, and a plan
# gives each warp about BWD_UNITS_PER_WARP units (a warp's last unit is
# the imbalance, a unit's end an extra add; tuned on an H100, PERF.md).
BWD_WARPS, BWD_BLOCKS_PER_SM = 16, 2
BWD_MAX_SLICE = 96
BWD_MAX_Q = 3
BWD_UNIT_MIN, BWD_UNIT_MAX = 32, 2048
BWD_UNITS_PER_WARP = 32


class BackwardPlan(NamedTuple):
    """``iff_gather_rows_bwd``'s launch: float4 words or not, the columns
    of a slice and the slices, blocks a slice and warps a block, log2 of
    the lanes a group, words a lane and entries a unit."""
    vec: bool
    slice_cols: int
    slices: int
    blocks: int
    warps: int
    log_g: int
    q: int
    unit: int


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: [N, C] rows of ``table``."""
    i, ok = _wrapped(idx, table.shape[0])
    # index_select: its backward is an index_add, which the CPU runs many
    # times faster than advanced indexing's accumulating index_put
    rows = torch.index_select(table, 0, i)
    if bool(ok.all()):  # the samplers' clamped indices
        return rows
    return torch.where(ok[:, None], rows, torch.nan)


def _wrapped(idx: torch.Tensor, r: int):
    """jnp.take's rule on int32 ``idx`` for a table of ``r`` rows ->
    (clamped row indices as int64, in-range flags)."""
    i = idx.long()
    i = torch.where(i < 0, i + r, i)
    ok = (i >= 0) & (i < r)
    return i.clamp(0, r - 1), ok


def gather_rows_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                               rows: int) -> torch.Tensor:
    """The backward's function in plain torch: a [rows, C] table of zeros
    with each upstream row ``grad[n]`` added into row ``idx[n]`` (wrapped
    as the forward wraps it; an out-of-range index adds nothing)."""
    i, ok = _wrapped(idx, rows)
    out = torch.zeros((rows, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    return out.index_add_(0, i, torch.where(ok[:, None], grad, 0.0))


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


def _launch(table, idx):
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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _slice_width(cols: int, slices: int, vf: int) -> int:
    """Columns of each of ``slices`` equal slices of ``cols``, a multiple
    of ``vf``."""
    return vf * _ceil(_ceil(cols, slices), vf)


def _groups(words: int):
    """(log2 of the lanes a group, words a lane) covering ``words`` words
    of a slice: the fewest words a lane, then the narrowest group."""
    for q in range(1, BWD_MAX_Q + 1):
        log_g = (_ceil(words, q) - 1).bit_length()
        if log_g <= 5:
            return log_g, q
    raise ValueError(f"no group covers {words} words")


def backward_plan(rows: int, cols: int, n: int, sms: int,
                  aligned: bool) -> BackwardPlan:
    """The backward's launch for ``n`` entries into a [rows, cols] table
    on a card of ``sms`` SMs, float4 words where ``cols`` % 4 == 0 and the
    pointers are ``aligned`` (16 bytes): the fewest slices of equal width
    (at most BWD_MAX_SLICE columns, a multiple of 4 on the float4 route);
    a group of lanes covers a slice's words with the fewest a lane (a
    slice of 96 columns: 24 lanes of one float4 word). Blocks (at most
    BWD_BLOCKS_PER_SM an SM in all, each warp at least 16 steps) and units
    give each warp about BWD_UNITS_PER_WARP units of consecutive entries.
    Raises ValueError for what the kernel does not take."""
    if not 0 < rows < 2 ** 31 or cols < 1 or n < 0 or sms < 1:
        raise ValueError(f"no backward plan for a [{rows}, {cols}] table, "
                         f"{n} entries and {sms} SMs")
    vec = bool(aligned) and cols % 4 == 0
    vf = 4 if vec else 1
    width = _slice_width(cols, _ceil(cols, BWD_MAX_SLICE), vf)
    slices = _ceil(cols, width)
    log_g, q = _groups(width // vf)
    e = 32 >> log_g  # entries a step
    blocks = max(1, min(BWD_BLOCKS_PER_SM * sms // slices,
                        _ceil(n, BWD_WARPS * e * 16), 65535))
    steps = min(BWD_UNIT_MAX // e, max(_ceil(BWD_UNIT_MIN, e), _ceil(
        n, blocks * BWD_WARPS * BWD_UNITS_PER_WARP * e)))
    unit = steps * e
    if slices > 65535 or _ceil(n, unit) >= 2 ** 31:
        raise ValueError(f"too many slices or units for a [{rows}, {cols}] "
                         f"table and {n} entries")
    return BackwardPlan(vec, width, slices, blocks, BWD_WARPS, log_g, q,
                        unit)


def _launch_backward(grad, idx, rows):
    n, c = grad.shape
    out = torch.zeros((rows, c), dtype=torch.float32, device=grad.device)
    if n == 0:
        return out
    plan = backward_plan(rows, c, n, _build.sm_count(grad.device),
                         grad.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.load("gather_rows", _SIGNATURES)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    rc = lib.iff_gather_rows_bwd(
        grad.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, c,
        int(plan.vec), plan.slice_cols, plan.blocks, plan.warps, plan.log_g,
        plan.q, plan.unit, stream)
    _build.check(rc, "gather_rows backward kernel launch")
    gather_rows_backward.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """The gather kernel and its hand-written backward; saves the indices
    only."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.rows = table.shape[0]
        ctx.save_for_backward(idx)
        return _launch(table, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return _launch_backward(grad.contiguous(), idx, ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]`` -> [N, C] float32 for ``table`` [R, C] float32
    and ``idx`` [N] int32. CPU tensors take the plain version; CUDA tensors
    launch the kernel (none for N = 0) or raise. On CUDA a table that
    requires grad gets its gradient from the backward kernel."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no row-gather kernel for {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    return _GatherRows.apply(table, idx)


def gather_rows_backward(grad: torch.Tensor, idx: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """The backward kernel's wrapper: a [rows, C] float32 table of zeros
    with each upstream row ``grad[n]`` ([N, C] float32) added into row
    ``idx[n]`` ([N] int32, wrapped as the forward wraps it; an index out of
    range adds nothing). CPU tensors take ``gather_rows_backward_plain``;
    CUDA tensors launch the kernel (none for N = 0) or raise."""
    if grad.dim() != 2 or grad.dtype != torch.float32 or grad.shape[1] < 1:
        raise ValueError(f"grad must be [N, C] float32 with C >= 1, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if not 0 < rows < 2 ** 31:
        raise ValueError(f"rows must be 1 to 2^31 - 1, got {rows}")
    if (idx.dim() != 1 or idx.dtype != torch.int32
            or idx.shape[0] != grad.shape[0]):
        raise ValueError(f"idx must be [{grad.shape[0]}] int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != grad.device:
        raise ValueError("grad and idx must share one device")
    if grad.device.type == "cpu":
        return gather_rows_backward_plain(grad, idx, rows)
    if grad.device.type != "cuda":
        raise ValueError(f"no row-gather kernel for {grad.device}")
    if not grad.is_contiguous() or not idx.is_contiguous():
        raise ValueError("grad and idx must be contiguous")
    return _launch_backward(grad, idx, rows)


gather_rows.launches = 0
gather_rows_backward.launches = 0
