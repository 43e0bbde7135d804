"""K3's backward plan (``ops/gather.py::backward_plan``) on the CPU: its
slices, groups, blocks and warps at the port's shapes and its refusals;
the C entry's arguments against the wrapper's signature; the timing
tool's text edits; a torch replay of a plan (a partial ``index_add_`` a
block's span and column slice, summed span by span) and a lane-level
model of the kernel's walk (``csrc/gather_rows.cu``, namespace ``bwd``:
steps of E entries, the segmented scan over the groups, the run carried
from step to step, an add a run) against ``jax.vjp`` of ``jnp.take``. The
kernel itself runs on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

Inputs are drawn by numpy from a seed. Tolerance: 1e-5 of the largest
|grad| (float32 sums of up to a few hundred terms in another order).
"""

import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch on one thread)
from iffnerf_tpu_torch.ops import gather
from iffnerf_tpu_torch.tools import k3_time

GRAD_TOL = 1e-5
SMS = 132


@pytest.mark.parametrize("rows,cols,aligned,slice_cols", [
    (505, 96, True, 96), (505, 288, True, 96), (2000, 96, True, 96),
    (16_061_175, 1, True, 1), (90_000, 48, True, 48), (40, 1, True, 1),
    (500, 7, True, 7), (505, 96, False, 96), (300, 290, True, 73),
    (90_000, 200, False, 67), (90_000, 200, True, 68)])
def test_backward_plan_at_the_ports_shapes(rows, cols, aligned, slice_cols):
    """Every column in exactly one slice; a slice's words covered by a
    group's lanes with less than half of them idle, at most BWD_MAX_Q a
    lane; at most BWD_BLOCKS_PER_SM blocks of BWD_WARPS warps an SM in
    all, and that many at the step's entries."""
    for n in (1, 409_320, 14_180_352):
        plan = gather.backward_plan(rows, cols, n, SMS, aligned)
        vf = 4 if plan.vec else 1
        assert plan.vec == (aligned and cols % 4 == 0)
        assert plan.slice_cols == slice_cols
        assert plan.slice_cols <= gather.BWD_MAX_SLICE
        assert plan.slice_cols % vf == 0
        owner = np.zeros(cols, int)
        for s in range(plan.slices):
            owner[s * plan.slice_cols:(s + 1) * plan.slice_cols] += 1
        assert (owner == 1).all()
        assert 1 <= plan.q <= (1 if plan.vec else gather.BWD_MAX_Q)
        assert (plan.q << plan.log_g) * vf >= plan.slice_cols
        assert (plan.q << plan.log_g) * vf < plan.slice_cols * 2 or (
            plan.log_g == 0)
        assert plan.unit % (32 >> plan.log_g) == 0
        assert plan.warps == gather.BWD_WARPS
        cap = gather.BWD_BLOCKS_PER_SM * SMS
        assert plan.blocks * plan.slices <= max(cap, plan.slices)
        if n == 14_180_352:
            assert plan.blocks == cap // plan.slices


def test_backward_entry_takes_the_wrappers_arguments():
    """``iff_gather_rows_bwd``'s C parameters, in order, are the ctypes
    signature the wrapper binds (pointers, ints, the entry count)."""
    source = (Path(gather.__file__).parents[1] / "csrc"
              / "gather_rows.cu").read_text()
    head = source[source.index('extern "C" int iff_gather_rows_bwd('):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    got = [kinds[" ".join(p.split()[:-1]).replace("const ", "")]
           for p in params]
    assert got == gather._SIGNATURES["iff_gather_rows_bwd"]


@pytest.mark.parametrize("args", [(0, 96, 10, SMS), (2 ** 31, 1, 10, SMS),
                                  (505, 0, 10, SMS), (505, 96, -1, SMS),
                                  (505, 96, 10, 0)])
def test_backward_plan_refuses(args):
    with pytest.raises(ValueError):
        gather.backward_plan(*args, True)


def _spans(plan, n):
    """Each block's span of entries: ceil(n / unit) units split evenly."""
    units = -(-n // plan.unit)
    return [(units * b // plan.blocks * plan.unit,
             min(units * (b + 1) // plan.blocks * plan.unit, n))
            for b in range(plan.blocks)]


def _replay(up, idx, rows, plan):
    """The plan replayed in torch: a partial index_add_ of each block's span
    into its column slice, summed span by span."""
    out = torch.zeros((rows, up.shape[1]))
    for s in range(plan.slices):
        cols = slice(s * plan.slice_cols, (s + 1) * plan.slice_cols)
        for lo, hi in _spans(plan, up.shape[0]):
            out[:, cols] += gather.gather_rows_backward_plain(
                up[lo:hi, cols].contiguous(), idx[lo:hi], rows)
    return out


def _walk(up, idx, rows, plan):
    """The kernel's walk, lane by lane in numpy: each block's units in
    steps of E entries (K steps loaded at once), the segmented scan over
    the groups, the carried run, an add a run into the table -> (the
    table, the adds)."""
    n, c = up.shape
    e_n = 32 >> plan.log_g
    i = idx.astype(np.int64)
    i = np.where(i < 0, i + rows, i)
    row = np.where((i >= 0) & (i < rows), i, -1)
    out, adds = np.zeros((rows, c)), 0
    for s in range(plan.slices):
        c0, c1 = s * plan.slice_cols, min((s + 1) * plan.slice_cols, c)
        for lo_b, hi_b in _spans(plan, n):
            acc = np.zeros((rows, c1 - c0))
            for lo in range(lo_b, hi_b, plan.unit):
                hi = min(lo + plan.unit, n)
                crow, carry = -1, np.zeros(c1 - c0)
                for b in range(lo, hi, e_n):  # K steps a batch: one order
                    ns = np.arange(b, b + e_n)
                    r = np.where(ns < hi, row[np.minimum(ns, n - 1)], -1)
                    x = np.where((ns < hi)[:, None],
                                 up[np.minimum(ns, n - 1), c0:c1], 0.0)
                    f = np.r_[True, r[1:] != r[:-1]]
                    tail = np.r_[r[1:] != r[:-1], True]
                    d = 1
                    while d < e_n:
                        x_up, f_up = x.copy(), f.copy()
                        take = (np.arange(e_n) >= d) & ~f
                        x[take] += x_up[np.nonzero(take)[0] - d]
                        f[take] = f_up[np.nonzero(take)[0] - d]
                        d <<= 1
                    t0 = int(np.argmax(tail))
                    runs = [(crow, carry)] if crow >= 0 and crow != r[0] else []
                    if crow >= 0 and crow == r[0]:
                        x[:t0 + 1] += carry
                    runs += [(r[e], x[e]) for e in range(e_n - 1)
                             if tail[e] and r[e] >= 0]
                    for rr, v in runs:
                        acc[rr] += v
                        adds += int((v != 0).any())
                    crow, carry = int(r[-1]), x[-1].copy()
                if crow >= 0:
                    acc[crow] += carry
                    adds += 1
            out[:, c0:c1] += acc
    return out, adds


def _take_vjp(table_shape, idx, up):
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                     jnp.zeros(table_shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(up))[0])


def _entries(kind, rows, n, rng):
    if kind == "runs":  # rays of a line: runs of 1 to 8 equal rows
        return np.repeat(rng.integers(0, rows, n), rng.integers(1, 9, n))[:n]
    if kind == "edges":  # wrapped and out-of-range indices in runs
        return np.repeat(rng.integers(-rows - 3, rows + 3, n),
                         rng.integers(1, 4, n))[:n]
    if kind == "ones":  # runs of 1
        return (np.arange(n) * 7) % rows
    return np.full(n, rows // 3)  # one run over every span


@pytest.mark.parametrize("rows,cols,n,sms,kind", [
    (40, 96, 2999, 4, "runs"), (40, 288, 3001, 6, "edges"),
    (40, 1, 30_001, 3, "runs"), (40, 12, 20_001, 2, "ones"),
    (40, 16, 5000, 3, "whole"), (40, 7, 2101, 2, "edges"),
    (60_000, 5, 9001, 2, "runs")])
def test_backward_plan_replay_and_walk_match_jax_take_vjp(rows, cols, n, sms,
                                                          kind):
    """A 40-row line (and a 60 000-row table) at runs of
    1 to 8, wrapped and out-of-range indices, runs of 1 and one run over
    every span, N not a multiple of a unit or a span: the plan's replay
    and the kernel's walk within GRAD_TOL of jax.vjp of jnp.take."""
    rng = np.random.default_rng(rows + cols + n)
    idx = _entries(kind, rows, n, rng).astype(np.int32)
    up = rng.standard_normal((n, cols)).astype(np.float32)
    up[rng.random(n) < 0.2] = 0.0
    plan = gather.backward_plan(rows, cols, n, sms, True)
    assert plan.blocks > 1
    assert n % plan.unit != 0
    want = _take_vjp((rows, cols), idx, up)
    tol = GRAD_TOL * np.abs(want).max()
    got = _replay(torch.from_numpy(up), torch.from_numpy(idx), rows, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    walked, adds = _walk(up.astype(np.float64), idx, rows, plan)
    np.testing.assert_allclose(walked, want, rtol=0, atol=tol)
    changes = 1 + int((idx[1:] != idx[:-1]).sum())
    units = plan.slices * -(-n // plan.unit)
    assert adds <= plan.slices * changes + units
    if kind == "whole":
        assert adds == units


@pytest.mark.parametrize("name", sorted(k3_time.VARIANTS))
def test_k3_time_variants_edit_the_source(name):
    """Each text edit of ``tools/k3_time.py``'s variants of this checkout's
    backward finds its text exactly once, and the source's backward is not
    the first design; a plan variant's plans at the timed shapes are plans
    the kernel takes (groups covering the slice, units of whole steps)."""
    source = (Path(gather.__file__).parents[1] / "csrc"
              / "gather_rows.cu").read_text()
    edits, _, transform = k3_time.VARIANTS[name]
    assert (k3_time.variant_source(name, source) != source) == bool(edits)
    assert not k3_time.first_design(source)
    if transform is None:
        return
    for rows, cols, n in ((489, 96, 14_180_352), (489, 288, 409_320),
                          (90_000, 48, 818_640), (16_061_175, 1, 56_721_408)):
        plan = transform(gather.backward_plan(rows, cols, n, SMS, True))
        vf = 4 if plan.vec else 1
        assert plan.q <= (1 if plan.vec else 3)
        assert (plan.q << plan.log_g) * vf >= plan.slice_cols
        assert plan.unit % (32 >> plan.log_g) == 0
