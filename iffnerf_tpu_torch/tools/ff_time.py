"""Times field_features' backward kernel, or with ``--forward`` its
forward kernel, or with ``--coords`` its coordinate-gradient kernel, on
one card, beside the parent's kernel and variants.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory. Its inputs are those of ``chip_smoke.py``'s field-training
phase: ``chip_smoke.train_with_capture`` runs ``train_field`` at
configs/lego.txt's widths (12 steps from a 128^3 field to 299^3) and keeps
the inputs of the backward's first launch at each grid; beside them the
axis-aligned ray set of ``chip_smoke.axis_ray_inputs`` at the final grid,
where consecutive samples share the most rows, and for the forward a
colour chunk's shape at the final grid (``colour_chunk_samples``:
204 660 ray-major samples, 20 a ray, 2 texels apart). It prints one JSON
line: for each variant, the kernel's graph-replayed and eager ms (medians
of CUDA-event batches, ``chip_smoke.time_ms``) at the 128^3 step, the
299^3 step, the axis-aligned set (and the colour chunk), its check
against the plain version at each (``chip_smoke.backward_errors``, or
``chip_smoke.forward_errors``: app products bit-equal, sigma within
FIELD_RTOL and FIELD_ATOL),
and a field-training step's split (forward, backward, Adam by CUDA
events); once, the corner-row adds of the backward (6 rows a sample and
axis pair with a gradient against the rows a run's walk leaves,
``row_adds``), or the corner-row reads of the forward (6 rows a sample and
axis pair against the rows a walk's cells enter, at runs of 1, 8, 16 and
the source's longest, ``row_fetches``) and each case's bytes bound.

    cd <checkout> && python3 <path>/ff_time.py <label> [--forward | --coords] [--variants A,B] [--rounds N] [--parent DIR]

With ``--coords`` the inputs are those of ``chip_smoke.py``'s iNeRF
phase instead (no training run): one refinement iteration's samples and
upstream, kept at its coordinate-kernel launch
(``chip_smoke.captured_iteration``: 1 060 864 samples at 300^3, about 4 %
of them with upstream), and the all-live ray-ordered set of as many
samples (``chip_smoke.all_live_coords_inputs``); for each variant the
kernel's graph-replayed and eager ms at both, its check against the
plain version (``chip_smoke.coords_grad_errors``) and bit-equal repeats,
and once each case's bound (``chip_smoke.coords_grad_bound``) and live
samples.

``--variants`` builds text edits of the checkout's
``csrc/field_features.cu`` into ``build/kernels/variants/``, all nvcc
processes at once, and times them in turns with the source's, ``--rounds``
times over:

- ``source``: the checkout's own build;
- ``parent``: ``DIR/iffnerf_tpu_torch/csrc/field_features.cu`` as it is,
  with ``--parent DIR`` (a parent commit unpacked beside the change; its C
  interface is this one's);
- ``no_merge``: each sample adds its sums to the gradients at once and
  reads its corner rows anew: what merging along a run buys;
- ``no_ring``: the consumers read every stage from global memory and the
  producer copies nothing: what the bulk-copy ring buys;
- ``run8`` ... ``run256``: runs of 8, 16, 64, 128 or 256 samples in place
  of 32;
- ``warps6``: 6 consumer warps a block (4 runs at lego's ranks), 2 blocks
  an SM;
- ``warps2``: 2 consumer warps a block (one run at lego's ranks), 5
  blocks an SM;
- ``g32``: groups of 32 lanes (at lego's ranks 16 of them idle, and a run
  a block);
- ``stages2``: a 2-stage ring;
- ``stream_normal``: the upstream copied under L2's normal policy in place
  of evict-first;
- ``no_add``, ``no_reads``, ``no_red``, ``no_line_red``, ``no_plane_red``
  (their gradients mean nothing, and are not checked): no sample added, no
  table row read (zeros), no sum added to the gradients (or to the line
  or the plane gradients only): what the walk costs without each;
- ``clocks``: counters of each group's cycles waiting for ring stages and
  in the adds, and of its adds and walked samples, over one call at each
  input.

The coordinate kernel's variants (with ``--coords``; ``source`` and
``parent`` as above, the parent's kernel the first design: a group of
lanes a sample, its upstream and corners loaded in dependent bursts):

- ``c_no_ring``: every stage copied in by the consumers' own loads, the
  producer copying nothing: what the bulk-copy ring buys;
- ``c_no_walk``: every live sample reads all 6 corner rows of each pair
  (no run walk);
- ``c_no_skip``: every sample counted live (the dead ones computed with
  their zero upstream): what skipping dead samples and stages buys;
- ``c_stages3``, ``c_stages4``: a 3- or 4-stage ring in place of 2;
- ``c_run4``, ``c_run16``: runs of 4 or 16 samples in place of 8;
- ``c_warps4``, ``c_warps12``: 4 or 12 consumer warps in place of 8;
- ``c_occ3``: registers capped for 3 blocks an SM.

The forward's variants (with ``--forward``; ``source`` and ``parent`` as
above):

- ``fwd_no_store``, ``fwd_one_row``, ``fwd_no_lerp``: edits of a
  ``--parent`` checkout whose forward is the first design (a group of
  lanes a sample, 6 corner rows read for each axis pair): its app stores
  cut out
  (the products summed into sigma instead), one corner row read a pair in
  place of 6, the lerps replaced by a sum of the 6 words; their outputs
  mean nothing and are not checked;
- ``walk_no_store``, ``walk_no_lerp``, ``walk_row0``, ``walk_row0_no_store``,
  ``walk_rows_in_l2``, ``walk_cells_only`` (not checked): this checkout's
  walk without its app stores (the products summed into sigma), with the
  lerps replaced by a sum, with every entered corner read from the
  table's first row (the reads kept, their traffic gone; and the stores
  cut too), with every entered row read from the table's first 4 096
  rows, which stay in L2 (device-memory traffic for rows gone), and
  without its word pass (the cell pass, barriers and sigma pass left);
  ``walk_rows_div2``, ``walk_rows_div4`` (not checked): every entered row
  read from row // 2 or row // 4, the tables' footprint halved or
  quartered (at 299^3: 35 or 17 MB, under L2's 50 MB);
- ``walk_run1``, ``walk_run8``, ``walk_run16``, ``walk_run64``: a longest
  run of 1 (every sample reads all its corners), 8, 16 or 64 in place of
  32;
- ``walk_spans1``, ``walk_spans16``: the host halves the run until every
  resident block has 1 or 16 spans in place of 4;
- ``walk_warps4``, ``walk_warps16``: blocks of about 4 or 16 warps in
  place of 8; ``walk_lb5``, ``walk_lb6``: blocks of at most 8 warps, and
  registers capped for 5 or 6 blocks an SM;
- ``walk_no_unroll``: the step loop not unrolled by 2;
- ``walk_ahead2``: the rows that the step two ahead enters prefetched into
  L1;
- ``walk_store_normal``: the app products stored under L2's normal policy
  in place of evict-first;
- ``walk_keep5``, ``walk_keep7``, ``walk_keep10``: the table rows read
  under L2's evict-last policy for 50, 70 or 100 % of lines;
  ``walk_keep3_ef``, ``walk_keep5_ef``, ``walk_keep7_ef``: for 30, 50 or
  70 %, the other lines evicted first.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# axis directions and two diagonals: rays in the order training samples
# them, half a texel apart on the finest axis
AXES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
DIAGONALS = ((1, 1, 1), (1, -1, 1))

_CALL = "add_sample<VEC>(o, k, sx[3 * u], sx[3 * u + 1], sx[3 * u + 2], gv);"
_GMASK = "  const unsigned gmask = g == 32 ? 0xffffffffu : ((1u << g) - 1) << (lane & ~(g - 1));\n"
_WAIT = "      hop::mbar_wait(full + s, (it / kStages) & 1);\n"
_WALKED = "    if (live) flush_all<VEC>(o, k);\n  }\n"
_END = _WALKED + "}\n"
_CLOCKS_TAIL = """
extern "C" int iff_ff_clocks(void* out, int reset) {
  if (reset) return static_cast<int>(cudaMemset(iff::bwd::clk_ptr(), 0, 5 * 8));
  return static_cast<int>(cudaMemcpy(out, iff::bwd::clk_ptr(), 5 * 8, cudaMemcpyDeviceToHost));
}
"""
# name -> (text edits of the source, whether its gradients mean anything)
_VARIANTS = {
    "no_merge": ([(_CALL, "{\n          " + _CALL + "\n          flush_all<VEC>(o, k);\n"
                   "          reset(k);\n        }")], True),
    "no_ring": ([("  p.direct = (", "  p.direct = 1 || (")], True),
    "run8": ([("constexpr int kRunSamples = 32;", "constexpr int kRunSamples = 8;")], True),
    "run16": ([("constexpr int kRunSamples = 32;", "constexpr int kRunSamples = 16;")], True),
    "run64": ([("constexpr int kRunSamples = 32;", "constexpr int kRunSamples = 64;")], True),
    "run128": ([("constexpr int kRunSamples = 32;", "constexpr int kRunSamples = 128;")], True),
    "run256": ([("constexpr int kRunSamples = 32;", "constexpr int kRunSamples = 256;")], True),
    "warps6": ([("constexpr int kConsumerWarps = 3;", "constexpr int kConsumerWarps = 6;"),
                ("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 2;")], True),
    "warps2": ([("constexpr int kConsumerWarps = 3;", "constexpr int kConsumerWarps = 2;"),
                ("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 5;")], True),
    "stages2": ([("constexpr int kStages = 4;", "constexpr int kStages = 2;")], True),
    "stream_normal": ([("createpolicy.fractional.L2::evict_first", "createpolicy.fractional.L2::evict_normal")], True),
    # cut-outs: the gradients mean nothing
    "no_add": ([(_CALL, "if (n0 < 0) " + _CALL)], False),
    "no_reads": ([("  return inside(y, x, o.h, o.w)\n", "  return false && inside(y, x, o.h, o.w)\n"),
                  ("  return l >= 0 && l < o.len ?", "  return false && l >= 0 && l < o.len ?")],
                 False),
    "no_line_red": ([("  if (o.gline && l >= 0", "  if (false && l >= 0")], False),
    "no_plane_red": ([("  if (o.gplane && inside(y, x, o.h, o.w)", "  if (false && inside(y, x, o.h, o.w)")], False),
    "g32": ([("  const int g = 1 << log_g;\n  b::Plan p;", "  log_g = 5;\n  const int g = 1 << log_g;\n  b::Plan p;")], True),
    "no_red": ([("  if (o.gplane && inside(y, x, o.h, o.w)", "  if (false && inside(y, x, o.h, o.w)"),
                ("  if (o.gline && l >= 0", "  if (false && l >= 0")], False),
    # clock counters: each group's leader adds up the cycles it waits for
    # stages and spends in add_sample, its adds and its whole walk
    "clocks": ([
        ("template <int VEC>\n__global__ void __launch_bounds__(kThreads, kBlocksPerSM)",
         "__device__ unsigned long long g_clk[5];\n"
         "__host__ void* clk_ptr() { void* p; cudaGetSymbolAddress(&p, g_clk); return p; }\n"
         "template <int VEC>\n__global__ void __launch_bounds__(kThreads, kBlocksPerSM)"),
        (_GMASK, _GMASK + "  long long t_wait = 0, t_add = 0, n_add = 0, n_walk = 0;\n"
                          "  const long long t_start = clock64();\n"),
        (_WAIT, "      { const long long c0 = clock64();\n" + _WAIT
                + "      t_wait += clock64() - c0; }\n"),
        (_CALL, "{ const long long c0 = clock64();\n          " + _CALL
                + "\n          t_add += clock64() - c0; ++n_add; }"),
        ("        Vec<VEC> gv = zero_vec<VEC>();\n",
         "        Vec<VEC> gv = zero_vec<VEC>();\n        n_walk += u < count;\n"),
        (_END, _WALKED + "  if ((threadIdx.x & (g - 1)) == 0) {\n"
               "    atomicAdd(g_clk, (unsigned long long)t_wait);\n"
               "    atomicAdd(g_clk + 1, (unsigned long long)t_add);\n"
               "    atomicAdd(g_clk + 2, (unsigned long long)n_add);\n"
               "    atomicAdd(g_clk + 3, (unsigned long long)(clock64() - t_start));\n"
               "    atomicAdd(g_clk + 4, (unsigned long long)n_walk);\n  }\n}\n")], True),
}


_PARENT_LOADS = """          const Vec<VEC> t01 = load_vec<VEC>(plane + r01 * c + col);
          const Vec<VEC> t10 = load_vec<VEC>(plane + r10 * c + col);
          const Vec<VEC> t11 = load_vec<VEC>(plane + r11 * c + col);
          const Vec<VEC> l0 = load_vec<VEC>(line + al.i0 * c + col);
          const Vec<VEC> l1 = load_vec<VEC>(line + al.i1 * c + col);
"""
_PARENT_LERP = """            const float top = lerp(__fmul_rn(t00.v[q], v00), __fmul_rn(t01.v[q], v01), ax.u, ax.w);
            const float bot = lerp(__fmul_rn(t10.v[q], v10), __fmul_rn(t11.v[q], v11), ax.u, ax.w);
            const float pf = lerp(top, bot, ay.u, ay.w);
            const float lf = lerp(__fmul_rn(l0.v[q], al.v0), __fmul_rn(l1.v[q], al.v1), al.u, al.w);
            prod.v[q] = __fmul_rn(pf, lf);
"""
_WALK_LERP = """    const float r0 = lerp(t[0].v[q], t[1].v[q], st.wxy.x, st.wxy.y);
    const float r1 = lerp(t[2].v[q], t[3].v[q], st.wxy.x, st.wxy.y);
    const float pf = lerp(r0, r1, st.wxy.z, st.wxy.w);
    const float lf = lerp(l[0].v[q], l[1].v[q], st.wl.x, st.wl.y);
    p.v[q] = __fmul_rn(pf, lf);
"""


def _constant(name, value):
    return f"constexpr int {name} = {value};"


_PRODUCT = "// The plane-times-line word of a sample in the samplers' order: each lerp"
_WALK_STEP = """        float s = 0.0f;
        if (live) {
          const Step e = st[u];
"""
_STORE = "            store_stream<VEC>(out, prod, once);\n"
_PREFETCH = """__device__ __forceinline__ void prefetch_row(const float* base, int row, int64_t c) {
  if (row >= 0) asm volatile("prefetch.global.L1 [%0];" ::"l"(base + row * c));
}

"""
_PLAIN_STORE = """__device__ __forceinline__ void store_plain(float* p, const Vec<4>& x) {
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
}

__device__ __forceinline__ void store_plain(float* p, const Vec<1>& x) { *p = x.v[0]; }

"""
_ENTER = "  if (row >= 0) t = load_vec<VEC>(base + row * c);"
_ENTERS = "// A corner a slot enters: its row's word."


def _keep_loads(fraction, rest="evict_unchanged"):
    """Table reads under L2's evict-last policy for ``fraction`` of the
    lines, ``rest`` for the others (a text to put before the forward's
    helpers)."""
    policy = (f"  uint64_t k;\n  asm(\"createpolicy.fractional.L2::evict_last.L2::{rest}"
              f".b64 %0, {fraction};\" : \"=l\"(k));\n")
    return ("__device__ __forceinline__ Vec<4> load_keep(const float* p, Vec<4>) {\n" + policy
            + "  Vec<4> x;\n  asm(\"ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\""
            " : \"=f\"(x.v[0]), \"=f\"(x.v[1]), \"=f\"(x.v[2]), \"=f\"(x.v[3]) : \"l\"(p), \"l\"(k));\n"
            "  return x;\n}\n\n"
            "__device__ __forceinline__ Vec<1> load_keep(const float* p, Vec<1>) {\n" + policy
            + "  Vec<1> x;\n  asm(\"ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\""
            " : \"=f\"(x.v[0]) : \"l\"(p), \"l\"(k));\n  return x;\n}\n\n")


# forward variants: name -> (the source they edit: "parent", the --parent
# checkout's (the grid-stride design a sample a group), or "source", this
# checkout's walk; its text edits; whether its outputs mean anything)
_FWD_VARIANTS = {
    "fwd_no_store": ("parent", [(
        "            store_vec<VEC>(app + n * a.app_cols + a.app_off[i] + col, prod);\n",
        "            for (int q = 0; q < VEC; ++q) s += prod.v[q];\n")], False),
    "fwd_one_row": ("parent", [(
        _PARENT_LOADS,
        "          const Vec<VEC> t01 = t00, t10 = t00, t11 = t00, l0 = t00, l1 = t00;\n")],
        False),
    "fwd_no_lerp": ("parent", [(
        _PARENT_LERP,
        "            prod.v[q] = t00.v[q] + t01.v[q] + t10.v[q] + t11.v[q] + l0.v[q] + l1.v[q];\n")],
        False),
    "walk_no_store": ("source", [(
        _STORE, "            for (int q = 0; q < VEC; ++q) s += prod.v[q];\n")], False),
    "walk_no_lerp": ("source", [(
        _WALK_LERP,
        "    p.v[q] = t[0].v[q] + t[1].v[q] + t[2].v[q] + t[3].v[q] + l[0].v[q] + l[1].v[q];\n")],
        False),
    "walk_row0": ("source", [("load_vec<VEC>(base + row * c);",
                               "load_vec<VEC>(base + (row & 0) * c);")], False),
    "walk_rows_in_l2": ("source", [("load_vec<VEC>(base + row * c);",
                                     "load_vec<VEC>(base + (row & 4095) * c);")], False),
    **{f"walk_rows_div{d}": ("source", [("load_vec<VEC>(base + row * c);",
                                         f"load_vec<VEC>(base + row / {d} * c);")], False)
       for d in (2, 4)},
    "walk_cells_only": ("source", [(
        "    for (int slot = gid; slot < slots; slot += groups) {",
        "    for (int slot = gid + slots; slot < slots; slot += groups) {")], False),
    **{f"walk_run{r}": ("source", [(_constant("kMaxRun", 32), _constant("kMaxRun", r))], True)
       for r in (1, 8, 16, 64)},
    # the entered rows of the step two ahead prefetched into L1
    "walk_ahead2": ("source", [(_PRODUCT, _PREFETCH + _PRODUCT), (_WALK_STEP, """        float s = 0.0f;
        if (live && u + 2 < cnt) {
          const int4 pr = st[u + 2].plane;
          const int2 lr = st[u + 2].line;
          prefetch_row(o.plane, pr.x, o.c);
          prefetch_row(o.plane, pr.y, o.c);
          prefetch_row(o.plane, pr.z, o.c);
          prefetch_row(o.plane, pr.w, o.c);
          prefetch_row(o.line, lr.x, o.c);
          prefetch_row(o.line, lr.y, o.c);
        }
        if (live) {
          const Step e = st[u];
""")], True),
    # the app products stored under L2's normal policy
    "walk_store_normal": ("source", [(_PRODUCT, _PLAIN_STORE + _PRODUCT), (
        _STORE, "            store_plain(out, prod);\n")], True),
    # the table rows read under L2's evict-last policy, for 50, 70 or 100 % of lines
    **{f"walk_keep{f}": ("source", [(_ENTERS, _keep_loads(f / 10) + _ENTERS), (
        _ENTER, "  if (row >= 0) t = load_keep(base + row * c, t);")], True)
       for f in (5, 7, 10)},
    # the same for 30, 50 or 70 % of lines, the others evicted first
    **{f"walk_keep{f}_ef": ("source", [(_ENTERS, _keep_loads(f / 10, "evict_first") + _ENTERS), (
        _ENTER, "  if (row >= 0) t = load_keep(base + row * c, t);")], True)
       for f in (3, 5, 7)},
    "walk_no_unroll": ("source", [("#pragma unroll 2\n      for (int u = 0; u < cnt; ++u) {",
                                   "      for (int u = 0; u < cnt; ++u) {")], True),
    **{f"walk_lb{b}": ("source", [(_constant("kMaxWarps", 16), _constant("kMaxWarps", 8)), (
        "__global__ void __launch_bounds__(kMaxWarps * 32)\n    field_features_kernel(",
        f"__global__ void __launch_bounds__(kMaxWarps * 32, {b})\n    field_features_kernel(")],
        True) for b in (5, 6)},
    "walk_row0_no_store": ("source", [
        ("load_vec<VEC>(base + row * c);", "load_vec<VEC>(base + (row & 0) * c);"),
        (_STORE, "            for (int q = 0; q < VEC; ++q) s += prod.v[q];\n")], False),
    **{f"walk_spans{k}": ("source", [(_constant("kSpansPerBlock", 4),
                                      _constant("kSpansPerBlock", k))], True)
       for k in (1, 16)},
    **{f"walk_warps{w}": ("source", [(_constant("kWarps", 8), _constant("kWarps", w))], True)
       for w in (4, 16)},
}


# coordinate-kernel variants: name -> (text edits of the source, whether
# its gradients mean anything)
_COORD_VARIANTS = {
    "c_no_ring": ([("  p.direct = 0 != (ends & 15);", "  p.direct = 1;")], True),
    "c_no_walk": ([("const int prev = below ? k - u + 31 - __clz(below) : -1;",
                    "const int prev = -1;")], True),
    "c_no_skip": ([("      const bool nz = ss[k] != 0.0f;", "      const bool nz = k < count;"),
                   ("    const int words = p.stage * p.cols / VEC;", "    const int words = 0;")],
                  True),
    **{f"c_stages{k}": ([("constexpr int kStages = 2;          // ring depth",
                          f"constexpr int kStages = {k};          // ring depth")], True)
       for k in (3, 4)},
    **{f"c_run{r}": ([("constexpr int kCoordRun = 8;", f"constexpr int kCoordRun = {r};")], True)
       for r in (4, 16)},
    **{f"c_warps{w}": ([("constexpr int kConsumerWarps = 8;", f"constexpr int kConsumerWarps = {w};")],
                       True) for w in (4, 12)},
    # a 2-stage ring and registers capped for 3 blocks an SM
    "c_occ3": ([("constexpr int kBlocksPerSM = 2;\nconstexpr int kBarrierBytes",
                 "constexpr int kBlocksPerSM = 3;\nconstexpr int kBarrierBytes")], True),
}


def ray_ordered_samples(grid, directions, per_ray, seed, spread=0.8,
                        texels=0.5):
    """Normalized coords [len(directions) * per_ray, 3] float32, ray-major:
    for each direction one ray of ``per_ray`` samples ``texels`` texels
    apart on the grid's finest axis (half a texel: training's step),
    centred on a point drawn uniformly from [-spread, spread]^3 (numpy,
    from ``seed``). Long rays leave [-1, 1]."""
    rng = np.random.default_rng(seed)
    step = 2.0 * texels / (max(grid) - 1)
    rays = []
    for d in directions:
        d = np.asarray(d, np.float64)
        d = d / np.linalg.norm(d)
        k = np.arange(per_ray) - per_ray / 2 + rng.random()
        rays.append(rng.uniform(-spread, spread, 3) + d * (k * step)[:, None])
    return np.concatenate(rays).astype(np.float32)


def ray_upstream(n, width, seed):
    """Upstream gradients for ``n`` ray-ordered samples (numpy, from
    ``seed``): dsigma [n] and dapp [n, width] normal, with stretches of
    zeros inside runs (dsigma zero on 37 of every 111 samples, dapp rows on
    23 of every 92, and a tenth of dapp's words) -> (dsigma, dapp)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    dsigma = rng.standard_normal(n).astype(np.float32)
    dsigma[(k // 37) % 3 == 0] = 0.0
    dapp = rng.standard_normal((n, width)).astype(np.float32)
    dapp[(k // 23) % 4 == 1] = 0.0
    dapp[rng.random((n, width)) < 0.1] = 0.0
    return dsigma, dapp


def run_samples(root: Path, name: str = "kRunSamples") -> int:
    """A constant of a checkout's field_features.cu: the backward's run
    length (``kRunSamples``), or another ``constexpr int`` by name whose
    value is a product of integers."""
    src = (root / "iffnerf_tpu_torch" / "csrc" / "field_features.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9* ]+);", src).group(1)
    return math.prod(int(t) for t in expr.split("*"))


def row_adds(params, xyz, dsigma, dapp, run):
    """Corner-row adds of one backward: the old design's (each sample with
    an upstream gradient adds into its 4 plane and 2 line corner rows of
    each axis pair) and this design's (a row adds when the walk of a run of
    ``run`` samples leaves it, and at the run's end). At lego's ranks a
    row add is one float4 RED for each of the pair's 16 words whose sum is
    not zero; counted on the card in torch -> {"old", "new", "factor"}."""
    from iffnerf_tpu_torch.ops.field_features import MAT_MODE, VEC_MODE, kernel_layout

    _, dims = kernel_layout(params, dapp is not None)
    old = new = 0
    for i in range(3):
        h, w, length = dims[5 * i:5 * i + 3]
        live = dsigma != 0
        if dapp is not None:
            off, ra = dims[15 + i], dims[5 * i + 4]
            live = live | (dapp[:, off:off + ra] != 0).any(-1)
        n = torch.nonzero(live).squeeze(1)
        old += 6 * n.numel()
        if n.numel() == 0:
            continue

        def cell(k, size):
            p = (xyz[n, k] + 1) * 0.5 * (size - 1)
            return torch.floor(p).clamp(-2, size).long()

        m0, m1 = MAT_MODE[i]
        fx, fy, fl = cell(m0, w), cell(m1, h), cell(VEC_MODE[i], length)
        same_run = (n[1:] // run) == (n[:-1] // run)
        dx, dy, dl = ((a[1:] - a[:-1]).abs() for a in (fx, fy, fl))
        keep = (2 - dx).clamp(min=0) * (2 - dy).clamp(min=0)
        new += int(((4 - keep) + dl.clamp(max=2))[same_run].sum())
        new += 6 * (int((~same_run).sum()) + 1)  # each run's last corners
    return {"old": old, "new": new, "factor": old / max(new, 1)}


def row_fetches(params, xyz, run):
    """Corner-row reads of one forward over every sample: the old design's
    (each sample reads its 4 plane and 2 line corner rows of each axis
    pair) and the walk's over runs of ``run`` samples (a run's first sample
    reads all 6 rows of a pair, each later one the rows its cell enters),
    as ``walk_forward`` counts them; in torch, on any device -> {"old",
    "new", "factor"}. A row read is one group's words of the row (16 float4
    words at lego's ranks)."""
    from iffnerf_tpu_torch.ops.field_features import MAT_MODE, VEC_MODE, kernel_layout

    _, dims = kernel_layout(params, False)
    n = xyz.shape[0]
    k = torch.arange(n, device=xyz.device)
    same_run = (k[1:] // run) == (k[:-1] // run)
    new = 0
    for i in range(3):
        h, w, length = dims[5 * i:5 * i + 3]

        def cell(c, size):
            p = (xyz[:, c] + 1) * 0.5 * (size - 1)
            return torch.floor(p).clamp(-2, size).long()

        m0, m1 = MAT_MODE[i]
        fx, fy, fl = cell(m0, w), cell(m1, h), cell(VEC_MODE[i], length)
        dx, dy, dl = ((a[1:] - a[:-1]).abs() for a in (fx, fy, fl))
        keep = (2 - dx).clamp(min=0) * (2 - dy).clamp(min=0)
        new += int(((4 - keep) + dl.clamp(max=2))[same_run].sum())
        new += 6 * -(-n // run)  # each run's first sample
    return {"old": 18 * n, "new": new, "factor": 18 * n / max(new, 1)}


FORWARD_CONSTANTS = ("kMaxRun", "kSpansPerBlock", "kWarps", "kMaxWarps", "kSmem")
STEP_BYTES = 64  # the kernel's Step: a sample's weights and rows for one pair


def forward_plan(dims, vec, n, resident, root=None):
    """The forward kernel's split of ``n`` samples as its host code
    (``iff_field_features``) makes it, its constants read from the source
    of ``root`` (default: this checkout), for ``dims`` as ``kernel_layout``
    gives them, float4 words when ``vec``, and ``resident`` blocks that fit
    on the card at once -> {"g": lanes a group, "red": the lanes of a group
    that hold density words, at most, "parts": groups a run, "warps": warps
    a block, "runs": runs a span, "run": samples a run, "spans"}. The host
    halves the run from kMaxRun until every resident block has
    kSpansPerBlock spans (or the run is 1)."""
    root = Path(__file__).resolve().parents[2] if root is None else root
    k = {name: run_samples(root, name) for name in FORWARD_CONSTANTS}
    words = 4 if vec else 1
    nv = [(dims[5 * i + 3] + dims[5 * i + 4]) // words for i in range(3)]
    log_g = 0
    while (1 << log_g) < max(nv + [1]) and log_g < 5:
        log_g += 1
    g = 1 << log_g
    parts = sum(-(-v // g) for v in nv)
    red = max([1] + [min(dims[5 * i + 3] // words, g) for i in range(3)])
    run_bytes = (3 * STEP_BYTES + parts * red * 4) * k["kMaxRun"]
    max_runs = k["kSmem"] // run_bytes
    per_warp = 32 >> log_g
    warps = min(parts // math.gcd(parts, per_warp), k["kMaxWarps"])
    while 2 * warps <= k["kWarps"] and 2 * warps * per_warp // parts <= max_runs:
        warps *= 2
    runs = min(max(1, warps * per_warp // parts), max_runs)
    run = k["kMaxRun"]
    while run > 1 and -(-n // (runs * run)) < k["kSpansPerBlock"] * resident:
        run //= 2
    return {"g": g, "red": red, "parts": parts, "warps": warps,
            "runs": runs, "run": run, "spans": -(-n // (runs * run))}


NO_CELL = -(1 << 20)  # the kernel's kNoCell: a corner no sample has


def _cells(g, size):
    """The kernel's ``axis_floor`` in float32: (lower corner clamped to
    [-2, size], weight of the upper corner w, 1 - w)."""
    p = (g.astype(np.float32) + np.float32(1)) * np.float32(0.5) * np.float32(size - 1)
    f = np.floor(p)
    w = p - f
    return np.clip(f, -2, size).astype(np.int64), w, np.float32(1) - w


def _slot_weights(f, w, u):
    """Weights of slot 0 (the even corner) and slot 1 (the odd one)."""
    odd = (f & 1) == 1
    return np.where(odd, w, u)[:, None], np.where(odd, u, w)[:, None]


def _enter(plane, line, t, lines, cells, sel, y, x, z):
    """The walk's step for the runs ``sel`` whose next walked samples lie
    in cells (y, x) and z: each slot whose corner the run's previous
    cell (``cells``: cy, cx, cl, updated) does not hold is read (times the
    corner's flag) into the slots ``t`` [runs, 4, R] and ``lines`` [runs,
    2, R] -> the rows read."""
    h, w, _ = plane.shape
    length = line.shape[0]
    cy, cx, cl = cells
    fetched = 0
    for s in range(4):
        yy = y + (((s >> 1) ^ y) & 1)
        xx = x + (((s & 1) ^ x) & 1)
        need = ((yy - cy[sel] < 0) | (yy - cy[sel] > 1)
                | (xx - cx[sel] < 0) | (xx - cx[sel] > 1))
        yv, xv = yy[need], xx[need]
        flag = ((yv >= 0) & (yv < h) & (xv >= 0) & (xv < w)).astype(np.float32)
        t[sel[need], s] = (plane[np.clip(yv, 0, h - 1), np.clip(xv, 0, w - 1)]
                           * flag[:, None])
        fetched += int(need.sum())
    for s in range(2):
        zz = z + ((s ^ z) & 1)
        need = (zz - cl[sel] < 0) | (zz - cl[sel] > 1)
        zv = zz[need]
        flag = ((zv >= 0) & (zv < length)).astype(np.float32)
        lines[sel[need], s] = line[np.clip(zv, 0, length - 1)] * flag[:, None]
        fetched += int(need.sum())
    cy[sel], cx[sel], cl[sel] = y, x, z
    return fetched


def _walk_pair(plane, line, gx, gy, gl, run):
    """The walk of one axis pair over runs of ``run`` consecutive samples:
    for each run, slots of the cell's 4 plane and 2 line corner rows by
    the corner's parity, a slot read only when the sample's cell enters its
    corner (and then multiplied by the corner's flag), each product
    computed in the samplers' order from the slots -> (products [n, R]
    float32, rows read)."""
    h, w, _ = plane.shape
    length = line.shape[0]
    n = gx.shape[0]
    (fx, wx, ux), (fy, wy, uy), (fl, wl, ul) = (
        _cells(gx, w), _cells(gy, h), _cells(gl, length))
    runs = -(-n // run)
    cy, cx, cl = (np.full(runs, NO_CELL, np.int64) for _ in range(3))
    t = np.zeros((runs, 4, plane.shape[2]), np.float32)
    lines = np.zeros((runs, 2, plane.shape[2]), np.float32)
    out = np.empty((n, plane.shape[2]), np.float32)
    fetched = 0
    for u in range(run):
        sel = np.arange(runs)[np.arange(runs) * run + u < n]
        ids = sel * run + u
        y, x, z = fy[ids], fx[ids], fl[ids]
        fetched += _enter(plane, line, t, lines, (cy, cx, cl), sel, y, x, z)
        x0, x1 = _slot_weights(x, wx[ids], ux[ids])
        y0, y1 = _slot_weights(y, wy[ids], uy[ids])
        l0, l1 = _slot_weights(z, wl[ids], ul[ids])
        r0 = t[sel, 0] * x0 + t[sel, 1] * x1
        r1 = t[sel, 2] * x0 + t[sel, 3] * x1
        out[ids] = (r0 * y0 + r1 * y1) * (lines[sel, 0] * l0 + lines[sel, 1] * l1)
    return out, fetched


def walk_forward(params, xyz, with_app=True, vec=True, run=32):
    """A numpy model of the forward kernel's walk: each axis pair walks
    runs of ``run`` consecutive samples (``_walk_pair``); a group's lanes
    take its words (float4 when ``vec``, else 4-byte; ``forward_plan``'s
    groups), each lane sums its density products, and sigma adds the
    first ``red`` lanes' sums of each group in part and lane order, as the
    kernel does -> (sigma [n], app products [n, sum(R_app)] or None, rows
    read).
    ``params``: the 12 tables as numpy or CPU torch arrays."""
    from iffnerf_tpu_torch.ops.field_features import MAT_MODE, VEC_MODE, kernel_layout

    _, dims = kernel_layout(params, with_app)
    plan = forward_plan(dims, vec, 1, 1)
    g, red = plan["g"], plan["red"]
    words = 4 if vec else 1
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    app = np.empty((n, dims[-1]), np.float32) if with_app else None
    sigma = np.zeros(n, np.float32)
    fetched = 0
    for i in range(3):
        h, w, length, rd, ra = dims[5 * i:5 * i + 5]
        kinds = ("density", "app") if ra else ("density",)
        plane = np.concatenate([np.asarray(params[f"{k}_plane"][i], np.float32)
                                for k in kinds], -1)
        line = np.concatenate([np.asarray(params[f"{k}_line"][i], np.float32)
                               for k in kinds], -1)
        m0, m1 = MAT_MODE[i]
        prod, f = _walk_pair(plane, line, xyz[:, m0], xyz[:, m1],
                             xyz[:, VEC_MODE[i]], run)
        fetched += f
        if ra:
            app[:, dims[15 + i]:dims[15 + i] + ra] = prod[:, rd:]
        nd = rd // words
        dens = prod[:, :rd].reshape(n, nd, words)
        for part in range(-(-(rd + ra) // words // g)):
            for lane in range(red):
                s = np.zeros(n, np.float32)
                if part * g + lane < nd:
                    for q in range(words):
                        s = s + dens[:, part * g + lane, q]
                sigma = sigma + s
    return sigma, app, fetched


def _walk_pair_coords(plane, line, gx, gy, gl, up, live, run):
    """The coordinate kernel's walk of one axis pair: runs of ``run``
    consecutive samples, each run's live samples in order, slots of the
    cell's 4 plane and 2 line corner rows by the corner's parity, a slot
    read only when a live sample's cell enters its corner (relative to the
    run's previous live sample; then multiplied by the corner's flag) ->
    (the derivatives [n, 3] in the upper corners' weights of x, y and the
    line, summed over the ranks with the upstream ``up`` [n, R]; zero for
    a sample that is not live, rows read)."""
    h, w, _ = plane.shape
    length = line.shape[0]
    n = gx.shape[0]
    (fx, wx, ux), (fy, wy, uy), (fl, wl, ul) = (
        _cells(gx, w), _cells(gy, h), _cells(gl, length))
    runs = -(-n // run)
    cy, cx, cl = (np.full(runs, NO_CELL, np.int64) for _ in range(3))
    t = np.zeros((runs, 4, plane.shape[2]), np.float32)
    lines = np.zeros((runs, 2, plane.shape[2]), np.float32)
    out = np.zeros((n, 3), np.float32)
    fetched = 0
    for u in range(run):
        sel = np.arange(runs)[np.arange(runs) * run + u < n]
        sel = sel[live[sel * run + u]]
        ids = sel * run + u
        y, x, z = fy[ids], fx[ids], fl[ids]
        fetched += _enter(plane, line, t, lines, (cy, cx, cl), sel, y, x, z)
        x0, x1 = _slot_weights(x, wx[ids], ux[ids])
        y0, y1 = _slot_weights(y, wy[ids], uy[ids])
        l0, l1 = _slot_weights(z, wl[ids], ul[ids])
        tt, ll, g = t[sel], lines[sel], up[ids]
        r0 = tt[:, 0] * x0 + tt[:, 1] * x1
        r1 = tt[:, 2] * x0 + tt[:, 3] * x1
        pf = r0 * y0 + r1 * y1
        lf = ll[:, 0] * l0 + ll[:, 1] * l1
        d = np.stack([
            (g * lf * (y0 * (tt[:, 1] - tt[:, 0]) + y1 * (tt[:, 3] - tt[:, 2]))).sum(-1),
            (g * lf * (r1 - r0)).sum(-1),
            (g * pf * (ll[:, 1] - ll[:, 0])).sum(-1)], -1)
        # slot 1 holds the lower corner of an odd cell: the other sign
        odd = np.stack([x & 1, y & 1, z & 1], -1) == 1
        out[ids] = np.where(odd, -d, d)
    return out, fetched


def walk_coords_grad(params, xyz, dsigma, dapp=None, run=8):
    """A numpy model of the coordinate kernel: a sample is live when any
    word of its upstream row (dsigma, and dapp when given) is not zero;
    each axis pair walks runs of ``run`` samples (``_walk_pair_coords``)
    and its derivatives scale by (size - 1) / 2 into the coordinates ->
    (dxyz [n, 3], exactly 0 for a sample that is not live; rows read).
    ``params``: the 12 tables as numpy or CPU torch arrays."""
    from iffnerf_tpu_torch.ops.field_features import MAT_MODE, VEC_MODE, kernel_layout

    with_app = dapp is not None
    _, dims = kernel_layout(params, with_app)
    xyz = np.asarray(xyz, np.float32)
    dsigma = np.asarray(dsigma, np.float32)
    live = dsigma != 0
    if with_app:
        dapp = np.asarray(dapp, np.float32)
        live = live | (dapp != 0).any(-1)
    n = xyz.shape[0]
    out = np.zeros((n, 3), np.float32)
    fetched = 0
    for i in range(3):
        h, w, length, rd, ra = dims[5 * i:5 * i + 5]
        kinds = ("density", "app") if with_app else ("density",)
        plane = np.concatenate([np.asarray(params[f"{k}_plane"][i], np.float32)
                                for k in kinds], -1)
        line = np.concatenate([np.asarray(params[f"{k}_line"][i], np.float32)
                               for k in kinds], -1)
        up = np.repeat(dsigma[:, None], rd, -1)
        if with_app:
            up = np.concatenate([up, dapp[:, dims[15 + i]:dims[15 + i] + ra]], -1)
        m0, m1 = MAT_MODE[i]
        d, f = _walk_pair_coords(plane, line, xyz[:, m0], xyz[:, m1],
                                 xyz[:, VEC_MODE[i]], up, live, run)
        fetched += f
        for c, (axis, size) in enumerate(((m0, w), (m1, h), (VEC_MODE[i], length))):
            out[:, axis] += d[:, c] * np.float32(0.5 * (size - 1))
    return out, fetched


def _build_variants(names, parent):
    """{name: the field_features library of variant name}, the nvcc
    processes all started together (``source``: the checkout's build)."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import field_features as ff

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "field_features.cu").read_text()
    procs = {}
    for name in names:
        if name == "source":
            continue
        base, edits = ("source", _VARIANTS[name][0]) if name in _VARIANTS else (
            ("source", _COORD_VARIANTS[name][0]) if name in _COORD_VARIANTS else (
                ("parent", []) if name == "parent" else _FWD_VARIANTS[name][:2]))
        if base == "parent" and parent is None:
            raise RuntimeError(f"the {name} variant needs --parent DIR")
        parent_cu = (None if parent is None else Path(parent).resolve()
                     / "iffnerf_tpu_torch" / "csrc" / "field_features.cu")
        if name == "parent":
            cu = parent_cu
        else:
            text = src if base == "source" else parent_cu.read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"the {base} no longer holds {old[:60]!r}")
                text = text.replace(old, new)
            if name == "clocks":
                text += _CLOCKS_TAIL
            cu = out / f"ff_{name}.cu"
            cu.write_text(text)
        lib = out / f"ff_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(cu.parent), "-I",
               str(_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    if "source" in names:
        _build._LIBS.pop("field_features", None)
        libs["source"] = _build.load("field_features", ff._SIGNATURES)
    for name, (proc, path) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in ff._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _clocks(lib, call):
    """The clocks variant's counters over one call: the group leaders'
    cycles waiting for stages, in add_sample and in all, their adds and
    the samples they walked, and the means a leader."""
    lib.iff_ff_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.iff_ff_clocks.restype = ctypes.c_int
    torch.cuda.synchronize()
    assert lib.iff_ff_clocks(None, 1) == 0
    call()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 5)()
    assert lib.iff_ff_clocks(ctypes.addressof(out), 0) == 0
    wait, add, n_add, total, n_walk = list(out)
    return {"wait_cycles": wait, "add_cycles": add, "adds": n_add,
            "total_cycles": total, "samples_walked": n_walk,
            "wait_share": wait / max(total, 1), "add_share": add / max(total, 1),
            "cycles_an_add": add / max(n_add, 1),
            "cycles_a_walked_sample": (total - wait - add) / max(n_walk, 1)}


def _arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


# a colour chunk's shape (chip_smoke.CHUNK_SAMPLES): 379 surface points x
# 27 directions, 20 samples a ray; its step at the object side's
# step_ratio 2.0 is about 2 texels
CHUNK_RAYS, CHUNK_PER_RAY, CHUNK_TEXELS = 379 * 27, 20, 2.0


def colour_chunk_samples(grid, seed):
    """A colour chunk's shape of ray-major samples (numpy, from ``seed``):
    CHUNK_RAYS rays in random directions, CHUNK_PER_RAY samples each,
    CHUNK_TEXELS texels apart."""
    dirs = np.random.default_rng(seed).standard_normal((CHUNK_RAYS, 3))
    return ray_ordered_samples(grid, dirs, CHUNK_PER_RAY, seed + 1,
                               texels=CHUNK_TEXELS)


def _cases(run, dev, forward):
    """The inputs captured at the first backward of the 128^3 grid and of
    the final one, the axis-aligned set at the final grid and, for the
    forward, a colour chunk's shape at the final grid -> {case: (params,
    xyz, dsigma, dapp)} (no upstream for the colour chunk)."""
    import chip_smoke

    keys = list(run.caught)
    cases = {"grid_128": run.caught[keys[0]], "grid_final": run.caught[keys[-1]]}
    params = cases["grid_final"][0]
    cases["axis_rays"] = chip_smoke.axis_ray_inputs(params, dev)
    if forward:
        grid = tuple(params["density_plane"][0].shape[1::-1]) + (
            params["density_line"][0].shape[0],)
        xyz = torch.as_tensor(colour_chunk_samples(grid, 41), device=dev)
        cases["colour_chunk"] = (params, xyz, None, None)
    return cases


def forward_main(run, cases, libs, variants, rounds, result):
    """The forward's variants in turns at each case (see the module's
    docstring) into ``result``."""
    import chip_smoke
    from iffnerf_tpu_torch.models.field import FieldConfig
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops.field_features import field_features
    from iffnerf_tpu_torch.utils.misc import cal_n_samples

    dev = torch.device("cuda")
    run_max = run_samples(Path("."), "kMaxRun")
    result["row_fetches"] = {
        case: {f"run{r}": row_fetches(p, xyz, r) for r in (1, 8, 16, run_max)}
        for case, (p, xyz, _, _) in cases.items()}
    plain, bounds = {}, {}
    for case, (p, xyz, _, _) in cases.items():
        chunks = chip_smoke.plain_features_chunked(p, xyz)
        plain[case] = (torch.cat([c[0] for c in chunks]),
                       torch.cat([c[1] for c in chunks]))
        bounds[case] = chip_smoke.field_bound(p, xyz, True)[0]
    result["bound_ms"] = bounds
    n_final = cal_n_samples(run.config.grid_size, run.args.step_ratio)
    for rnd in range(rounds):
        for name in variants:
            _build._LIBS["field_features"] = libs[name]
            print(f"ff_time: {name} round {rnd}", file=sys.stderr, flush=True)
            row = result.setdefault(f"forward_{name}", {})
            meaningful = _FWD_VARIANTS.get(name, (None, None, True))[2]
            for case, (p, xyz, _, _) in cases.items():
                cell = row.setdefault(case, {"graph_ms": [], "ms": []})
                with torch.no_grad():
                    def call():
                        return field_features(FieldConfig(), p, xyz, True)
                    cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                    cell["ms"].append(chip_smoke.time_ms(call))
                    if rnd == 0 and meaningful:
                        cell.update(chip_smoke.forward_errors(p, xyz, plain[case]))
                torch.cuda.empty_cache()
            split = chip_smoke.step_split_field(run.config, run.params, run.mask,
                                                run.pool, n_final, dev, profile=False)
            row.setdefault("step_split", []).append(split)


def backward_main(run, cases, libs, variants, rounds, result):
    """The backward's variants in turns at each case (see the module's
    docstring) into ``result``."""
    import chip_smoke
    from iffnerf_tpu_torch.models.field import FieldConfig
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops.field_features import field_features_backward
    from iffnerf_tpu_torch.utils.misc import cal_n_samples

    dev = torch.device("cuda")
    result["row_adds"] = {k: row_adds(*v, result["run_samples"]) for k, v in cases.items()}
    n_final = cal_n_samples(run.config.grid_size, run.args.step_ratio)
    for rnd in range(rounds):
        for name in variants:
            _build._LIBS["field_features"] = libs[name]
            print(f"ff_time: {name} round {rnd}", file=sys.stderr, flush=True)
            row = result.setdefault(f"backward_{name}", {})
            for case, (p, xyz, dsigma, dapp) in cases.items():
                cell = row.setdefault(case, {"ms": [], "graph_ms": []})

                def call():
                    return field_features_backward(FieldConfig(), p, xyz, dsigma, dapp)
                cell["ms"].append(chip_smoke.time_ms(call))
                cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                if rnd == 0 and _VARIANTS.get(name, ((), True))[1]:
                    cell.update(chip_smoke.backward_errors(p, xyz, dsigma, dapp))
                if rnd == 0 and name == "clocks":
                    cell["clocks"] = _clocks(libs[name], call)
                torch.cuda.empty_cache()
            split = chip_smoke.step_split_field(run.config, run.params, run.mask,
                                                run.pool, n_final, dev, profile=False)
            row.setdefault("step_split", []).append(split)


def coords_main(cases, libs, variants, rounds, result):
    """The coordinate kernel's variants in turns at each case (see the
    module's docstring) into ``result``."""
    import chip_smoke
    from iffnerf_tpu_torch.models.field import FieldConfig
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops.field_features import field_features_coords_grad

    result["bound_ms"] = {case: chip_smoke.coords_grad_bound(*c)[0]
                          for case, c in cases.items()}
    for case, (_, _, dsigma, dapp) in cases.items():
        result.setdefault("live_samples", {})[case] = int(
            ((dsigma != 0) | (dapp != 0).any(-1)).sum())
    for rnd in range(rounds):
        for name in variants:
            _build._LIBS["field_features"] = libs[name]
            print(f"ff_time: {name} round {rnd}", file=sys.stderr, flush=True)
            row = result.setdefault(f"coords_{name}", {})
            for case, c in cases.items():
                cell = row.setdefault(case, {"graph_ms": [], "ms": []})

                def call():
                    return field_features_coords_grad(FieldConfig(), *c)
                cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                cell["ms"].append(chip_smoke.time_ms(call))
                if rnd == 0 and _COORD_VARIANTS.get(name, ((), True))[1]:
                    cell.update(chip_smoke.coords_grad_errors(*c))
                    cell["repeats_bit_equal"] = chip_smoke.coords_grad_repeats(*c)
                torch.cuda.empty_cache()


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke

    if not torch.cuda.is_available():
        print("ff_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "ff"
    forward = "--forward" in sys.argv
    variants = _arg("--variants", "source").split(",")
    rounds = int(_arg("--rounds", "1"))
    libs = _build_variants(variants, _arg("--parent", None))
    dev = torch.device("cuda")
    if "--coords" in sys.argv:
        sc = chip_smoke.inerf_scene(dev)
        _, _, inputs = chip_smoke.captured_iteration(sc, dev)
        del sc
        cases = {"iteration": inputs,
                 "all_live": chip_smoke.all_live_coords_inputs(inputs[0], dev)}
        result = {"label": label, "card": chip_smoke.card_line(),
                  "coord_run": run_samples(Path("."), "kCoordRun"),
                  "n": {k: v[1].shape[0] for k, v in cases.items()}}
        coords_main(cases, libs, variants, rounds, result)
        print(json.dumps(result), flush=True)
        return 0
    run = chip_smoke.train_with_capture(dev)
    cases = _cases(run, dev, forward)
    result = {"label": label, "card": chip_smoke.card_line(),
              "run_samples": run_samples(Path(".")),
              "grids": {k: list(v[0]["density_plane"][0].shape[:2]) for k, v in cases.items()},
              "n": {k: v[1].shape[0] for k, v in cases.items()}}
    (forward_main if forward else backward_main)(run, cases, libs, variants, rounds, result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
