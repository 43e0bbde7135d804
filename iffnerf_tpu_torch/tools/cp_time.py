"""Times the TensorCP kernels' line gradient (``iff_cp_features_bwd``),
with ``--forward`` their forward (``iff_cp_features``) or with ``--coords``
their coordinate gradient (``iff_cp_features_coords_grad``) on one card,
beside the parent's kernel and cut-out variants of both.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory. Its inputs are those of ``chip_smoke.py``'s ``tensor_cp`` phase:
``chip_smoke.train_cp`` trains configs/lego.txt with TensoRF's CP block
(ranks 96 / 288) for 12 steps to 505x505x489 and keeps the inputs of the
backward's first launch at each grid; the tool takes the final grid's (a
CP step: 7 090 176 samples, their dsigma and dapp and the six lines), and
a colour chunk's shape at that grid (``ff_time.colour_chunk_samples``:
204 660 ray-major samples 2 texels apart) with ``chip_smoke.
cp_random_upstream``'s upstream; the forward also an iNeRF iteration's
count, the step's first INERF_SAMPLES samples (1 022 rays; an iteration on
the CP field draws 1 024 rays of 1 728 samples). It prints one JSON line:
the card's name and power limit, each case's samples, live samples and
bound (``chip_smoke.cp_bounds``, ``cp_forward_bound``), the source's plan,
each built variant's registers a thread from ``ptxas -v`` (and the
warps an SM they leave room for), and for each variant and case the
kernel's graph-replayed and eager ms in every round (medians of
CUDA-event batches, ``chip_smoke.time_ms``) and, where its results mean
something, its errors against the plain version (the backward's largest
error as a share of CP_GRAD_TOL of the line's largest; the forward's
products bit-equal, sigma within FIELD_RTOL and FIELD_ATOL x max|plain|,
two calls bit-equal; the coordinate gradient's largest error as a share
of COORDS_GRAD_TOL of max|plain| and three calls bit-equal).

``--coords`` times five cases: the step (its captured upstream, about 38 %
of the samples live), an iNeRF iteration's count (the step's first
INERF_SAMPLES samples with ``iteration_upstream``: a run of live samples a
ray, about 3.4 % live), an iNeRF iteration's own inputs (captured at the
first iteration from ``chip_smoke.cp_inerf_frame``'s start), a colour
chunk's shape (``cp_random_upstream``) and ``chip_smoke.cp_all_live_
inputs``' all-live set (as many samples, ray-ordered half a texel apart,
every upstream word normal); with each case's live 8-sample stages. The parent's
coordinate gradient runs through its own entry where it is the first
design (a group of lanes a sample, no ring).

``--iterations`` (with ``--coords`` and a ``parent`` variant) also
profiles INERF_PROFILE_ITERS iterations of ``estimate_pose_inerf`` on the
trained field (``chip_smoke.cp_inerf_frame``), with the source's
coordinate kernel and with the parent's in turns, ``--rounds`` times:
each iteration's kernel ms and host ms, and its coordinate kernel's ms.

    cd <checkout> && python3 <path>/cp_time.py <label> [--forward [--placements] | --coords [--iterations]] [--parent DIR] [--variants A,B] [--rounds N]

``--variants`` builds text edits of the checkout's ``csrc/cp_features.cu``
(or of the parent's) into ``build/kernels/variants/``, all nvcc processes
at once, and times them in turns, ``--rounds`` times over. ``source`` is
the checkout's own build; ``parent`` is ``DIR/iffnerf_tpu_torch/csrc/
cp_features.cu`` as it is, with ``--parent DIR`` (a parent commit unpacked
beside the change): its forward (the first design) through its own entry;
its backward through this checkout's wrapper or, where its line gradient is
the first design (no bulk-copy ring), through its own entry with the first
design's own plan (``parent_plan``: 16 columns a block at lego's lines,
two blocks resident an SM, four an SM launched). The line gradient's:

- ``stream_only`` (not checked): the rings stream every stage and the
  warps take them, reading no word: the upstream stream alone;
- ``vote_only`` (not checked): the stream and the vote, no corners, loads
  or walk;
- ``no_walk`` (not checked): the stream, the vote and the corners, no
  line-word loads or walk;
- ``no_adds`` (not checked): the walk with a plain shared-memory store in
  place of each add (a CAS loop on the card);
- ``load_all``: every slot's line word loaded at every live sample, not
  only when its row changes;
- ``flush_only`` (not checked): no unit taken: the sums zeroed and flushed;
- ``no_skip``: every sample walked, its upstream zero or not;
- ``no_tma``: every stage read from device memory, nothing bulk-copied:
  what the rings buy;
- ``cw16``: the plan held to 16 columns a block (two groups a warp, twice
  the slices);
- ``run4``: 4 samples a stage and group in place of 8;
- ``run16_warps8``: 16 samples a stage and group, 8 warps a block;
- ``warps8``, ``warps12``: 8 or 12 warps a block in place of 16;

and of the first design's line gradient (a parent whose backward is it):

- ``parent_stream_only`` (not checked): the first design reading each
  sample's upstream word, and the coordinates of a live one, and nothing
  more: its chase alone;
- ``parent_no_adds`` (not checked): the first design with a plain
  shared-memory store in place of each add;
- ``parent_flush_only`` (not checked): the first design walking nothing.

The forward's (``--forward``), of the shared-memory design:

- ``fwd_store_only`` (not checked): products replaced by a constant, no
  corners, record or slice read: the slices' stream of coordinates in and
  products out alone;
- ``fwd_no_store`` (not checked): the walk without the products' stores
  (the density slices' sums still stored);
- ``fwd_no_walk`` (not checked): the coordinates and the corners into the
  records, no walk;
- ``fwd_no_xyz`` (not checked): every unit walks its warp's first unit's
  coordinates, none read after those: the most that any way of bringing
  the coordinates in (a bulk-copy ring among them) could save;
- ``fwd_always_load``: both slots' words read from the slice at every
  sample, not only when their rows change;
- ``fwd_cw16``: the plan held to 16 columns a block (twice the slices);

and of the forward's first design (``parent_fwd_*``: the parent's kernel,
which the source keeps as its long-line route, so that the edits find
their text in both):

- ``parent_fwd_store_only`` (not checked): products replaced by a
  constant, no coordinate or line read: the store stream alone;
- ``parent_fwd_one_store`` (not checked): the line reads and lerps, the
  appearance products summed into sigma: one store a sample;
- ``parent_fwd_cg``: line reads through ``ld.global.cg`` (L2 only, not
  L1).

The coordinate gradient's (``--coords``):

- ``coords_no_skip``: every stage walked, its samples live or not (the
  vote's result unused: the compiler drops the vote too);
- ``coords_no_ring``: every stage read from device memory, nothing
  bulk-copied: what the rings buy;
- ``coords_vote_only`` (not checked): the stream and the vote, no corners
  or walk;
- ``coords_always_load``: each slot's row loaded at every live sample, not
  only when its key changes;
- ``coords_warps8``, ``coords_warps16``: 8 warps a block (3-stage rings,
  at most 255 registers a thread), or 16 with 2-stage rings of 4-sample
  stages (at most 128);
- ``coords_no_tree`` (not checked): no shuffle tree, each lane's sums
  taken as they are;
- ``coords_no_loads`` (not checked): no slot row loaded, the walk on
  zeros.

``--placements`` (with ``--forward``) also times the source's forward at
the step with its outputs carved out of one large buffer at offsets of
PLACEMENTS MB, in that order, twice over: whether where the products land
moves the kernel's time.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

INERF_SAMPLES = 1024 * 1728
# an iNeRF iteration's upstream on the CP field: about 59 live samples a
# ray of 1 728 (60 243-60 395 of 1 769 472), in one run along the ray
RAY_SAMPLES, LIVE_RUN = 1728, 59
PLACEMENTS = (0, 1, 2, 4, 16)
_RUN_TAIL = "                   // samples a group"
_WARPS_TAIL = "                // warps a block, each walking"
_COORDS_WARPS_TAIL = "                // warps a block, each walking on its own; one"
_NEVER = " && p.rows < 0"  # false at run time, which the compiler cannot see
_NO_RING = ("  p.tma = tma;\n", "  p.tma = 0;\n")
_ADD = "  if (row != kNoRow && s != 0.0f) atomicAdd(acc + off + static_cast<int>(row) * cw, s);"
# the first design's line gradient (parent_*, but not parent_fwd_*)
_PARENT_ADDS = """atomicAdd(acc + off[i] + cur0[i] * cw + lane, a0[i]);
{0}atomicAdd(acc + off[i] + cur1[i] * cw + lane, a1[i]);
"""
_PARENT_STORES = """acc[off[i] + cur0[i] * cw + lane] = a0[i];
{0}acc[off[i] + cur1[i] * cw + lane] = a1[i];
"""
_PARENT_END = "#pragma unroll\n    for (int i = 0; i < 3; ++i) {\n      if (cur0[i] >= 0) {\n"
# the first design's walk of a word's three axes (parent_fwd_*)
_L1_PRODUCTS = """          Vec<VEC> prod;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float* line = dens ? t.density[i] : t.app[i];
            const Vec<VEC> a = load_vec<VEC>(line + static_cast<int64_t>(c[i].r0) * stride + col);
            const Vec<VEC> b = load_vec<VEC>(line + static_cast<int64_t>(c[i].r1) * stride + col);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float l = lerp(a.v[e], b.v[e], c[i]);
              prod.v[e] = i == 0 ? l : __fmul_rn(prod.v[e], l);
            }
          }
"""
_L1_STORE = "            store_vec<VEC>(app + n * t.ra + col, prod);\n"
# the shared-memory design's walk of a sample's three axes, its corners
# and its store (fwd_*)
_FWD_PRODUCTS = """        Vec<VEC> prod;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint4 q = rec[(k * 3 + i) * G + grp];
          if (q.x != ce[i]) ve[i] = load_shared<VEC, kHalf>(mine + q.x);
          if (q.y != co[i]) vo[i] = load_shared<VEC, kHalf>(mine + q.y);
          ce[i] = q.x;
          co[i] = q.y;
          const float we = __uint_as_float(q.z), wo = __uint_as_float(q.w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float l = __fadd_rn(__fmul_rn(ve[i].v[e], we), __fmul_rn(vo[i].v[e], wo));
            prod.v[e] = i == 0 ? l : __fmul_rn(prod.v[e], l);
          }
        }
"""
_FWD_CORNERS = "      for (int i = 0; i < 3; ++i)\n        rec[(glane * 3 + i) * G + grp]"
_FWD_STORE = "        if (o != nullptr && k < live) store_stream"
_FWD_WALK = "      for (int k = 0; k < R; ++k) {\n"
_FWD_STORE_ONLY = [
    (_FWD_PRODUCTS, """        Vec<VEC> prod;
#pragma unroll
        for (int e = 0; e < VEC; ++e) prod.v[e] = static_cast<float>(col + e);
"""),
    (_FWD_CORNERS, _FWD_CORNERS.replace("i < 3;", "i < 3" + _NEVER + ";"))]


def _constant(name, value, new, tail=""):
    """A text edit of ``constexpr int name = value;`` (and ``tail``, which
    tells it from a constant of the same name in another namespace)."""
    return (f"constexpr int {name} = {value};{tail}", f"constexpr int {name} = {new};{tail}")


# name: (base, text edits, overrides of ops/cp_features.py's constants or
# plan, whether its results mean something). The cut-outs guard what
# they cut with a condition false at run time, so that the compiler keeps
# the work they leave. Names with "fwd_" time the forward (--forward),
# names with "coords_" the coordinate gradient (--coords).
VARIANTS = {
    "stream_only": ("source", [(
        "        u[k] = k < count ? su[k * ustride] : 0.0f;\n",
        "        u[k] = k < count" + _NEVER + " ? su[k * ustride] : 0.0f;\n")], {}, False),
    "vote_only": ("source", [("      if (liveg != 0) {\n",
                              "      if (liveg != 0" + _NEVER + ") {\n")], {}, False),
    "no_walk": ("source", [("        if (live) {\n", "        if (live" + _NEVER + ") {\n")],
                {}, False),
    "no_adds": ("source", [(_ADD, _ADD.replace(
        "atomicAdd(acc + off + static_cast<int>(row) * cw, s)",
        "acc[off + static_cast<int>(row) * cw] = s"))], {}, False),
    "load_all": ("source", [
        ("              if (d & 0xffffu)\n                fresh",
         "              if (true)\n                fresh"),
        ("              if (d >> 16)\n                fresh",
         "              if (true)\n                fresh")], {}, True),
    "flush_only": ("source", [("  int cu = grab();  // the unit the walk is in\n",
                               "  int cu = -1;\n")], {}, False),
    "no_skip": ("source", [(
        "        const unsigned vote = __ballot_sync(0xffffffffu, u[k] != 0.0f);\n",
        "        const unsigned vote = __ballot_sync(0xffffffffu, k < count);\n")],
        {}, True),
    "no_tma": ("source", [_NO_RING], {}, True),
    "cw16": ("source", [], {"log_cw": 4}, True),
    "run4": ("source", [_constant("kRun", 8, 4, _RUN_TAIL)], {"BWD_RUN": 4}, True),
    "run16_warps8": ("source", [_constant("kRun", 8, 16, _RUN_TAIL), _constant("kWarps", 16, 8, _WARPS_TAIL)],
                     {"BWD_RUN": 16, "BWD_WARPS": 8}, True),
    "warps8": ("source", [_constant("kWarps", 16, 8, _WARPS_TAIL)], {"BWD_WARPS": 8}, True),
    "warps12": ("source", [_constant("kWarps", 16, 12, _WARPS_TAIL)], {"BWD_WARPS": 12}, True),
    "parent_stream_only": ("parent", [
        ("      if (u == 0.0f) continue;\n",
         "      if (u == 0.0f) continue;\n      a0[0] += u * __ldg(xyz + 3 * n);\n"
         "      continue;\n"),
        (_PARENT_END, "    if (a0[0] != 0.0f) atomicAdd(acc + lane, a0[0]);\n" + _PARENT_END)],
        {}, False),
    "parent_no_adds": ("parent", [
        ("{\n            " + _PARENT_ADDS.format(" " * 12),
         "{\n            " + _PARENT_STORES.format(" " * 12)),
        ("{\n        " + _PARENT_ADDS.format(" " * 8),
         "{\n        " + _PARENT_STORES.format(" " * 8))], {}, False),
    "parent_flush_only": ("parent", [(
        "    for (int64_t n = s_lo; n < s_hi; ++n) {\n",
        "    for (int64_t n = s_lo; n < s_lo; ++n) {\n")], {}, False),
    "coords_no_skip": ("source", [(
        "      if (__any_sync(0xffffffffu, nz)) live |= 1u << k;\n",
        "      if (__any_sync(0xffffffffu, nz) || k < count) live |= 1u << k;\n")],
        {}, True),
    "coords_no_ring": ("source", [("  p.tma = vec && aligned(xyz)",
                                   "  p.tma = 0 && vec && aligned(xyz)")], {}, True),
    "coords_vote_only": ("source", [("    if (live != 0) {\n      // corners once a block",
                                     "    if (live != 0 && p.units < 0) {\n"
                                     "      // corners once a block")], {}, False),
    "coords_warps8": ("source", [_constant("kWarps", 12, 8, _COORDS_WARPS_TAIL)],
                      {"COORDS_WARPS": 8}, True),
    "coords_warps16": ("source", [_constant("kWarps", 12, 16, _COORDS_WARPS_TAIL)],
                       {"COORDS_WARPS": 16, "COORDS_RUNS": (4,), "COORDS_STAGES": (2,)}, True),
    "coords_no_tree": ("source", [(
        "            for (int o = 16; o > 0; o >>= 1) a[i] += __shfl_xor_sync(",
        "            for (int o = 16; o > 0 && p.units < 0; o >>= 1) a[i] += __shfl_xor_sync(")],
        {}, False),
    "coords_no_loads": ("source", [("            if (q[i].x != ke[i]) {",
                                    "            if (q[i].x != ke[i] && p.units < 0) {"),
                                   ("            if (q[i].y != ko[i]) {",
                                    "            if (q[i].y != ko[i] && p.units < 0) {")], {}, False),
    "coords_always_load": ("source", [("            if (q[i].x != ke[i]) {",
                                       "            if (true) {"),
                                      ("            if (q[i].y != ko[i]) {",
                                       "            if (true) {")], {}, True),
    "fwd_store_only": ("source", _FWD_STORE_ONLY, {}, False),
    "fwd_no_store": ("source", [(_FWD_STORE, _FWD_STORE.replace("k < live", "k < live" + _NEVER))],
                     {}, False),
    "fwd_no_walk": ("source", [(_FWD_WALK, _FWD_WALK.replace("k < R", "k < R" + _NEVER))],
                    {}, False),
    "fwd_no_xyz": ("source", [("      else\n        fetch(nu, 0, x);\n",
                               "      else if (p.rows < 0)\n        fetch(nu, 0, x);\n")],
                   {}, False),
    "fwd_always_load": ("source", [
        ("          if (q.x != ce[i]) ve", "          if (true) ve"),
        ("          if (q.y != co[i]) vo", "          if (true) vo")], {}, True),
    "fwd_cw16": ("source", [], {"log_cw": 4}, True),
    "parent_fwd_store_only": ("parent", [(_L1_PRODUCTS, """          Vec<VEC> prod;
#pragma unroll
          for (int e = 0; e < VEC; ++e) prod.v[e] = static_cast<float>(col + e);
""")], {}, False),
    "parent_fwd_one_store": ("parent", [(_L1_STORE, """#pragma unroll
            for (int e = 0; e < VEC; ++e) s += prod.v[e];
""")], {}, False),
    "parent_fwd_cg": ("parent", [
        ("  const float4 q = __ldg(reinterpret_cast<const float4*>(p));\n",
         "  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));\n"),
        ("  return {{__ldg(p)}};\n", "  return {{__ldcg(p)}};\n")], {}, True),
}
# the first designs' entries, as a parent that holds them exports them
PARENT_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
PARENT_FORWARD = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p]
PARENT_COORDS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
                 ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def is_forward(name):
    return "fwd_" in name


def is_coords(name):
    return name.startswith("coords_")


def kernel_of(name):
    """The kernel variant ``name`` times: "forward", "coords" or
    "backward"."""
    return "forward" if is_forward(name) else "coords" if is_coords(name) else "backward"


def first_backward(text):
    """Whether the line gradient of ``text`` (a cp_features.cu) is the
    first design, which streams no stage through a bulk-copy ring."""
    return _NO_RING[0] not in text


def first_coords(text):
    """Whether the coordinate gradient of ``text`` (a cp_features.cu) is
    the first design (a group of lanes a sample, no ring)."""
    return "namespace cgrad" not in text


def iteration_upstream(params, n, seed, dev, per_ray=RAY_SAMPLES, run=LIVE_RUN):
    """An iNeRF iteration's kind of upstream for ``n`` ray-major samples
    (numpy, from ``seed``): in each ``per_ray``-sample ray one run of live
    samples, 0 to 2 * ``run`` long at a random start, dsigma and dapp
    normal there, zeros elsewhere -> (dsigma [n], dapp [n, R_app])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ra = params["app_line"][0].shape[1]
    live = np.zeros(n, bool)
    for r0 in range(0, n, per_ray):
        length = int(rng.integers(0, 2 * run + 1))
        start = r0 + int(rng.integers(0, per_ray - length + 1))
        live[start:min(start + length, n)] = True
    dsigma = rng.standard_normal(n, dtype=np.float32) * live
    dapp = rng.standard_normal((n, ra), dtype=np.float32) * live[:, None]
    return (torch.as_tensor(dsigma, device=dev),
            torch.as_tensor(dapp, device=dev))


def parent_plan(dims, cols, n, sms):
    """The first design's plan: the widest power of two up to 32 columns
    (no wider than ``cols``) whose sums of the three lines fit 112 KB, and
    four blocks an SM in all, no chunk under 2 048 samples -> (log_cw,
    chunks)."""
    rows = sum(dims[:3])
    log_cw = 0
    while log_cw < 5 and (1 << log_cw) < cols and rows * 4 << (log_cw + 1) <= 112 * 1024:
        log_cw += 1
    slices = -(-cols >> log_cw)
    return log_cw, max(1, min(-(-4 * sms // slices), -(-n // 2048), 65535))


def variant_source(name, source, parent):
    """The text of variant ``name``: the edits applied to the source or
    the parent text, each of which must hold its text exactly once."""
    base, edits, _, _ = VARIANTS[name]
    text = source if base == "source" else parent
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the {base} no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def ptxas_registers(log):
    """{kernel's mangled name: registers a thread} from nvcc's ``-Xptxas
    -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


# threads a block of each kernel of csrc/cp_features.cu
KERNEL_THREADS = {"cp_features_fwd_kernel": 512, "cp_features_bwd_kernel": 512,
                  "cp_features_kernel": 256, "cp_coords_grad_kernel": 256,
                  "cp_sigma_sum_kernel": 256}


def resident_warps(registers, threads):
    """Warps an SM that blocks of ``threads`` threads at ``registers`` a
    thread leave room for (registers allocated 256 a warp; at most 32
    blocks and 64 warps an SM; shared memory aside)."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65536 // per_warp // (threads // 32), 32, 2048 // threads)
    return blocks * threads // 32


def kernels_resident_warps(registers):
    """{mangled name: warps an SM} for each kernel of a ``ptxas_registers``
    report, at its own block's threads."""
    out = {}
    for name, regs in registers.items():
        for kernel, threads in KERNEL_THREADS.items():
            if f"{len(kernel)}{kernel}" in name:
                out[name] = resident_warps(regs, threads)
    return out


def _is_parent(name):
    return name == "parent" or VARIANTS[name][0] == "parent"


def _parent_cu(parent):
    return (None if parent is None else Path(parent).resolve()
            / "iffnerf_tpu_torch" / "csrc" / "cp_features.cu")


def _build_variants(names, parent_cu, first):
    """({name: the cp_features library of variant name}, {name: its
    kernels' registers}), the nvcc processes all started together
    (``source``: the checkout's build; ``parent_cu`` the parent's source,
    ``first`` whether its line gradient and its coordinate gradient are
    the first designs: {"backward", "coords"} -> bool)."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "cp_features.cu").read_text()
    procs = {}
    for name in dict.fromkeys(names):
        if name == "source" or (name in VARIANTS and not VARIANTS[name][1]):
            continue
        if _is_parent(name) and parent_cu is None:
            raise RuntimeError(f"the {name} variant needs --parent DIR")
        if name == "parent":
            cu = parent_cu
        else:
            cu = out / f"cp_{name}.cu"
            cu.write_text(variant_source(
                name, source, parent_cu.read_text() if parent_cu else None))
        lib = out / f"cp_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    _build._LIBS.pop("cp_features", None)
    own = _build.load("cp_features", cpf._SIGNATURES)
    own_log = _build.library_path("cp_features").with_suffix(".so.log")
    own_regs = ptxas_registers(own_log.read_text()) if own_log.exists() else {}
    libs, regs = {}, {}
    for name in names:
        if name == "source" or (name in VARIANTS and not VARIANTS[name][1]):
            libs[name], regs[name] = own, own_regs
    for name, (proc, path) in procs.items():
        log = proc.communicate(timeout=600)[0]
        path.with_suffix(".so.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs[name] = ptxas_registers(log)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in cpf._SIGNATURES.items():
            if _is_parent(name) and fn == "iff_cp_features":
                argtypes = PARENT_FORWARD
            if _is_parent(name) and fn == "iff_cp_features_bwd" and first["backward"]:
                argtypes = PARENT_SIGNATURE
            if (_is_parent(name) and fn == "iff_cp_features_coords_grad"
                    and first["coords"]):
                argtypes = PARENT_COORDS
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def parent_backward(lib, params, xyz, dsigma, dapp):
    """The first design's line gradient at these inputs with its own plan
    -> the six gradient lines."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    lines, dims = cpf.kernel_layout(params, True)
    full = [torch.zeros_like(a) for a in lines]
    n = xyz.shape[0]
    sms = _build.sm_count(xyz.device)
    log_cw, chunks = parent_plan(dims, dims[3] + dims[4], n, sms)
    rc = lib.iff_cp_features_bwd(
        xyz.data_ptr(), n, (ctypes.c_longlong * 6)(*cpf._ptrs(lines)),
        (ctypes.c_longlong * 6)(*cpf._ptrs(full)), (ctypes.c_int * 5)(*dims),
        dsigma.data_ptr(), dapp.data_ptr(), 1, 1, log_cw, chunks,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(rc, "the parent's CP backward")
    return {"density_line": tuple(full[:3]), "app_line": tuple(full[3:])}


def parent_forward(lib, params, xyz):
    """The parent's forward (the first design) at these inputs -> (sigma,
    the appearance products)."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    lines, dims = cpf.kernel_layout(params, True)
    n = xyz.shape[0]
    sigma = torch.empty(n, dtype=torch.float32, device=xyz.device)
    app = torch.empty((n, dims[4]), dtype=torch.float32, device=xyz.device)
    ptrs = cpf._ptrs(lines)
    vec = cpf._vec(dims, ptrs + [xyz.data_ptr(), app.data_ptr()])
    rc = lib.iff_cp_features(
        xyz.data_ptr(), n, (ctypes.c_longlong * 6)(*ptrs), (ctypes.c_int * 5)(*dims),
        sigma.data_ptr(), app.data_ptr(), int(vec), _build.sm_count(xyz.device),
        torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(rc, "the parent's CP forward")
    return sigma, app


def parent_coords(lib, params, xyz, dsigma, dapp):
    """The first design's coordinate gradient at these inputs through its
    own entry -> dxyz [n, 3]."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    lines, dims = cpf.kernel_layout(params, True)
    n = xyz.shape[0]
    dxyz = torch.empty((n, 3), dtype=torch.float32, device=xyz.device)
    ptrs = cpf._ptrs(lines)
    vec = cpf._vec(dims, ptrs + [xyz.data_ptr(), dapp.data_ptr()])
    rc = lib.iff_cp_features_coords_grad(
        xyz.data_ptr(), n, (ctypes.c_longlong * 6)(*ptrs), (ctypes.c_int * 5)(*dims),
        dsigma.data_ptr(), dapp.data_ptr(), dxyz.data_ptr(), int(vec),
        _build.sm_count(xyz.device), torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(rc, "the parent's CP coordinate gradient")
    return dxyz


def iteration_profiles(chip_smoke, config, params, mask, parent_lib, rounds):
    """{"source" | "parent": [a profile a round]} of INERF_PROFILE_ITERS
    iNeRF iterations on the CP field, its coordinate gradient through the
    source's kernel or the parent's (the launcher swapped), in turns: the
    kernel ms and host ms an iteration and the coordinate kernel's ms."""
    from iffnerf_tpu_torch.ops import cp_features as cpf

    dev = params["density_line"][0].device
    frame = chip_smoke.cp_inerf_frame(config, params, mask, dev)
    launch = cpf._launch_coords_grad

    def parent_launch(lines, dims, flat, dsigma, dapp):
        cpf.cp_features_coords_grad.launches += 1
        return parent_coords(parent_lib, {"density_line": lines[:3], "app_line": lines[3:]},
                             flat, dsigma, dapp)

    def iterations():
        chip_smoke.cp_inerf(config, params, mask, frame, chip_smoke.INERF_PROFILE_ITERS,
                            chip_smoke.SEED + 1, dev)
        return chip_smoke.INERF_PROFILE_ITERS

    out = {}
    for _ in range(rounds):
        for name in ("source", "parent"):
            cpf._launch_coords_grad = launch if name == "source" else parent_launch
            try:
                prof = chip_smoke._profiled(f"cp_time {name} iterations", iterations)
            finally:
                cpf._launch_coords_grad = launch
            top = prof["top_kernels_ms_per_unit"]
            out.setdefault(name, []).append({
                "device_ms_per_iteration": prof["device_ms_per_unit"],
                "host_ms_per_iteration": prof["host_ms_per_unit"],
                "busy_share": prof["device_busy_share"],
                "coords_ms": sum(v for k, v in top.items() if "coords_grad" in k),
                "top_kernels_ms": top})
    return out


def coords_errors(call, want, tol):
    """The coordinate gradient's largest error against the plain version's
    as a share of ``tol`` x max|plain|, and whether three calls gave the
    same bits."""
    got = call()
    err = float((got - want).abs().max())
    return {"share_of_tolerance": err / (tol * max(float(want.abs().max()), 1e-30)),
            "max_abs_err": err,
            "repeats_bit_equal": all(torch.equal(got, call()) for _ in range(2))}


def placed_forward(params, xyz, buf, offset):
    """The checkout's shared-route forward at xyz (lines and xyz 16-byte
    aligned, the ranks multiples of 8), sigma and the products written into
    ``buf`` from ``offset`` bytes on."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    lines, dims = cpf.kernel_layout(params, True)
    n = xyz.shape[0]
    route, log_cw = cpf.forward_plan(dims, True)
    slices = -(-(dims[3] + dims[4]) >> log_cw)
    part = torch.empty((-(-dims[3] >> log_cw), n), dtype=torch.float32, device=xyz.device)
    at = offset // 4
    sigma, app = buf[at:at + n], buf[at + n:at + n + n * dims[4]]
    sms = _build.sm_count(xyz.device)
    rc = _build.load("cp_features", cpf._SIGNATURES).iff_cp_features(
        xyz.data_ptr(), n, (ctypes.c_longlong * 6)(*cpf._ptrs(lines)), (ctypes.c_int * 5)(*dims),
        sigma.data_ptr(), app.data_ptr(), 8, log_cw,
        cpf.chunks(n, slices, sms, cpf.FWD_UNIT, cpf.FWD_WARPS), part.data_ptr(), sms,
        torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(rc, f"the placed CP forward ({route} route)")


def placement_ms(params, xyz, reps=8):
    """{offset in MB: the forward's ms at the step in ``reps`` single calls
    timed by CUDA events, in order}, with its outputs at each offset of
    PLACEMENTS into one buffer, the offsets taken in turn twice over."""
    n, ra = xyz.shape[0], params["app_line"][0].shape[1]
    buf = torch.empty((max(PLACEMENTS) << 18) + n * (1 + ra), dtype=torch.float32,
                      device=xyz.device)
    out = {}
    for offset in PLACEMENTS + PLACEMENTS:
        for _ in range(2):
            placed_forward(params, xyz, buf, offset << 20)
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            placed_forward(params, xyz, buf, offset << 20)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        out.setdefault(offset, []).append(ts)
    return out


class _Overrides:
    """ops/cp_features.py's constants (or its plans' column width) set for
    one variant's calls, restored after."""

    def __init__(self, spec):
        self.spec = dict(spec)

    def __enter__(self):
        from iffnerf_tpu_torch.ops import cp_features as cpf

        self.saved = {k: getattr(cpf, k) for k in
                      ("BWD_WARPS", "BWD_RUN", "BWD_STAGES", "COORDS_WARPS", "COORDS_RUNS",
                       "COORDS_STAGES", "backward_plan", "forward_plan")}
        log_cw = self.spec.pop("log_cw", None)
        for k, v in self.spec.items():
            setattr(cpf, k, v)
        if log_cw is not None:
            def plan(dims, want_density, want_app):
                for stages in cpf.BWD_STAGES:
                    if cpf.backward_smem(sum(dims[:3]), log_cw, stages) <= cpf.MAX_SMEM:
                        return log_cw, stages
                raise ValueError("no ring fits")

            def fplan(dims, with_app):
                if cpf.forward_smem(sum(dims[:3]), log_cw) > cpf.MAX_SMEM:
                    raise ValueError("the slice does not fit")
                return "shared", log_cw
            cpf.backward_plan, cpf.forward_plan = plan, fplan
        return self

    def __exit__(self, *exc):
        from iffnerf_tpu_torch.ops import cp_features as cpf

        for k, v in self.saved.items():
            setattr(cpf, k, v)


def errors(got, want, tol):
    """The largest error of each gradient line against the plain version's,
    as a share of ``tol`` x that line's largest -> (worst share, its line,
    the largest absolute error)."""
    worst, leaf, err_max = 0.0, "", 0.0
    for name in want:
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            err = float((a - b).abs().max())
            share = err / (tol * max(float(b.abs().max()), 1e-30))
            err_max = max(err_max, err)
            if share >= worst:
                worst, leaf = share, f"{name}[{i}]"
    return {"share_of_tolerance": worst, "worst_line": leaf, "max_abs_err": err_max}


def forward_errors(got, again, want, rtol, atol):
    """The forward's results against the plain version's: the products
    bit-equal, sigma's largest error and whether it is within ``rtol`` and
    ``atol`` x max|plain|, and whether a second call gave the same bits."""
    scale = float(want[0].abs().max())
    return {"app_bit_equal": bool(torch.equal(got[1], want[1])),
            "sigma_max_abs_err": float((got[0] - want[0]).abs().max()),
            "sigma_within_tolerance": bool(torch.allclose(
                got[0], want[0], rtol=rtol, atol=atol * scale)),
            "repeat_bit_equal": bool(torch.equal(got[0], again[0])
                                     and torch.equal(got[1], again[1]))}


def _arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf
    from iffnerf_tpu_torch.ops.gather import gather_rows_plain
    from iffnerf_tpu_torch.tools.ff_time import colour_chunk_samples

    if not torch.cuda.is_available():
        print("cp_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "cp"
    forward = "--forward" in sys.argv
    coords = "--coords" in sys.argv
    kernel = "forward" if forward else "coords" if coords else "backward"
    variants = _arg("--variants", "source").split(",")
    wrong = [v for v in variants if v in VARIANTS and kernel_of(v) != kernel]
    if wrong:
        raise SystemExit(f"cp_time: {wrong} time another kernel")
    rounds = int(_arg("--rounds", "1"))
    parent_cu = _parent_cu(_arg("--parent", None))
    ptext = parent_cu.read_text() if parent_cu is not None else None
    first = {"backward": ptext is not None and first_backward(ptext),
             "coords": ptext is not None and first_coords(ptext)}
    libs, regs = _build_variants(variants, parent_cu, first)
    dev = torch.device("cuda")
    run = chip_smoke.train_cp(dev)
    config = run.config
    params, xyz, dsigma, dapp = run.caught
    field = (run.config, run.params, run.mask)
    del run
    torch.cuda.empty_cache()
    lengths = [a.shape[0] for a in params["density_line"]]
    cxyz = torch.as_tensor(colour_chunk_samples(lengths[::-1], 41), device=dev)
    cases = {"step": (xyz, dsigma, dapp),
             "colour_chunk": (cxyz, *chip_smoke.cp_random_upstream(params, cxyz, 42))}
    if forward:
        cases["inerf"] = (xyz[:INERF_SAMPLES], None, None)
    if coords:
        cases["inerf"] = (xyz[:INERF_SAMPLES],
                          *iteration_upstream(params, INERF_SAMPLES, 43, dev))
        cases["all_live"] = chip_smoke.cp_all_live_inputs(params, dev)[1:]
        frame = chip_smoke.cp_inerf_frame(*field, dev)
        with chip_smoke.captured_cp("_launch_coords_grad", chip_smoke.first_call()) as caught:
            chip_smoke.cp_inerf(*field, frame, 1, chip_smoke.SEED, dev)
        cases["inerf_captured"] = caught["inputs"][1:]
        del frame
    ranks = [params["density_line"][0].shape[1], params["app_line"][0].shape[1]]
    dims = lengths + ranks
    result = {"label": label, "kernel": kernel,
              "card": chip_smoke.card_line(), "lines": lengths, "ranks": ranks,
              "n": {}, "live": {}, "bound_ms": {}, "plan": {},
              "registers": regs,
              "resident_warps": {v: kernels_resident_warps(rs) for v, rs in regs.items()}}
    plain = {}
    sms = _build.sm_count(dev)
    cols = sum(ranks)
    for case, (x, ds, da) in cases.items():
        result["n"][case] = x.shape[0]
        if forward:
            route, log_cw = cpf.forward_plan(dims, True)
            slices = -(-cols >> log_cw) if log_cw is not None else None
            result["bound_ms"][case] = chip_smoke.cp_forward_bound(params, x)[0]
            result["plan"][case] = {
                "route": route, "log_cw": log_cw, "slices": slices,
                "chunks": None if slices is None else cpf.chunks(
                    x.shape[0], slices, sms, cpf.FWD_UNIT, cpf.FWD_WARPS)}
            with torch.no_grad():
                plain[case] = chip_smoke.cp_chunked(lambda c: cpf.cp_features_plain(
                    params, c, True, gather_rows_plain), x)
            continue
        result["live"][case] = int(((ds != 0) | (da != 0).any(-1)).sum())
        if coords:
            alive = (ds != 0) | (da != 0).any(-1)
            pad = -alive.shape[0] % 8
            result.setdefault("live_stages", {})[case] = int(torch.nn.functional.pad(
                alive, (0, pad)).view(-1, 8).any(-1).sum())
            result["bound_ms"][case] = chip_smoke.cp_bounds(params, x, ds, da)["coords_grad"][0]
            result["plan"][case] = dict(zip(("run", "stages"), cpf.coords_plan(dims, True)))
            plain[case] = chip_smoke.cp_chunked(
                lambda *a: cpf.cp_features_coords_grad_plain(params, *a), x, ds, da)
            continue
        log_cw, stages = cpf.backward_plan(dims, True, True)
        slices = -(-cols >> log_cw)
        result["bound_ms"][case] = chip_smoke.cp_bounds(params, x, ds, da)["backward"][0]
        result["plan"][case] = {"log_cw": log_cw, "stages": stages, "slices": slices,
                                "parent_plan": parent_plan(dims, cols, x.shape[0], sms),
                                "chunks": cpf.chunks(x.shape[0], slices, sms, cpf.BWD_UNIT,
                                                     cpf.BWD_WARPS)}
        plain[case] = chip_smoke.cp_chunked(
            lambda *a: cpf.cp_features_backward_plain(params, *a), x, ds, da, total=True)
    for rnd in range(rounds):
        for name in variants:
            print(f"cp_time: {name} round {rnd}", file=sys.stderr, flush=True)
            base, _, spec, meaningful = VARIANTS.get(name, (name, [], {}, True))
            parentish = base == "parent"
            row = result.setdefault(name, {})
            for case, (x, ds, da) in cases.items():
                cell = row.setdefault(case, {"graph_ms": [], "ms": []})
                if forward and parentish:
                    def call():
                        return parent_forward(libs[name], params, x)
                elif coords and parentish and first["coords"]:
                    def call():
                        return parent_coords(libs[name], params, x, ds, da)
                elif coords:
                    def call():
                        return cpf.cp_features_coords_grad(config, params, x, ds, da)
                elif parentish and first["backward"]:
                    def call():
                        return parent_backward(libs[name], params, x, ds, da)
                elif forward:
                    def call():
                        return cpf.cp_features(config, params, x)
                else:
                    def call():
                        return cpf.cp_features_backward(config, params, x, ds, da)
                _build._LIBS["cp_features"] = libs[name]
                with _Overrides(spec), torch.no_grad():
                    cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                    cell["ms"].append(chip_smoke.time_ms(call))
                    if rnd == 0 and meaningful and coords:
                        cell.update(coords_errors(call, plain[case],
                                                  chip_smoke.COORDS_GRAD_TOL))
                    elif rnd == 0 and meaningful and forward:
                        got = call()
                        cell.update(forward_errors(got, call(), plain[case],
                                                   chip_smoke.FIELD_RTOL,
                                                   chip_smoke.FIELD_ATOL))
                        del got
                    elif rnd == 0 and meaningful:
                        cell.update(errors(call(), plain[case], chip_smoke.CP_GRAD_TOL))
                _build._LIBS["cp_features"] = libs.get("source", _build._LIBS["cp_features"])
                torch.cuda.empty_cache()
    if coords and "--iterations" in sys.argv:
        _build._LIBS["cp_features"] = libs.get("source", _build._LIBS["cp_features"])
        result["iterations"] = iteration_profiles(chip_smoke, *field, libs["parent"], rounds)
    if forward and "--placements" in sys.argv:
        _build._LIBS["cp_features"] = libs.get("source", _build._LIBS["cp_features"])
        with torch.no_grad():
            result["placement_ms"] = placement_ms(params, xyz)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
