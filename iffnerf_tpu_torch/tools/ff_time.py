"""Times field_features' backward kernel (and its forward) on one card, and
variants of the backward.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory. Its inputs are those of ``chip_smoke.py``'s field-training
phase: ``chip_smoke.train_with_capture`` runs ``train_field`` at
configs/lego.txt's widths (12 steps from a 128^3 field to 299^3) and keeps
the inputs of the backward's first launch at each grid; beside them the
axis-aligned ray set of ``chip_smoke.axis_ray_inputs`` at the final grid,
where consecutive samples share the most rows. It prints one JSON line:
for each variant, the backward's eager and graph-replayed ms (medians of
CUDA-event batches, ``chip_smoke.time_ms``) at the 128^3 step, the 299^3
step and the axis-aligned set, its check against the plain version
(``chip_smoke.backward_errors``) at each, and a field-training step's
split (forward, backward, Adam by CUDA events); once, the forward's eager
and graph ms at the 299^3 step, and the corner-row adds of the old design
(6 rows a sample and axis pair with a gradient) and of this one (the rows
a run's walk leaves, ``row_adds``).

    cd <checkout> && python3 <path>/ff_time.py <label> [--variants A,B] [--rounds N] [--parent DIR]

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
"""

from __future__ import annotations

import ctypes
import json
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


def ray_ordered_samples(grid, directions, per_ray, seed, spread=0.8):
    """Normalized coords [len(directions) * per_ray, 3] float32, ray-major:
    for each direction one ray of ``per_ray`` samples half a texel apart on
    the grid's finest axis, centred on a point drawn uniformly from
    [-spread, spread]^3 (numpy, from ``seed``). Long rays leave [-1, 1]."""
    rng = np.random.default_rng(seed)
    step = 1.0 / (max(grid) - 1)
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


def run_samples(root: Path) -> int:
    """The backward's run length, read from a checkout's source."""
    src = (root / "iffnerf_tpu_torch" / "csrc" / "field_features.cu").read_text()
    return int(re.search(r"kRunSamples = (\d+);", src).group(1))


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
        if name == "parent":
            if parent is None:
                raise RuntimeError("the parent variant needs --parent DIR")
            cu = Path(parent).resolve() / "iffnerf_tpu_torch" / "csrc" / "field_features.cu"
        else:
            text = src
            for old, new in _VARIANTS[name][0]:
                if text.count(old) != 1:
                    raise RuntimeError(f"the source no longer holds {old[:60]!r}")
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


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke
    from iffnerf_tpu_torch.models.field import FieldConfig
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops.field_features import (
        field_features,
        field_features_backward,
    )
    from iffnerf_tpu_torch.utils.misc import cal_n_samples

    if not torch.cuda.is_available():
        print("ff_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "ff"
    variants = _arg("--variants", "source").split(",")
    rounds = int(_arg("--rounds", "1"))
    libs = _build_variants(variants, _arg("--parent", None))
    dev = torch.device("cuda")
    run = chip_smoke.train_with_capture(dev)
    keys = list(run.caught)
    cases = {"grid_128": run.caught[keys[0]], "grid_final": run.caught[keys[-1]]}
    cases["axis_rays"] = chip_smoke.axis_ray_inputs(cases["grid_final"][0], dev)
    result = {"label": label, "card": chip_smoke.card_line(),
              "run_samples": run_samples(Path(".")),
              "grids": {k: list(v[0]["density_plane"][0].shape[:2]) for k, v in cases.items()}}
    result["row_adds"] = {k: row_adds(*v, result["run_samples"]) for k, v in cases.items()}
    p, xyz, _, _ = cases["grid_final"]
    with torch.no_grad():
        result["forward_grid_final"] = {
            "n": xyz.shape[0],
            "ms": chip_smoke.time_ms(lambda: field_features(FieldConfig(), p, xyz, True),
                                     graph=True),
            "eager_ms": chip_smoke.time_ms(lambda: field_features(FieldConfig(), p, xyz, True))}
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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
