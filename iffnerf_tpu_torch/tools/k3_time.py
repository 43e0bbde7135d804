"""Times K3's backward (``iff_gather_rows_bwd``, ``csrc/gather_rows.cu``
namespace ``bwd``) on one card, beside the parent's kernel and cut-out
variants of this checkout's.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory. The cases are those of ``chip_smoke.py``'s ``tensor_cp`` phase:
``chip_smoke.train_cp`` trains configs/lego.txt with TensoRF's CP block for
12 steps to 505x505x489 and keeps the final step's samples, from which
come a density line's corners ([489, 96] x 14 180 352) and the alpha
mask's ([16 061 175, 1] x 56 721 408); a colour chunk's shape at that grid
(``ff_time.colour_chunk_samples``: 204 660 ray-major samples 2 texels
apart) gives an appearance line's corners ([489, 288] x 409 320) and a VM
plane's ([300^2, 48] x 818 640, the global route with wide rows), each
with a normal upstream from a seed; and the six launches of a 256-ray step
of the samplers under grad (``chip_smoke.sampler_step``, as
``cp_sampler_route`` drives it; upstream and indices captured as they were
launched), timed one by one and summed. It prints one JSON line: the card's name and power limit;
each case's table, entries, runs of equal indices, plan (slice width,
slices, blocks, warps, group, unit), bound (``chip_smoke.k3_backward_
holds``' bytes) and one ``index_add_``'s ms; each built variant's
registers and spill bytes a kernel from ``ptxas -v``; for each variant and
case the graph-replayed and eager ms in every round (medians of CUDA-event
batches, ``chip_smoke.time_ms``) and, where its results mean something,
its largest error against ``index_add_`` as a share of CP_GRAD_TOL of the
largest |grad|, and against the same sum in float64 (``exact``), beside
``index_add_``'s own; and the goals (GOALS, graph ms) met or missed by
the source's slowest round.

    cd <checkout> && python3 -m iffnerf_tpu_torch.tools.k3_time <label> [--parent DIR] [--variants A,B] [--rounds N]

``--variants`` (default ``source``) builds text edits of the checkout's
``csrc/gather_rows.cu`` into ``build/kernels/variants/``, all nvcc
processes at once, and times them in turns, ``--rounds`` times over.
``source`` is the checkout's own build; ``parent`` is ``DIR/iffnerf_tpu_
torch/csrc/gather_rows.cu`` as it is (``--parent DIR``: a parent commit
unpacked beside the change), called through its own entry when it is the
first design (a grid stride of thread groups, one RED an entry). The
cut-outs guard what they cut with a condition false at run time, so that
the compiler keeps the work they leave:

- ``stream_only`` (not checked): the upstream and indices streamed and
  scanned, nothing added;
- ``no_merge``: every entry its own run, so every entry adds;
- ``no_ahead``: one step loaded at a time, in place of K at once;

and ``warps16``, a plan other than ``backward_plan``'s for the same
source: half the blocks (16 warps an SM in place of 32).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

# graph ms that the redesign aims under, at NVIDIA H100 80GB HBM3, 700 W
GOALS = {"density_line": 3.0, "app_line_chunk": 0.25, "mask": 1.1}
VM_PLANE, VM_RANKS = 300, 48
_NEVER = " && p.rows < 0"  # false at run time, which the compiler cannot see
_ALWAYS = " || p.rows > 0"  # true at run time


def _half_blocks(plan):
    """Half the blocks of a plan (at least one): 16 warps an SM."""
    return plan._replace(blocks=max(1, plan.blocks // 2))


# name: (text edits of the source, whether its results mean something,
# a transform of backward_plan's plans or None)
VARIANTS = {
    "stream_only": ([
        ("    if (w >= words || !nonzero(x[q])) continue;\n",
         "    if (w >= words || !nonzero(x[q])" + _ALWAYS + ") continue;\n")], False, None),
    "no_merge": ([
        ("        int f = e == 0 || rp != r;",
         "        int f = e == 0 || rp != r" + _ALWAYS + ";"),
        ("        const bool tail = e == E - 1 || rn != r;",
         "        const bool tail = e == E - 1 || rn != r" + _ALWAYS + ";"),
        ("        const bool goes_on = crow >= 0 && crow == r0;",
         "        const bool goes_on = crow >= 0 && crow == r0" + _NEVER + ";")], True, None),
    "no_ahead": ([("constexpr int kAheadBytes = 64;", "constexpr int kAheadBytes = 0;")], True,
                 None),
    "warps16": ([], True, _half_blocks),
}
PARENT_BWD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


def variant_source(name, source):
    """The text of variant ``name``: its edits applied to the source, each
    of which must hold its text exactly once (a plan variant: none)."""
    text = source
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def first_design(text):
    """Whether the backward of ``text`` (a gather_rows.cu) is the first
    design (a grid stride of thread groups, one RED an entry)."""
    return "namespace bwd" not in text


def ptxas_report(log):
    """{kernel's mangled name: {"registers": n, "spill_bytes": stores +
    loads}} from nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "bwd" in k}


def build_variants(names, parent_cu):
    """({name: its gather_rows library (the source's) or (library, whether
    its backward is the first design)}, {name: its backward kernels'
    registers and spills}), the nvcc processes all started together; the
    source's library is loaded whether it is timed or not."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import gather

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "gather_rows.cu").read_text()
    procs = {}
    for name in dict.fromkeys(names):
        if name == "source" or (name in VARIANTS and not VARIANTS[name][0]):
            continue
        if name == "parent":
            if parent_cu is None:
                raise RuntimeError("the parent variant needs --parent DIR")
            cu = parent_cu
        else:
            cu = out / f"k3_{name}.cu"
            cu.write_text(variant_source(name, source))
        lib = out / f"k3_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    _build._LIBS.pop("gather_rows", None)
    own = _build.load("gather_rows", gather._SIGNATURES)
    own_log = _build.library_path("gather_rows").with_suffix(".so.log")
    libs, regs = {"source": own}, {}
    if "source" in names:
        regs["source"] = ptxas_report(own_log.read_text()) if own_log.exists() else {}
    for name in names:  # plan variants run the source's build
        if name in VARIANTS and not VARIANTS[name][0]:
            libs[name] = (own, False)
    for name, (proc, path) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs[name] = ptxas_report(log)
        lib = ctypes.CDLL(str(path))
        first = name == "parent" and first_design(parent_cu.read_text())
        for fn, argtypes in gather._SIGNATURES.items():
            if fn == "iff_gather_rows_bwd" and first:
                argtypes = PARENT_BWD
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, first)
    return libs, regs


def parent_backward(lib, up, idx, rows):
    """The first design at these inputs through its own entry -> grad."""
    from iffnerf_tpu_torch.ops import _build

    n, c = up.shape
    out = torch.zeros((rows, c), dtype=torch.float32, device=up.device)
    vec = c % 4 == 0 and up.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = lib.iff_gather_rows_bwd(up.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, c,
                                 int(vec), _build.sm_count(up.device),
                                 torch.cuda.current_stream(up.device).cuda_stream)
    _build.check(rc, "the parent's K3 backward")
    return out


def cases(chip_smoke, dev):
    """{case: (upstream [N, C], idx [N] int32, table rows)} (see the
    module's docstring)."""
    from iffnerf_tpu_torch.ops.grid_sample import corners_1d, corners_2d, corners_3d
    from iffnerf_tpu_torch.tools.ff_time import colour_chunk_samples

    run = chip_smoke.train_cp(dev)
    params, xyz = run.caught[0], run.caught[1]
    run.caught = None
    lengths = [a.shape[0] for a in params["density_line"]]
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 61)
    vol = run.mask.volume
    out = {}
    idx = corners_3d(*vol.shape, xyz)[0].reshape(-1).contiguous()
    out["mask"] = (torch.randn((idx.shape[0], 1), generator=g, device=dev), idx, vol.numel())
    idx = corners_1d(lengths[0], xyz[:, 2])[0].reshape(-1).contiguous()
    out["density_line"] = (torch.randn((idx.shape[0], 96), generator=g, device=dev), idx,
                           lengths[0])
    cxyz = torch.as_tensor(colour_chunk_samples(lengths[::-1], 41), device=dev)
    idx = corners_1d(lengths[0], cxyz[:, 2])[0].reshape(-1).contiguous()
    out["app_line_chunk"] = (torch.randn((idx.shape[0], 288), generator=g, device=dev),
                             idx, lengths[0])
    idx = corners_2d(VM_PLANE, VM_PLANE, cxyz[:, :2])[0].reshape(-1).contiguous()
    out["vm_plane"] = (torch.randn((idx.shape[0], VM_RANKS), generator=g, device=dev), idx,
                       VM_PLANE ** 2)
    del xyz, cxyz
    n_final = chip_smoke.cal_n_samples(run.config.grid_size, run.args.step_ratio)
    with chip_smoke.captured_k3_backward() as caught:
        chip_smoke.sampler_step(run.config.replace(fused_eval="off"), run.params, run.mask,
                                run.pool, n_final, dev)
    for k, (up, idx, rows) in enumerate(caught):
        out[f"sampler_{k}"] = (up, idx, rows)
    del run
    torch.cuda.empty_cache()
    return out


def exact(up, idx, rows):
    """The backward's function summed in float64 (index_add_ in chunks of
    2^22 entries)."""
    from iffnerf_tpu_torch.ops.gather import _wrapped

    i, ok = _wrapped(idx, rows)
    out = torch.zeros((rows, up.shape[1]), dtype=torch.float64, device=up.device)
    for s in range(0, up.shape[0], 1 << 22):
        part = slice(s, s + (1 << 22))
        out.index_add_(0, i[part], torch.where(ok[part, None], up[part].double(), 0.0))
    return out


def share(got, want):
    """The largest error of ``got`` against ``want`` as a share of
    CP_GRAD_TOL x max|want|."""
    import chip_smoke

    err = float((got.double() - want.double()).abs().max())
    return err / (chip_smoke.CP_GRAD_TOL * max(float(want.abs().max()), 1e-30))


def _arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def main() -> int:
    sys.path.insert(0, ".")  # the checkout in the working directory
    import chip_smoke
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import gather
    from iffnerf_tpu_torch.ops.gather import (
        gather_rows_backward,
        gather_rows_backward_plain,
    )

    if not torch.cuda.is_available():
        print("k3_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "k3"
    variants = _arg("--variants", "source").split(",")
    unknown = [v for v in variants if v not in VARIANTS and v not in ("source", "parent")]
    if unknown:
        raise SystemExit(f"k3_time: unknown variants {unknown}")
    rounds = int(_arg("--rounds", "1"))
    parent = _arg("--parent", None)
    parent_cu = (None if parent is None else
                 Path(parent).resolve() / "iffnerf_tpu_torch" / "csrc" / "gather_rows.cu")
    libs, regs = build_variants(variants, parent_cu)
    dev = torch.device("cuda")
    inputs = cases(chip_smoke, dev)
    sms = _build.sm_count(dev)
    result = {"label": label, "card": chip_smoke.card_line(), "cases": {},
              "registers": regs, "goals": {}}
    for case, (up, idx, rows) in inputs.items():
        c = up.shape[1]
        plan = gather.backward_plan(rows, c, idx.shape[0], sms, up.data_ptr() % 16 == 0)
        touched = torch.unique(idx).numel()
        long_idx = idx.long()

        def library(up=up, long_idx=long_idx, rows=rows, c=c):
            return torch.zeros((rows, c), device=up.device).index_add_(0, long_idx, up)

        result["cases"][case] = {
            "table": [rows, c], "n": idx.shape[0], "runs": chip_smoke.k3_runs(idx),
            "plan": plan._asdict(),
            "bound_ms": chip_smoke.bound(up.numel() * 4 + idx.numel() * 4
                                         + 2 * touched * c * 4, 0.0, torch.float32)[0],
            "library_ms": chip_smoke.time_ms(library, reps=3)}
    want = {case: gather_rows_backward_plain(up, idx, rows)
            for case, (up, idx, rows) in inputs.items()}
    want64 = {case: exact(up, idx, rows) for case, (up, idx, rows) in inputs.items()}
    for case in inputs:
        result["cases"][case]["index_add_share_of_exact"] = share(want[case], want64[case])
    own = libs["source"]
    plan_of = gather.backward_plan
    for rnd in range(rounds):
        for name in variants:
            print(f"k3_time: {name} round {rnd}", file=sys.stderr, flush=True)
            _, meaningful, transform = VARIANTS.get(name, ([], True, None))
            row = result.setdefault(name, {})
            lib = libs[name]
            for case, (up, idx, rows) in inputs.items():
                cell = row.setdefault(case, {"graph_ms": [], "ms": []})
                if name == "parent" and lib[1]:
                    def call(up=up, idx=idx, rows=rows):
                        return parent_backward(lib[0], up, idx, rows)
                else:
                    _build._LIBS["gather_rows"] = lib if name == "source" else lib[0]

                    def call(up=up, idx=idx, rows=rows):
                        return gather_rows_backward(up, idx, rows)
                if transform is not None:
                    gather.backward_plan = lambda *a: transform(plan_of(*a))
                cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                cell["ms"].append(chip_smoke.time_ms(call))
                if rnd == 0 and meaningful:
                    got = call()
                    cell["share_of_tolerance"] = share(got, want[case])
                    cell["share_of_exact"] = share(got, want64[case])
                    del got
                _build._LIBS["gather_rows"] = own
                gather.backward_plan = plan_of
                torch.cuda.empty_cache()
    steps = [k for k in inputs if k.startswith("sampler_")]
    for name in dict.fromkeys(variants):
        result[name]["sampler_step_sum"] = {
            key: [sum(t) for t in zip(*(result[name][k][key] for k in steps))]
            for key in ("graph_ms", "ms")}
    if "source" in variants:
        for case, goal in GOALS.items():
            worst = max(result["source"][case]["graph_ms"])
            result["goals"][case] = {"goal_ms": goal, "slowest_ms": worst,
                                     "met": worst <= goal}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
