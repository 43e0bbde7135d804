"""Times the TensorCP line-gradient kernel (``iff_cp_features_bwd``) on
one card, beside the parent's kernel and cut-out variants of both.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory. Its inputs are those of ``chip_smoke.py``'s ``tensor_cp`` phase:
``chip_smoke.train_cp`` trains configs/lego.txt with TensoRF's CP block
(ranks 96 / 288) for 12 steps to 505x505x489 and keeps the inputs of the
backward's first launch at each grid; the tool takes the final grid's (a
CP step: 7 090 176 samples, their dsigma and dapp and the six lines), and
a colour chunk's shape at that grid (``ff_time.colour_chunk_samples``:
204 660 ray-major samples 2 texels apart) with ``chip_smoke.
cp_random_upstream``'s upstream. It prints one JSON line: the card's name
and power limit, each case's samples, live samples and bound
(``chip_smoke.cp_bounds``), the plan of each design, and for each variant
and case the kernel's graph-replayed and eager ms in every round (medians
of CUDA-event batches, ``chip_smoke.time_ms``) and, where its gradients
mean something, its largest error against the plain version
(``cp_features_backward_plain``, chunked) as a share of CP_GRAD_TOL of the
line's largest.

    cd <checkout> && python3 <path>/cp_time.py <label> [--parent DIR] [--variants A,B] [--rounds N]

``--variants`` builds text edits of the checkout's ``csrc/cp_features.cu``
(or of the parent's) into ``build/kernels/variants/``, all nvcc processes
at once, and times them in turns, ``--rounds`` times over:

- ``source``: the checkout's own build;
- ``parent``: ``DIR/iffnerf_tpu_torch/csrc/cp_features.cu`` as it is, with
  ``--parent DIR`` (a parent commit unpacked beside the change), launched
  with the first design's own plan (``parent_plan``: 16 columns a block at
  lego's lines, two blocks resident an SM, four an SM launched);
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
- ``parent_stream_only`` (not checked): the first design reading each
  sample's upstream word, and the coordinates of a live one, and nothing
  more: its chase alone;
- ``parent_no_adds`` (not checked): the first design with a plain
  shared-memory store in place of each add;
- ``parent_flush_only`` (not checked): the first design walking nothing.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

_RUN_TAIL = "                   // samples a group"
_NEVER = " && p.rows < 0"  # false at run time, which the compiler cannot see
_NO_RING = ("  p.tma = tma;\n", "  p.tma = 0;\n")
_ADD = "  if (row != kNoRow && s != 0.0f) atomicAdd(acc + off + static_cast<int>(row) * cw, s);"
_PARENT_ADDS = """atomicAdd(acc + off[i] + cur0[i] * cw + lane, a0[i]);
{0}atomicAdd(acc + off[i] + cur1[i] * cw + lane, a1[i]);
"""
_PARENT_STORES = """acc[off[i] + cur0[i] * cw + lane] = a0[i];
{0}acc[off[i] + cur1[i] * cw + lane] = a1[i];
"""
_PARENT_END = "#pragma unroll\n    for (int i = 0; i < 3; ++i) {\n      if (cur0[i] >= 0) {\n"


def _constant(name, value, new, tail=""):
    """A text edit of ``constexpr int name = value;`` (and ``tail``, which
    tells it from a constant of the same name in another namespace)."""
    return (f"constexpr int {name} = {value};{tail}", f"constexpr int {name} = {new};{tail}")


# name: (base, text edits, overrides of ops/cp_features.py's constants or
# plan, whether its gradients mean something). The cut-outs guard what
# they cut with a condition false at run time, so that the compiler keeps
# the work they leave.
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
    "run16_warps8": ("source", [_constant("kRun", 8, 16, _RUN_TAIL), _constant("kWarps", 16, 8)],
                     {"BWD_RUN": 16, "BWD_WARPS": 8}, True),
    "warps8": ("source", [_constant("kWarps", 16, 8)], {"BWD_WARPS": 8}, True),
    "warps12": ("source", [_constant("kWarps", 16, 12)], {"BWD_WARPS": 12}, True),
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
}
PARENT_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _build_variants(names, parent):
    """{name: the cp_features library of variant name}, the nvcc processes
    all started together (``source``: the checkout's build)."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "cp_features.cu").read_text()
    parent_cu = (None if parent is None else Path(parent).resolve()
                 / "iffnerf_tpu_torch" / "csrc" / "cp_features.cu")
    procs = {}
    for name in names:
        if name == "source" or (name in VARIANTS and not VARIANTS[name][1]):
            continue
        if (name == "parent" or VARIANTS[name][0] == "parent") and parent_cu is None:
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
    libs = {name: own for name in names
            if name == "source" or (name in VARIANTS and not VARIANTS[name][1])}
    for name, (proc, path) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(path))
        parentish = name == "parent" or VARIANTS[name][0] == "parent"
        for fn, argtypes in cpf._SIGNATURES.items():
            getattr(lib, fn).argtypes = (PARENT_SIGNATURE if parentish
                                         and fn == "iff_cp_features_bwd" else argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def parent_backward(lib, params, xyz, dsigma, dapp):
    """The parent's kernel at these inputs with its own plan -> the six
    gradient lines."""
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


class _Overrides:
    """ops/cp_features.py's constants (or its plan's column width) set for
    one variant's calls, restored after."""

    def __init__(self, spec):
        self.spec = dict(spec)

    def __enter__(self):
        from iffnerf_tpu_torch.ops import cp_features as cpf

        self.saved = {k: getattr(cpf, k) for k in
                      ("BWD_WARPS", "BWD_RUN", "BWD_STAGES", "backward_plan")}
        log_cw = self.spec.pop("log_cw", None)
        for k, v in self.spec.items():
            setattr(cpf, k, v)
        if log_cw is not None:
            def plan(dims, want_density, want_app):
                for stages in cpf.BWD_STAGES:
                    if cpf.backward_smem(sum(dims[:3]), log_cw, stages) <= cpf.BWD_MAX_SMEM:
                        return log_cw, stages
                raise ValueError("no ring fits")
            cpf.backward_plan = plan
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


def _arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import cp_features as cpf
    from iffnerf_tpu_torch.tools.ff_time import colour_chunk_samples

    if not torch.cuda.is_available():
        print("cp_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "cp"
    variants = _arg("--variants", "source").split(",")
    rounds = int(_arg("--rounds", "1"))
    libs = _build_variants(variants, _arg("--parent", None))
    dev = torch.device("cuda")
    run = chip_smoke.train_cp(dev)
    config = run.config
    params, xyz, dsigma, dapp = run.caught
    del run
    torch.cuda.empty_cache()
    lengths = [a.shape[0] for a in params["density_line"]]
    cxyz = torch.as_tensor(colour_chunk_samples(lengths[::-1], 41), device=dev)
    cases = {"step": (xyz, dsigma, dapp),
             "colour_chunk": (cxyz, *chip_smoke.cp_random_upstream(params, cxyz, 42))}
    result = {"label": label, "card": chip_smoke.card_line(), "lines": lengths,
              "ranks": [params["density_line"][0].shape[1],
                        params["app_line"][0].shape[1]],
              "n": {}, "live": {}, "bound_ms": {}, "plan": {}, "parent_plan": {}}
    plain = {}
    sms = _build.sm_count(dev)
    for case, (x, ds, da) in cases.items():
        dims = lengths + result["ranks"]
        cols = sum(result["ranks"])
        log_cw, stages = cpf.backward_plan(dims, True, True)
        slices = -(-cols >> log_cw)
        result["n"][case] = x.shape[0]
        result["live"][case] = int(((ds != 0) | (da != 0).any(-1)).sum())
        result["bound_ms"][case] = chip_smoke.cp_bounds(params, x, ds, da)["backward"][0]
        result["plan"][case] = {"log_cw": log_cw, "stages": stages, "slices": slices,
                                "chunks": cpf.backward_chunks(x.shape[0], slices, sms)}
        result["parent_plan"][case] = dict(zip(("log_cw", "chunks"), parent_plan(
            dims, cols, x.shape[0], sms)))
        plain[case] = chip_smoke.cp_chunked(
            lambda *a: cpf.cp_features_backward_plain(params, *a), x, ds, da, total=True)
    for rnd in range(rounds):
        for name in variants:
            print(f"cp_time: {name} round {rnd}", file=sys.stderr, flush=True)
            base, _, spec, meaningful = VARIANTS.get(name, (name, [], {}, True))
            row = result.setdefault(name, {})
            for case, (x, ds, da) in cases.items():
                cell = row.setdefault(case, {"graph_ms": [], "ms": []})
                if base == "parent":
                    def call():
                        return parent_backward(libs[name], params, x, ds, da)
                else:
                    def call():
                        return cpf.cp_features_backward(config, params, x, ds, da)
                _build._LIBS["cp_features"] = libs[name]
                with _Overrides(spec):
                    cell["graph_ms"].append(chip_smoke.time_ms(call, graph=True))
                    cell["ms"].append(chip_smoke.time_ms(call))
                    if rnd == 0 and meaningful:
                        cell.update(errors(call(), plain[case], chip_smoke.CP_GRAD_TOL))
                _build._LIBS["cp_features"] = libs.get("source", _build._LIBS["cp_features"])
                torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
