"""Times the fused ray-scoring kernel (K2) on one card, and variants of it.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory, so that two checkouts (say a parent commit unpacked beside the
change) can be timed in turns on one card. Its inputs are those of
``chip_smoke.py``'s main path: the ID module's weights from seed 0, the
540 000 rays of ``chip_smoke.make_scene`` through ``ray_mlp_inputs`` and
the ViT's queries of its first image. It prints one JSON line: K2 in
float32 and bf16, eager (CUDA events over a batch of calls) and replayed
from a CUDA graph, with each route's errors against its plain version
(``chip_smoke.errors``) and whether two calls are bit-equal.

    cd <checkout> && python3 <path>/k2_time.py <label> [--variants A,B] [--rounds N]

``--variants`` builds text edits of the checkout's
``csrc/fused_ray_attention.cu`` into ``build/kernels/variants/`` and times
them in turns with the source's, ``--rounds`` times over (``source`` is
the checkout's own build), each in the dtypes whose route it edits:

- ``one_product`` (float32): hi . hi alone in place of the three TF32
  products, which the checks' largest relative error must refuse;
- ``no_ring`` (both): the producer loads no weights and the consumers
  never wait for a stage (the products read whatever the stages hold):
  the consumers' own time, products, loads, barriers and epilogues;
- ``no_products`` (both): the consumers wait for each stage and free it
  without issuing its products: the weights' stream from L2 through the
  ring;
- ``skeleton`` (both): neither the ring nor the products: what is left of
  the consumers (barriers, layer and logits epilogues, x) and the
  wrapper;
- ``stage1``, ``stage2`` (bf16): one or two 16-deep steps a ring stage
  (a bulk copy and a wait each) in place of four; ``stage1`` with up to 16
  stages. The wrapper lays the steps out to match;
- ``lag2`` (bf16): two stages of products left running, in place of one,
  while the next stage issues.

Only ``one_product``, ``stage1``, ``stage2`` and ``lag2`` give scores
that mean anything beside ``source``.
"""

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys

import torch

CALLS, REPS = 10, 7

_PRODUCTS = "  mma(acc, hi, b_lo, accumulate);\n  mma(acc, lo, b_hi, 1);\n  mma(acc, hi, b_hi, 1);\n"
_BF16_MMA = "      mma(acc, a, hop::desc_sw32(stage + g * n * kStepBytes), k);\n"
_BF16_STAGE_STEPS = "constexpr int kStageSteps = 4;"
_MAX_STAGES = "constexpr int kMaxStages = 8;"
# name -> (dtypes it is timed in, text edits of the source, wrapper
# attributes to set while it runs)
_VARIANTS = {
    "one_product": (("float32",), [(_PRODUCTS, "  mma(acc, hi, b_hi, accumulate);\n")], {}),
    "no_ring": (("float32", "bfloat16"), [
        ("        hop::mbar_wait(sm.empty + at.s, at.phase ^ 1);\n        if (leader) {",
         "        if (false) {"),
        ("  hop::mbar_wait(sm.full + at.s, at.phase);\n  const unsigned char* slot",
         "  const unsigned char* slot"),
        ("    release(sm, s0);\n    release(sm, s1);\n", ""),
        ("    hop::mbar_wait(sm.full + at.s, at.phase);\n    const unsigned char* stage",
         "    const unsigned char* stage")], {}),
    "no_products": (("float32", "bfloat16"), [
        (_PRODUCTS, "  if (b_hi == 0 && b_lo == 0) mma(acc, hi, b_lo, accumulate);\n"),
        (_BF16_MMA, "      if (stage == nullptr) " + _BF16_MMA.lstrip())], {}),
    "stage1": (("bfloat16",), [
        (_BF16_STAGE_STEPS, "constexpr int kStageSteps = 1;"),
        (_MAX_STAGES, "constexpr int kMaxStages = 16;")],
        {"_BF16_STAGE_STEPS": 1, "_MAX_STAGES": 16}),
    "stage2": (("bfloat16",), [(_BF16_STAGE_STEPS, "constexpr int kStageSteps = 2;")],
               {"_BF16_STAGE_STEPS": 2}),
    "lag2": (("bfloat16",), [("constexpr int kInFlight = 1;", "constexpr int kInFlight = 2;")], {}),
}
_VARIANTS["skeleton"] = (("float32", "bfloat16"),
                         _VARIANTS["no_ring"][1] + _VARIANTS["no_products"][1], {})


def _variants(names) -> dict:
    """{name: the fused kernel built with the text edits of variant name},
    the variants' nvcc processes all started together (``source``: the
    checkout's own build)."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import fused_ray_attention as fra

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_ray_attention.cu").read_text()
    procs = {}
    for name in names:
        if name == "source":
            continue
        text = src
        for old, new in _VARIANTS[name][1]:
            if text.count(old) != 1:
                raise RuntimeError(f"the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        cu = out / f"k2_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    if "source" in names:
        _build._LIBS.pop("fused_ray_attention", None)
        libs["source"] = _build.load("fused_ray_attention", fra._SIGNATURES)
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"k2_{name}.so"))
        for fn, argtypes in fra._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _times(fn):
    """(eager ms, graph ms) a call: medians of REPS batches of CALLS calls.
    The graph time is None where the wrapper cannot be captured (a parent
    whose K2 wrapper copied the query scale from the host)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def batch():
        for _ in range(CALLS):
            fn()

    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            batch()
    except RuntimeError:
        graph = None
    out = []
    for run in (batch, graph.replay if graph is not None else None):
        if run is None:
            out.append(None)
            continue
        ts = []
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / CALLS)
        out.append(round(statistics.median(ts), 4))
    return out


@contextlib.contextmanager
def _wrapper_set(attrs):
    """The wrapper's attributes set to ``attrs`` (and its cached weight
    steps dropped) while the block runs."""
    from iffnerf_tpu_torch.ops import fused_ray_attention as fra

    if not attrs:
        yield
        return
    old = {k: getattr(fra, k) for k in attrs}
    for k, v in attrs.items():
        setattr(fra, k, v)
    fra._NET.clear()
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(fra, k, v)
        fra._NET.clear()


def _arg(flag, default):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    import chip_smoke
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import fused_ray_attention as fra
    from iffnerf_tpu_torch.pose.id_module import (IDConfig, image_queries,
                                                  init_id_module,
                                                  ray_mlp_inputs)

    if not torch.cuda.is_available():
        print("k2_time: no CUDA device", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "k2"
    variants = _arg("--variants", "source").split(",")
    rounds = int(_arg("--rounds", "1"))
    libs = _variants(variants)
    dev = torch.device("cuda")
    ro, rd, rr, imgs, mask = chip_smoke.make_scene(dev)
    params = init_id_module(torch.Generator().manual_seed(chip_smoke.SEED),
                            IDConfig(compute_dtype="bfloat16"), device=dev)
    result = {"label": label, "card": chip_smoke.card_line()}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            cfg = IDConfig(compute_dtype=dtype)
            x = ray_mlp_inputs(cfg, ro, rd, rr)
            q, pv, _ = image_queries(params, cfg, imgs[0], mask)
            names = [n for n in variants
                     if n == "source" or dtype in _VARIANTS[n][0]]
            want = fra.fused_ray_scores_plain(params, q, pv, x)
            tol = chip_smoke.score_tol(chip_smoke.K2_RTOL[dtype], pv, x.shape[0])
            for rnd in range(rounds):
                for name in names:
                    _build._LIBS["fused_ray_attention"] = libs[name]
                    attrs = _VARIANTS[name][2] if name != "source" else {}
                    row = result.setdefault(f"k2_{dtype}_{name}", {"ms": [], "graph_ms": []})
                    print(f"k2_time: {dtype} {name} round {rnd}", file=sys.stderr, flush=True)
                    with _wrapper_set(attrs):
                        ms, graph_ms = _times(lambda: fra.fused_ray_scores(params, q, pv, x))
                        row["ms"].append(ms)
                        row["graph_ms"].append(graph_ms)
                        if rnd == 0:
                            got = fra.fused_ray_scores(params, q, pv, x)
                            row.update(chip_smoke.errors(got, want))
                            row["allclose"] = torch.allclose(got, want, **tol)
                            row["bit_equal"] = torch.equal(
                                got, fra.fused_ray_scores(params, q, pv, x))
            del x, want
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
