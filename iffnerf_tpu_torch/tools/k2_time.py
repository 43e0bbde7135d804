"""Times the fused ray-scoring kernel (K2) on one card, and variants of it.

Imports ``iffnerf_tpu_torch`` and ``chip_smoke`` from the working
directory, so that two checkouts (say a parent commit unpacked beside the
change) can be timed in turns on one card. Its inputs are those of
``chip_smoke.py``'s main path: the ID module's weights from seed 0, the
540 000 rays of ``chip_smoke.make_scene`` through ``ray_mlp_inputs`` and
the ViT's queries of its first image. It prints one JSON line: K2 in
float32 and bf16, eager (CUDA events over a batch of calls) and replayed
from a CUDA graph, with the float32 route's errors against its plain
version (``chip_smoke.errors``) and whether two calls are bit-equal.

    cd <checkout> && python3 <path>/k2_time.py <label> [--variants A,B] [--rounds N]

``--variants`` builds text edits of the checkout's
``csrc/fused_ray_attention.cu`` into ``build/kernels/variants/`` and times
their float32 route in turns with the source's, ``--rounds`` times over
(``source`` is the checkout's own build):

- ``one_product``: hi . hi alone in place of the three TF32 products,
  which the checks' largest relative error must refuse;
- ``no_ring``: the producer loads no weights and the consumers never wait
  for a stage (the products read whatever the stages hold): the
  consumers' own time, products, loads, splits, barriers and epilogues;
- ``no_products``: the consumers wait for each stage and free it without
  issuing its products: the weights' stream from L2 through the ring.

Only ``one_product`` gives scores that mean anything beside ``source``.
"""

import ctypes
import json
import statistics
import subprocess
import sys

import torch

CALLS, REPS = 10, 7

_PRODUCTS = "  mma(acc, hi, b_lo, accumulate);\n  mma(acc, lo, b_hi, 1);\n  mma(acc, hi, b_hi, 1);\n"
_EDITS = {
    "one_product": [(_PRODUCTS, "  mma(acc, hi, b_hi, accumulate);\n")],
    "no_ring": [
        ("        hop::mbar_wait(sm.empty + at.s, at.phase ^ 1);\n        if (leader) {",
         "        if (false) {"),
        ("  hop::mbar_wait(sm.full + at.s, at.phase);\n  const unsigned char* slot",
         "  const unsigned char* slot"),
        ("    release(sm, s0);\n    release(sm, s1);\n", "")],
    "no_products": [
        (_PRODUCTS, "  if (b_hi == 0 && b_lo == 0) mma(acc, hi, b_lo, accumulate);\n")],
}


def _variant(name: str) -> ctypes.CDLL:
    """The fused kernel built with the text edits of variant ``name``."""
    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import fused_ray_attention as fra

    if name == "source":
        _build._LIBS.pop("fused_ray_attention", None)
        return _build.load("fused_ray_attention", fra._SIGNATURES)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_ray_attention.cu").read_text()
    for old, new in _EDITS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    cu = out / f"k2_{name}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in fra._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


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
    libs = {name: _variant(name) for name in variants}
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
            names = variants if dtype == "float32" else ["source"]
            if dtype == "float32":
                want = fra.fused_ray_scores_plain(params, q, pv, x)
            for rnd in range(rounds):
                for name in names:
                    _build._LIBS["fused_ray_attention"] = libs.get(name) or _variant(name)
                    row = result.setdefault(f"k2_{dtype}_{name}", {"ms": [], "graph_ms": []})
                    print(f"k2_time: {dtype} {name} round {rnd}", file=sys.stderr, flush=True)
                    ms, graph_ms = _times(lambda: fra.fused_ray_scores(params, q, pv, x))
                    row["ms"].append(ms)
                    row["graph_ms"].append(graph_ms)
                    if dtype == "float32" and rnd == 0:
                        got = fra.fused_ray_scores(params, q, pv, x)
                        row.update(chip_smoke.errors(got, want))
                        tol = chip_smoke.score_tol(chip_smoke.K2_RTOL[dtype], pv, x.shape[0])
                        row["allclose"] = torch.allclose(got, want, **tol)
                        row["bit_equal"] = torch.equal(got, fra.fused_ray_scores(params, q, pv, x))
            del x
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
