"""Where the float32 route of the banked-scoring kernel (K1) spends its time.

Builds variants of ``csrc/banked_attention.cu`` (text edits of the source,
into ``build/kernels/variants/``) and runs each in a process of its own on
one CUDA card at R = 540 000 rays, D = 384, a float32 bank:

- ``source``: the kernel as it is;
- ``trace``: the same with clock counters round each float32 chunk: lane 0
  of the first warp of each consumer warpgroup of the first CTA records
  when it starts to wait for the chunk, when the chunk's values are split
  in registers and its stage freed, when it starts and ends issuing the
  chunk's products, and when the wait that follows (for the chunk before)
  ends;
- ``trace_no_ring``: the same without the bank's ring (the producers load
  only q, the consumers never wait and read whatever the stages hold): the
  compute alone, whose scores mean nothing;
- ``one_product``: one TF32 product a step (hi . hi) in place of three, as
  far from float32 as a plain TF32 product.

Each prints its time a call (CUDA events over 20 calls), each launch's
device time (torch.profiler), its largest relative score error against the
plain version, and for the traced ones the median clocks of each step of a
chunk (tiles 1-4 of each warpgroup). Run from the root of the checkout:

    python -m iffnerf_tpu_torch.tools.k1_trace
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

VARIANTS = ("source", "trace", "trace_no_ring", "one_product")
R, D = 540000, 384

_THREE = """    hop::wgmma_m64n64k8_tf32(acc, hi[kk], b_lo + 2 * kk, kc | kk);
    hop::wgmma_m64n64k8_tf32(acc, lo[kk], b_hi + 2 * kk, 1);
    hop::wgmma_m64n64k8_tf32(acc, hi[kk], b_hi + 2 * kk, 1);"""
_ONE = "    hop::wgmma_m64n64k8_tf32(acc, hi[kk], b_hi + 2 * kk, kc | kk);"
_BRANCH = """    uint32_t ha[4][4], la[4][4], hb[4][4], lb[4][4];
    load_split_f32(sm, j, 0, nk, ha, la);
#pragma unroll 1
    for (int kc = 0; kc < nk; kc += 2) {
      products_f32(sm, nk, kc, ha, la, acc);
      hop::wgmma_wait<1>();  // chunk kc - 1's products, which read set b
      if (kc + 1 < nk) {
        load_split_f32(sm, j, kc + 1, nk, hb, lb);
        products_f32(sm, nk, kc + 1, hb, lb, acc);
        hop::wgmma_wait<1>();  // chunk kc's, which read set a
        if (kc + 2 < nk) load_split_f32(sm, j, kc + 2, nk, ha, la);
      }
    }"""
_TRACED = """    uint32_t ha[4][4], la[4][4], hb[4][4], lb[4][4];
    stamp(j, 0, nk, 0);
    load_split_f32(sm, j, 0, nk, ha, la);
    stamp(j, 0, nk, 1);
#pragma unroll 1
    for (int kc = 0; kc < nk; kc += 2) {
      stamp(j, kc, nk, 2);
      products_f32(sm, nk, kc, ha, la, acc);
      stamp(j, kc, nk, 3);
      hop::wgmma_wait<1>();
      stamp(j, kc, nk, 4);
      if (kc + 1 < nk) {
        stamp(j, kc + 1, nk, 0);
        load_split_f32(sm, j, kc + 1, nk, hb, lb);
        stamp(j, kc + 1, nk, 1);
        stamp(j, kc + 1, nk, 2);
        products_f32(sm, nk, kc + 1, hb, lb, acc);
        stamp(j, kc + 1, nk, 3);
        hop::wgmma_wait<1>();
        stamp(j, kc + 1, nk, 4);
        if (kc + 2 < nk) {
          stamp(j, kc + 2, nk, 0);
          load_split_f32(sm, j, kc + 2, nk, ha, la);
          stamp(j, kc + 2, nk, 1);
        }
      }
    }"""
_STAMP = """__device__ long long g_trace[2][256][5];

// clock of step k of chunk kc of tile j, for lane 0 of each consumer
// warpgroup's first warp in the first CTA
__device__ __forceinline__ void stamp(int j, int kc, int nk, int k) {
  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0) {
    const int idx = (j >> 1) * nk + kc;
    if (idx < 256) g_trace[threadIdx.x >> 7][idx][k] = clock64();
  }
}

"""
_TRACE_FN = """
extern "C" int iff_trace(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, iff::wg::g_trace, sizeof(iff::wg::g_trace)));
}
"""


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


def variant(src: str, name: str) -> str:
    """The text of ``csrc/banked_attention.cu`` for variant ``name``."""
    if name == "source":
        return src
    if name == "one_product":
        return _edit(src, _THREE, _ONE)
    s = _edit(src, _BRANCH, _TRACED)
    s = _edit(s, "// Chunk kc of the j-th tile in float32, once it has landed",
              _STAMP + "// Chunk kc of the j-th tile in float32, once it has landed")
    s += _TRACE_FN
    if name == "trace_no_ring":
        s = _edit(s, "  hop::mbar_wait(sm.full + at.stage, at.parity);\n  const int warp",
                  "  const int warp")
        s = _edit(s, "  __syncwarp();  // every lane's loads have returned\n"
                  "  release(sm, at.stage);", "  __syncwarp();")
        s = _edit(s, "  for (int j = ring;; j += S::kRings) {",
                  "  for (int j = ring; sizeof(T) == 2; j += S::kRings) {")
    return s


def build_all() -> dict:
    """Builds every variant, all nvcc processes at once -> {name: path}."""
    from iffnerf_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "banked_attention.cu").read_text()
    procs = {}
    for name in VARIANTS:
        cu = out / f"k1_{name}.cu"
        cu.write_text(variant(src, name))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"k1_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    paths = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        paths[name] = str(out / f"k1_{name}.so")
    return paths


def run(name: str, path: str) -> None:
    """Times variant ``name`` built at ``path`` and prints its numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iffnerf_tpu_torch.ops import _build
    from iffnerf_tpu_torch.ops import banked_attention as ba

    lib = ctypes.CDLL(path)
    for fn, argtypes in ba._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _build._LIBS["banked_attention"] = lib
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    bank = torch.randn((R, D), generator=g).to(dev)
    q = torch.randn((256, D), generator=g).to(dev)
    valid = torch.zeros(256, dtype=torch.bool, device=dev)
    valid[40:200] = True
    want = ba.banked_scores_plain(bank, q, valid)

    def call():
        return ba.banked_scores_fused(bank, q, valid)

    got = call()
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        call()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kernels = {e.key.split("(")[0][:40]: e.self_device_time_total / 5e3
               for e in prof.key_averages() if e.self_device_time_total > 0}
    print(f"{name}: ms {start.elapsed_time(end) / 20:.4f} max_rel_err {rel:.3g} "
          f"device ms {kernels}", flush=True)
    if name.startswith("trace"):
        buf = np.zeros((2, 256, 5), dtype=np.int64)
        lib.iff_trace.argtypes = [ctypes.c_void_p]
        lib.iff_trace.restype = ctypes.c_int
        call()
        torch.cuda.synchronize()
        _build.check(lib.iff_trace(buf.ctypes.data), "trace copy")
        for w in range(2):
            b = buf[w, 12:61]
            print(f"  warpgroup {w}, median clocks a chunk: wait for it, load "
                  f"and split {np.median(b[:-1, 1] - b[:-1, 0]):.0f}, issue its "
                  f"products {np.median(b[:-1, 3] - b[:-1, 2]):.0f}, then wait "
                  f"for the chunk before {np.median(b[:-1, 4] - b[:-1, 3]):.0f}; "
                  f"products to products {np.median(np.diff(b[:, 2])):.0f}",
                  flush=True)


def main() -> int:
    if len(sys.argv) == 3:
        run(sys.argv[1], sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k1_trace: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    paths = build_all()
    for name in VARIANTS + ("source",):
        subprocess.run([sys.executable, "-m", "iffnerf_tpu_torch.tools.k1_trace",
                        name, paths[name]], check=True, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
