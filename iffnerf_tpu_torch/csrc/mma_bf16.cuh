// bf16 tensor-core helpers of the fused ray-scoring kernel
// (fused_ray_attention.cu): the mma.sync m16n8k16 product, fragment loads,
// and the softmax statistics of a tile held in mma accumulators.
//
// Accumulator layout of one m16 x n8 tile (PTX ISA, "mma.m16n8k16"): lane
// (g = lane / 4, tq = lane % 4) holds c[i] at row g + 8*(i >> 1), column
// 2*tq + (i & 1). The kernel runs 8 warps as 2 (rays) x 4 (patches), each
// warp holding 64 patch columns, so a thread owns the 16 columns
//   col(j) = wn*64 + (j >> 1)*8 + 2*tq + (j & 1),  j < 16.
#pragma once

#include <cstdint>

#include "softmax_stats.cuh"

namespace iff {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kStatCols = 16;                  // patch columns a thread owns
constexpr int kRedFloats = 2 * 2 * kPatches;   // fold_block_stats' shared floats

// two consecutive bf16 (4-byte aligned) as one fragment register
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 products, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows row0 .. row0+15, depth k0 .. k0+15 of a bf16 matrix in
// shared memory with row stride ld (elements); lane offsets included.
__device__ __forceinline__ void load_a(const bf16* base, int ld, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const bf16* p = base + (lane >> 2) * ld + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Folds one tile's scaled logits acc[mt][nt][i] into the thread's running
// (m, d) of its 16 columns; ok[mt][h] says whether row g + 8h of m-tile mt
// is a ray (the last tile is ragged).
template <int MT>
__device__ __forceinline__ void update_stats(const float (&acc)[MT][8][4],
                                             const bool (&ok)[MT][2],
                                             float (&m_run)[kStatCols],
                                             float (&d_run)[kStatCols]) {
#pragma unroll
  for (int j = 0; j < kStatCols; ++j) {
    const int nt = j >> 1, c = j & 1;
    float tmax = kNegInf;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[mt][h]) tmax = fmaxf(tmax, acc[mt][nt][2 * h + c]);
    const float m_new = fmaxf(m_run[j], tmax);
    float s = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[mt][h]) s += expf(acc[mt][nt][2 * h + c] - m_new);
    d_run[j] = d_run[j] * expf(m_run[j] - m_new) + s;
    m_run[j] = m_new;
  }
}

// Folds the running pairs of the 8 row groups of each warp (lanes of one
// tq) and of the 2 warps that share a column block into the block's
// partial (m_b, d_b) [256]. `red` is kRedFloats of shared memory that no
// thread still reads.
__device__ __forceinline__ void fold_block_stats(float (&m_run)[kStatCols],
                                                 float (&d_run)[kStatCols], float* red,
                                                 float* part_m, float* part_d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int j = 0; j < kStatCols; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[j], off);
      const float dd = __shfl_xor_sync(0xffffffffu, d_run[j], off);
      const float mn = fmaxf(m_run[j], mo);
      d_run[j] = d_run[j] * expf(m_run[j] - mn) + dd * expf(mo - mn);
      m_run[j] = mn;
    }
  float* red_m = red;
  float* red_d = red + 2 * kPatches;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kStatCols; ++j) {
      const int col = wn * 64 + (j >> 1) * 8 + 2 * tq + (j & 1);
      red_m[wm * kPatches + col] = m_run[j];
      red_d[wm * kPatches + col] = d_run[j];
    }
  }
  __syncthreads();
  const int p = threadIdx.x;  // one patch per thread
  const float m0 = red_m[p], m1 = red_m[kPatches + p];
  const float m = fmaxf(m0, m1);
  part_m[blockIdx.x * kPatches + p] = m;
  part_d[blockIdx.x * kPatches + p] = red_d[p] * expf(m0 - m) + red_d[kPatches + p] * expf(m1 - m);
}

}  // namespace tc
}  // namespace iff
