// Banked softmax-column-sum scoring for sm_90a.
//
// Replaces the two Pallas TPU kernels of iffnerf_tpu/ops/banked_attention.py
// (_stats_kernel, _score_kernel, called from banked_scores_fused). For a ray
// bank K [R, D] and queries q [P, D] (P = 256 patches):
//   l[r, p]   = (K[r] . q[p]) * scale                (scale = 1/sqrt(D), f32)
//   scores[r] = sum_p exp(l[r, p] - m[p]) * w[p],    w[p] = valid[p] / d[p]
// with m, d the max and denominator of each column over all rays. The
// [R, P] logits never reach device memory: pass 1 computes the statistics,
// pass 2 recomputes the logits tile and reduces it to scores.
//
// Three launches on the caller's stream:
//   1. the stats kernel: each block walks ray tiles and writes a partial
//      (m_b, d_b) per patch (the TPU grid's running pair cannot cross blocks)
//   2. lse_merge_kernel (softmax_stats.cuh): m, d, w
//   3. the score kernel: scores[r]
//
// Bound on an H100 SXM: each pass reads the bank once (R*D*2 bytes in bf16,
// 415 MB at R = 540000) and does 2*R*D*P flops (106 GFLOP); with bf16 on
// the tensor cores the pair is memory-bound at about 0.12 ms a pass.
//
// bf16 bank (the inference path): mma.sync m16n8k16 bf16 tensor-core tiles
// with float32 accumulators. q (256 x D) stays in shared memory for the
// whole block, one persistent block a SM walks 128-ray tiles, and the bank
// streams through a two-stage cp.async ring in 32-deep slices. Each warp
// owns 64 rays x 64 patches (128 accumulators a thread). The exps of the
// online softmax (one per logit) cost about a fifth of the products; the
// bank is read twice. wgmma/TMA tiles are later work.
//
// float32 bank (training's precision): float32 FMAs in a 64-ray x 256-patch
// register tile (8 x 8 per thread), q^T [D, 256] streaming through shared
// memory in 16-deep slices from L2; bound by the 67 TFLOP/s FMA rate
// (1.6 ms).
#include <cstdint>

#include "mma_bf16.cuh"
#include "softmax_stats.cuh"

namespace iff {

// ---------------------------------------------------------------------------
// float32 bank: FMA tiles
// ---------------------------------------------------------------------------

constexpr int kBK = 16;  // depth of one shared-memory slice

// acc[i][j] = K[ray0 + wp*8 + i] . qt[:, ln + 32*j]; rays past R read as 0.
__device__ __forceinline__ void logits_tile(const float* __restrict__ bank,
                                            const float* __restrict__ qt, int R, int D, int ray0,
                                            float* As, float* Bs,
                                            float (&acc)[kRaysPerWarp][kColsPerLane]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;

  const int lr = tid >> 2;        // ray of the tile this thread loads
  const int lk = (tid & 3) * 4;   // first of its 4 depth elements
  const int gr = ray0 + lr;
  const float* brow = bank + static_cast<int64_t>(gr) * D;

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[(lk + e) * kTileRays + lr] = gr < R ? brow[k0 + lk + e] : 0.f;
#pragma unroll
    for (int e = 0; e < kBK * kPatches / kThreads; ++e) {
      const int idx = tid + e * kThreads;  // = kk * 256 + p
      Bs[idx] = qt[static_cast<int64_t>(k0) * kPatches + idx];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * kTileRays + warp * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * kTileRays + warp * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) b[j] = Bs[kk * kPatches + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    banked_stats_f32(const float* __restrict__ bank, const float* __restrict__ qt, int R, int D,
                     float scale, float* part_m, float* part_d) {
  __shared__ __align__(16) float As[kBK * kTileRays];
  __shared__ __align__(16) float Bs[kBK * kPatches];
  __shared__ float red[2 * 8 * kPatches];
  const int warp = threadIdx.x >> 5;
  float m_run[kColsPerLane], d_run[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    m_run[j] = kNegInf;
    d_run[j] = 0.f;
  }
  const int ntiles = (R + kTileRays - 1) / kTileRays;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kTileRays;
    float acc[kRaysPerWarp][kColsPerLane];
    logits_tile(bank, qt, R, D, ray0, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] *= scale;
    const int nvalid = min(max(R - (ray0 + warp * kRaysPerWarp), 0), kRaysPerWarp);
    online_update(acc, nvalid, m_run, d_run);
  }
  write_block_stats(m_run, d_run, red, part_m, part_d);
}

__global__ void __launch_bounds__(kThreads)
    banked_score_f32(const float* __restrict__ bank, const float* __restrict__ qt, int R, int D,
                     float scale, const float* __restrict__ m, const float* __restrict__ w,
                     float* scores) {
  __shared__ __align__(16) float As[kBK * kTileRays];
  __shared__ __align__(16) float Bs[kBK * kPatches];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mc[kColsPerLane], wc[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    mc[j] = m[lane + 32 * j];
    wc[j] = w[lane + 32 * j];
  }
  const int ntiles = (R + kTileRays - 1) / kTileRays;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kTileRays;
    float acc[kRaysPerWarp][kColsPerLane];
    logits_tile(bank, qt, R, D, ray0, As, Bs, acc);
    float s[kRaysPerWarp];
#pragma unroll
    for (int i = 0; i < kRaysPerWarp; ++i) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) v += expf(acc[i][j] * scale - mc[j]) * wc[j];
      s[i] = v;
    }
    // sum over the warp's 32 lanes: every lane ends with the 8 ray totals
#pragma unroll
    for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    float mine = s[0];
#pragma unroll
    for (int i = 1; i < kRaysPerWarp; ++i)
      if (lane == i) mine = s[i];
    const int r = ray0 + warp * kRaysPerWarp + lane;
    if (lane < kRaysPerWarp && r < R) scores[r] = mine;
  }
}

// ---------------------------------------------------------------------------
// bf16 bank: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;         // rays per tile
constexpr int kBK = 32;          // depth of one bank slice
constexpr int kLdA = kBK + 8;    // bank slice row stride: conflict-free fragment loads
constexpr int kMT = 4, kNT = 8;  // m16 and n8 tiles of a warp: 64 rays x 64 patches

// dynamic shared memory: q [256][D + 8], two bank slices, the reductions
inline size_t smem_bytes(int D) {
  return sizeof(bf16) * (static_cast<size_t>(kPatches) * (D + 8) + 2 * kBM * kLdA) +
         sizeof(float) * kRedFloats;
}

// 16 bytes global -> shared; zero-filled when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

struct Smem {
  bf16* q;      // [256][D + 8]
  bf16* a;      // [2][kBM][kLdA]
  float* red;   // kRedFloats
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int D) {
  Smem s;
  s.q = reinterpret_cast<bf16*>(raw);
  s.a = s.q + kPatches * (D + 8);
  s.red = reinterpret_cast<float*>(s.a + 2 * kBM * kLdA);
  return s;
}

// q [256][D] -> shared [256][D + 8], 16 bytes a thread at a time
__device__ __forceinline__ void load_q(const bf16* __restrict__ q, int D, bf16* qs) {
  const int chunks = D / 8;
  for (int c = threadIdx.x; c < kPatches * chunks; c += kThreads) {
    const int p = c / chunks, k = (c % chunks) * 8;
    *reinterpret_cast<uint4*>(qs + p * (D + 8) + k) =
        *reinterpret_cast<const uint4*>(q + static_cast<int64_t>(p) * D + k);
  }
}

// bank rows ray0 .. ray0+127, depth k0 .. k0+31 -> one slice (rays past R: 0)
__device__ __forceinline__ void load_slice(const bf16* __restrict__ bank, int R, int D,
                                           int ray0, int k0, bf16* slice) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 128 rows x 4 chunks
    const int r = c >> 2, k = (c & 3) * 8;
    const bool ok = ray0 + r < R;
    const bf16* src = bank + static_cast<int64_t>(ok ? ray0 + r : 0) * D + k0 + k;
    cp_async16(slice + r * kLdA + k, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc = bank[ray0 : ray0+128] . q^T for this warp's 64 x 64 block:
// acc[mt][nt][i] is ray  wm*64 + mt*16 + g + 8*(i >> 1),
//                 patch  wn*64 + nt*8 + 2*tq + (i & 1)
// with g = lane / 4, tq = lane % 4, wm = warp / 4, wn = warp % 4.
__device__ __forceinline__ void logits_tile(const bf16* __restrict__ bank, int R, int D,
                                            int ray0, const Smem& sm,
                                            float (&acc)[kMT][kNT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int nk = D / kBK;
  load_slice(bank, R, D, ray0, 0, sm.a);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_slice(bank, R, D, ray0, (kc + 1) * kBK, sm.a + ((kc + 1) & 1) * kBM * kLdA);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* a_s = sm.a + (kc & 1) * kBM * kLdA + wm * 64 * kLdA;
    const bf16* q_s = sm.q + (wn * 64 + g) * (D + 8) + kc * kBK + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) load_a(a_s + mt * 16 * kLdA + ks, kLdA, a[mt]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const bf16* p = q_s + nt * 8 * (D + 8) + ks;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // the next load reuses this slice
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    banked_stats_bf16(const bf16* __restrict__ bank, const bf16* __restrict__ q, int R, int D,
                      float scale, float* part_m, float* part_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, wm = warp >> 2;
  load_q(q, D, sm.q);
  float m_run[kStatCols], d_run[kStatCols];
#pragma unroll
  for (int j = 0; j < kStatCols; ++j) {
    m_run[j] = kNegInf;
    d_run[j] = 0.f;
  }
  const int ntiles = (R + kBM - 1) / kBM;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kBM;
    float acc[kMT][kNT][4];
    logits_tile(bank, R, D, ray0, sm, acc);
    bool ok[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) ok[mt][h] = ray0 + wm * 64 + mt * 16 + g + 8 * h < R;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] *= scale;
    update_stats<kMT>(acc, ok, m_run, d_run);
  }
  fold_block_stats(m_run, d_run, sm.red, part_m, part_d);
}

__global__ void __launch_bounds__(kThreads, 1)
    banked_score_bf16(const bf16* __restrict__ bank, const bf16* __restrict__ q, int R, int D,
                      float scale, const float* __restrict__ m, const float* __restrict__ w,
                      float* scores) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;
  load_q(q, D, sm.q);
  float mc[kStatCols], wc[kStatCols];
#pragma unroll
  for (int j = 0; j < kStatCols; ++j) {
    const int col = wn * 64 + (j >> 1) * 8 + 2 * tq + (j & 1);
    mc[j] = m[col];
    wc[j] = w[col];
  }
  const int ntiles = (R + kBM - 1) / kBM;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kBM;
    float acc[kMT][kNT][4];
    logits_tile(bank, R, D, ray0, sm, acc);
    // the tile's rays over this warp's 64 patches, then over the 4 warps
    // that share the rays: red[wn][row]
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            s += expf(acc[mt][nt][2 * h + c] * scale - mc[2 * nt + c]) * wc[2 * nt + c];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (tq == 0) sm.red[wn * kBM + wm * 64 + mt * 16 + 8 * h + g] = s;
      }
    __syncthreads();
    if (threadIdx.x < kBM && ray0 + threadIdx.x < R) {
      const int i = threadIdx.x;
      scores[ray0 + i] = sm.red[i] + sm.red[kBM + i] + sm.red[2 * kBM + i] + sm.red[3 * kBM + i];
    }
    // the next tile writes `red` only after logits_tile's barriers
  }
}

}  // namespace tc

cudaError_t run_f32(const float* bank, const float* qt, const unsigned char* valid, int R, int D,
                    float scale, float* part_m, float* part_d, int nblocks, float* m, float* d,
                    float* w, float* scores, cudaStream_t stream) {
  banked_stats_f32<<<nblocks, kThreads, 0, stream>>>(bank, qt, R, D, scale, part_m, part_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_lse_merge(part_m, part_d, nblocks, kPatches, valid, m, d, w, stream);
  if (err != cudaSuccess) return err;
  banked_score_f32<<<nblocks, kThreads, 0, stream>>>(bank, qt, R, D, scale, m, w, scores);
  return cudaGetLastError();
}

cudaError_t run_bf16(const tc::bf16* bank, const tc::bf16* q, const unsigned char* valid, int R,
                     int D, float scale, float* part_m, float* part_d, int nblocks, float* m,
                     float* d, float* w, float* scores, cudaStream_t stream) {
  const int smem = static_cast<int>(tc::smem_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(tc::banked_stats_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tc::banked_score_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  tc::banked_stats_bf16<<<nblocks, kThreads, smem, stream>>>(bank, q, R, D, scale, part_m,
                                                             part_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_lse_merge(part_m, part_d, nblocks, kPatches, valid, m, d, w, stream);
  if (err != cudaSuccess) return err;
  tc::banked_score_bf16<<<nblocks, kThreads, smem, stream>>>(bank, q, R, D, scale, m, w,
                                                             scores);
  return cudaGetLastError();
}

}  // namespace iff

// bank [R, D] of one dtype (0: float32, 1: bfloat16) and the queries in
// it: q [256, D] for bfloat16, its transpose [D, 256] for float32; both
// 16-byte aligned; valid [256] uint8; part_m/part_d [nblocks, 256], m/d/w
// [256] and scores [R] float32. D must be a multiple of 16 (float32) or of
// 32 and at most 384 (bfloat16). nblocks: at most one per 64-ray (float32)
// or 128-ray (bfloat16) tile. Returns a cudaError_t.
extern "C" int iff_banked_scores(const void* bank, const void* q, const void* valid, int R,
                                 int D, int P, int is_bf16, float scale, void* part_m,
                                 void* part_d, int nblocks, void* m, void* d, void* w,
                                 void* scores, void* stream) {
  const bool d_ok = is_bf16 ? D % iff::tc::kBK == 0 && D <= 384 : D % iff::kBK == 0;
  if (P != iff::kPatches || !d_ok || R <= 0 || nblocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* pm = static_cast<float*>(part_m);
  auto* pd = static_cast<float*>(part_d);
  auto* v = static_cast<const unsigned char*>(valid);
  auto* mo = static_cast<float*>(m);
  auto* dout = static_cast<float*>(d);
  auto* wo = static_cast<float*>(w);
  auto* so = static_cast<float*>(scores);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? iff::run_bf16(static_cast<const iff::tc::bf16*>(bank),
                              static_cast<const iff::tc::bf16*>(q), v, R, D, scale, pm, pd,
                              nblocks, mo, dout, wo, so, s)
              : iff::run_f32(static_cast<const float*>(bank), static_cast<const float*>(q), v,
                             R, D, scale, pm, pd, nblocks, mo, dout, wo, so, s);
  return static_cast<int>(err);
}
