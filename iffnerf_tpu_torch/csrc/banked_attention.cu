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
//   1. the stats kernel: partial (m_b, d_b) per patch for each block or
//      cluster (the TPU grid's running pair cannot cross them)
//   2. lse_merge_kernel (softmax_stats.cuh): m, d, w
//   3. the score kernel: scores[r]
//
// Bound on an H100 SXM: the bank is read twice, and must be. A ray's score
// weighs patch p by 1/d_p, known only once every ray has been seen, and
// keeping the logits instead (276 MB even in bf16, written and read back)
// moves more bytes than a second read. At R = 540000 in bf16 the two reads
// are 2 x 415 MB, 0.248 ms at 3.35 TB/s, and the products 2 x 106 GFLOP,
// 0.215 ms at 989 TFLOP/s: bytes bound the pair at 0.248 ms (one read
// alone 0.124 ms).
//
// bf16 bank (the inference path): each pass is a persistent,
// warp-specialised kernel over 2-CTA clusters, one CTA an SM. The patch
// axis is split over the pair: each CTA keeps its 128 patches of q in
// shared memory (96 KB at D = 384), and the rest holds a ring of 16 bank
// chunks of 64 rays x 64 deep (8 KB each, 128-byte swizzle), guarded by
// full and empty mbarriers. One producer thread loads chunks by TMA; each
// CTA loads half of a chunk's rays and multicasts it to both, so device
// memory serves the bank once per pass and 128 KB of it is in flight a
// pair. Two consumer warpgroups take the cluster's 64-ray tiles in turn,
// each tile a chain of wgmma m64n128k16 (bank chunk K-major as A, q K-major
// as B) with float32 accumulators, and free each chunk to both producers
// once read. The epilogue works on the accumulators in registers, with
// log2(e) folded into the scale and exp2. Stats: rays past R are kept out
// of the max and the sum, and each CTA owns its patches' (m, d), so the
// pass needs no exchange. Score: each CTA adds its half of a ray's sum to
// the score that the stats pass zeroed; two addends on zero give the same
// bits in either order, so the scores are deterministic. Depth must be a
// multiple of 64 up to 384.
//
// float32 bank (training's precision): float32 FMAs in a 64-ray x 256-patch
// register tile (8 x 8 per thread), q^T [D, 256] streaming through shared
// memory in 16-deep slices from L2; bound by the 67 TFLOP/s FMA rate
// (1.6 ms).
#include <cstdint>

#include "softmax_stats.cuh"
#include "tma_wgmma.cuh"

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
// bf16 bank: a TMA ring, wgmma, pairs of CTAs
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRays = 64;                      // rays a tile: one wgmma M
constexpr int kChunk = 64;                     // depth a TMA box: the 128-byte swizzle width
constexpr int kHalf = kPatches / 2;            // patches a CTA of the pair holds: wgmma N
constexpr int kMaxChunks = 384 / kChunk;       // depth up to 384
constexpr int kStages = 16;                    // bank chunks in the ring
constexpr int kStageElems = kRays * kChunk;    // 8 KB
constexpr int kQChunkElems = kHalf * kChunk;   // 16 KB
constexpr int kConsumerWarps = 8;              // two warpgroups
constexpr int kThreadsWs = 32 * (kConsumerWarps + 4);  // and the producer warpgroup
constexpr uint32_t kReleases = 2 * 4;          // a chunk is freed by 4 warps in each CTA
// registers a thread, moved from the producer warpgroup to the two
// consumer ones: 128 x (168 - 40) = 256 x (232 - 168)
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// q's chunks, the ring and the barriers, after up to 1 KB of alignment
inline size_t smem_bytes(int nk) {
  return 1024 + sizeof(bf16) * (static_cast<size_t>(nk) * kQChunkElems + kStages * kStageElems) +
         sizeof(uint64_t) * (2 * kStages + 1);
}

struct Smem {
  bf16* q;          // nk chunks [128 patches][64 depth], swizzled
  bf16* ring;       // kStages chunks [64 rays][64 depth], swizzled
  uint64_t* full;   // kStages: the chunk has landed in this CTA
  uint64_t* empty;  // kStages: both CTAs' consumers are done with it
  uint64_t* qbar;   // q has landed
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int nk) {
  const uint32_t pad = (1024 - (hop::smem_u32(raw) & 1023)) & 1023;  // swizzle atoms
  Smem s;
  s.q = reinterpret_cast<bf16*>(raw + pad);
  s.ring = s.q + nk * kQChunkElems;
  s.full = reinterpret_cast<uint64_t*>(s.ring + kStages * kStageElems);
  s.empty = s.full + kStages;
  s.qbar = s.empty + kStages;
  return s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bar.sync over the two consumer warpgroups (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// The producer warp, all of it in step (a lone thread would leave the
// warp diverged around blocking waits): this CTA's half of q once, then
// every tile's nk chunks through the ring, lane 0 issuing. Each CTA loads
// half of a chunk's rays and multicasts it to both, so device memory serves
// each chunk once; rays past R read as 0.
__device__ void produce(const CUtensorMap* bank_map, const CUtensorMap* q_map, const Smem& sm,
                        int nk, int ntiles, int cluster, int nclusters, uint32_t rank) {
  const bool leader = (threadIdx.x & 31) == 0;
  if (leader) {
    hop::prefetch_map(bank_map);
    hop::mbar_arrive_expect_tx(sm.qbar, nk * kQChunkElems * sizeof(bf16));
    for (int kc = 0; kc < nk; ++kc)
      hop::tma_load_2d(sm.q + kc * kQChunkElems, q_map, sm.qbar, kc * kChunk, rank * kHalf);
  }
  __syncwarp();
  int g = 0;  // chunks so far
  for (int t = cluster; t < ntiles; t += nclusters) {  // tiles dealt round-robin
    const int ray0 = t * kRays + rank * (kRays / 2);
    for (int kc = 0; kc < nk; ++kc, ++g) {
      const int s = g % kStages;
      hop::mbar_wait(sm.empty + s, ((g / kStages) & 1) ^ 1);
      if (leader) {
        hop::mbar_arrive_expect_tx(sm.full + s, kStageElems * sizeof(bf16));
        hop::tma_load_2d_multicast(sm.ring + s * kStageElems + rank * (kRays / 2) * kChunk,
                                   bank_map, sm.full + s, kc * kChunk, ray0, 0x3);
      }
      __syncwarp();
    }
  }
}

// frees chunk s in both CTAs: this warp's products have read it
__device__ __forceinline__ void release(const Smem& sm, int s) {
  if ((threadIdx.x & 31) == 0) {
    hop::mbar_arrive_cluster(sm.empty + s, 0);
    hop::mbar_arrive_cluster(sm.empty + s, 1);
  }
}

// acc = the unscaled logits of this cluster's j-th tile: the warpgroup's 64
// rays x this CTA's 128 patches. Each chunk is freed as soon as the
// products of the next one are issued and its own have completed.
__device__ __forceinline__ void tile_logits(const Smem& sm, int nk, int j, float (&acc)[64]) {
  hop::fence_regs(acc);
  int prev = 0;
  for (int kc = 0; kc < nk; ++kc) {
    const int g = j * nk + kc, s = g % kStages;
    hop::mbar_wait(sm.full + s, (g / kStages) & 1);
    const uint64_t a = hop::desc_sw128(sm.ring + s * kStageElems);
    const uint64_t b = hop::desc_sw128(sm.q + kc * kQChunkElems);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      hop::wgmma_m64n128k16(acc, a + 2 * kk, b + 2 * kk, kc | kk);
    hop::wgmma_commit();
    if (kc > 0) {
      hop::wgmma_wait<1>();
      release(sm, prev);
    }
    prev = s;
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  release(sm, prev);
}

// Folds each thread's running (m, d) (base 2) of its 32 columns over the 8
// row groups of its warp, then over the 8 consumer warps, into this CTA's
// half of the cluster's partial row (natural log units, as lse_merge reads).
__device__ __forceinline__ void fold_stats(const Smem& sm, float (&mr)[32], float (&dr)[32],
                                           int cluster, uint32_t rank, float* part_m,
                                           float* part_d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int k = 0; k < 32; ++k)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mr[k], off);
      const float dd = __shfl_xor_sync(0xffffffffu, dr[k], off);
      const float mn = fmaxf(mr[k], mo);
      dr[k] = dr[k] * ex2(mr[k] - mn) + dd * ex2(mo - mn);
      mr[k] = mn;
    }
  consumers_sync();  // both warpgroups are done with the ring: it holds the fold
  float* red_m = reinterpret_cast<float*>(sm.ring);
  float* red_d = red_m + kConsumerWarps * kHalf;
  if (lane < 4) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int col = 8 * (k >> 1) + 2 * tq + (k & 1);
      red_m[warp * kHalf + col] = mr[k];
      red_d[warp * kHalf + col] = dr[k];
    }
  }
  consumers_sync();
  if (threadIdx.x < kHalf) {
    const int p = threadIdx.x;
    float m = kNegInf;
    for (int i = 0; i < kConsumerWarps; ++i) m = fmaxf(m, red_m[i * kHalf + p]);
    float d = 0.f;
    for (int i = 0; i < kConsumerWarps; ++i)
      d += red_d[i * kHalf + p] * ex2(red_m[i * kHalf + p] - m);
    part_m[cluster * kPatches + rank * kHalf + p] = m * kLn2;
    part_d[cluster * kPatches + rank * kHalf + p] = d;
  }
}

// Two consumer warpgroups take the cluster's tiles in turn (one's epilogue
// overlaps the other's products). Thread value k < 32 of a row is patch
// rank*128 + 8 (k >> 1) + 2 (lane % 4) + (k & 1); its rows are
// 16 (warp % 4) + lane / 4 and 8 more.
//   stats (kScore false): running (m, d) in base 2 of its columns over its
//     rays, then fold_stats; CTA 0 of the pair zeroes the tile's scores.
//   score (kScore true): each row's sum over its 128 patches of
//     exp2(l log2e - m log2e) w, added to the zeroed score: the two CTAs'
//     halves land on 0 in either order with the same sum, bit for bit.
template <bool kScore>
__device__ void consume(const Smem& sm, int R, int nk, float scale2, int ntiles, int cluster,
                        int nclusters, uint32_t rank, const float* __restrict__ m,
                        const float* __restrict__ w, float* part_m, float* part_d,
                        float* scores) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  float ra[32], rb[32];  // stats: running max and sum; score: max (both base 2) and weight
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if constexpr (kScore) {
      const int col = rank * kHalf + 8 * (k >> 1) + 2 * tq + (k & 1);
      ra[k] = m[col] * kLog2e;
      rb[k] = w[col];
    } else {
      ra[k] = kNegInf;
      rb[k] = 0.f;
    }
  }
  hop::mbar_wait(sm.qbar, 0);
  float acc[64] = {};
  for (int j = warp >> 2;; j += 2) {
    const int t = cluster + j * nclusters;
    if (t >= ntiles) break;
    tile_logits(sm, nk, j, acc);
    const int r0 = t * kRays + 16 * (warp & 3) + (lane >> 2);
    const int r1 = r0 + 8;
    if constexpr (kScore) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        s0 = fmaf(ex2(fmaf(acc[i], scale2, -ra[k])), rb[k], s0);
        s1 = fmaf(ex2(fmaf(acc[i + 2], scale2, -ra[k])), rb[k], s1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (tq == 0) {
        if (r0 < R) atomicAdd(scores + r0, s0);
        if (r1 < R) atomicAdd(scores + r1, s1);
      }
    } else {
      // rays past R (the last tile's zero rows) stay out of the statistics
      const bool ok0 = r0 < R, ok1 = r1 < R;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        const float t0 = ok0 ? acc[i] * scale2 : kNegInf;
        const float t1 = ok1 ? acc[i + 2] * scale2 : kNegInf;
        const float mn = fmaxf(ra[k], fmaxf(t0, t1));
        const float e = (ok0 ? ex2(t0 - mn) : 0.f) + (ok1 ? ex2(t1 - mn) : 0.f);
        rb[k] = fmaf(rb[k], ex2(ra[k] - mn), e);
        ra[k] = mn;
      }
      if (rank == 0 && tq == 0) {
        if (ok0) scores[r0] = 0.f;
        if (ok1) scores[r1] = 0.f;
      }
    }
  }
  if constexpr (!kScore) fold_stats(sm, ra, rb, cluster, rank, part_m, part_d);
}

// One pass over the bank: 2-CTA clusters, one CTA an SM, persistent over
// the cluster's tiles; warps 0-7 consume, warp 8 produces.
template <bool kScore>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreadsWs, 1)
    banked_bf16(const __grid_constant__ CUtensorMap bank_map,
                const __grid_constant__ CUtensorMap q_map, int R, int nk, float scale2,
                const float* __restrict__ m, const float* __restrict__ w,
                float* part_m, float* part_d, float* scores) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, nk);
  const uint32_t rank = hop::cluster_rank();
  const int cluster = hop::cluster_id(), nclusters = hop::cluster_count();
  const int ntiles = (R + kRays - 1) / kRays;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(sm.full + s, 1);
      hop::mbar_init(sm.empty + s, kReleases);
    }
    hop::mbar_init(sm.qbar, 1);
    hop::fence_mbar_init();
  }
  hop::cluster_sync();  // both CTAs' barriers exist before anyone arrives on them
  // each role runs to its own end (setmaxnreg needs branches that never
  // rejoin), where no CTA leaves while its partner may still arrive on its
  // barriers
  if (threadIdx.x >= 32 * kConsumerWarps) {  // warp 8 loads; warps 9-11 only lend registers
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32 * (kConsumerWarps + 1))
      produce(&bank_map, &q_map, sm, nk, ntiles, cluster, nclusters, rank);
    hop::cluster_sync();
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    consume<kScore>(sm, R, nk, scale2, ntiles, cluster, nclusters, rank, m, w, part_m, part_d,
                    scores);
    hop::cluster_sync();
  }
}

// Sets the kernels' shared-memory limit and counts the clusters that fit
// on the card at once, on the first call -> that count (0: an error).
inline int resident_clusters() {
  static const int n = [] {
    const int smem = static_cast<int>(smem_bytes(kMaxChunks));
    if (cudaFuncSetAttribute(banked_bf16<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaFuncSetAttribute(banked_bf16<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kThreadsWs);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    return cudaOccupancyMaxActiveClusters(
               &clusters, reinterpret_cast<const void*>(banked_bf16<false>), &cfg) == cudaSuccess
               ? clusters
               : 0;
  }();
  return n;
}

}  // namespace wg

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

cudaError_t run_bf16(const wg::bf16* bank, const wg::bf16* q, const unsigned char* valid, int R,
                     int D, float scale, float* part_m, float* part_d, int nclusters, float* m,
                     float* d, float* w, float* scores, cudaStream_t stream) {
  const int resident = wg::resident_clusters();
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  nclusters = nclusters < resident ? nclusters : resident;
  CUtensorMap bank_map, q_map;  // built for each call: the bank's address and R change
  if (!hop::bf16_rows_map(&bank_map, bank, R, D, wg::kRays / 2) ||
      !hop::bf16_rows_map(&q_map, q, kPatches, D, wg::kHalf))
    return cudaErrorInvalidValue;
  const int nk = D / wg::kChunk;
  const size_t smem = wg::smem_bytes(nk);
  const float scale2 = scale * wg::kLog2e;
  wg::banked_bf16<false><<<2 * nclusters, wg::kThreadsWs, smem, stream>>>(
      bank_map, q_map, R, nk, scale2, nullptr, nullptr, part_m, part_d, scores);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_lse_merge(part_m, part_d, nclusters, kPatches, valid, m, d, w, stream);
  if (err != cudaSuccess) return err;
  wg::banked_bf16<true><<<2 * nclusters, wg::kThreadsWs, smem, stream>>>(
      bank_map, q_map, R, nk, scale2, m, w, nullptr, nullptr, scores);
  return cudaGetLastError();
}

}  // namespace iff

// 2-CTA clusters of the bfloat16 kernels that fit on the current card at
// once (the most that run), or a negative cudaError_t.
extern "C" int iff_banked_bf16_clusters() {
  const int n = iff::wg::resident_clusters();
  return n > 0 ? n : -static_cast<int>(cudaErrorInvalidConfiguration);
}

// bank [R, D] of one dtype (0: float32, 1: bfloat16) and the queries in
// it: q [256, D] for bfloat16, its transpose [D, 256] for float32; both
// 16-byte aligned; valid [256] bytes of 0 or 1; part_m/part_d [nblocks, 256], m/d/w
// [256] and scores [R] float32. D must be a multiple of 16 (float32) or of
// 64 and at most 384 (bfloat16). nblocks: at most one block per 64-ray
// tile (float32), or one 2-CTA cluster per 64-ray tile (bfloat16; fewer
// if fewer fit on the card at once, and the first ones of part_m/part_d
// are used). Returns a cudaError_t.
extern "C" int iff_banked_scores(const void* bank, const void* q, const void* valid, int R,
                                 int D, int P, int is_bf16, float scale, void* part_m,
                                 void* part_d, int nblocks, void* m, void* d, void* w,
                                 void* scores, void* stream) {
  const bool d_ok = is_bf16 ? D % iff::wg::kChunk == 0 && D <= iff::wg::kMaxChunks * iff::wg::kChunk
                            : D % iff::kBK == 0;
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
      is_bf16 ? iff::run_bf16(static_cast<const iff::wg::bf16*>(bank),
                              static_cast<const iff::wg::bf16*>(q), v, R, D, scale, pm, pd,
                              nblocks, mo, dout, wo, so, s)
              : iff::run_f32(static_cast<const float*>(bank), static_cast<const float*>(q), v,
                             R, D, scale, pm, pd, nblocks, mo, dout, wo, so, s);
  return static_cast<int>(err);
}
