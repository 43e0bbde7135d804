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
// Launches on the caller's stream:
//   1. the stats pass: partial (m_c, d_c) per patch for each cluster (the
//      TPU grid's running pair cannot cross clusters)
//   2. lse_merge_kernel (softmax_stats.cuh): m, d, w
//   3. the score pass: scores[r] (bf16), or each CTA's share of them
//   4. (float32 only) sum_shares: the shares summed in rank order
//
// Both passes of both dtypes are one persistent, warp-specialised kernel
// (banked_pass<T, kScore>) over clusters of CTAs, one CTA an SM. The
// cluster splits the patch axis: each CTA keeps its share of q in shared
// memory and gives the rest to a ring of bank chunks of 64 rays x 128 bytes
// of depth (128-byte swizzle), guarded by full and empty mbarriers. A
// producer warp loads chunks by TMA; each CTA loads its share of a chunk's
// rays and multicasts it to the whole cluster, so device memory serves the
// bank once per pass. Two consumer warpgroups take the cluster's 64-ray
// tiles in turn (one's epilogue overlaps the other's products), with wgmma
// products into float32 accumulators and an epilogue in registers, log2(e)
// folded into the scale and exp2. Stats: rays past R are kept out of the
// max and the sum, and each CTA owns its patches' (m, d), so the pass needs
// no exchange. setmaxnreg moves registers from the producer warpgroup (40)
// to the consumers (232).
//
// bf16 bank (the inference path): 2-CTA clusters, 128 patches of q a CTA
// (96 KB at D = 384), a ring of 16 chunks 64 deep (8 KB) shared by both
// warpgroups, wgmma m64n128k16 with both operands in shared memory. Each
// CTA adds its half of a ray's score to the score that the stats pass
// zeroed; two addends on zero give the same bits in either order, so the
// scores are deterministic. Bound on an H100 SXM at R = 540000, D = 384:
// the two reads are 2 x 415 MB, 0.248 ms at 3.35 TB/s, the products
// 2 x 106 GFLOP, 0.215 ms at 989 TFLOP/s: bytes bound the pair at 0.248 ms.
// Depth: a multiple of 64 up to 384.
//
// float32 bank: the products run on the tensor cores in TF32 split in
// three, which keeps float32 accuracy (one TF32 product alone is off by
// about 1e-3 of a score). For x = hi + lo with hi = x rounded to TF32,
//   K . q ~ hi_K . lo_q + lo_K . hi_q + hi_K . hi_q
// (the small terms first, lo_K . lo_q dropped: 2^-22 of the product).
// 4-CTA clusters, 64 patches a CTA: q's hi and lo for them take 192 KB at
// D = 384 (loaded by TMA, split in place once), which leaves 32 KB for 4
// chunks 32 deep (8 KB), two for each warpgroup: each warpgroup has a ring
// and a producer warp of its own, since a shared ring that shallow would
// let the second warpgroup wait on a phase of the first one's chunks. A
// warpgroup loads a chunk's values into registers (16-byte loads: the
// depth is read in a permuted order, the same for q), splits them there
// and frees the stage at once; then each 8-deep step issues three wgmma
// m64n64k8 with A from registers and B = q_lo, q_hi, q_hi from shared
// memory, and the next chunk is loaded and split while they run. The score pass writes each CTA's share of a ray's score to a
// [4, R] scratch, and sum_shares adds them in rank order: deterministic.
// Bound on an H100 SXM at R = 540000, D = 384: three TF32 products of
// 106 GFLOP a pass, 2 x 0.644 ms at 495 TFLOP/s, bound the pair at
// 1.287 ms; the bank's two reads take 0.495 ms (the float32 FMA rate
// would need 3.17 ms). What holds it back (tools/k1_trace.py, PERF.md):
// a chunk's loads and splits take about as long as its products, and the
// products of two warpgroups that take A from registers issue slower than
// their nominal rate; and 30 clusters fit (120 SMs). Depth: a multiple of
// 32 up to 384.
#include <cstdint>

#include "softmax_stats.cuh"
#include "tma_wgmma.cuh"

namespace iff {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRays = 64;                              // rays a tile: one wgmma M
constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreadsWs = 32 * (kConsumerWarps + 4);  // and the producer warpgroup
// registers a thread, moved from the producer warpgroup to the two
// consumer ones: 128 x (168 - 40) = 256 x (232 - 168)
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDepth = 384;

// What differs between the routes: T is the bank's element type.
template <class T>
struct Route;

template <>
struct Route<bf16> {
  static constexpr int kCtas = 2;     // CTAs a cluster, each a share of the patches
  static constexpr int kStages = 16;  // bank chunks in the ring
  static constexpr int kRings = 1;    // both warpgroups share one ring
  static constexpr int kQCopies = 1;  // q as loaded
};

template <>
struct Route<float> {
  static constexpr int kCtas = 4;
  static constexpr int kStages = 4;
  static constexpr int kRings = 2;    // a ring of 2 chunks for each warpgroup
  static constexpr int kQCopies = 2;  // q_hi, q_lo
};

template <class T>
struct Shape : Route<T> {
  using Route<T>::kCtas;
  using Route<T>::kStages;
  using Route<T>::kRings;
  using Route<T>::kQCopies;
  static constexpr int kChunk = 128 / sizeof(T);        // depth a TMA box: the swizzle width
  static constexpr int kN = kPatches / kCtas;           // patches a CTA: wgmma N
  static constexpr int kAcc = kN / 2;                   // accumulators a thread
  static constexpr int kCols = kN / 4;                  // columns a thread holds of each row
  static constexpr int kMaxChunks = kMaxDepth / kChunk;
  static constexpr int kStageElems = kRays * kChunk;    // 8 KB
  static constexpr int kQChunkElems = kN * kChunk;      // 16 KB (bf16), 8 KB (float32)
  static constexpr int kRingStages = kStages / kRings;  // chunks in each ring
  static constexpr int kShareRays = kRays / kCtas;      // rays of a chunk each CTA loads
  static constexpr uint32_t kReleases = kCtas * 4;      // a chunk is freed by 4 warps a CTA
  static constexpr uint16_t kMask = (1 << kCtas) - 1;   // every CTA of the cluster

  // q's chunks (and their lo copies), the ring and the barriers, after up
  // to 1 KB of alignment
  static size_t smem_bytes(int nk) {
    return 1024 +
           sizeof(T) * (static_cast<size_t>(nk) * kQChunkElems * kQCopies +
                        kStages * kStageElems) +
           sizeof(uint64_t) * (2 * kStages + 1);
  }
};

template <class T>
struct Smem {
  T* q;             // kQCopies x nk chunks [kN patches][kChunk depth], swizzled
  T* ring;          // kStages chunks [64 rays][kChunk depth], swizzled
  uint64_t* full;   // kStages: the chunk has landed in this CTA
  uint64_t* empty;  // kStages: every CTA's consumers are done with it
  uint64_t* qbar;   // q has landed
};

template <class T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int nk) {
  using S = Shape<T>;
  const uint32_t pad = (1024 - (hop::smem_u32(raw) & 1023)) & 1023;  // swizzle atoms
  Smem<T> s;
  s.q = reinterpret_cast<T*>(raw + pad);
  s.ring = s.q + nk * S::kQChunkElems * S::kQCopies;
  s.full = reinterpret_cast<uint64_t*>(s.ring + S::kStages * S::kStageElems);
  s.empty = s.full + S::kStages;
  s.qbar = s.empty + S::kStages;
  return s;
}

__device__ __forceinline__ void consumers_sync() { hop::named_sync<32 * kConsumerWarps>(); }

// Chunk kc of the cluster's j-th tile: its ring (tiles are dealt to the
// rings in turn), its stage and the parity of that stage's phase.
struct Slot {
  int stage;
  uint32_t parity;
};

template <class T>
__device__ __forceinline__ Slot slot(int j, int kc, int nk) {
  using S = Shape<T>;
  const int ring = j % S::kRings;
  const int g = (j / S::kRings) * nk + kc;  // chunks of this ring before it
  return {ring * S::kRingStages + g % S::kRingStages,
          static_cast<uint32_t>((g / S::kRingStages) & 1)};
}

// A producer warp, all of it in step (a lone thread would leave the warp
// diverged around blocking waits), lane 0 issuing: ring 0's also loads
// this CTA's share of q once. Then every tile of its ring, nk chunks each:
// each CTA loads its share of a chunk's rays and multicasts it to the
// cluster, so device memory serves each chunk once; rays past R read as 0.
template <class T>
__device__ void produce(const CUtensorMap* bank_map, const CUtensorMap* q_map, const Smem<T>& sm,
                        int nk, int ntiles, int cluster, int nclusters, uint32_t rank, int ring) {
  using S = Shape<T>;
  const bool leader = (threadIdx.x & 31) == 0;
  if (leader) {
    hop::prefetch_map(bank_map);
    if (ring == 0) {
      hop::mbar_arrive_expect_tx(sm.qbar, nk * S::kQChunkElems * sizeof(T));
      for (int kc = 0; kc < nk; ++kc)
        hop::tma_load_2d(sm.q + kc * S::kQChunkElems, q_map, sm.qbar, kc * S::kChunk,
                         rank * S::kN);
    }
  }
  __syncwarp();
  for (int j = ring;; j += S::kRings) {
    const int t = cluster + j * nclusters;  // tiles dealt round-robin over the clusters
    if (t >= ntiles) break;
    const int ray0 = t * kRays + rank * S::kShareRays;
    for (int kc = 0; kc < nk; ++kc) {
      const Slot at = slot<T>(j, kc, nk);
      hop::mbar_wait(sm.empty + at.stage, at.parity ^ 1);
      if (leader) {
        hop::mbar_arrive_expect_tx(sm.full + at.stage, S::kStageElems * sizeof(T));
        hop::tma_load_2d_multicast(
            sm.ring + at.stage * S::kStageElems + rank * S::kShareRays * S::kChunk, bank_map,
            sm.full + at.stage, kc * S::kChunk, ray0, S::kMask);
      }
      __syncwarp();
    }
  }
}

// frees chunk s in every CTA of the cluster: this warp's products have read it
template <class T>
__device__ __forceinline__ void release(const Smem<T>& sm, int s) {
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (uint32_t c = 0; c < Shape<T>::kCtas; ++c) hop::mbar_arrive_cluster(sm.empty + s, c);
  }
}

// The float32 route reads the depth of a 32-deep chunk in a permuted order,
// the same for the bank and q, so that each thread's bank values lie in two
// 16-byte words a row (load_split_f32): step kk's depth c (0..7) is
// the chunk's column 8 (c % 4) + 2 kk + c / 4.
__device__ __forceinline__ int permuted_col(int kk, int c) {
  return 8 * (c & 3) + 2 * kk + (c >> 2);
}

// The float32 route's q: each 32-deep row of this CTA's share permuted
// (permuted_col) and split in place into hi = tf32(x) (in q's chunks) and
// lo = x - hi (in the chunks after them), then made visible to wgmma.
__device__ __forceinline__ void split_q(const Smem<float>& sm, int nk) {
  using S = Shape<float>;
  unsigned char* hi = reinterpret_cast<unsigned char*>(sm.q);
  unsigned char* lo = hi + nk * S::kQChunkElems * sizeof(float);
  for (int i = threadIdx.x; i < nk * S::kN; i += 32 * kConsumerWarps) {
    const int base = (i / S::kN) * S::kQChunkElems * sizeof(float), row = i % S::kN;
    float x[S::kChunk];
#pragma unroll
    for (int c = 0; c < S::kChunk; ++c)
      x[c] = *reinterpret_cast<const float*>(hi + base + hop::swz128_f32(row, c));
#pragma unroll
    for (int c = 0; c < S::kChunk; ++c) {
      const float v = x[permuted_col(c >> 3, c & 7)];
      const float h = __uint_as_float(hop::to_tf32(v));
      *reinterpret_cast<float*>(hi + base + hop::swz128_f32(row, c)) = h;
      *reinterpret_cast<float*>(lo + base + hop::swz128_f32(row, c)) = v - h;
    }
  }
  hop::fence_proxy_async();
  consumers_sync();
}

// Chunk kc of the j-th tile in float32, once it has landed: the bank's
// values of its 4 steps of 8 deep loaded into registers and split there
// into hi and lo, then its stage freed (the products read only registers
// and q). Element e of step kk's A fragment (row r0 + 8 (e & 1), depth
// t + 4 (e >> 1), t = lane % 4) is the chunk's column 8 t + 2 kk + (e >> 1)
// (permuted_col): the thread's 8 columns of a row are two 16-byte words, 4
// loads a chunk.
__device__ __forceinline__ void load_split_f32(const Smem<float>& sm, int j, int kc, int nk,
                                               uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  using S = Shape<float>;
  const Slot at = slot<float>(j, kc, nk);
  hop::mbar_wait(sm.full + at.stage, at.parity);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const unsigned char* a =
      reinterpret_cast<const unsigned char*>(sm.ring + at.stage * S::kStageElems);
  float x[2][8];  // columns 8 t .. 8 t + 7 of rows r0 and r0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      *reinterpret_cast<float4*>(&x[i][4 * u]) =
          *reinterpret_cast<const float4*>(a + hop::swz128_f32(r0 + 8 * i, 8 * t + 4 * u));
#pragma unroll
  for (int kk = 0; kk < S::kChunk / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = x[e & 1][2 * kk + (e >> 1)];
      hi[kk][e] = hop::to_tf32(v);
      lo[kk][e] = __float_as_uint(v - __uint_as_float(hi[kk][e]));
    }
#pragma unroll
  for (int kk = 0; kk < S::kChunk / 8; ++kk) {
    hop::fence_regs(hi[kk]);
    hop::fence_regs(lo[kk]);
  }
  __syncwarp();  // every lane's loads have returned
  release(sm, at.stage);
}

// The three products a step of depth chunk kc, from its split values.
__device__ __forceinline__ void products_f32(const Smem<float>& sm, int nk, int kc,
                                             const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4], float (&acc)[32]) {
  using S = Shape<float>;
  const uint64_t b_hi = hop::desc_sw128(sm.q + kc * S::kQChunkElems);
  const uint64_t b_lo = hop::desc_sw128(sm.q + (nk + kc) * S::kQChunkElems);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S::kChunk / 8; ++kk) {
    hop::wgmma_m64n64k8_tf32(acc, hi[kk], b_lo + 2 * kk, kc | kk);
    hop::wgmma_m64n64k8_tf32(acc, lo[kk], b_hi + 2 * kk, 1);
    hop::wgmma_m64n64k8_tf32(acc, hi[kk], b_hi + 2 * kk, 1);
  }
  hop::wgmma_commit();
}

// acc = the unscaled logits of this cluster's j-th tile: the warpgroup's 64
// rays x this CTA's kN patches. A bf16 chunk is read by its products, and
// freed as soon as the products of the next one are issued (at most two
// chunks' in flight) and its own have completed. A float32 chunk is freed
// once its values are in registers, and the next chunk is loaded and split
// while its products run. A wgmma's A registers must keep their values
// until it completes (a rule on PTX registers), so the chunks alternate
// between two sets, a and b, in two inlined copies of the same steps: a
// set is rewritten only after the wait that ends the products reading it.
template <class T>
__device__ __forceinline__ void tile_logits(const Smem<T>& sm, int nk, int j,
                                            float (&acc)[Shape<T>::kAcc]) {
  using S = Shape<T>;
  hop::fence_regs(acc);
  if constexpr (sizeof(T) == 2) {
    int prev = 0;
    for (int kc = 0; kc < nk; ++kc) {
      const Slot at = slot<T>(j, kc, nk);
      hop::mbar_wait(sm.full + at.stage, at.parity);
      const uint64_t a = hop::desc_sw128(sm.ring + at.stage * S::kStageElems);
      const uint64_t b = hop::desc_sw128(sm.q + kc * S::kQChunkElems);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::kChunk / 16; ++kk)
        hop::wgmma_m64n128k16(acc, a + 2 * kk, b + 2 * kk, kc | kk);
      hop::wgmma_commit();
      if (kc > 0) {
        hop::wgmma_wait<1>();
        release(sm, prev);
      }
      prev = at.stage;
    }
    hop::wgmma_wait<0>();
    release(sm, prev);
  } else {
    uint32_t ha[4][4], la[4][4], hb[4][4], lb[4][4];
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
    }
    hop::wgmma_wait<0>();
  }
  hop::fence_regs(acc);
}

// Folds each thread's running (m, d) (base 2) of its kCols columns over the
// 8 row groups of its warp, then over the 8 consumer warps, into this CTA's
// share of the cluster's partial row (natural log units, as lse_merge
// reads).
template <class T>
__device__ __forceinline__ void fold_stats(const Smem<T>& sm, float (&mr)[Shape<T>::kCols],
                                           float (&dr)[Shape<T>::kCols], int cluster,
                                           uint32_t rank, float* part_m, float* part_d) {
  using S = Shape<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int k = 0; k < S::kCols; ++k)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mr[k], off);
      const float dd = __shfl_xor_sync(0xffffffffu, dr[k], off);
      const float mn = fmaxf(mr[k], mo);
      dr[k] = dr[k] * hop::ex2(mr[k] - mn) + dd * hop::ex2(mo - mn);
      mr[k] = mn;
    }
  consumers_sync();  // both warpgroups are done with the ring: it holds the fold
  float* red_m = reinterpret_cast<float*>(sm.ring);
  float* red_d = red_m + kConsumerWarps * S::kN;
  if (lane < 4) {
#pragma unroll
    for (int k = 0; k < S::kCols; ++k) {
      const int col = 8 * (k >> 1) + 2 * tq + (k & 1);
      red_m[warp * S::kN + col] = mr[k];
      red_d[warp * S::kN + col] = dr[k];
    }
  }
  consumers_sync();
  if (threadIdx.x < S::kN) {
    const int p = threadIdx.x;
    float m = kNegInf;
    for (int i = 0; i < kConsumerWarps; ++i) m = fmaxf(m, red_m[i * S::kN + p]);
    float d = 0.f;
    for (int i = 0; i < kConsumerWarps; ++i)
      d += red_d[i * S::kN + p] * hop::ex2(red_m[i * S::kN + p] - m);
    part_m[cluster * kPatches + rank * S::kN + p] = m * kLn2;
    part_d[cluster * kPatches + rank * S::kN + p] = d;
  }
}

// Two consumer warpgroups take the cluster's tiles in turn. Thread value
// k < kCols of a row is patch rank*kN + 8 (k >> 1) + 2 (lane % 4) + (k & 1);
// its rows are 16 (warp % 4) + lane / 4 and 8 more.
//   stats (kScore false): running (m, d) in base 2 of its columns over its
//     rays, then fold_stats; for bf16, CTA 0 of the pair zeroes the tile's
//     scores.
//   score (kScore true): each row's sum over the CTA's patches of
//     exp2(l log2e - m log2e) w. bf16: added to the zeroed score (the two
//     CTAs' halves land on 0 in either order with the same sum, bit for
//     bit); float32: written to this CTA's row of out [4, R].
template <class T, bool kScore>
__device__ void consume(const Smem<T>& sm, int R, int nk, float scale2, int ntiles, int cluster,
                        int nclusters, uint32_t rank, const float* __restrict__ m,
                        const float* __restrict__ w, float* part_m, float* part_d, float* out) {
  using S = Shape<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  float ra[S::kCols], rb[S::kCols];  // stats: running max and sum; score: max (both base 2) and weight
#pragma unroll
  for (int k = 0; k < S::kCols; ++k) {
    if constexpr (kScore) {
      const int col = rank * S::kN + 8 * (k >> 1) + 2 * tq + (k & 1);
      ra[k] = m[col] * kLog2e;
      rb[k] = w[col];
    } else {
      ra[k] = kNegInf;
      rb[k] = 0.f;
    }
  }
  hop::mbar_wait(sm.qbar, 0);
  if constexpr (sizeof(T) == 4) split_q(sm, nk);
  float acc[S::kAcc] = {};
  for (int j = warp >> 2;; j += 2) {
    const int t = cluster + j * nclusters;
    if (t >= ntiles) break;
    tile_logits<T>(sm, nk, j, acc);
    const int r0 = t * kRays + 16 * (warp & 3) + (lane >> 2);
    const int r1 = r0 + 8;
    if constexpr (kScore) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < S::kCols; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        s0 = fmaf(hop::ex2(fmaf(acc[i], scale2, -ra[k])), rb[k], s0);
        s1 = fmaf(hop::ex2(fmaf(acc[i + 2], scale2, -ra[k])), rb[k], s1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (tq == 0) {
        if constexpr (sizeof(T) == 2) {
          if (r0 < R) atomicAdd(out + r0, s0);
          if (r1 < R) atomicAdd(out + r1, s1);
        } else {
          float* share = out + static_cast<int64_t>(rank) * R;
          if (r0 < R) share[r0] = s0;
          if (r1 < R) share[r1] = s1;
        }
      }
    } else {
      // rays past R (the last tile's zero rows) stay out of the statistics
      const bool ok0 = r0 < R, ok1 = r1 < R;
#pragma unroll
      for (int k = 0; k < S::kCols; ++k) {
        const int i = 4 * (k >> 1) + (k & 1);
        const float t0 = ok0 ? acc[i] * scale2 : kNegInf;
        const float t1 = ok1 ? acc[i + 2] * scale2 : kNegInf;
        const float mn = fmaxf(ra[k], fmaxf(t0, t1));
        const float e = (ok0 ? hop::ex2(t0 - mn) : 0.f) + (ok1 ? hop::ex2(t1 - mn) : 0.f);
        rb[k] = fmaf(rb[k], hop::ex2(ra[k] - mn), e);
        ra[k] = mn;
      }
      if constexpr (sizeof(T) == 2) {
        if (rank == 0 && tq == 0) {
          if (ok0) out[r0] = 0.f;
          if (ok1) out[r1] = 0.f;
        }
      }
    }
  }
  if constexpr (!kScore) fold_stats<T>(sm, ra, rb, cluster, rank, part_m, part_d);
}

// One pass over the bank: clusters of Route<T>::kCtas CTAs, one CTA an SM,
// persistent over the cluster's tiles; warps 0-7 consume, warps 8 (and 9,
// with two rings) produce.
template <class T, bool kScore>
__global__ void __launch_bounds__(kThreadsWs, 1)
    banked_pass(const __grid_constant__ CUtensorMap bank_map,
                const __grid_constant__ CUtensorMap q_map, int R, int nk, float scale2,
                const float* __restrict__ m, const float* __restrict__ w, float* part_m,
                float* part_d, float* out) {
  using S = Shape<T>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<T> sm = carve<T>(smem_raw, nk);
  const uint32_t rank = hop::cluster_rank();
  const int cluster = hop::cluster_id(), nclusters = hop::cluster_count();
  const int ntiles = (R + kRays - 1) / kRays;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hop::mbar_init(sm.full + s, 1);
      hop::mbar_init(sm.empty + s, S::kReleases);
    }
    hop::mbar_init(sm.qbar, 1);
    hop::fence_mbar_init();
  }
  hop::cluster_sync();  // every CTA's barriers exist before anyone arrives on them
  // each role runs to its own end (setmaxnreg needs branches that never
  // rejoin), where no CTA leaves while another may still arrive on its
  // barriers
  if (threadIdx.x >= 32 * kConsumerWarps) {  // the producer warpgroup
    hop::setmaxnreg_dec<kProducerRegs>();
    const int ring = (threadIdx.x >> 5) - kConsumerWarps;
    if (ring < S::kRings)
      produce<T>(&bank_map, &q_map, sm, nk, ntiles, cluster, nclusters, rank, ring);
    hop::cluster_sync();
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    consume<T, kScore>(sm, R, nk, scale2, ntiles, cluster, nclusters, rank, m, w, part_m,
                       part_d, out);
    hop::cluster_sync();
  }
}

// scores[r] = the four CTAs' shares of a float32 score, added in rank order
__global__ void __launch_bounds__(kThreads)
    sum_shares(const float* __restrict__ shares, int R, float* __restrict__ scores) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += gridDim.x * blockDim.x) {
    float s = shares[r];
#pragma unroll
    for (int c = 1; c < Route<float>::kCtas; ++c) s += shares[static_cast<int64_t>(c) * R + r];
    scores[r] = s;
  }
}

inline cudaLaunchConfig_t cluster_config(int ctas, int nclusters, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas * nclusters);
  cfg.blockDim = dim3(kThreadsWs);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the route's shared-memory limit and counts its clusters that fit on
// the card at once, on the first call -> that count (0: an error).
template <class T>
int resident_clusters() {
  static const int n = [] {
    using S = Shape<T>;
    const size_t smem = S::smem_bytes(S::kMaxChunks);
    if (cudaFuncSetAttribute(banked_pass<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaFuncSetAttribute(banked_pass<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(S::kCtas, 1, smem, nullptr, &attr);
    int clusters = 0;
    return cudaOccupancyMaxActiveClusters(
               &clusters, reinterpret_cast<const void*>(banked_pass<T, false>), &cfg) ==
                   cudaSuccess
               ? clusters
               : 0;
  }();
  return n;
}

template <class T>
cudaError_t run(const T* bank, const T* q, const unsigned char* valid, int R, int D, float scale,
                float* part_m, float* part_d, int nclusters, float* m, float* d, float* w,
                float* shares, float* scores, cudaStream_t stream) {
  using S = Shape<T>;
  const int resident = resident_clusters<T>();
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  nclusters = nclusters < resident ? nclusters : resident;
  CUtensorMap bank_map, q_map;  // built for each call: the bank's address and R change
  if (!hop::rows_map<T>(&bank_map, bank, R, D, S::kShareRays) ||
      !hop::rows_map<T>(&q_map, q, kPatches, D, S::kN))
    return cudaErrorInvalidValue;
  const int nk = D / S::kChunk;
  const size_t smem = S::smem_bytes(nk);
  const float scale2 = scale * kLog2e;
  float* out = sizeof(T) == 2 ? scores : shares;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(S::kCtas, nclusters, smem, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, banked_pass<T, false>, bank_map, q_map, R, nk,
                                       scale2, static_cast<const float*>(nullptr),
                                       static_cast<const float*>(nullptr), part_m, part_d, out);
  if (err != cudaSuccess) return err;
  err = launch_lse_merge(part_m, part_d, nclusters, kPatches, valid, m, d, w, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, banked_pass<T, true>, bank_map, q_map, R, nk, scale2,
                           static_cast<const float*>(m), static_cast<const float*>(w),
                           static_cast<float*>(nullptr), static_cast<float*>(nullptr), out);
  if (err != cudaSuccess || sizeof(T) == 2) return err;
  const int blocks = (R + kThreads - 1) / kThreads;
  sum_shares<<<blocks < 1024 ? blocks : 1024, kThreads, 0, stream>>>(shares, R, scores);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace iff

// Clusters of the route for is_bf16 (2 CTAs for bfloat16, 4 for float32)
// that fit on the current card at once (the most that run), or a negative
// cudaError_t.
extern "C" int iff_banked_clusters(int is_bf16) {
  const int n = is_bf16 ? iff::wg::resident_clusters<iff::wg::bf16>()
                        : iff::wg::resident_clusters<float>();
  return n > 0 ? n : -static_cast<int>(cudaErrorInvalidConfiguration);
}

// bank [R, D] of one dtype (0: float32, 1: bfloat16) and the queries in
// it, q [256, D], both 16-byte aligned; valid [256] bytes of 0 or 1;
// part_m/part_d [nclusters, 256], m/d/w [256] and scores [R] float32;
// shares [4, R] float32 scratch for float32 (unused for bfloat16). D must
// be a multiple of 64 (bfloat16) or 32 (float32), at most 384. nclusters:
// at most one cluster per 64-ray tile (fewer if fewer fit on the card at
// once, and the first ones of part_m/part_d are used). Returns a
// cudaError_t.
extern "C" int iff_banked_scores(const void* bank, const void* q, const void* valid, int R,
                                 int D, int P, int is_bf16, float scale, void* part_m,
                                 void* part_d, int nclusters, void* m, void* d, void* w,
                                 void* shares, void* scores, void* stream) {
  using namespace iff::wg;
  const int step = is_bf16 ? Shape<bf16>::kChunk : Shape<float>::kChunk;
  if (P != iff::kPatches || D <= 0 || D % step != 0 || D > kMaxDepth || R <= 0 ||
      nclusters <= 0 || (!is_bf16 && shares == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* pm = static_cast<float*>(part_m);
  auto* pd = static_cast<float*>(part_d);
  auto* v = static_cast<const unsigned char*>(valid);
  auto* mo = static_cast<float*>(m);
  auto* dout = static_cast<float*>(d);
  auto* wo = static_cast<float*>(w);
  auto* sh = static_cast<float*>(shares);
  auto* so = static_cast<float*>(scores);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? run<bf16>(static_cast<const bf16*>(bank), static_cast<const bf16*>(q), v, R, D,
                          scale, pm, pd, nclusters, mo, dout, wo, sh, so, s)
              : run<float>(static_cast<const float*>(bank), static_cast<const float*>(q), v, R,
                           D, scale, pm, pd, nclusters, mo, dout, wo, sh, so, s);
  return static_cast<int>(err);
}
