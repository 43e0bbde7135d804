// Fused ray MLP + k projection + logits for sm_90a.
//
// Replaces the Pallas TPU kernel of iffnerf_tpu/ops/fused_ray_attention.py
// (_kernel, called from fused_ray_scores). For each 64-ray tile of the
// ray inputs x [R, in] it runs, with the activations in shared memory,
//   h1 = relu(x  W1 + b1)           in  -> h1
//   h2 = relu(h1 W2 + b2)           h1 -> h2
//   h3 = relu([h2, x] W3 + b3)      h2 + in -> h3   (skip concat [h, x])
//   h4 = h3 W4 + b4                 h3 -> D          (ray features)
//   k  = h4 Wk + bk                 D  -> D          (k projection)
//   l  = k qs                       D  -> P          (qs carries 1/sqrt(D))
// Each layer accumulates in float32, adds the bias, applies the ReLU and
// rounds to the working dtype, as the TPU kernel does. The float32 logits
// [R, P] go to device memory, and each block writes a partial softmax
// (m_b, d_b) per patch; lse_merge (softmax_stats.cuh) reduces them to
// m, d, w. The caller forms scores = exp(l - m) w.
//
// Two launches on the caller's stream: the fused kernel, lse_merge_kernel.
//
// Bound on an H100 SXM: 1.09 MFLOP a ray (591 GFLOP at R = 540000) and
// 705 MB of traffic (x in bf16, logits out in f32): compute-bound, about
// 0.60 ms on the bf16 tensor cores.
//
// bfloat16 (the inference path): mma.sync m16n8k16 bf16 tiles with float32
// accumulators, 64 rays a block, one block a SM. The activations stay in
// shared memory as bf16 (every layer rounds to bf16 anyway), about 136 KB
// at the model's widths; the weights, transposed and depth-padded by the
// wrapper, reach the tensor cores as fragments read from L2, where all
// 1.1 MB of them stay. Those L2 reads (the whole net again for every 64
// rays) and the 553 MB of logits keep it above the bound; staging weights
// through shared memory and wgmma are later work.
//
// float32 (training's precision): float32 FMAs, the activations in shared
// memory as floats (64 * (in + max(h1, h3) + max(h2, D)) of them, 195 KB),
// the k buffer over the x and h1/h3 space once both are dead, and weights
// streaming through a 16-deep shared slice from L2; bound by the FMA rate.
#include <cstdint>

#include "mma_bf16.cuh"
#include "softmax_stats.cuh"

namespace iff {

constexpr int kBK = 16;        // depth of one weight slice
constexpr int kMaxChunk = 256; // output columns per pass (32 lanes x 8)

// acc[i][j] = sum_k in(wp*8 + i, k) * W[k][c0 + ln + 32*j] over k < KA + KB,
// where in(r, k) is inA[r][k] for k < KA and inB[r][k - KA] after it.
template <int NJ>
__device__ __forceinline__ void chunk_acc(const float* inA, int ldA, int KA, const float* inB,
                                          int ldB, int KB, const float* __restrict__ W, int N,
                                          int c0, float* Ws, float (&acc)[kRaysPerWarp][NJ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int ncols = 32 * NJ;
#pragma unroll
  for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const int K = KA + KB;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBK * ncols; idx += kThreads) {
      const int kk = idx / ncols, c = idx % ncols;
      const int k = k0 + kk;
      Ws[idx] = k < K ? W[static_cast<int64_t>(k) * N + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int k = k0 + kk;
      if (k < K) {
        const float* src = k < KA ? inA + k : inB + (k - KA);
        const int ld = k < KA ? ldA : ldB;
        float a[kRaysPerWarp];
#pragma unroll
        for (int i = 0; i < kRaysPerWarp; ++i) a[i] = src[(warp * kRaysPerWarp + i) * ld];
        float b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = Ws[kk * ncols + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRaysPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <int NJ>
__device__ __forceinline__ void layer_chunk(const float* inA, int ldA, int KA, const float* inB,
                                            int ldB, int KB, const float* __restrict__ W,
                                            const float* __restrict__ bias, int N, int c0,
                                            bool relu, float* Ws, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kRaysPerWarp][NJ];
  chunk_acc<NJ>(inA, ldA, KA, inB, ldB, KB, W, N, c0, Ws, acc);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = c0 + lane + 32 * j;
    const float bb = bias[c];
#pragma unroll
    for (int i = 0; i < kRaysPerWarp; ++i) {
      float v = acc[i][j] + bb;
      if (relu) v = fmaxf(v, 0.f);
      out[(warp * kRaysPerWarp + i) * N + c] = v;
    }
  }
}

// out [64][N] = layer(in); N a multiple of 128. `out` aliases no input;
// the next reader's first __syncthreads orders the writes before it.
__device__ void dense(const float* inA, int KA, const float* inB, int KB,
                      const float* __restrict__ W, const float* __restrict__ bias, int N,
                      bool relu, float* Ws, float* out) {
  for (int c0 = 0; c0 < N; c0 += kMaxChunk) {
    if (N - c0 >= kMaxChunk)
      layer_chunk<8>(inA, KA, KA, inB, KB, KB, W, bias, N, c0, relu, Ws, out);
    else
      layer_chunk<4>(inA, KA, KA, inB, KB, KB, W, bias, N, c0, relu, Ws, out);
  }
}

struct Weights {
  const void *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4, *wk, *bk, *qs;
  int in_dim, h1, h2, h3, dk;
};

__global__ void __launch_bounds__(kThreads)
    fused_ray_f32(const float* __restrict__ x, int R, Weights wt, float* __restrict__ logits,
                     float* part_m, float* part_d) {
  extern __shared__ __align__(16) float smem[];
  const int in_dim = wt.in_dim;
  const int r1 = max(wt.h1, wt.h3), r2 = max(wt.h2, wt.dk);
  float* X = smem;                              // [64][in]
  float* R1 = X + kTileRays * in_dim;           // [64][h1] then [64][h3]
  float* R2 = R1 + kTileRays * r1;              // [64][h2] then [64][D]
  float* Ws = R2 + kTileRays * r2;              // [16][<=256]
  float* Kb = X;                                // [64][D] over X and R1
  const float* w1 = static_cast<const float*>(wt.w1);
  const float* b1 = static_cast<const float*>(wt.b1);
  const float* w2 = static_cast<const float*>(wt.w2);
  const float* b2 = static_cast<const float*>(wt.b2);
  const float* w3 = static_cast<const float*>(wt.w3);
  const float* b3 = static_cast<const float*>(wt.b3);
  const float* w4 = static_cast<const float*>(wt.w4);
  const float* b4 = static_cast<const float*>(wt.b4);
  const float* wk = static_cast<const float*>(wt.wk);
  const float* bk = static_cast<const float*>(wt.bk);
  const float* qs = static_cast<const float*>(wt.qs);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m_run[kColsPerLane], d_run[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    m_run[j] = kNegInf;
    d_run[j] = 0.f;
  }
  const int ntiles = (R + kTileRays - 1) / kTileRays;
  const int64_t total = static_cast<int64_t>(R) * in_dim;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kTileRays;
    const int64_t base = static_cast<int64_t>(ray0) * in_dim;
    for (int idx = threadIdx.x; idx < kTileRays * in_dim; idx += kThreads)
      X[idx] = base + idx < total ? x[base + idx] : 0.f;

    dense(X, in_dim, nullptr, 0, w1, b1, wt.h1, true, Ws, R1);
    dense(R1, wt.h1, nullptr, 0, w2, b2, wt.h2, true, Ws, R2);
    dense(R2, wt.h2, X, in_dim, w3, b3, wt.h3, true, Ws, R1);
    dense(R1, wt.h3, nullptr, 0, w4, b4, wt.dk, false, Ws, R2);
    dense(R2, wt.dk, nullptr, 0, wk, bk, wt.dk, false, Ws, Kb);

    float acc[kRaysPerWarp][kColsPerLane];
    chunk_acc<kColsPerLane>(Kb, wt.dk, wt.dk, nullptr, 0, 0, qs, kPatches, 0, Ws, acc);
#pragma unroll
    for (int i = 0; i < kRaysPerWarp; ++i) {
      const int r = ray0 + warp * kRaysPerWarp + i;
      if (r < R) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          logits[static_cast<int64_t>(r) * kPatches + lane + 32 * j] = acc[i][j];
      }
    }
    const int nvalid = min(max(R - (ray0 + warp * kRaysPerWarp), 0), kRaysPerWarp);
    online_update(acc, nvalid, m_run, d_run);
  }
  __syncthreads();
  write_block_stats(m_run, d_run, R2, part_m, part_d);
}

inline size_t smem_bytes(const Weights& wt) {
  const int r1 = wt.h1 > wt.h3 ? wt.h1 : wt.h3;
  const int r2 = wt.h2 > wt.dk ? wt.h2 : wt.dk;
  return sizeof(float) *
         (static_cast<size_t>(kTileRays) * (wt.in_dim + r1 + r2) + kBK * kMaxChunk);
}

cudaError_t run_f32(const float* x, int R, const Weights& wt, const unsigned char* valid,
                    float* logits, float* part_m, float* part_d, int nblocks, float* m,
                    float* d, float* w, cudaStream_t stream) {
  const size_t smem = smem_bytes(wt);
  cudaError_t err = cudaFuncSetAttribute(fused_ray_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_ray_f32<<<nblocks, kThreads, smem, stream>>>(x, R, wt, logits, part_m, part_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_lse_merge(part_m, part_d, nblocks, kPatches, valid, m, d, w, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 64;  // rays per tile
constexpr int kPad = 8;    // row padding (elements): conflict-free fragment loads

// Transposed bf16 weights [out][in_pad], the input depth padded with zeros
// to a multiple of 16 (w3t: [h3][h2 + in_pad], matching the skip concat
// [h, x] with x padded), bf16 biases, and the pre-scaled queries q [256][D].
struct Net {
  const bf16 *w1t, *b1, *w2t, *b2, *w3t, *b3, *w4t, *b4, *wkt, *bk, *q;
  int in_dim, in_pad, h1, h2, h3, dk;
};

// shared row strides: [h2 | x] then k; h1 then h3; the ray features
struct Strides {
  int la, lb, lc;
};

inline __host__ __device__ Strides strides(const Net& n) {
  const int a = n.h2 + n.in_pad > n.dk ? n.h2 + n.in_pad : n.dk;
  const int b = n.h1 > n.h3 ? n.h1 : n.h3;
  return {a + kPad, b + kPad, n.dk + kPad};
}

inline size_t smem_bytes(const Net& n) {
  const Strides st = strides(n);
  return sizeof(bf16) * kRows * (st.la + st.lb + st.lc) + sizeof(float) * kRedFloats;
}

// acc[mt][nt] = in[wm*32 + 16*mt .., 0:K] . wt[n0 + 8*nt .., 0:K]^T for the
// warp's 32 rows and NT n8 tiles from column n0; in: shared, row stride ldi;
// wt [N][K] global (weight fragments come from L2).
template <int NT>
__device__ __forceinline__ void mma_rows(const bf16* in, int ldi, int K,
                                         const bf16* __restrict__ wt, int n0,
                                         float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const bf16* a_s = in + wm * 32 * ldi;
  const bf16* w_g = wt + static_cast<int64_t>(n0 + (lane >> 2)) * K + 2 * (lane & 3);
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4];
    load_a(a_s + k0, ldi, a[0]);
    load_a(a_s + 16 * ldi + k0, ldi, a[1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* p = w_g + static_cast<int64_t>(nt) * 8 * K + k0;
      const uint32_t b0 = ldg32(p), b1 = ldg32(p + 8);
      mma(acc[0][nt], a[0], b0, b1);
      mma(acc[1][nt], a[1], b0, b1);
    }
  }
}

// out[64][N] = act(in[64][K] . wt^T + b), rounded to bf16 as the TPU kernel
// rounds each layer; warp (wm, wn) writes rows wm*32 .. +31, columns
// wn*N/4 .. +N/4 (NT = N/32 n8 tiles).
template <int NT>
__device__ void dense_nt(const bf16* in, int ldi, int K, const bf16* __restrict__ wt,
                         const bf16* __restrict__ bias, bool relu, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int n0 = wn * NT * 8;
  float acc[2][NT][4];
  mma_rows<NT>(in, ldi, K, wt, n0, acc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tq;
    const float bias0 = __bfloat162float(bias[col]), bias1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mt][nt][2 * h] + bias0, v1 = acc[mt][nt][2 * h + 1] + bias1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// N in {128, 256, 384, 512} (checked by the entry point)
__device__ void dense(const bf16* in, int ldi, int K, const bf16* __restrict__ wt,
                      const bf16* __restrict__ bias, int N, bool relu, bf16* out, int ldo) {
  switch (N) {
    case 128: dense_nt<4>(in, ldi, K, wt, bias, relu, out, ldo); break;
    case 256: dense_nt<8>(in, ldi, K, wt, bias, relu, out, ldo); break;
    case 384: dense_nt<12>(in, ldi, K, wt, bias, relu, out, ldo); break;
    default: dense_nt<16>(in, ldi, K, wt, bias, relu, out, ldo); break;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_ray_bf16(const bf16* __restrict__ x, int R, Net net, float* __restrict__ logits,
                   float* part_m, float* part_d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Strides st = strides(net);
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // [64][la]: [h2 | x], then k
  bf16* B = A + kRows * st.la;                  // [64][lb]: h1, then h3
  bf16* C = B + kRows * st.lb;                  // [64][lc]: ray features
  float* red = reinterpret_cast<float*>(C + kRows * st.lc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;

  float m_run[kStatCols], d_run[kStatCols];
#pragma unroll
  for (int j = 0; j < kStatCols; ++j) {
    m_run[j] = kNegInf;
    d_run[j] = 0.f;
  }
  const bf16 zero = __float2bfloat16(0.f);
  const int ntiles = (R + kRows - 1) / kRows;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ray0 = t * kRows;
    // x tile -> A[:, h2 : h2 + in_pad]; zero past in_dim and past R
    for (int idx = threadIdx.x; idx < kRows * net.in_pad; idx += kThreads) {
      const int r = idx / net.in_pad, c = idx % net.in_pad;
      A[r * st.la + net.h2 + c] = ray0 + r < R && c < net.in_dim
                                      ? x[static_cast<int64_t>(ray0 + r) * net.in_dim + c]
                                      : zero;
    }
    __syncthreads();
    dense(A + net.h2, st.la, net.in_pad, net.w1t, net.b1, net.h1, true, B, st.lb);
    __syncthreads();
    dense(B, st.lb, net.h1, net.w2t, net.b2, net.h2, true, A, st.la);
    __syncthreads();
    dense(A, st.la, net.h2 + net.in_pad, net.w3t, net.b3, net.h3, true, B, st.lb);
    __syncthreads();
    dense(B, st.lb, net.h3, net.w4t, net.b4, net.dk, false, C, st.lc);
    __syncthreads();
    dense(C, st.lc, net.dk, net.wkt, net.bk, net.dk, false, A, st.la);
    __syncthreads();

    // logits against the 256 pre-scaled queries, float32, and their stats
    float acc[2][8][4];
    mma_rows<8>(A, st.la, net.dk, net.q, wn * 64, acc);
    bool ok[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ray0 + wm * 32 + mt * 16 + g + 8 * h;
        ok[mt][h] = r < R;
        if (!ok[mt][h]) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(logits + static_cast<int64_t>(r) * kPatches + wn * 64 +
                                     nt * 8 + 2 * tq) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    update_stats<2>(acc, ok, m_run, d_run);
    __syncthreads();  // the next tile's x overwrites A
  }
  fold_block_stats(m_run, d_run, red, part_m, part_d);
}

}  // namespace tc

cudaError_t run_bf16(const tc::bf16* x, int R, const tc::Net& net, const unsigned char* valid,
                     float* logits, float* part_m, float* part_d, int nblocks, float* m,
                     float* d, float* w, cudaStream_t stream) {
  const size_t smem = tc::smem_bytes(net);
  cudaError_t err = cudaFuncSetAttribute(
      tc::fused_ray_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tc::fused_ray_bf16<<<nblocks, kThreads, smem, stream>>>(x, R, net, logits, part_m, part_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_lse_merge(part_m, part_d, nblocks, kPatches, valid, m, d, w, stream);
}

}  // namespace iff

// float32: x [R, in_dim]; w1 [in, h1], w2 [h1, h2], w3 [h2 + in, h3],
// w4 [h3, D], wk [D, D], qs [D, 256] and the biases; valid [256] uint8;
// logits [R, 256], part_m/part_d [nblocks, 256], m/d/w [256] float32.
// h1, h2, h3 and D must be multiples of 128 and in + max(h1, h3) >= D.
// Returns a cudaError_t.
extern "C" int iff_fused_ray_scores_f32(const void* x, int R, int in_dim, const void* w1,
                                        const void* b1, int h1, const void* w2, const void* b2,
                                        int h2, const void* w3, const void* b3, int h3,
                                        const void* w4, const void* b4, int dk, const void* wk,
                                        const void* bk, const void* qs, int P, const void* valid,
                                        void* logits, void* part_m, void* part_d, int nblocks,
                                        void* m, void* d, void* w, void* stream) {
  const iff::Weights wt{w1, b1, w2, b2, w3, b3, w4, b4, wk, bk, qs, in_dim, h1, h2, h3, dk};
  const bool widths_ok = h1 % 128 == 0 && h2 % 128 == 0 && h3 % 128 == 0 && dk % 128 == 0 &&
                         in_dim + (h1 > h3 ? h1 : h3) >= dk;
  if (P != iff::kPatches || !widths_ok || R <= 0 || nblocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(iff::run_f32(
      static_cast<const float*>(x), R, wt, static_cast<const unsigned char*>(valid),
      static_cast<float*>(logits), static_cast<float*>(part_m), static_cast<float*>(part_d),
      nblocks, static_cast<float*>(m), static_cast<float*>(d), static_cast<float*>(w),
      static_cast<cudaStream_t>(stream)));
}

// bfloat16: x [R, in_dim]; w1t [h1, in_pad], w2t [h2, h1],
// w3t [h3, h2 + in_pad], w4t [D, h3], wkt [D, D] (each weight transposed,
// the input depth zero-padded to in_pad, a multiple of 16 >= in_dim),
// the biases, and the pre-scaled queries q [256, D], all bf16; valid [256]
// uint8; logits [R, 256], part_m/part_d [nblocks, 256], m/d/w [256]
// float32. h1, h2, h3 and D must be 128, 256, 384 or 512, and the tiles
// must fit the card's shared memory. Returns a cudaError_t.
extern "C" int iff_fused_ray_scores_bf16(const void* x, int R, int in_dim, int in_pad,
                                         const void* w1t, const void* b1, int h1,
                                         const void* w2t, const void* b2, int h2,
                                         const void* w3t, const void* b3, int h3,
                                         const void* w4t, const void* b4, int dk,
                                         const void* wkt, const void* bk, const void* q, int P,
                                         const void* valid, void* logits, void* part_m,
                                         void* part_d, int nblocks, void* m, void* d, void* w,
                                         void* stream) {
  using iff::tc::bf16;
  auto cast = [](const void* p) { return static_cast<const bf16*>(p); };
  const iff::tc::Net net{cast(w1t), cast(b1), cast(w2t), cast(b2), cast(w3t), cast(b3),
                         cast(w4t), cast(b4), cast(wkt), cast(bk), cast(q),
                         in_dim, in_pad, h1, h2, h3, dk};
  auto width_ok = [](int n) { return n == 128 || n == 256 || n == 384 || n == 512; };
  const bool ok = P == iff::kPatches && width_ok(h1) && width_ok(h2) && width_ok(h3) &&
                  width_ok(dk) && in_pad % 16 == 0 && in_pad >= in_dim && in_dim > 0 &&
                  iff::tc::smem_bytes(net) <= 232448 && R > 0 && nblocks > 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(iff::run_bf16(
      static_cast<const bf16*>(x), R, net, static_cast<const unsigned char*>(valid),
      static_cast<float*>(logits), static_cast<float*>(part_m), static_cast<float*>(part_d),
      nblocks, static_cast<float*>(m), static_cast<float*>(d), static_cast<float*>(w),
      static_cast<cudaStream_t>(stream)));
}
