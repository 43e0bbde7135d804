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
// [R, P] go to device memory, and each CTA writes a partial softmax
// (m_b, d_b) per patch; lse_merge (softmax_stats.cuh) reduces them to
// m, d, w. The caller forms scores = exp(l - m) w.
//
// Two launches on the caller's stream: the fused kernel, lse_merge_kernel.
// Work at R = 540000 and the model's widths: 1.095 MFLOP a ray, 591 GFLOP.
//
// float32 (training's precision): the products run on the TF32 tensor
// cores split in three, as K1's float32 route does: for a = hi + lo with
// hi = a rounded to TF32, a . w ~ hi_a . lo_w + lo_a . hi_w + hi_a . hi_w
// (lo . lo dropped: 2^-22 of the product). One persistent, warp-specialised
// CTA an SM walks its own 64-ray tiles (one wgmma M), every CTA the same
// number.
//   - The weights are the B operand. The wrapper lays out, once per set of
//     parameters, each layer's w^T split into hi and lo and cut into steps
//     of 8 deep (one TF32 k-step): step i is [N rows hi | N rows lo] x 8
//     floats, the depth of each 32-deep chunk permuted as the activations
//     are read (load_split). The queries' steps are laid out so for each
//     call, each step as its image in shared memory (rows of 32 bytes with
//     the 32-byte swizzle). A producer warp streams the steps, in the same
//     order for every tile, by bulk copies (one a step, 16 or 24 KB) into a
//     ring of stages guarded by full and empty mbarriers: 4.46 MB of
//     weights from L2 a tile. (2-CTA clusters multicasting each step,
//     which halve those reads, measured no faster: PERF.md.)
//   - The activations are the A operand: float32 in shared memory, in
//     chunks of [64 rays][32 deep] with the 128-byte swizzle. The two
//     consumer warpgroups share a tile: each takes half of every layer's
//     output columns (wgmma N = 64, 128 or 192), loads two steps of the
//     input into registers, splits them there and issues three wgmma
//     m64nNk8 a step, then waits for them before the next steps rewrite
//     those registers; the other warpgroup's products fill the wait.
//     Keeping the next steps' registers in flight made ptxas serialise the
//     products (C7512: too few registers) and measured slower. A layer's
//     output is written over its input once both warpgroups have read it
//     (named barriers), so x [64, in], the h1/h2/h3 buffer and, over both,
//     h4 and k fit in 104 KB at the model's widths, which leaves 5 ring
//     stages of 24 KB. Up to 96 accumulators a thread (N = 192).
//   - The logits layer writes the float32 logits and folds each tile's
//     (m, d) of a column over a warp's 16 rows into a running pair that
//     one lane keeps; each CTA folds those into one partial at the end.
//     Tiles and folds run in a fixed order: repeats are bit-equal.
//   - The next tile's x is copied in (cp.async, zero past R and past in)
//     while the logits epilogue runs.
// Bound on an H100 SXM at R = 540000: the three TF32 products are 1.77
// TFLOP, 3.58 ms at 495 TFLOP/s (the float32 FMA rate would need 8.82 ms);
// x and the logits take 0.26 ms. Widths: h1, h2, h3, D in {128, 256, 384},
// with at least two ring stages in shared memory.
//
// bfloat16 (the inference path): mma.sync m16n8k16 bf16 tiles with float32
// accumulators, 64 rays a block, one block a SM. The activations stay in
// shared memory as bf16 (every layer rounds to bf16 anyway), about 136 KB
// at the model's widths; the weights, transposed and depth-padded by the
// wrapper, reach the tensor cores as fragments read from L2, where all
// 1.1 MB of them stay. Those L2 reads (the whole net again for every 64
// rays) and the 553 MB of logits keep it above its bound (0.60 ms on the
// bf16 tensor cores); the float32 route's pipeline in bf16 is later work.
#include <cstdint>

#include "mma_bf16.cuh"
#include "softmax_stats.cuh"
#include "tma_wgmma.cuh"

namespace iff {

// ---------------------------------------------------------------------------
// float32: three TF32 wgmma products a step, the weights through a ring
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRays = 64;                              // rays a tile: one wgmma M
constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreadsWs = 32 * (kConsumerWarps + 4);  // and the producer warpgroup
// registers a thread, moved by setmaxnreg from the producer warpgroup to
// the consumers (without it the consumers spill)
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kChunk = 32;                // depth of an activation chunk: 128-byte rows
constexpr int kChunkBytes = kRays * 128;  // 8 KB
constexpr int kStep = 8;                  // depth of a ring stage: one TF32 k-step
constexpr int kStepBytes = kStep * 4;     // a weight row of a stage: 32 bytes
constexpr int kMaxStages = 8;
constexpr int kSmemBytes = 232448;        // all the dynamic shared memory a CTA may have
constexpr float kLog2e = 1.4426950408889634f;

struct Net {
  const float *b1, *b2, *b3, *b4, *bk;
  int in_dim, h1, h2, h3, dk;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory at these widths: x takes xc chunks after the hc chunks of
// the h1/h2/h3 buffer; h4 and k lie over both. A ring stage holds the hi and
// lo rows of the widest layer's step. (ops/fused_ray_attention.py's
// f32_stages computes the same.)
struct Plan {
  int xc, hc, act, slot, stages;
};

__host__ __device__ inline Plan plan(const Net& n) {
  Plan p;
  p.xc = (n.in_dim + kChunk - 1) / kChunk;
  const int h = imax(imax(n.h1, n.h2), n.h3);
  p.hc = h / kChunk;
  p.act = imax(p.hc + p.xc, n.dk / kChunk);
  p.slot = 2 * imax(imax(h, n.dk), kPatches) * kStepBytes;
  const int left = kSmemBytes - 1024 - 2 * kMaxStages * 8 - p.act * kChunkBytes;
  p.stages = left / p.slot < kMaxStages ? left / p.slot : kMaxStages;
  return p;
}

// steps (of 8 deep) and output width of each of the six layers, in the
// order the ring serves them; layer 5 (the logits) takes the queries' steps
inline __host__ __device__ int layer_steps(const Net& n, const Plan& p, int l) {
  switch (l) {
    case 0: return p.xc * (kChunk / kStep);
    case 1: return n.h1 / kStep;
    case 2: return n.h2 / kStep + p.xc * (kChunk / kStep);
    case 3: return n.h3 / kStep;
    default: return n.dk / kStep;
  }
}

inline __host__ __device__ int layer_width(const Net& n, int l) {
  switch (l) {
    case 0: return n.h1;
    case 1: return n.h2;
    case 2: return n.h3;
    case 5: return kPatches;
    default: return n.dk;
  }
}

struct Smem {
  unsigned char* act;   // p.act chunks [64 rays][32 floats], 128-byte swizzle
  unsigned char* ring;  // p.stages stages: [N rows hi | N rows lo] x 8 floats, 32-byte swizzle
  uint64_t* full;       // the stage has landed in this CTA
  uint64_t* empty;      // the consumer warps are done with it
};

__device__ __forceinline__ Smem carve(unsigned char* raw, const Plan& p) {
  const uint32_t pad = (1024 - (hop::smem_u32(raw) & 1023)) & 1023;  // swizzle atoms
  Smem s;
  s.act = raw + pad;
  s.ring = s.act + p.act * kChunkBytes;
  s.full = reinterpret_cast<uint64_t*>(s.ring + p.stages * p.slot);
  s.empty = s.full + kMaxStages;
  return s;
}

// the next stage of the ring and the parity of its phase
struct Pos {
  int s;
  uint32_t phase;
};

__device__ __forceinline__ void advance(Pos& at, int stages) {
  if (++at.s == stages) {
    at.s = 0;
    at.phase ^= 1;
  }
}

__device__ __forceinline__ void consumers_sync() { hop::named_sync<32 * kConsumerWarps>(); }

__device__ __forceinline__ float fast_exp(float x) { return hop::ex2(x * kLog2e); }

// 4 bytes from global to shared memory, or zeros when bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hop::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer warp, all of it in step, lane 0 issuing: for every tile, the
// six layers' steps in order, each a bulk copy of its shared-memory image.
__device__ __forceinline__ void produce(const unsigned char* w_img, const unsigned char* q_img,
                                        const Smem& sm, const Net& n, const Plan& p, int iters) {
  const bool leader = (threadIdx.x & 31) == 0;
  Pos at{0, 0};
  for (int j = 0; j < iters; ++j) {
    const unsigned char* src = w_img;
    for (int l = 0; l < 6; ++l) {
      if (l == 5) src = q_img;
      const uint32_t bytes = 2 * layer_width(n, l) * kStepBytes;
      const int steps = layer_steps(n, p, l);
      for (int st = 0; st < steps; ++st) {
        hop::mbar_wait(sm.empty + at.s, at.phase ^ 1);
        if (leader) {
          hop::mbar_arrive_expect_tx(sm.full + at.s, bytes);
          hop::bulk_load(sm.ring + at.s * p.slot, src, bytes, sm.full + at.s);
        }
        __syncwarp();
        src += bytes;
        advance(at, p.stages);
      }
    }
  }
}

// frees stage s: this warp's products have read it
__device__ __forceinline__ void release(const Smem& sm, int s) {
  if ((threadIdx.x & 31) == 0) hop::mbar_arrive(sm.empty + s);
}

// Step kk (0..3) of an activation chunk loaded into registers and split
// there. Element e of the step's A fragment (row r0 + 8 (e & 1), depth
// t + 4 (e >> 1), t = lane % 4) is the chunk's column 8 t + 2 kk + (e >> 1),
// the depth that the wrapper's steps put at that position: one 8-byte word
// a row.
__device__ __forceinline__ void load_split(const unsigned char* chunk, int kk, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), col = 8 * (lane & 3) + 2 * kk;
  const float2 w0 = *reinterpret_cast<const float2*>(chunk + hop::swz128_f32(r0, col));
  const float2 w1 = *reinterpret_cast<const float2*>(chunk + hop::swz128_f32(r0 + 8, col));
  const float x[4] = {w0.x, w1.x, w0.y, w1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = hop::to_tf32(x[e]);
    lo[e] = __float_as_uint(x[e] - __uint_as_float(hi[e]));
  }
  hop::fence_regs(hi);
  hop::fence_regs(lo);
}

// d (+)= a . b over the warpgroup's 64, 128 or 192 output columns
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int s) {
  hop::wgmma_m64n64k8_tf32(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int s) {
  hop::wgmma_m64n128k8_tf32(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int s) {
  hop::wgmma_m64n192k8_tf32(d, a, b, s);
}

// The three products of one step (the small terms first; scale_d 0 on the
// layer's first step overwrites acc) on its stage, once it has landed.
template <int NA>
__device__ __forceinline__ void step_products(const Smem& sm, const Plan& p, const Pos& at, int n,
                                              int accumulate, const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4], float (&acc)[NA]) {
  constexpr int kNW = 2 * NA;  // this warpgroup's output columns
  const int wg = threadIdx.x >> 7;
  hop::mbar_wait(sm.full + at.s, at.phase);
  const unsigned char* slot = sm.ring + at.s * p.slot;
  const uint64_t b_hi = hop::desc_sw32(slot + wg * kNW * kStepBytes);
  const uint64_t b_lo = hop::desc_sw32(slot + (n + wg * kNW) * kStepBytes);
  hop::wgmma_fence();
  mma(acc, hi, b_lo, accumulate);
  mma(acc, lo, b_hi, 1);
  mma(acc, hi, b_hi, 1);
}

// acc = the layer's products over nc1 activation chunks from chunk c1, then
// nc2 from chunk c2, two steps at a time: their activations loaded and
// split into registers, their six products issued, then waited for (the
// next pair rewrites those registers) and both stages freed. The other
// warpgroup's products keep the tensor cores busy meanwhile. (One step a
// wait, or four, measured slower.)
template <int NA>
__device__ __forceinline__ void layer_products(const Smem& sm, const Plan& p, Pos& at, int n,
                                               int c1, int nc1, int c2, int nc2,
                                               float (&acc)[NA]) {
  const int ns = 4 * (nc1 + nc2);  // steps, 4 a chunk
  hop::fence_regs(acc);
#pragma unroll 1
  for (int s = 0; s < ns; s += 2) {
    const int q = s >> 2;
    const unsigned char* chunk = sm.act + (q < nc1 ? c1 + q : c2 + q - nc1) * kChunkBytes;
    uint32_t hi0[4], lo0[4], hi1[4], lo1[4];
    load_split(chunk, s & 3, hi0, lo0);
    load_split(chunk, (s & 3) + 1, hi1, lo1);
    const int s0 = at.s;
    step_products<NA>(sm, p, at, n, s, hi0, lo0, acc);
    advance(at, p.stages);
    const int s1 = at.s;
    step_products<NA>(sm, p, at, n, 1, hi1, lo1, acc);
    advance(at, p.stages);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    release(sm, s0);
    release(sm, s1);
  }
  hop::fence_regs(acc);
}

// act(acc + bias) over the layer's input, into chunk 0 onwards: thread value
// i is column wg * NW + 8 (i >> 2) + 2 t + (i & 1) of row r0 + 8 ((i >> 1) & 1)
template <int NA>
__device__ __forceinline__ void store_layer(const float (&acc)[NA], const float* __restrict__ bias,
                                            bool relu, unsigned char* out) {
  constexpr int kNW = 2 * NA;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j) {
    const int col = wg * kNW + 8 * j + 2 * (lane & 3);
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      unsigned char* at = out + (col >> 5) * kChunkBytes + hop::swz128_f32(r0 + 8 * h, col & 31);
      *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
    }
  }
}

// one of the five dense layers: products, then (once both warpgroups have
// read the input) the output over it
template <int NA>
__device__ __forceinline__ void dense(const Smem& sm, const Plan& p, Pos& at, int n, int c1,
                                      int nc1, int c2, int nc2, const float* bias, bool relu) {
  float acc[NA] = {};
  layer_products<NA>(sm, p, at, n, c1, nc1, c2, nc2, acc);
  consumers_sync();
  store_layer<NA>(acc, bias, relu, sm.act);
  consumers_sync();
}

__device__ __forceinline__ void dense_n(const Smem& sm, const Plan& p, Pos& at, int n, int c1,
                                     int nc1, int c2, int nc2, const float* bias, bool relu) {
  switch (n) {
    case 128: dense<32>(sm, p, at, n, c1, nc1, c2, nc2, bias, relu); break;
    case 256: dense<64>(sm, p, at, n, c1, nc1, c2, nc2, bias, relu); break;
    default: dense<96>(sm, p, at, n, c1, nc1, c2, nc2, bias, relu); break;
  }
}

// The tile's 64 rays x 256 patches of x into chunks [X, X + xc), zero past
// R and past in_dim; cp.async, waited for with cp_async_wait_all.
__device__ __forceinline__ void load_x(const float* __restrict__ x, int R, int in_dim, int ray0,
                                       unsigned char* X, int xc) {
  const int cols = xc * kChunk;
  for (int i = threadIdx.x; i < kRays * cols; i += 32 * kConsumerWarps) {
    const int r = i / cols, c = i - r * cols;
    const bool ok = ray0 + r < R && c < in_dim;
    const float* src = ok ? x + static_cast<int64_t>(ray0 + r) * in_dim + c : x;
    cp_async4(X + (c >> 5) * kChunkBytes + hop::swz128_f32(r, c & 31), src, ok ? 4 : 0);
  }
}

// The logits of a tile to device memory (rows past R are not written nor
// counted), and the tile's (m, d) of each of the warpgroup's 128 patch
// columns folded into the warp's running pair. A thread holds value k of
// column 8 (k >> 1) + 2 t + (k & 1) (past wg * 128) for rows r0 and r0 + 8;
// the tile's max and sum of each column over the warp's 16 rows go round
// the 8 lanes that share t, and lane 4 g + t keeps the running pair of its
// columns k = 4 g .. 4 g + 3.
__device__ __forceinline__ void logits_epilogue(const float (&acc)[64], int ray0, int R,
                                                float* __restrict__ logits, float (&mr)[4],
                                                float (&dr)[4]) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, r0 = ray0 + 16 * warp + g;
  const bool ok0 = r0 < R, ok1 = r0 + 8 < R;
  float* row0 = logits + static_cast<int64_t>(r0) * kPatches + wg * 128 + 2 * (lane & 3);
  float* row1 = row0 + 8 * kPatches;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (ok0) __stcs(reinterpret_cast<float2*>(row0 + 8 * j), make_float2(acc[4 * j], acc[4 * j + 1]));
    if (ok1)
      __stcs(reinterpret_cast<float2*>(row1 + 8 * j), make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = 4 * (k >> 1) + (k & 1);
    const float t0 = ok0 ? acc[i] : kNegInf, t1 = ok1 ? acc[i + 2] : kNegInf;
    float tm = fmaxf(t0, t1);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
    float ts = (ok0 ? fast_exp(t0 - tm) : 0.f) + (ok1 ? fast_exp(t1 - tm) : 0.f);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) ts += __shfl_xor_sync(0xffffffffu, ts, off);
    if ((k >> 2) == g) {
      const int c = k & 3;
      const float mn = fmaxf(mr[c], tm);
      dr[c] = dr[c] * fast_exp(mr[c] - mn) + ts * fast_exp(tm - mn);
      mr[c] = mn;
    }
  }
}

// Folds the running pairs of the 4 warps of each warpgroup into this CTA's
// partial row.
__device__ __forceinline__ void fold_stats(const Smem& sm, const float (&mr)[4],
                                           const float (&dr)[4], float* part_m, float* part_d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  consumers_sync();  // nobody reads the activations any more: they hold the fold
  float* red_m = reinterpret_cast<float*>(sm.act);
  float* red_d = red_m + kConsumerWarps * 128;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = 4 * (lane >> 2) + c;
    const int col = 8 * (k >> 1) + 2 * (lane & 3) + (k & 1);
    red_m[warp * 128 + col] = mr[c];
    red_d[warp * 128 + col] = dr[c];
  }
  consumers_sync();
  if (threadIdx.x < kPatches) {
    const int p = threadIdx.x, w0 = 4 * (p >> 7), c = p & 127;
    float m = kNegInf;
    for (int w = w0; w < w0 + 4; ++w) m = fmaxf(m, red_m[w * 128 + c]);
    float d = 0.f;
    for (int w = w0; w < w0 + 4; ++w) d += red_d[w * 128 + c] * expf(red_m[w * 128 + c] - m);
    part_m[blockIdx.x * kPatches + p] = m;
    part_d[blockIdx.x * kPatches + p] = d;
  }
}

// The two consumer warpgroups: every tile of this CTA (tile blockIdx.x +
// j gridDim.x; tiles past R compute zeros that are neither written nor
// counted), its six layers in turn.
__device__ __forceinline__ void consume(const Smem& sm, const Plan& p, const Net& n, const float* __restrict__ x,
                        int R, int iters, float* __restrict__ logits, float* part_m,
                        float* part_d) {
  float mr[4], dr[4];  // running (m, d) of 4 columns, see logits_epilogue
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mr[c] = kNegInf;
    dr[c] = 0.f;
  }
  Pos at{0, 0};
  unsigned char* X = sm.act + p.hc * kChunkBytes;
  const int hc1 = n.h1 / kChunk, hc2 = n.h2 / kChunk, hc3 = n.h3 / kChunk, dc = n.dk / kChunk;
  load_x(x, R, n.in_dim, blockIdx.x * kRays, X, p.xc);
  for (int j = 0; j < iters; ++j) {
    const int ray0 = (blockIdx.x + j * gridDim.x) * kRays;
    cp_async_wait_all();
    consumers_sync();
    dense_n(sm, p, at, n.h1, p.hc, p.xc, 0, 0, n.b1, true);
    dense_n(sm, p, at, n.h2, 0, hc1, 0, 0, n.b2, true);
    dense_n(sm, p, at, n.h3, 0, hc2, p.hc, p.xc, n.b3, true);
    dense_n(sm, p, at, n.dk, 0, hc3, 0, 0, n.b4, false);
    dense_n(sm, p, at, n.dk, 0, dc, 0, 0, n.bk, false);
    float acc[64] = {};
    layer_products<64>(sm, p, at, kPatches, 0, dc, 0, 0, acc);
    consumers_sync();  // k has been read: the next tile's x may land over it
    if (j + 1 < iters) load_x(x, R, n.in_dim, ray0 + gridDim.x * kRays, X, p.xc);
    logits_epilogue(acc, ray0, R, logits, mr, dr);
  }
  fold_stats(sm, mr, dr, part_m, part_d);
}

// One CTA an SM, persistent over `iters` tiles each; warps 0-7 consume,
// warp 8 produces.
__global__ void __launch_bounds__(kThreadsWs, 1)
    fused_ray_f32(const float* __restrict__ w_img, const float* __restrict__ q_img,
                  const float* __restrict__ x, int R, Net net, int iters,
                  float* __restrict__ logits, float* part_m, float* part_d) {
  extern __shared__ unsigned char smem_raw[];
  const Plan p = plan(net);
  const Smem sm = carve(smem_raw, p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(sm.full + s, 1);
      hop::mbar_init(sm.empty + s, kConsumerWarps);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();  // the barriers exist before anyone arrives on them
  // each role runs to its own end (setmaxnreg needs branches that never
  // rejoin)
  if (threadIdx.x >= 32 * kConsumerWarps) {
    hop::setmaxnreg_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) == kConsumerWarps)
      produce(reinterpret_cast<const unsigned char*>(w_img),
              reinterpret_cast<const unsigned char*>(q_img), sm, net, p, iters);
  } else {
    hop::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, p, net, x, R, iters, logits, part_m, part_d);
  }
}

// rows of the weights' step image of layers 1-5
inline int net_rows(const Net& n, const Plan& p) {
  int rows = 0;
  for (int l = 0; l < 5; ++l) rows += layer_steps(n, p, l) * 2 * layer_width(n, l);
  return rows;
}

cudaError_t run(const float* x, int R, const Net& net, const float* w_img, int w_rows,
                const float* q_img, const unsigned char* valid, float* logits, float* part_m,
                float* part_d, int max_ctas, float* m, float* d, float* w, cudaStream_t stream) {
  const Plan p = plan(net);
  if (p.stages < 2 || w_rows != net_rows(net, p)) return cudaErrorInvalidValue;
  // the shared-memory limit, set once (a static of this non-inline function
  // stays this library's own where two builds of the source share a process)
  static const cudaError_t limit = cudaFuncSetAttribute(
      fused_ray_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (limit != cudaSuccess) return limit;
  const int ntiles = (R + kRays - 1) / kRays;
  const int grid = ntiles < max_ctas ? ntiles : max_ctas;
  const int iters = (ntiles + grid - 1) / grid;
  fused_ray_f32<<<grid, kThreadsWs, kSmemBytes, stream>>>(w_img, q_img, x, R, net, iters, logits,
                                                          part_m, part_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_lse_merge(part_m, part_d, grid, kPatches, valid, m, d, w, stream);
}

}  // namespace f32

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

// float32: x [R, in_dim]; w_img [w_rows, 8]: the steps of layers 1-5 (the
// skip layer's h2 steps, then its x steps) and q_img [(D / 8) 2 P, 8]: the
// steps of the logits layer, each step the hi then lo rows of w^T with the
// depth of each 32-deep chunk permuted (ops/fused_ray_attention.py lays
// them out); the biases; valid [256] uint8; logits [R, 256], part_m/part_d
// [max_ctas, 256], m/d/w [256] float32. h1, h2, h3 and D must be 128, 256
// or 384, and the activations must leave two ring stages of shared memory.
// Returns a cudaError_t.
extern "C" int iff_fused_ray_scores_f32(const void* x, int R, int in_dim, int h1, int h2, int h3,
                                        int dk, const void* w_img, int w_rows, const void* b1,
                                        const void* b2, const void* b3, const void* b4,
                                        const void* bk, const void* q_img, int P,
                                        const void* valid, void* logits, void* part_m,
                                        void* part_d, int max_ctas, void* m, void* d, void* w,
                                        void* stream) {
  auto cast = [](const void* p) { return static_cast<const float*>(p); };
  const iff::f32::Net net{cast(b1), cast(b2), cast(b3), cast(b4), cast(bk),
                          in_dim, h1, h2, h3, dk};
  auto width_ok = [](int n) { return n == 128 || n == 256 || n == 384; };
  const bool ok = P == iff::kPatches && width_ok(h1) && width_ok(h2) && width_ok(h3) &&
                  width_ok(dk) && in_dim > 0 && R > 0 && max_ctas > 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(iff::f32::run(
      cast(x), R, net, cast(w_img), w_rows, cast(q_img), static_cast<const unsigned char*>(valid),
      static_cast<float*>(logits), static_cast<float*>(part_m), static_cast<float*>(part_d),
      max_ctas, static_cast<float*>(m), static_cast<float*>(d), static_cast<float*>(w),
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
