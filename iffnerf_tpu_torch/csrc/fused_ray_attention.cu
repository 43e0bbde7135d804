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
// Both dtypes run one pipeline. One persistent, warp-specialised CTA an SM
// walks its own 64-ray tiles (one wgmma M), every CTA the same number.
//   - The weights are the B operand. The wrapper lays out, once per set of
//     parameters, each layer's w^T cut into k-steps, each step as its image
//     in shared memory (rows of 32 bytes with the 32-byte swizzle); the
//     queries' steps so for each call, on the device. A producer warp
//     streams the steps, in the same order for every tile, by bulk copies
//     into a ring of stages guarded by full and empty mbarriers.
//   - The activations are the A operand, in chunks of [64 rays][128 bytes]
//     with the 128-byte swizzle. The two consumer warpgroups share a tile:
//     each takes half of every layer's output columns. A layer's output is
//     written over its input once both warpgroups have read it (named
//     barriers), so x, the h1/h2/h3 buffer and, over both, h4 and k fit in
//     a few chunks; the rest of the 227 KB holds the ring.
//   - The logits layer writes the float32 logits and folds each tile's
//     (m, d) of a column over a warp's 16 rows into a running pair that
//     one lane keeps; each CTA folds those into one partial at the end.
//     Tiles and folds run in a fixed order: repeats are bit-equal.
//   - The next tile's x is copied in while the logits epilogue runs.
// Namespace ws holds what the routes share (roles, ring, producer, logits
// epilogue, fold); f32 and bf hold each route's layout, products and layer
// epilogue. They are two namespaces and not one template on the element
// type because their products differ in kind: the float32 route reads A
// into registers and splits it, the bf16 route gives wgmma both operands
// in shared memory.
//
// float32 (training's precision): the products run on the TF32 tensor
// cores split in three, as K1's float32 route does: for a = hi + lo with
// hi = a rounded to TF32, a . w ~ hi_a . lo_w + lo_a . hi_w + hi_a . hi_w
// (lo . lo dropped: 2^-22 of the product).
//   - A weight step is 8 deep (one TF32 k-step): [N rows hi | N rows lo]
//     x 8 floats, the depth of each 32-deep chunk permuted as the
//     activations are read (load_split); one bulk copy a step (16 or 24 KB),
//     4.46 MB of weights from L2 a tile. (2-CTA clusters multicasting each
//     step, which halve those reads, measured no faster: PERF.md.)
//   - Activations are float32 chunks of [64 rays][32 deep]. Each
//     warpgroup (wgmma N = 64, 128 or 192) loads two steps of its input
//     into registers, splits them there and issues three wgmma m64nNk8 a
//     step, then waits for them before the next steps rewrite those
//     registers; the other warpgroup's products fill the wait. Keeping the
//     next steps' registers in flight made ptxas serialise the products
//     (C7512: too few registers) and measured slower. x [64, in], the
//     h1/h2/h3 buffer and h4 and k take 104 KB at the model's widths, which
//     leaves 5 ring stages of 24 KB. Up to 96 accumulators a thread.
//   - The next tile's x is copied in by cp.async, 4 bytes at a time.
// Bound on an H100 SXM at R = 540000: the three TF32 products are 1.77
// TFLOP, 3.58 ms at 495 TFLOP/s (the float32 FMA rate would need 8.82 ms);
// x and the logits take 0.26 ms. Widths: h1, h2, h3, D in {128, 256, 384},
// with at least two ring stages in shared memory.
//
// bfloat16 (the inference path): bf16 wgmma m64nNk16 with both operands in
// shared memory and float32 sums; no split, no depth permutation.
//   - A weight step is 16 deep (one bf16 k-step): N rows of 32 bytes, the
//     32-byte swizzle that the float32 steps use, so the same layout code
//     (the wrapper's _swizzle32) serves both dtypes. A ring stage holds
//     kStageSteps = 4 steps, one bulk copy and one wait: 48 KB at N = 384,
//     3 stages at the model's widths. (Two steps a stage, 7 stages of 24 KB,
//     measured 2 % slower, one step 5 % slower: PERF.md.) The skip layer's
//     steps are the h2 rows, then the x rows; x's depth is padded with
//     zeros to whole stages (141 -> 192).
//   - Activations are bf16 chunks of [64 rays][64 deep] (8 KB). Each
//     warpgroup (N = 64, 128, 192 or 256: 32 to 128 accumulators a thread)
//     issues a stage's products back to back, commits them and waits for
//     the previous stage's before it frees that stage (kInFlight): one
//     stage of products in flight while the next one's wait and issue run. Each
//     layer's epilogue adds the bias, applies the ReLU, rounds to bf16
//     (__floats2bfloat162_rn) and writes the swizzled chunks over the
//     layer's input, then fences them for the async proxy that wgmma reads
//     with. At the model's widths x takes 3 chunks, the h1/h2/h3 buffer 4,
//     h4 and k 6 over both: 56 KB, which leaves 3 stages of 48 KB.
//   - x cannot come by TMA or cp.async into its chunks: a row is 282
//     bytes, so every odd row starts on a 2-byte boundary. But a tile's 64
//     rows are 128 in bytes in a row, at a 16-byte boundary (x is 16-byte
//     aligned): cp.async brings them 16 bytes at a time (zeros past R) into
//     staging chunks during the logits epilogue, and the next tile starts
//     by placing them into x's swizzled chunks (zeros past in).
// Bound on an H100 SXM at R = 540000: the products take 0.598 ms at 989
// TFLOP/s; x and the logits 0.20 ms. The weights' stream from L2 is 1.15 MB
// a tile, 9.7 GB a call. Widths: h1, h2, h3, D in {128, 256, 384, 512},
// with at least two ring stages in shared memory.
#include <cstdint>

#include "softmax_stats.cuh"
#include "tma_wgmma.cuh"

namespace iff {

// ---------------------------------------------------------------------------
// shared by both routes: roles, the ring and its producer, the logits
// ---------------------------------------------------------------------------

namespace ws {

constexpr int kRays = 64;                              // rays a tile: one wgmma M
constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreadsWs = 32 * (kConsumerWarps + 4);  // and the producer warpgroup
// registers a thread, moved by setmaxnreg from the producer warpgroup to
// the consumers (without it the consumers spill)
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kChunkBytes = kRays * 128;  // an activation chunk: 128-byte rows, 8 KB
constexpr int kMaxStages = 8;
constexpr int kSmemBytes = 232448;        // all the dynamic shared memory a CTA may have
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ring stages of `slot` bytes that fit beside `act` activation chunks
__host__ __device__ inline int ring_stages(int act, int slot) {
  const int left = kSmemBytes - 1024 - 2 * kMaxStages * 8 - act * kChunkBytes;
  return left / slot < kMaxStages ? left / slot : kMaxStages;
}

// output width of each of the six layers, in the order the ring serves
// them; layer 5 (the logits) takes the queries' steps
template <class Net>
__host__ __device__ inline int layer_width(const Net& n, int l) {
  switch (l) {
    case 0: return n.h1;
    case 1: return n.h2;
    case 2: return n.h3;
    case 5: return kPatches;
    default: return n.dk;
  }
}

struct Smem {
  unsigned char* act;   // activation chunks, 128-byte swizzle
  unsigned char* ring;  // the stages, rows of 32 bytes with the 32-byte swizzle
  uint64_t* full;       // the stage has landed in this CTA
  uint64_t* empty;      // the consumer warps are done with it
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int act, int slot, int stages) {
  const uint32_t pad = (1024 - (hop::smem_u32(raw) & 1023)) & 1023;  // swizzle atoms
  Smem s;
  s.act = raw + pad;
  s.ring = s.act + act * kChunkBytes;
  s.full = reinterpret_cast<uint64_t*>(s.ring + stages * slot);
  s.empty = s.full + kMaxStages;
  return s;
}

// the ring's barriers, before anyone arrives on them
__device__ __forceinline__ void init_ring(const Smem& sm, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(sm.full + s, 1);
      hop::mbar_init(sm.empty + s, kConsumerWarps);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
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

// threadIdx.x, read afresh where the call stands. A layer epilogue's store
// and bias addresses derive from it; from threadIdx.x itself the compiler
// hoists them out of the tile loop, a few hundred a thread for all the
// layers, and spills them.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ float fast_exp(float x) { return hop::ex2(x * kLog2e); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer warp, all of it in step, lane 0 issuing: for every tile, the
// six layers' stages in order, each a bulk copy of its shared-memory image.
// A route's layer_stages(n, p, l) and stage_bytes(n, l) say how many stages
// layer l takes and how large each is.
template <class Net, class Plan>
__device__ __forceinline__ void produce(const unsigned char* w_img, const unsigned char* q_img,
                                        const Smem& sm, const Net& n, const Plan& p, int iters) {
  const bool leader = (threadIdx.x & 31) == 0;
  Pos at{0, 0};
  for (int j = 0; j < iters; ++j) {
    const unsigned char* src = w_img;
    for (int l = 0; l < 6; ++l) {
      if (l == 5) src = q_img;
      const uint32_t bytes = stage_bytes(n, l);
      const int steps = layer_stages(n, p, l);
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

}  // namespace ws

// ---------------------------------------------------------------------------
// float32: three TF32 wgmma products a step, A split in registers
// ---------------------------------------------------------------------------

namespace f32 {

using namespace ws;

constexpr int kChunk = 32;                // depth of an activation chunk: 128-byte rows
constexpr int kStep = 8;                  // depth of a ring stage: one TF32 k-step
constexpr int kStepBytes = kStep * 4;     // a weight row of a stage: 32 bytes

struct Net {
  const float *b1, *b2, *b3, *b4, *bk;
  int in_dim, h1, h2, h3, dk;
};

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
  p.stages = ring_stages(p.act, p.slot);
  return p;
}

// steps (of 8 deep) of each of the six layers, in the order the ring
// serves them, one a stage
inline __host__ __device__ int layer_steps(const Net& n, const Plan& p, int l) {
  switch (l) {
    case 0: return p.xc * (kChunk / kStep);
    case 1: return n.h1 / kStep;
    case 2: return n.h2 / kStep + p.xc * (kChunk / kStep);
    case 3: return n.h3 / kStep;
    default: return n.dk / kStep;
  }
}

inline __host__ __device__ int layer_stages(const Net& n, const Plan& p, int l) {
  return layer_steps(n, p, l);
}

inline __host__ __device__ uint32_t stage_bytes(const Net& n, int l) {
  return 2 * layer_width(n, l) * kStepBytes;
}

// 4 bytes from global to shared memory, or zeros when bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hop::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
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
  const int t = thread_index(), wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
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
  const Smem sm = carve(smem_raw, p.act, p.slot, p.stages);
  init_ring(sm, p.stages);
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
// bfloat16: bf16 wgmma with both operands in shared memory
// ---------------------------------------------------------------------------

namespace bf {

using namespace ws;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;               // depth of an activation chunk: 128-byte rows
constexpr int kStep = 16;                // depth of a weight step: one bf16 k-step
constexpr int kStepBytes = kStep * 2;    // a weight row of a step: 32 bytes
constexpr int kStageSteps = 4;           // steps a ring stage: one bulk copy, one wait
constexpr int kInFlight = 1;             // stages whose products run while the next one issues

struct Net {
  const bf16 *b1, *b2, *b3, *b4, *bk;
  int in_dim, h1, h2, h3, dk;
};

// Shared memory at these widths: the h1/h2/h3 buffer takes hc chunks from
// chunk 0, x its xc chunks from chunk x0 = max(hc, xc), and the next tile's
// x is staged in chunks [0, xc) while the logits epilogue runs; h4 and k
// lie over all of them. xs is the steps of x that the products issue (its
// depth in whole stages). A ring stage holds kStageSteps steps of the
// widest layer. (ops/fused_ray_attention.py's bf16_stages computes the
// same.)
struct Plan {
  int xc, x0, xs, act, slot, stages;
};

__host__ __device__ inline Plan plan(const Net& n) {
  Plan p;
  p.xc = (n.in_dim + kChunk - 1) / kChunk;
  const int h = imax(imax(n.h1, n.h2), n.h3);
  p.x0 = imax(h / kChunk, p.xc);
  constexpr int kStageDepth = kStep * kStageSteps;
  p.xs = (n.in_dim + kStageDepth - 1) / kStageDepth * kStageSteps;
  p.act = imax(p.x0 + p.xc, n.dk / kChunk);
  p.slot = kStageSteps * imax(imax(h, n.dk), kPatches) * kStepBytes;
  p.stages = ring_stages(p.act, p.slot);
  return p;
}

// steps (of 16 deep) of each of the six layers, in the order the ring
// serves them
inline __host__ __device__ int layer_steps(const Net& n, const Plan& p, int l) {
  switch (l) {
    case 0: return p.xs;
    case 1: return n.h1 / kStep;
    case 2: return n.h2 / kStep + p.xs;
    case 3: return n.h3 / kStep;
    default: return n.dk / kStep;
  }
}

inline __host__ __device__ int layer_stages(const Net& n, const Plan& p, int l) {
  return layer_steps(n, p, l) / kStageSteps;
}

inline __host__ __device__ uint32_t stage_bytes(const Net& n, int l) {
  return kStageSteps * layer_width(n, l) * kStepBytes;
}

// 16 bytes from global to shared memory, zero past the first `bytes`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hop::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// d (+)= a . b over the warpgroup's 64, 128, 192 or 256 output columns
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int s) {
  hop::wgmma_m64n64k16(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int s) {
  hop::wgmma_m64n128k16(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b, int s) {
  hop::wgmma_m64n192k16(d, a, b, s);
}
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int s) {
  hop::wgmma_m64n256k16(d, a, b, s);
}

// acc = the layer's products over ns1 steps of the activation chunks from
// chunk c1, then ns2 steps from chunk c2 (4 steps a chunk), a stage at a
// time: once it has landed, its kStageSteps products (scale_d 0 on the
// layer's first step overwrites acc) are issued and committed; then the
// products of the stage kInFlight before it are waited for and that stage
// freed.
template <int NA>
__device__ __forceinline__ void layer_products(const Smem& sm, const Plan& p, Pos& at, int n,
                                               int c1, int ns1, int c2, int ns2,
                                               float (&acc)[NA]) {
  constexpr int kNW = 2 * NA;  // this warpgroup's output columns
  const int wg = threadIdx.x >> 7;
  const int stages = (ns1 + ns2) / kStageSteps;
  hop::fence_regs(acc);
  Pos done = at;  // the next stage to free
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    hop::mbar_wait(sm.full + at.s, at.phase);
    const unsigned char* stage = sm.ring + at.s * p.slot + wg * kNW * kStepBytes;
    hop::wgmma_fence();
#pragma unroll
    for (int g = 0; g < kStageSteps; ++g) {
      const int k = s * kStageSteps + g;
      const int kc = k < ns1 ? k : k - ns1;  // the step within its segment
      const unsigned char* chunk = sm.act + ((k < ns1 ? c1 : c2) + (kc >> 2)) * kChunkBytes;
      const uint64_t a = hop::desc_sw128(chunk) + 2 * (kc & 3);
      mma(acc, a, hop::desc_sw32(stage + g * n * kStepBytes), k);
    }
    hop::wgmma_commit();
    if (s >= kInFlight) {
      hop::wgmma_wait<kInFlight>();
      release(sm, done.s);
      advance(done, p.stages);
    }
    advance(at, p.stages);
  }
  hop::wgmma_wait<0>();
  for (int s = stages < kInFlight ? 0 : stages - kInFlight; s < stages; ++s) {
    release(sm, done.s);
    advance(done, p.stages);
  }
  hop::fence_regs(acc);
}

// act(acc + bias) rounded to bf16 over the layer's input, into chunk 0
// onwards, fenced for wgmma's reads: thread value i is column wg * NW +
// 8 (i >> 2) + 2 t + (i & 1) of row r0 + 8 ((i >> 1) & 1)
template <int NA>
__device__ __forceinline__ void store_layer(const float (&acc)[NA], const bf16* __restrict__ bias,
                                            bool relu, unsigned char* out) {
  constexpr int kNW = 2 * NA;
  const int t = thread_index(), wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j) {
    const int col = wg * kNW + 8 * j + 2 * (lane & 3);
    const float2 bb =
        __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bias + col)));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      unsigned char* at = out + (col >> 6) * kChunkBytes + hop::swz128_bf16(r0 + 8 * h, col & 63);
      *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(v0, v1);
    }
  }
  hop::fence_proxy_async();
}

// one of the five dense layers: products, then (once both warpgroups have
// read the input) the output over it
template <int NA>
__device__ __forceinline__ void dense(const Smem& sm, const Plan& p, Pos& at, int n, int c1,
                                      int ns1, int c2, int ns2, const bf16* bias, bool relu) {
  float acc[NA] = {};
  layer_products<NA>(sm, p, at, n, c1, ns1, c2, ns2, acc);
  consumers_sync();
  store_layer<NA>(acc, bias, relu, sm.act);
  consumers_sync();
}

__device__ __forceinline__ void dense_n(const Smem& sm, const Plan& p, Pos& at, int n, int c1,
                                        int ns1, int c2, int ns2, const bf16* bias, bool relu) {
  switch (n) {
    case 128: dense<32>(sm, p, at, n, c1, ns1, c2, ns2, bias, relu); break;
    case 256: dense<64>(sm, p, at, n, c1, ns1, c2, ns2, bias, relu); break;
    case 384: dense<96>(sm, p, at, n, c1, ns1, c2, ns2, bias, relu); break;
    default: dense<128>(sm, p, at, n, c1, ns1, c2, ns2, bias, relu); break;
  }
}

// The tile's rows of x, 128 in_dim bytes in a row from a 16-byte boundary,
// into the staging chunks from chunk 0 as they lie, 16 bytes a cp.async,
// zeros past R; waited for with cp_async_wait_all.
__device__ __forceinline__ void stage_x(const bf16* __restrict__ x, int R, int in_dim, int ray0,
                                        unsigned char* staging) {
  const char* src = reinterpret_cast<const char*>(x);
  const int64_t begin = static_cast<int64_t>(ray0) * in_dim * 2;
  const int64_t end = static_cast<int64_t>(R) * in_dim * 2;
  for (int i = threadIdx.x; i < 8 * in_dim; i += 32 * kConsumerWarps) {
    const int64_t at = begin + 16 * i;
    const int bytes = at >= end ? 0 : (end - at < 16 ? static_cast<int>(end - at) : 16);
    cp_async16(staging + 16 * i, bytes ? src + at : src, bytes);
  }
}

// The staged rows into x's swizzled chunks from X: staged element e is
// row e / in_dim, column e % in_dim; columns [in_dim, 16 xs), which the
// products read, are zeroed. Fenced for wgmma's reads.
__device__ __forceinline__ void place_x(const unsigned char* staging, int in_dim, int xs,
                                        unsigned char* X) {
  for (int i = threadIdx.x; i < 8 * in_dim; i += 32 * kConsumerWarps) {
    const uint4 v = *reinterpret_cast<const uint4*>(staging + 16 * i);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    int r = 8 * i / in_dim, c = 8 * i - r * in_dim;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint16_t h = static_cast<uint16_t>(words[e >> 1] >> (16 * (e & 1)));
      *reinterpret_cast<uint16_t*>(X + (c >> 6) * kChunkBytes + hop::swz128_bf16(r, c & 63)) = h;
      if (++c == in_dim) {
        c = 0;
        ++r;
      }
    }
  }
  const int pad = kStep * xs - in_dim;
  for (int i = threadIdx.x; i < kRays * pad; i += 32 * kConsumerWarps) {
    const int r = i / pad, c = in_dim + i - r * pad;
    *reinterpret_cast<uint16_t*>(X + (c >> 6) * kChunkBytes + hop::swz128_bf16(r, c & 63)) = 0;
  }
  hop::fence_proxy_async();
}

// The two consumer warpgroups: every tile of this CTA (tile blockIdx.x +
// j gridDim.x; tiles past R compute zeros that are neither written nor
// counted), its six layers in turn.
__device__ __forceinline__ void consume(const Smem& sm, const Plan& p, const Net& n,
                                        const bf16* __restrict__ x, int R, int iters,
                                        float* __restrict__ logits, float* part_m,
                                        float* part_d) {
  float mr[4], dr[4];  // running (m, d) of 4 columns, see logits_epilogue
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mr[c] = kNegInf;
    dr[c] = 0.f;
  }
  Pos at{0, 0};
  unsigned char* X = sm.act + p.x0 * kChunkBytes;
  const int s1 = n.h1 / kStep, s2 = n.h2 / kStep, s3 = n.h3 / kStep, sd = n.dk / kStep;
  stage_x(x, R, n.in_dim, blockIdx.x * kRays, sm.act);
  for (int j = 0; j < iters; ++j) {
    const int ray0 = (blockIdx.x + j * gridDim.x) * kRays;
    cp_async_wait_all();
    consumers_sync();
    place_x(sm.act, n.in_dim, p.xs, X);
    consumers_sync();
    dense_n(sm, p, at, n.h1, p.x0, p.xs, 0, 0, n.b1, true);
    dense_n(sm, p, at, n.h2, 0, s1, 0, 0, n.b2, true);
    dense_n(sm, p, at, n.h3, 0, s2, p.x0, p.xs, n.b3, true);
    dense_n(sm, p, at, n.dk, 0, s3, 0, 0, n.b4, false);
    dense_n(sm, p, at, n.dk, 0, sd, 0, 0, n.bk, false);
    float acc[64] = {};
    layer_products<64>(sm, p, at, kPatches, 0, sd, 0, 0, acc);
    consumers_sync();  // k has been read: the next tile's x may be staged over it
    if (j + 1 < iters) stage_x(x, R, n.in_dim, ray0 + gridDim.x * kRays, sm.act);
    logits_epilogue(acc, ray0, R, logits, mr, dr);
  }
  fold_stats(sm, mr, dr, part_m, part_d);
}

// One CTA an SM, persistent over `iters` tiles each; warps 0-7 consume,
// warp 8 produces.
__global__ void __launch_bounds__(kThreadsWs, 1)
    fused_ray_bf16(const bf16* __restrict__ w_img, const bf16* __restrict__ q_img,
                   const bf16* __restrict__ x, int R, Net net, int iters,
                   float* __restrict__ logits, float* part_m, float* part_d) {
  extern __shared__ unsigned char smem_raw[];
  const Plan p = plan(net);
  const Smem sm = carve(smem_raw, p.act, p.slot, p.stages);
  init_ring(sm, p.stages);
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

// rows (of 16 bf16) of the weights' step image of layers 1-5
inline int net_rows(const Net& n, const Plan& p) {
  int rows = 0;
  for (int l = 0; l < 5; ++l) rows += layer_steps(n, p, l) * layer_width(n, l);
  return rows;
}

cudaError_t run(const bf16* x, int R, const Net& net, const bf16* w_img, int w_rows,
                const bf16* q_img, const unsigned char* valid, float* logits, float* part_m,
                float* part_d, int max_ctas, float* m, float* d, float* w, cudaStream_t stream) {
  const Plan p = plan(net);
  if (p.stages < 2 || w_rows != net_rows(net, p) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  // the shared-memory limit, set once (see f32::run)
  static const cudaError_t limit = cudaFuncSetAttribute(
      fused_ray_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (limit != cudaSuccess) return limit;
  const int ntiles = (R + kRays - 1) / kRays;
  const int grid = ntiles < max_ctas ? ntiles : max_ctas;
  const int iters = (ntiles + grid - 1) / grid;
  fused_ray_bf16<<<grid, kThreadsWs, kSmemBytes, stream>>>(w_img, q_img, x, R, net, iters, logits,
                                                           part_m, part_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_lse_merge(part_m, part_d, grid, kPatches, valid, m, d, w, stream);
}

}  // namespace bf

}  // namespace iff

// Both routes: x [R, in_dim] (bf16: at a 16-byte boundary); w_img the steps
// of layers 1-5 (the skip layer's h2 steps, then its x steps) and q_img the
// steps of the logits layer, each step as shared memory holds it
// (ops/fused_ray_attention.py lays them out): float32 [w_rows, 8], each
// step the hi then lo rows of w^T with the depth of each 32-deep chunk
// permuted; bf16 [w_rows, 16], each step the rows of w^T. The biases in
// x's dtype; valid [256] uint8; logits [R, 256], part_m/part_d
// [max_ctas, 256], m/d/w [256] float32. h1, h2, h3 and D must be 128, 256
// or 384 (float32) or also 512 (bf16), and the activations must leave two
// ring stages of shared memory. Returns a cudaError_t.
template <class Route, class T>
static int fused_ray_scores(const void* x, int R, int in_dim, int h1, int h2, int h3, int dk,
                            const void* w_img, int w_rows, const void* b1, const void* b2,
                            const void* b3, const void* b4, const void* bk, const void* q_img,
                            int P, const void* valid, void* logits, void* part_m, void* part_d,
                            int max_ctas, void* m, void* d, void* w, void* stream, int max_width) {
  auto cast = [](const void* p) { return static_cast<const T*>(p); };
  const Route net{cast(b1), cast(b2), cast(b3), cast(b4), cast(bk), in_dim, h1, h2, h3, dk};
  auto width_ok = [max_width](int n) { return n % 128 == 0 && n >= 128 && n <= max_width; };
  const bool ok = P == iff::kPatches && width_ok(h1) && width_ok(h2) && width_ok(h3) &&
                  width_ok(dk) && in_dim > 0 && R > 0 && max_ctas > 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if constexpr (sizeof(T) == 4)
    return static_cast<int>(iff::f32::run(
        cast(x), R, net, cast(w_img), w_rows, cast(q_img), static_cast<const unsigned char*>(valid),
        f(logits), f(part_m), f(part_d), max_ctas, f(m), f(d), f(w),
        static_cast<cudaStream_t>(stream)));
  else
    return static_cast<int>(iff::bf::run(
        cast(x), R, net, cast(w_img), w_rows, cast(q_img), static_cast<const unsigned char*>(valid),
        f(logits), f(part_m), f(part_d), max_ctas, f(m), f(d), f(w),
        static_cast<cudaStream_t>(stream)));
}

extern "C" int iff_fused_ray_scores_f32(const void* x, int R, int in_dim, int h1, int h2, int h3,
                                        int dk, const void* w_img, int w_rows, const void* b1,
                                        const void* b2, const void* b3, const void* b4,
                                        const void* bk, const void* q_img, int P,
                                        const void* valid, void* logits, void* part_m,
                                        void* part_d, int max_ctas, void* m, void* d, void* w,
                                        void* stream) {
  return fused_ray_scores<iff::f32::Net, float>(x, R, in_dim, h1, h2, h3, dk, w_img, w_rows, b1,
                                                b2, b3, b4, bk, q_img, P, valid, logits, part_m,
                                                part_d, max_ctas, m, d, w, stream, 384);
}

extern "C" int iff_fused_ray_scores_bf16(const void* x, int R, int in_dim, int h1, int h2,
                                         int h3, int dk, const void* w_img, int w_rows,
                                         const void* b1, const void* b2, const void* b3,
                                         const void* b4, const void* bk, const void* q_img, int P,
                                         const void* valid, void* logits, void* part_m,
                                         void* part_d, int max_ctas, void* m, void* d, void* w,
                                         void* stream) {
  return fused_ray_scores<iff::bf::Net, iff::bf::bf16>(
      x, R, in_dim, h1, h2, h3, dk, w_img, w_rows, b1, b2, b3, b4, bk, q_img, P, valid, logits,
      part_m, part_d, max_ctas, m, d, w, stream, 512);
}
