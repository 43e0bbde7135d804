// The TensorCP field's features, their line gradient and their coordinate
// gradient, for sm_90a.
//
// A TensorCP field holds, for each kind (density, appearance), three lines
// [L_i, R] of R ranks; line i is indexed by the sample's coordinate
// xyz[2 - i]. For each sample and each axis i the line is lerped at that
// coordinate, and the three lerps are multiplied rank by rank: the density
// products are summed over the ranks into the sigma feature, the appearance
// products are written out (the input of basis_mat, which stays a torch
// matmul). This is compute_densityfeature and compute_appfeature of the
// JAX package for CP (iffnerf_tpu/models/field.py:383-389, 484-489). The
// JAX package has no fused route for CP: each texel fetch is the work of
// the Pallas kernel pallas_gather (extra/pallas_gather_bench.py:46), an XLA
// gather there, and the gradients are the scatter-adds that XLA derives.
// The dense route the port took before (ops/grid_sample.py on the row
// gather, K3) wrote two corner rows a sample and axis to device memory and
// lerped them in torch: at TensoRF's CP setting (ranks 96 / 288, a 500^3
// grid, about 7.1 M samples a training step) one appearance axis's corner
// rows are 16 GB, and three of them do not fit on the card.
//
// Numerics are grid_sample_1d's (ops/grid_sample.py): align_corners=True,
// p = (g + 1) / 2 * (L - 1), the lower corner floor(p) as an int, both
// corners clamped to [0, L - 1] and flagged when out of range, a flagged
// texel multiplied by 0, the lerp f0 * (1 - w) + f1 * w. Every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction) in
// the sampler's order and the axes are multiplied in the order 0, 1, 2, so
// the appearance products equal the plain route's bit for bit; only
// sigma's sum over ranks runs in another order.
//
// Forward (namespace fwd: cp_features_fwd_kernel and cp_sigma_sum_kernel,
// iff_cp_features). Bound on an H100 SXM: bytes. Device memory sees the
// coordinates (12 B a sample), sigma (4 B) and the appearance products
// (4 B a rank) once each; at ranks 96 / 288 that is 1 168 B a sample, 8.3
// GB at 7.1 M samples, 2.5 ms at 3.35 TB/s. The lines are at most 3 x 500
// x 384 x 4 B = 2.3 MB. The first design (cp_features_kernel, kept as
// iff_cp_features_l1 for lines longer than a column slice holds: a group
// of lanes a sample, each lane reading its word of the 6 corner rows
// through L1) was held by those reads, 9.2 KB a sample through L1 at 24
// warps an SM (tools/cp_time.py: its stores alone took 55 % of it, its
// reads and lerps without the stores 87 %, its reads from L2 alone twice
// as long). The design here:
// - Lines in shared memory by column slice: block (x, y) owns the cw
//   columns x * cw .. (density ranks, then appearance ranks, as the line
//   gradient lays them out) and loads that slice of all three lines once,
//   by cp.async ([L_0 + L_1 + L_2][cw] floats: 192 KB at 1 499 rows and 32
//   columns; the host's plan narrows cw for longer lines). One block an
//   SM; the grid's y is the blocks a slice.
// - Units in step: warp w of block (x, y) walks units of kUnit samples
//   y * kWarps + w, then every gridDim.y * kWarps-th after it. Every slice
//   walks the same stretch of samples at the same time, so that the
//   coordinates' repeats come from L2 and the lines of an output row are
//   written close together. (A queue a slice, as the line gradient takes,
//   cost an atomic's round trip a unit; larger units spread the rows' writes
//   over more of L2: both were slower, PERF.md.)
// - Corners once a block: a stage is 32 samples a warp; each lane fetches
//   one sample's coordinates a stage ahead (three coalesced loads a warp,
//   not a bulk-copy ring: with no coordinate read after a warp's first
//   unit the kernel is 0.7 % faster, tools/cp_time.py) and writes its three corners
//   into the warp's records: the byte offsets of its two rows in the slice
//   by slot parity (as the line gradient's slot_record orders them) and
//   their weights with the in-range flag folded in (f * (m * a) for
//   (f * m) * a: the same float, m being 0 or 1 and a >= 0).
// - The walk: a sample's group is cw / VEC lanes of VEC columns (8 where
//   the ranks and pointers allow: two float4 words a half slice apart, so
//   that each store fills whole 32-byte sectors; else 1); a warp's
//   groups each walk their own consecutive samples, reading the records
//   as broadcasts. A lane keeps each axis's two slot words in registers
//   and reads a slot from the slice only when its row changes; it lerps
//   (two products and a sum, no FMA contraction), multiplies the axes in
//   the order 0, 1, 2, and stores its appearance words through
//   st.global.cs (evicted from L2 first, so that the coordinates stay).
// - sigma: each density slice sums its columns in a fixed tree (a lane's
//   columns in order, then shuffles); with more than one density slice the
//   sums go to a [slices, N] scratch that cp_sigma_sum_kernel adds in slice
//   order. No atomics: two calls give the same bits.
// What holds it at a lego CP step (tools/cp_time.py, 1.32 times the
// bound): its store stream alone (products a constant, no corner or slice
// read) takes longer than the whole kernel, and its walk without the
// stores as long as the whole: the two overlap almost wholly. The stream
// writes each output row's nine 128-byte lines from nine SMs; the walk
// issues about 150 instructions a step of 8 samples, 88 of them the lerps
// and products, at 16 warps an SM.
//
// Line gradient (cp_features_bwd_kernel, iff_cp_features_bwd): for each
// sample, axis i and rank c, the upstream u (dsigma for a density rank,
// dapp[c] for an appearance rank) times the other two axes' lerps (in
// autograd's order through ((l0 * l1) * l2)), times (1 - w) into row r0 and
// times w into row r1 of line i, where the corner is in range. Bound on an
// H100 SXM: bytes, nearly all of them the upstream read (dapp, 1 152 B a
// sample at 288 ranks: 8.2 GB at a lego CP step's 7.09 M samples, 2.47 ms
// at 3.35 TB/s), most of it zeros (62 % of a step's samples carry none),
// each word read to know. Each line row takes about N / L = 14 000 terms a
// step, so atomics into device memory alone would serialise on a few
// hundred addresses. The first design (a lane a column walking a long
// stretch of samples one after another: the upstream word, then the
// coordinates, then the line words when the row changed) kept about one
// load in flight a lane, recomputed every corner in every lane (384 times
// a sample) and walked the dead samples lane by lane: 9.7 times the bound.
// The design here:
// - A block owns a slice of cw columns (ranks; density and appearance ranks
//   side by side) and keeps the slice's sums of all three lines in shared
//   memory ([L_0 + L_1 + L_2][cw] floats). One block an SM, kWarps warps;
//   cw is 32 where the sums and the rings fit the SM's 227 KB (1 499 rows:
//   192 KB of sums, 37 KB of rings), else 16, 8, ... (the host's plan).
//   Each warp walks on its own: it takes units of kUnit consecutive samples
//   from its slice's queue (an atomic counter a slice, so that units go to
//   whichever warp is free and no warp that meets the live rays holds the
//   launch) and walks a unit stage by stage, kRun samples a stage and group
//   (a group is cw lanes, a lane a column; with cw = 16 a warp's two groups
//   each walk their own half of the unit).
// - Streaming the upstream, not chasing it: lane 0 of each warp produces
//   its warp's ring of 2 to 4 stages in shared memory, each an mbarrier: the
//   stage's [kRun x cw] box of dapp through a 2-D TMA tensor map under L2's
//   evict-first policy (or its dsigma), and its xyz rows, bulk-copied; a
//   stage is refilled as soon as the warp has read it. The walk reads the
//   upstream and the coordinates from shared memory only. The stage a call
//   ends in, and every stage when a pointer is not 16-byte aligned, a rank
//   is not a multiple of 4 or a slice holds both kinds, is read from device
//   memory instead (the producer arrives with no bytes).
// - One vote a sample: a ballot on the stage's upstream words. A stage with
//   no live sample is left at once, without corners or a walk; a live
//   sample's zero word still adds nothing.
// - Corners once a block: once a stage's words are in registers, the
//   warp's lanes compute each live sample's three corners once (corner(),
//   the forward's arithmetic) into the stage's box, as the walk takes them:
//   the two corner rows in two slots by the parity of the lower corner's
//   index (slot e the even corner, slot o the odd one) and their weights
//   (1 - w or w, 0 where flagged out). The walking lanes read them as
//   broadcasts.
// - The walk: a lane first loads the line words of the rows its stage's
//   live samples enter (a slot's word is kept while its row stays), then,
//   sample by sample, lerps, multiplies and adds each term to a running sum
//   a slot; only when a slot's row changes (with slots by parity a cell that
//   moves by one row changes one slot) or its unit ends does it add the sum
//   into shared memory, one add (a CAS loop on the card). At cw = 32 a warp
//   is one group and a slice's line row is 128 bytes, so a warp's adds
//   touch 32 banks and never conflict; at cw = 16 (longer lines) two groups
//   share a warp and conflict two-way when their rows have the same parity.
// - At the end the block adds its non-zero sums into the gradient lines
//   with one float RED a row, column and block.
// What holds it at a lego CP step (cut-out variants, tools/cp_time.py): the
// stream with the vote and the corners takes about 2.3 times the bound, and
// the walk adds as much again: each warp's stage is a chain of dependent
// steps (the vote, the corners, the line words from L2, the walk's sums and
// adds), and the sums and rings leave room for 16 warps an SM and two
// stages each, too few to hide it. The additions land in another order on
// every run: the gradient is not bit-stable.
//
// Coordinate gradient (namespace cgrad: cp_coords_grad_kernel,
// iff_cp_features_coords_grad), for iNeRF on a CP field: for each sample
// and axis i, the sum over ranks of u * (f1 - f0) * the other two axes'
// lerps, scaled by (L_i - 1) / 2, into dxyz[2 - i]; f0 and f1 the flagged
// corner texels, so an axis whose corners are out of range adds zero.
// Bound on an H100 SXM: bytes, nearly all of them the upstream read (dapp,
// 1 152 B a sample at 288 ranks: 2.04 GB at an iNeRF iteration's 1.77 M
// samples, 0.62 ms at 3.35 TB/s), of which an iteration's samples carry
// about 3.4 % (each word has to be read to know). The first design (the
// first forward's mapping: a group of lanes a sample) did all its work
// for every sample, dead or not: 9.2 KB of corner words through L1 a
// sample, and one chain of dependent loads a lane: 3.2 times the bound.
// The design here:
// - Streaming the upstream: each of a block's kWarps warps takes 64-sample
//   units from a queue and streams their 8-sample stages (xyz, dsigma and
//   whole dapp rows, contiguous: 9 344 B) through its own ring of 2 to 4
//   mbarrier slots, lane 0 bulk-copying under L2's evict-first policy (the
//   host's plan: the longest stage at the deepest ring that fits; 2 slots
//   at lego's ranks). The stage a call ends in, and every stage off the
//   float4 route or with a pointer off the 16-byte grid, is read from
//   device memory instead.
// - One vote a sample on its whole upstream row, each word read once. A
//   stage with no live sample stores its zeros and is done: no corner, no
//   line word.
// - Corners once a block: a lane a live sample and axis writes the
//   sample's record: the keys of its two slots by the parity of the
//   corner's row (the flag folded into the key, so that a flagged slot
//   holds zeros), the odd slot's weight, and the axis's factor, negated
//   where the odd slot holds the lower corner.
// - The walk: lanes take three float4 words of the ranks (density first;
//   4-byte words, and passes of 96, off the float4 route) and keep each
//   axis's two slot words in registers, loading a slot's row (from L2:
//   the lines are 2.3 MB) only when its key changes; per lane the terms
//   are summed in rank order, then a fixed shuffle tree a sample. No
//   atomics: repeats are bit-equal, and a sample with no upstream is
//   exactly 0.
// What holds it (tools/cp_time.py --coords, PERF.md): at an iteration the
// stream and the vote alone take 94 % of the kernel (1.12 times the bound);
// where most samples are live the walk holds it, about 1 160 cycles a live
// sample a warp, so the time falls with more warps (8 to 12: the step
// 3.74 -> 3.10 ms); removing its slot loads or its shuffle trees saves
// 8 % and 5 % of an all-live set, and its lerps and products (14 floating-
// point operations a rank) keep it near the issue rate.
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "tma_wgmma.cuh"

namespace iff {
namespace cp {

constexpr int kThreads = 256;
constexpr int kRun = 8;                  // consecutive samples a group walks (forward)
constexpr int kBlocksPerSm = 8;          // grid cap of the forward's grid-stride loop
constexpr int kMaxSmem = 227 * 1024;     // a block's shared memory, at most

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p);

template <>
__device__ __forceinline__ Vec<1> load_vec<1>(const float* p) {
  return {{__ldg(p)}};
}

template <>
__device__ __forceinline__ Vec<4> load_vec<4>(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& x);

template <>
__device__ __forceinline__ void store_vec<1>(float* p, const Vec<1>& x) {
  *p = x.v[0];
}

template <>
__device__ __forceinline__ void store_vec<4>(float* p, const Vec<4>& x) {
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
}

// The lines of a call: density and appearance lines of each axis, their
// lengths, and the ranks (floats a row) of each kind.
struct Lines {
  const float* density[3];
  const float* app[3];
  int L[3];
  int rd, ra;
};

// One axis of one sample: the lower corner's index, clamped corner rows,
// their in-range flags as 1 or 0, the upper corner's weight w and 1 - w
// (grid_sample_1d's arithmetic).
struct Corner {
  int i0;
  int r0, r1;
  float m0, m1;
  float w, omw;
};

__device__ __forceinline__ Corner corner(float g, int L) {
  Corner c;
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), static_cast<float>(L - 1));
  const int i0 = static_cast<int>(floorf(p));
  const int i1 = i0 + 1;
  c.i0 = i0;
  c.w = __fsub_rn(p, static_cast<float>(i0));
  c.omw = __fsub_rn(1.0f, c.w);
  c.m0 = (i0 >= 0 && i0 <= L - 1) ? 1.0f : 0.0f;
  c.m1 = (i1 >= 0 && i1 <= L - 1) ? 1.0f : 0.0f;
  c.r0 = min(max(i0, 0), L - 1);
  c.r1 = min(max(i1, 0), L - 1);
  return c;
}

__device__ __forceinline__ float lerp(float f0, float f1, const Corner& c) {
  return __fadd_rn(__fmul_rn(__fmul_rn(f0, c.m0), c.omw), __fmul_rn(__fmul_rn(f1, c.m1), c.w));
}

// The group of g = 1 << log_g lanes that owns a sample, within its warp.
struct Group {
  int sub;    // lane in the group
  int index;  // group in the warp
  int per_warp;
};

__device__ __forceinline__ Group group_of(int log_g) {
  const int lane = threadIdx.x & 31;
  return {lane & ((1 << log_g) - 1), lane >> log_g, 32 >> log_g};
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    cp_features_kernel(const float* __restrict__ xyz, Lines t, float* __restrict__ sigma,
                       float* __restrict__ app, int64_t N, int log_g) {
  const int g = 1 << log_g;
  const Group grp = group_of(log_g);
  const int wd = t.rd / VEC, words = wd + t.ra / VEC;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t span = static_cast<int64_t>(grp.per_warp) * kRun;
  // base and k are the same for every lane of a warp: the shuffles below
  // see the whole warp
  for (int64_t base = warp * span; base < N; base += warps * span) {
    const int64_t first = base + static_cast<int64_t>(grp.index) * kRun;
    for (int k = 0; k < kRun; ++k) {
      const int64_t n = first + k;
      const bool live = n < N;
      float s = 0.0f;
      if (live) {
        Corner c[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) c[i] = corner(__ldg(xyz + 3 * n + 2 - i), t.L[i]);
        for (int w = grp.sub; w < words; w += g) {
          const bool dens = w < wd;
          const int stride = dens ? t.rd : t.ra;
          const int col = (dens ? w : w - wd) * VEC;
          Vec<VEC> prod;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float* line = dens ? t.density[i] : t.app[i];
            const Vec<VEC> a = load_vec<VEC>(line + static_cast<int64_t>(c[i].r0) * stride + col);
            const Vec<VEC> b = load_vec<VEC>(line + static_cast<int64_t>(c[i].r1) * stride + col);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float l = lerp(a.v[e], b.v[e], c[i]);
              prod.v[e] = i == 0 ? l : __fmul_rn(prod.v[e], l);
            }
          }
          if (dens) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s += prod.v[e];
          } else {
            store_vec<VEC>(app + n * t.ra + col, prod);
          }
        }
      }
      for (int o = g >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (live && grp.sub == 0 && sigma != nullptr) sigma[n] = s;
    }
  }
}

struct Grads {
  float* density[3];
  float* app[3];
};

namespace bwd {

constexpr int kWarps = 16;                // warps a block, each walking on its own
constexpr int kThreads = 32 * kWarps;     // one block an SM
constexpr int kRun = 8;                   // samples a group takes from each stage
constexpr int kUnit = 1024;               // samples a warp takes from its slice's queue
constexpr int kMaxGroups = 2;             // groups of cw lanes a warp (cw < 16 leaves lanes idle)
constexpr int kBoxBytes = 32 * kRun * 4;  // a warp's upstream words of a stage
constexpr int kRowBytes = kRun * 16;      // a group's xyz (12 B a sample), then its dsigma
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr uint32_t kNoRow = 0xffffu;
static_assert(kRun % 4 == 0, "a stage's xyz and dsigma rows are whole 16-byte units");
static_assert(kUnit % (kMaxGroups * kRun) == 0, "a group's part of a unit is whole stages");
static_assert(kMaxGroups * kRun * 3 * 16 <= kBoxBytes,
              "a stage's corner records fit its upstream box, read by then");

// The host's split of the work.
struct Plan {
  int log_cw;  // columns a block: cw = 1 << log_cw
  int groups;  // groups of cw lanes a warp
  int stages;  // ring depth a warp
  int col_lo, col_hi;
  int rows;    // L_0 + L_1 + L_2
  int tma;     // stages bulk-copied into the rings (else read from device memory)
  int units;   // units of kUnit samples
};

// Shared memory of a block: each warp's ring (its stages' upstream boxes,
// which take the stage's corner records once its words are read, then
// their xyz and dsigma rows, then the barriers), then the sums. The host's
// plan (ops/cp_features.py: backward_smem) counts the same.
__host__ __device__ inline long long smem_bytes(int rows, int log_cw, int groups, int stages) {
  return static_cast<long long>(kWarps) * stages * (kBoxBytes + groups * kRowBytes + 8) +
         static_cast<long long>(rows) * (4 << log_cw);
}

// An L2 policy for data that streams through once (the upstream): evicted
// first, so that the coordinates, which every slice reads, and the lines
// stay longer
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// box at (c0 innermost, c1) -> dst under an L2 policy; completes its bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(hop::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hop::smem_u32(bar)), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

// A sample's corners on one axis as the walk takes them: x the rows by the
// parity of the lower corner's index (low 16 bits slot e, the even corner;
// high 16 bits slot o, the odd one), y and z their weights (1 - w and w, 0
// where the corner is flagged out: the lerp's f * m * (1 - w) is f * 0
// there, the same float)
__device__ __forceinline__ uint4 slot_record(const Corner& c) {
  const float w0 = c.m0 != 0.0f ? c.omw : 0.0f;
  const float w1 = c.m1 != 0.0f ? c.w : 0.0f;
  const bool even = (c.i0 & 1) == 0;
  const uint32_t re = static_cast<uint32_t>(even ? c.r0 : c.r1);
  const uint32_t ro = static_cast<uint32_t>(even ? c.r1 : c.r0);
  return make_uint4(re | (ro << 16), __float_as_uint(even ? w0 : w1),
                    __float_as_uint(even ? w1 : w0), 0u);
}

// A slot's running sum into the block's sums of its row (none: kNoRow)
__device__ __forceinline__ void add_row(float* acc, int off, uint32_t row, int cw, float s) {
  if (row != kNoRow && s != 0.0f) atomicAdd(acc + off + static_cast<int>(row) * cw, s);
}

// A lane's slot state for the three axes: the rows (as a record's x), the
// running sums and the line words
struct Slots {
  uint32_t cur[3];
  float se[3], so[3], ve[3], vo[3];
};

// The walk of a stage's live samples (bit k of live), with the line words
// of the rows they enter in fresh and their records at rec: each term is
// added to its slot's sum, which goes into shared memory when the slot's
// row changes
__device__ __forceinline__ void walk(Slots& st, const uint4* rec, unsigned live,
                                     const float (&u)[kRun], const float (&fresh)[kRun][3][2],
                                     float* acc, const int (&off)[3], int cw) {
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (!((live >> k) & 1)) continue;
    float l[3], we[3], wo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 q = rec[3 * k + i];
      const uint32_t d = q.x ^ st.cur[i];
      if (d & 0xffffu) {
        add_row(acc, off[i], st.cur[i] & 0xffffu, cw, st.se[i]);
        st.se[i] = 0.0f;
        st.ve[i] = fresh[k][i][0];
      }
      if (d >> 16) {
        add_row(acc, off[i], st.cur[i] >> 16, cw, st.so[i]);
        st.so[i] = 0.0f;
        st.vo[i] = fresh[k][i][1];
      }
      st.cur[i] = q.x;
      we[i] = __uint_as_float(q.y);
      wo[i] = __uint_as_float(q.z);
      l[i] = __fadd_rn(__fmul_rn(st.ve[i], we[i]), __fmul_rn(st.vo[i], wo[i]));
    }
    // autograd's order through ((l0 * l1) * l2)
    const float u2 = u[k] * l[2];
    const float gi[3] = {u2 * l[1], u2 * l[0], u[k] * (l[0] * l[1])};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      st.se[i] += gi[i] * we[i];
      st.so[i] += gi[i] * wo[i];
    }
  }
}

// every slot's sum into shared memory, the slots emptied (a unit's end)
__device__ __forceinline__ void flush(Slots& st, float* acc, const int (&off)[3], int cw) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    add_row(acc, off[i], st.cur[i] & 0xffffu, cw, st.se[i]);
    add_row(acc, off[i], st.cur[i] >> 16, cw, st.so[i]);
    st.cur[i] = kNoRow | kNoRow << 16;
    st.se[i] = st.so[i] = 0.0f;
  }
}

// Block (x, y) takes the columns col_lo + x * cw .. + cw - 1 and units of
// its slice's queue (queue[x], zeroed by the host) until they run out.
__global__ void __launch_bounds__(kThreads, 1)
    cp_features_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ dsigma,
                           const float* __restrict__ dapp, const __grid_constant__ CUtensorMap map,
                           const __grid_constant__ Lines t, const __grid_constant__ Grads gr,
                           const __grid_constant__ Plan p, int64_t N, int* __restrict__ queue) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.stages, G = p.groups, log_cw = p.log_cw, cw = 1 << log_cw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* boxes = smem;                                       // [kWarps][K][kBoxBytes]
  unsigned char* xd_rows = boxes + kWarps * K * kBoxBytes;           // [kWarps][K][G][kRowBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xd_rows + kWarps * K * G * kRowBytes);
  float* acc = reinterpret_cast<float*>(bars + kWarps * K);          // [rows][cw]
  uint64_t* bar = bars + warp * K;
  const int total = p.rows * cw;
  for (int e = threadIdx.x; e < total; e += kThreads) acc[e] = 0.0f;
  if (lane == 0) {
    for (int s = 0; s < K; ++s) hop::mbar_init(bar + s, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();

  const int c0 = p.col_lo + static_cast<int>(blockIdx.x) * cw;
  const bool slice_dens = c0 < t.rd;  // on the TMA route a slice holds one kind
  const int grp = lane >> log_cw, glane = lane & (cw - 1);
  const int gq = grp < G ? grp : 0;   // an idle lane's addresses stay in range
  const int col = c0 + glane;
  const bool on = grp < G && col < p.col_hi;
  const bool dens = col < t.rd;
  const int stride = dens ? t.rd : t.ra;
  const int c = dens ? col : col - t.rd;
  const float* lines[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) lines[i] = (dens ? t.density[i] : t.app[i]) + c;
  const int off[3] = {glane, t.L[0] * cw + glane, (t.L[0] + t.L[1]) * cw + glane};
  const unsigned cols = cw == 32 ? 0xffffffffu : (1u << cw) - 1;
  const int part = kUnit / G, per_unit = part / kRun;
  const uint32_t stage_tx = G * (kRun * 12 + (slice_dens ? kRun * 4 : kRun * cw * 4));
  const uint64_t policy = evict_first();

  auto grab = [&]() {  // the next unit of the slice's queue, or -1
    int u = 0;
    if (lane == 0) u = atomicAdd(queue + blockIdx.x, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    return u < p.units ? u : -1;
  };
  // the bulk copies of stage st of unit into slot s, by lane 0 (none when
  // the stage is read from device memory)
  auto issue = [&](int s, int unit, int st) {
    if (lane != 0) return;
    const int64_t base = static_cast<int64_t>(unit) * kUnit + st * kRun;
    const bool staged = p.tma && base + static_cast<int64_t>(G - 1) * part + kRun <= N;
    hop::mbar_arrive_expect_tx(bar + s, staged ? stage_tx : 0u);
    if (!staged) return;
    for (int g = 0; g < G; ++g) {
      const int64_t n0 = base + static_cast<int64_t>(g) * part;
      unsigned char* xd = xd_rows + ((warp * K + s) * G + g) * kRowBytes;
      hop::bulk_load(xd, xyz + 3 * n0, kRun * 12, bar + s);
      if (slice_dens)
        hop::bulk_load(xd + kRun * 12, dsigma + n0, kRun * 4, bar + s);
      else
        tma_load_2d(boxes + (warp * K + s) * kBoxBytes + g * kRun * cw * 4, &map, bar + s,
                    c0 - t.rd, static_cast<int>(n0), policy);
    }
  };

  int cu = grab();  // the unit the walk is in
  if (cu >= 0) {
    int iu = cu, nu = -1, ist = 0, issued = 0;  // the unit and stage issued next
    bool more = true;
    auto advance = [&]() {
      if (++ist == per_unit) {
        ist = 0;
        iu = nu = grab();
        more = iu >= 0;
      }
    };
    for (int s = 0; s < K && more; ++s, ++issued) {
      issue(s, iu, ist);
      advance();
    }
    Slots sl;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sl.cur[i] = kNoRow | kNoRow << 16;
      sl.se[i] = sl.so[i] = sl.ve[i] = sl.vo[i] = 0.0f;
    }
    int consumed = 0, cst = 0, s = 0;
    uint32_t phase = 0;
    while (consumed < issued) {
      hop::mbar_wait(bar + s, phase);
      const int64_t base = static_cast<int64_t>(cu) * kUnit + cst * kRun;
      const bool staged = p.tma && base + static_cast<int64_t>(G - 1) * part + kRun <= N;
      const int64_t n0 = base + static_cast<int64_t>(gq) * part;
      const int64_t left = N - n0;
      const int count = !on || left <= 0 ? 0 : left < kRun ? static_cast<int>(left) : kRun;
      unsigned char* box = boxes + (warp * K + s) * kBoxBytes;
      const unsigned char* xd = xd_rows + ((warp * K + s) * G + gq) * kRowBytes;
      const float* su;
      int ustride;
      if (dens) {
        su = staged ? reinterpret_cast<const float*>(xd + kRun * 12) : dsigma + n0;
        ustride = 1;
      } else {
        su = staged ? reinterpret_cast<const float*>(box + gq * kRun * cw * 4) + glane
                    : dapp + n0 * t.ra + c;
        ustride = staged ? cw : t.ra;
      }
      // the vote: bit g * kRun + k of liveg (the same in every lane) when
      // sample k of group g has a non-zero word
      float u[kRun];
      unsigned liveg = 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        u[k] = k < count ? su[k * ustride] : 0.0f;
        const unsigned vote = __ballot_sync(0xffffffffu, u[k] != 0.0f);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < G && (vote >> (g * cw) & cols) != 0) liveg |= 1u << (g * kRun + k);
      }
      if (liveg != 0) {
        // the words are in registers: the box takes the corners of the live
        // samples, a lane a (group, sample, axis)
        __syncwarp();
        uint4* rec = reinterpret_cast<uint4*>(box);  // [G][kRun][3]
        for (int r = lane; r < G * kRun * 3; r += 32) {
          const int gk = r / 3, i = r - 3 * gk;
          if (!((liveg >> gk) & 1)) continue;
          const int g = gk / kRun, k = gk - g * kRun;
          const float* gx = staged ? reinterpret_cast<const float*>(
                                         xd_rows + ((warp * K + s) * G + g) * kRowBytes)
                                   : xyz + 3 * (base + static_cast<int64_t>(g) * part);
          rec[gk * 3 + i] = slot_record(corner(gx[3 * k + 2 - i], t.L[i]));
        }
        __syncwarp();
        const unsigned live = on ? (liveg >> (gq * kRun)) & ((1u << kRun) - 1) : 0u;
        if (live) {
          const uint4* grec = rec + gq * kRun * 3;
          // the line words of the rows the live samples' slots enter (rows
          // other than the previous live sample's), loaded for the whole
          // stage at once; a slot's word is kept while its row stays
          float fresh[kRun][3][2];
          uint32_t prev[3] = {sl.cur[0], sl.cur[1], sl.cur[2]};
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            if (!((live >> k) & 1)) continue;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const uint32_t rows = grec[3 * k + i].x;
              const uint32_t d = rows ^ prev[i];
              if (d & 0xffffu)
                fresh[k][i][0] = __ldg(lines[i] + static_cast<int64_t>(rows & 0xffffu) * stride);
              if (d >> 16)
                fresh[k][i][1] = __ldg(lines[i] + static_cast<int64_t>(rows >> 16) * stride);
              prev[i] = rows;
            }
          }
          walk(sl, grec, live, u, fresh, acc, off, cw);
        }
        // the box was written through the generic proxy: order that before
        // the bulk copy that refills it
        hop::fence_proxy_async();
      }
      __syncwarp();  // the slot read: refill it
      ++consumed;
      if (++cst == per_unit) {  // the unit's end: its sums into the block's
        cst = 0;
        if (on) flush(sl, acc, off, cw);
        cu = nu;
      }
      if (more) {
        issue(s, iu, ist);
        ++issued;
        advance();
      }
      if (++s == K) {
        s = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < total; e += kThreads) {
    const float v = acc[e];
    if (v == 0.0f) continue;
    const int cg = c0 + (e & (cw - 1));
    if (cg >= p.col_hi) continue;
    int r = e >> log_cw, i = 0;
    if (r >= t.L[0]) {
      r -= t.L[0];
      i = 1;
      if (r >= t.L[1]) {
        r -= t.L[1];
        i = 2;
      }
    }
    const bool dn = cg < t.rd;
    float* grad = dn ? gr.density[i] : gr.app[i];
    if (grad == nullptr) continue;
    atomicAdd(grad + static_cast<int64_t>(r) * (dn ? t.rd : t.ra) + (dn ? cg : cg - t.rd), v);
  }
}

// dapp [N, Ra] float32 read in boxes of kRun rows x cw columns, no
// swizzle; rows past N and columns past Ra read as zeros
bool upstream_map(CUtensorMap* map, const void* dapp, long long n, int ra, int cw) {
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ra), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ra) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cw), static_cast<cuuint32_t>(kRun)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(dapp), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace bwd

namespace cgrad {

constexpr int kWarps = 12;                // warps a block, each walking on its own; one block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRun = 8;                // samples a stage, at most (the host's plan: 8 or 4)
constexpr int kUnit = 64;                 // samples a warp takes from the queue
constexpr int kWords = 3;                 // words a lane takes in a pass over the ranks
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kRecordBytes = 3 * 16;      // a sample's corner records, one an axis
constexpr uint32_t kNoKey = 0xffffffffu;  // a slot that holds no row
constexpr uint32_t kOut = 0x80000000u;    // a slot key's flag: the corner lies outside
static_assert(kMaxStages * kMaxRun <= kUnit, "the ring runs at most one unit ahead");

// The host's split of the work.
struct Plan {
  int run;          // samples a stage: 8, or 4 for wide appearance ranks
  int stages;       // ring depth a warp
  int stage_bytes;  // a stage's xyz, dsigma and dapp rows: run * (16 + 4 Ra)
  int tma;          // stages bulk-copied into the rings (else read from device memory)
  int units;        // units of kUnit samples
};

// Shared memory of a block: each warp's ring of stages (its xyz, dsigma
// and dapp rows), then each warp's corner records, then the barriers. The
// host's plan (ops/cp_features.py: coords_smem) counts the same.
__host__ __device__ inline long long smem_bytes(int ra, int run, int stages) {
  return static_cast<long long>(kWarps) *
         (stages * (static_cast<long long>(run) * (16 + 4LL * ra) + 8) + kMaxRun * kRecordBytes);
}

// A sample's corners on one axis as the walk takes them: x and y the keys
// of slot e (the even corner's row) and slot o (the odd one's), each with
// kOut set where its corner is flagged out (the slot's words are then
// zeros: a flag that changes reloads the slot, as a row does); z the odd
// slot's weight, so that the lerp is ve + (vo - ve) * wo; w the axis's
// factor (L - 1) / 2, negated where the odd slot holds the lower corner
// (vo - ve is then f0 - f1, not the derivative f1 - f0)
__device__ __forceinline__ uint4 record(const Corner& c, int L) {
  const bool even = (c.i0 & 1) == 0;
  const uint32_t ke = static_cast<uint32_t>(even ? c.r0 : c.r1) |
                      ((even ? c.m0 : c.m1) != 0.0f ? 0u : kOut);
  const uint32_t ko = static_cast<uint32_t>(even ? c.r1 : c.r0) |
                      ((even ? c.m1 : c.m0) != 0.0f ? 0u : kOut);
  const float scale = 0.5f * static_cast<float>(L - 1);
  return make_uint4(ke, ko, __float_as_uint(even ? c.w : c.omw),
                    __float_as_uint(even ? scale : -scale));
}

// VEC floats at p, in shared memory (a ring's stage) or device memory
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_any(const float* p) {
  Vec<VEC> x;
  if (VEC == 1) {
    x.v[0] = *p;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x.v[0] = q.x;
    x.v[1] = q.y;
    x.v[2] = q.z;
    x.v[3] = q.w;
  }
  return x;
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> zero_vec() {
  Vec<VEC> x;
#pragma unroll
  for (int e = 0; e < VEC; ++e) x.v[e] = 0.0f;
  return x;
}

template <int VEC>
__device__ __forceinline__ bool nonzero(const Vec<VEC>& x) {
  bool nz = false;
#pragma unroll
  for (int e = 0; e < VEC; ++e) nz |= x.v[e] != 0.0f;
  return nz;
}

// Word w of a sample's ranks (density words first) of line i at the row
// of slot key `key`: zeros where the corner is flagged out or the word is
// past the ranks
template <int VEC>
__device__ __forceinline__ Vec<VEC> slot_word(const Lines& t, int i, uint32_t key, int w, int wd,
                                              int words) {
  if ((key & kOut) || w >= words) return zero_vec<VEC>();
  const bool dens = w < wd;
  const float* line = dens ? t.density[i] : t.app[i];
  const int64_t stride = dens ? t.rd : t.ra;
  return load_vec<VEC>(line + static_cast<int64_t>(key) * stride + (dens ? w : w - wd) * VEC);
}

// Each warp takes units of kUnit samples from the queue (an int32, zeroed
// by the host) until they run out, and streams each unit's stages of
// p.run samples through its own ring of p.stages slots: lane 0 bulk-copies
// a stage's xyz, dsigma and dapp rows (contiguous) under L2's evict-first
// policy, or arrives with no bytes where the lanes read the stage from
// device memory (the stage a call ends in, and every stage off the ring's
// route). For each stage: one vote a sample on its whole upstream row (each
// word read once); a stage with no live sample stores its zeros; otherwise
// lanes compute each live sample's three corner records once, and the warp
// walks the live samples in order, a lane taking kWords words of the ranks
// a pass (float4 or float, density words first) and keeping each axis's
// two slot words in registers, loading a slot's row only when its key
// changes; a sample's lane sums (in rank order) meet in a fixed shuffle
// tree. No atomics: repeats are bit-equal, and a sample with no upstream
// is exactly 0.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    cp_coords_grad_kernel(const float* __restrict__ xyz, const float* __restrict__ dsigma,
                          const float* __restrict__ dapp, const __grid_constant__ Lines t,
                          const __grid_constant__ Plan p, int64_t N, float* __restrict__ dxyz,
                          int* __restrict__ queue) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.stages, run = p.run, ra = t.ra;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ring_bytes = kWarps * K * p.stage_bytes;
  unsigned char* ring = smem + warp * K * p.stage_bytes;                       // [K][stage_bytes]
  uint4* rec = reinterpret_cast<uint4*>(smem + ring_bytes) + warp * kMaxRun * 3;  // [run][3]
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + ring_bytes + kWarps * kMaxRun * kRecordBytes) + warp * K;
  if (lane == 0) {
    for (int s = 0; s < K; ++s) hop::mbar_init(bar + s, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();

  const int wd = t.rd / VEC, words = wd + ra / VEC;  // words of a sample's ranks
  const int passes = (words + 32 * kWords - 1) / (32 * kWords);
  const int per_unit = kUnit / run;
  const uint64_t policy = bwd::evict_first();

  auto grab = [&]() {  // the next unit of the queue, or -1
    int u = 0;
    if (lane == 0) u = atomicAdd(queue, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    return u < p.units ? u : -1;
  };
  // the bulk copies of stage st of unit into slot s, by lane 0 (none when
  // the stage is read from device memory)
  auto issue = [&](int s, int unit, int st) {
    if (lane != 0) return;
    const int64_t n0 = static_cast<int64_t>(unit) * kUnit + st * run;
    const bool staged = p.tma && n0 + run <= N;
    hop::mbar_arrive_expect_tx(bar + s, staged ? static_cast<uint32_t>(p.stage_bytes) : 0u);
    if (!staged) return;
    unsigned char* dst = ring + s * p.stage_bytes;
    hop::bulk_load(dst, xyz + 3 * n0, run * 12, bar + s, policy);
    hop::bulk_load(dst + run * 12, dsigma + n0, run * 4, bar + s, policy);
    if (ra) hop::bulk_load(dst + run * 16, dapp + n0 * ra, run * ra * 4, bar + s, policy);
  };

  int cu = grab();  // the unit being consumed
  if (cu < 0) return;
  int iu = cu, nu = -1, ist = 0, issued = 0;  // the unit and stage issued next
  bool more = true;
  auto advance = [&]() {
    if (++ist == per_unit) {
      ist = 0;
      iu = nu = grab();
      more = iu >= 0;
    }
  };
  for (int s = 0; s < K && more; ++s, ++issued) {
    issue(s, iu, ist);
    advance();
  }
  // a lane's slots: each axis's keys and words, kept while the keys hold
  uint32_t ke[3], ko[3];
  Vec<VEC> ve[3][kWords], vo[3][kWords];
  auto forget = [&]() {
#pragma unroll
    for (int i = 0; i < 3; ++i) ke[i] = ko[i] = kNoKey;
  };
  forget();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < kWords; ++j) ve[i][j] = vo[i][j] = zero_vec<VEC>();

  int consumed = 0, cst = 0, s = 0;
  uint32_t phase = 0;
  while (consumed < issued) {
    hop::mbar_wait(bar + s, phase);
    const int64_t n0 = static_cast<int64_t>(cu) * kUnit + cst * run;
    const bool staged = p.tma && n0 + run <= N;
    const int64_t left = N - n0;
    const int count = left <= 0 ? 0 : left < run ? static_cast<int>(left) : run;
    const unsigned char* slot = ring + s * p.stage_bytes;
    const float* sx = staged ? reinterpret_cast<const float*>(slot) : xyz + 3 * n0;
    const float* sd = staged ? reinterpret_cast<const float*>(slot + run * 12) : dsigma + n0;
    const float* sa = !ra ? nullptr
                          : staged ? reinterpret_cast<const float*>(slot + run * 16)
                                   : dapp + n0 * ra;
    // the vote: bit k of live when sample k has a non-zero word
    unsigned live = 0;
    for (int k = 0; k < count; ++k) {
      bool nz = sd[k] != 0.0f;
      for (int w = lane; w < ra / VEC; w += 32) nz |= nonzero<VEC>(load_any<VEC>(sa + k * ra + w * VEC));
      if (__any_sync(0xffffffffu, nz)) live |= 1u << k;
    }
    float out = 0.0f;  // lane 3 k + c: coordinate c of sample k
    if (live != 0) {
      // corners once a block: a lane a live sample and axis
      if (lane < 3 * count) {
        const int k = lane / 3, i = lane - 3 * k;
        if ((live >> k) & 1) rec[lane] = record(corner(sx[3 * k + 2 - i], t.L[i]), t.L[i]);
      }
      __syncwarp();
      for (int ps = 0; ps < passes; ++ps) {
        const int w0 = ps * 32 * kWords + lane;  // the lane's word j is w0 + 32 j
        if (passes > 1) forget();
        for (int k = 0; k < count; ++k) {
          if (!((live >> k) & 1)) continue;
          uint4 q[3];
          float wo[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            q[i] = rec[3 * k + i];
            wo[i] = __uint_as_float(q[i].z);
            if (q[i].x != ke[i]) {
              ke[i] = q[i].x;
#pragma unroll
              for (int j = 0; j < kWords; ++j)
                ve[i][j] = slot_word<VEC>(t, i, q[i].x, w0 + 32 * j, wd, words);
            }
            if (q[i].y != ko[i]) {
              ko[i] = q[i].y;
#pragma unroll
              for (int j = 0; j < kWords; ++j)
                vo[i][j] = slot_word<VEC>(t, i, q[i].y, w0 + 32 * j, wd, words);
            }
          }
          const float us = sd[k];
          float a[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int w = w0 + 32 * j;
            Vec<VEC> u;
            if (w >= words) {
              u = zero_vec<VEC>();
            } else if (w < wd) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) u.v[e] = us;
            } else {
              u = load_any<VEC>(sa + k * ra + (w - wd) * VEC);
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              float d[3], l[3];
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                d[i] = vo[i][j].v[e] - ve[i][j].v[e];
                l[i] = fmaf(d[i], wo[i], ve[i][j].v[e]);
              }
              // autograd's order through ((l0 * l1) * l2)
              const float u2 = u.v[e] * l[2];
              a[0] = fmaf(u2 * l[1], d[0], a[0]);
              a[1] = fmaf(u2 * l[0], d[1], a[1]);
              a[2] = fmaf(u.v[e] * (l[0] * l[1]), d[2], a[2]);
            }
          }
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
            if (lane == 3 * k + 2 - i) out += a[i];
          }
        }
      }
      if (lane < 3 * count) {
        const int k = lane / 3, i = 2 - (lane - 3 * k);
        out = (live >> k) & 1 ? out * __uint_as_float(rec[3 * k + i].w) : 0.0f;
      }
      __syncwarp();  // the records read before the next stage's are written
    }
    if (lane < 3 * count) dxyz[3 * n0 + lane] = out;
    __syncwarp();  // the slot read: refill it
    ++consumed;
    if (++cst == per_unit) {  // the unit's end: the next unit's rows are others
      cst = 0;
      cu = nu;
      forget();
    }
    if (more) {
      issue(s, iu, ist);
      ++issued;
      advance();
    }
    if (++s == K) {
      s = 0;
      phase ^= 1;
    }
  }
}

}  // namespace cgrad

namespace fwd {

constexpr int kWarps = 16;                   // warps a block, one block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 32;                   // samples of a warp's stage: one a lane's corners
constexpr int kUnit = 32;                    // samples a warp walks before it moves on
constexpr int kStages = kUnit / kStage;      // stages a unit
constexpr int kRecordBytes = 3 * 16;         // a sample's corner records, one an axis
static_assert(kUnit % kStage == 0, "a unit is whole stages");

// The host's split of the work.
struct Plan {
  int log_cw;  // columns a block: cw = 1 << log_cw
  int rows;    // L_0 + L_1 + L_2, below 65 535 (a record's rows are 16-bit)
  int units;   // units of kUnit samples
};

// Shared memory of a block: each warp's corner records of a stage, then
// the slice of the three lines. The host's plan (ops/cp_features.py:
// forward_smem) counts the same.
__host__ __device__ inline long long smem_bytes(int rows, int log_cw) {
  return static_cast<long long>(kWarps) * kStage * kRecordBytes +
         static_cast<long long>(rows) * (4 << log_cw);
}

// W floats src -> dst through cp.async (complete at copy_wait)
template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src);

template <>
__device__ __forceinline__ void copy_async<1>(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hop::smem_u32(dst)), "l"(src)
               : "memory");
}

template <>
__device__ __forceinline__ void copy_async<4>(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hop::smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A sample's corners on axis i as the walk takes them: the byte offsets in
// the block's slice of its two rows by slot parity (slot e, the even
// corner's, then slot o; the slice's rows of axis i start at row off),
// then their flagged weights
__device__ __forceinline__ uint4 walk_record(const Corner& c, uint32_t off, int log_row_bytes) {
  const uint4 r = bwd::slot_record(c);
  return make_uint4((off + (r.x & 0xffffu)) << log_row_bytes, (off + (r.x >> 16)) << log_row_bytes,
                    r.y, r.z);
}

// A lane's words of a row of the slice: VEC floats, as VEC / 4 float4
// words kHalf columns apart (16-byte aligned) or one float
template <int VEC, int kHalf>
__device__ __forceinline__ Vec<VEC> load_shared(const unsigned char* p) {
  Vec<VEC> x;
  if (VEC == 1) {
    x.v[0] = *reinterpret_cast<const float*>(p);
  } else {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 q = *reinterpret_cast<const float4*>(p + h * kHalf * 4);
      x.v[4 * h] = q.x;
      x.v[4 * h + 1] = q.y;
      x.v[4 * h + 2] = q.z;
      x.v[4 * h + 3] = q.w;
    }
  }
  return x;
}

// Word h of a lane's products to p + h * kHalf where app_word[h], through
// st.global.cs: no one reads them back here, so L2 evicts them first and
// keeps the coordinates, which every slice reads
template <int VEC, int kHalf>
__device__ __forceinline__ void store_stream(float* p, const Vec<VEC>& x, const bool* app_word) {
  if (VEC == 1) {
    if (app_word[0]) __stcs(p, x.v[0]);
  } else {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h)
      if (app_word[h])
        __stcs(reinterpret_cast<float4*>(p + h * kHalf),
               make_float4(x.v[4 * h], x.v[4 * h + 1], x.v[4 * h + 2], x.v[4 * h + 3]));
  }
}

// Block (x, y) owns the columns x * cw .. + cw - 1 (density ranks, then
// appearance ranks); its warp w walks units y * kWarps + w, then every
// gridDim.y * kWarps-th after it, so that all slices walk the same
// stretch of samples at the same time. A sample's group is R = 1 << LW lanes,
// VEC columns each (one float, or float4 words: with two, a group's first
// words are the slice's first half, so that each store fills whole 32-byte
// sectors); a warp holds G = 32 / R groups. Each unit splits into G parts
// of consecutive samples, one a group, walked R samples a stage. part: the
// density slices' sums of their columns [slices with a density column][N]
// (sigma itself when there is one such slice).
template <int VEC, int LW>
__global__ void __launch_bounds__(kThreads, 1)
    cp_features_fwd_kernel(const float* __restrict__ xyz, const __grid_constant__ Lines t,
                           const __grid_constant__ Plan p, float* __restrict__ part,
                           float* __restrict__ app, int64_t N) {
  constexpr int R = 1 << LW;        // lanes a sample, samples a group walks a stage
  constexpr int G = 32 >> LW;       // groups a warp
  constexpr int kPart = kUnit / G;  // a group's part of a unit
  constexpr int W = VEC == 1 ? 1 : 4;  // floats a word
  constexpr int kHalf = (VEC << LW) / (VEC / W);  // columns between a lane's words
  extern __shared__ __align__(128) unsigned char smem[];
  const int log_cw = p.log_cw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* rec = reinterpret_cast<uint4*>(smem) + warp * kStage * 3;  // [R][3][G]
  float* lines = reinterpret_cast<float*>(smem + kWarps * kStage * kRecordBytes);  // [rows][cw]
  const int c0 = static_cast<int>(blockIdx.x) << log_cw;
  const int ncols = t.rd + t.ra;

  // the slice of the three lines, loaded once (zeros past the last column)
  const int log_words = log_cw - (W == 4 ? 2 : 0);
  for (int e = threadIdx.x; e < p.rows << log_words; e += kThreads) {
    int row = e >> log_words, i = 0;
    const int col = c0 + (e & ((1 << log_words) - 1)) * W;
    if (row >= t.L[0]) {
      row -= t.L[0];
      i = 1;
      if (row >= t.L[1]) {
        row -= t.L[1];
        i = 2;
      }
    }
    float* dst = lines + e * W;
    if (col >= ncols) {
#pragma unroll
      for (int v = 0; v < W; ++v) dst[v] = 0.0f;
    } else if (col < t.rd) {
      copy_async<W>(dst, t.density[i] + static_cast<int64_t>(row) * t.rd + col);
    } else {
      copy_async<W>(dst, t.app[i] + static_cast<int64_t>(row) * t.ra + (col - t.rd));
    }
  }
  copy_wait();
  __syncthreads();

  const int grp = lane >> LW, glane = lane & (R - 1);
  const int col = c0 + glane * W;  // the lane's first column; word h at col + h * kHalf
  bool dens[VEC / W], app_word[VEC / W];
#pragma unroll
  for (int h = 0; h < VEC / W; ++h) {
    dens[h] = col + h * kHalf < t.rd;
    app_word[h] = !dens[h] && col + h * kHalf < ncols;
  }
  const bool slice_dens = c0 < t.rd;
  const bool stores = app_word[0] || app_word[VEC / W - 1];
  const unsigned char* mine = reinterpret_cast<const unsigned char*>(lines + glane * W);
  const uint32_t off[3] = {0u, static_cast<uint32_t>(t.L[0]),
                           static_cast<uint32_t>(t.L[0] + t.L[1])};

  const int step = static_cast<int>(gridDim.y) * kWarps;  // units between a warp's
  // the coordinates of the sample whose corners this lane computes at
  // stage st of unit u: sample glane of group grp's stage (zeros past N)
  auto fetch = [&](int64_t u, int st, float (&x)[3]) {
    const int64_t n = u * kUnit + grp * kPart + st * R + glane;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = 0.0f;
    if (n < N) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = __ldg(xyz + 3 * n + c);
    }
  };

  // a lane's slots: for each axis the rows (as a record's offsets) and
  // their words, kept while the rows hold
  uint32_t ce[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  uint32_t co[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  Vec<VEC> ve[3], vo[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ve[i].v[e] = vo[i].v[e] = 0.0f;

  int64_t u = static_cast<int64_t>(blockIdx.y) * kWarps + warp;
  float x[3];
  fetch(u, 0, x);
  for (; u < p.units; u += step) {
    const int64_t nu = u + step;
    for (int st = 0; st < kStages; ++st) {
      const float g[3] = {x[0], x[1], x[2]};
      if (st + 1 < kStages)
        fetch(u, st + 1, x);
      else
        fetch(nu, 0, x);
      // corners once a block: each lane's sample's three, as the walk
      // takes them (rows into the slice by slot parity, flagged weights)
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 3; ++i)
        rec[(glane * 3 + i) * G + grp] = walk_record(corner(g[2 - i], t.L[i]), off[i], log_cw + 2);
      __syncwarp();
      // the walk: sample by sample, a slot's words loaded from the slice
      // only when its row changes
      const int64_t n0 = u * kUnit + grp * kPart + st * R;
      const int live = N - n0 < R ? static_cast<int>(N - n0) : R;  // samples before N
      float* o = stores ? app + n0 * t.ra + (col - t.rd) : nullptr;
      float* ps = part + static_cast<int64_t>(blockIdx.x) * N + n0;
#pragma unroll 8
      for (int k = 0; k < R; ++k) {
        Vec<VEC> prod;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint4 q = rec[(k * 3 + i) * G + grp];
          if (q.x != ce[i]) ve[i] = load_shared<VEC, kHalf>(mine + q.x);
          if (q.y != co[i]) vo[i] = load_shared<VEC, kHalf>(mine + q.y);
          ce[i] = q.x;
          co[i] = q.y;
          const float we = __uint_as_float(q.z), wo = __uint_as_float(q.w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float l = __fadd_rn(__fmul_rn(ve[i].v[e], we), __fmul_rn(vo[i].v[e], wo));
            prod.v[e] = i == 0 ? l : __fmul_rn(prod.v[e], l);
          }
        }
        if (slice_dens) {  // the group's density columns summed in a fixed tree
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (dens[e / W]) s = __fadd_rn(s, prod.v[e]);
#pragma unroll
          for (int h = R >> 1; h > 0; h >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, h));
          if (glane == 0 && k < live) __stcs(ps + k, s);
        }
        if (o != nullptr && k < live) store_stream<VEC, kHalf>(o, prod, app_word);
        if (o != nullptr) o += t.ra;
      }
    }
  }
}

// sigma[n]: the density slices' sums of sample n, added in slice order
__global__ void __launch_bounds__(256)
    cp_sigma_sum_kernel(const float* __restrict__ part, float* __restrict__ sigma, int slices,
                        int64_t N) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; n < N;
       n += step) {
    float s = part[n];
    for (int j = 1; j < slices; ++j) s = __fadd_rn(s, part[j * N + n]);
    sigma[n] = s;
  }
}

template <int VEC, int LW>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const float* xyz, const Lines& t,
                   const Plan& p, float* part, float* app, int64_t N) {
  auto* kernel = cp_features_fwd_kernel<VEC, LW>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(xyz, t, p, part, app, N);
  return cudaGetLastError();
}

}  // namespace fwd

bool make_lines(const long long* ptrs, const int* dims, Lines& t) {
  for (int i = 0; i < 3; ++i) {
    t.density[i] = reinterpret_cast<const float*>(ptrs[i]);
    t.app[i] = reinterpret_cast<const float*>(ptrs[3 + i]);
    t.L[i] = dims[i];
    if (t.L[i] <= 0) return false;
  }
  t.rd = dims[3];
  t.ra = dims[4];
  return t.rd >= 0 && t.ra >= 0 && t.rd + t.ra > 0;
}

int log_group(int words) {
  int log_g = 0;
  while ((1 << log_g) < words && log_g < 5) ++log_g;
  return log_g;
}

int grid_of(int64_t N, int log_g, int sms) {
  const int64_t per_block = static_cast<int64_t>(kThreads / 32) * (32 >> log_g) * kRun;
  const int64_t want = (N + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace cp
}  // namespace iff

// The forward: xyz [N, 3] float32 normalized coords; ptrs: the density
// lines then the app lines of the 3 axes as device addresses (float32,
// contiguous [L_i, R]; the app ones 0 for density only); dims: (L_0, L_1,
// L_2, Rd, Ra), Rd or Ra 0 for a kind not computed. sigma [N] float32 or
// null (Rd 0); app [N, Ra] float32 or null (Ra 0). vec: the columns a lane
// takes, 1 or 8 (8: Rd and Ra multiples of 8, every pointer 16-byte
// aligned, two float4 words; at most 1 << log_cw). log_cw: log2 of the
// columns a block owns (the records and the slice of the three lines,
// fwd::smem_bytes, at most 227 KB; L_0 + L_1 + L_2 below 65 535); chunks:
// blocks a column slice (grid y); part: a [ceil(Rd / cw), N] float32
// scratch of the density slices' sums when Rd > cw (else unused: the one
// density slice writes sigma), added into sigma in slice order by a second
// kernel; sms the card's SM count. Returns a cudaError_t; N == 0 launches
// nothing.
extern "C" int iff_cp_features(const void* xyz, long long N, const long long* ptrs,
                               const int* dims, void* sigma, void* app, int vec, int log_cw,
                               int chunks, void* part, int sms, void* stream) {
  namespace c = iff::cp;
  namespace f = iff::cp::fwd;
  c::Lines t;
  if (N < 0 || sms <= 0 || !c::make_lines(ptrs, dims, t) || (vec != 1 && vec != 8) ||
      t.rd % vec || t.ra % vec || (t.rd > 0) != (sigma != nullptr) ||
      (t.ra > 0) != (app != nullptr) || log_cw < 0 || log_cw > 5 || (1 << log_cw) < vec ||
      chunks <= 0 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  f::Plan p;
  p.log_cw = log_cw;
  p.rows = t.L[0] + t.L[1] + t.L[2];
  const int cw = 1 << log_cw;
  const int slices = (t.rd + t.ra + cw - 1) / cw, dens_slices = (t.rd + cw - 1) / cw;
  const long long units = (N + f::kUnit - 1) / f::kUnit;
  const long long smem = f::smem_bytes(p.rows, log_cw);
  if (p.rows >= 0xffff || units > INT_MAX || smem > c::kMaxSmem ||
      (dens_slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  p.units = static_cast<int>(units);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  float* sums = dens_slices > 1 ? static_cast<float*>(part) : static_cast<float*>(sigma);
  auto* a = static_cast<float*>(app);
  const dim3 grid(slices, chunks);
  const int sm = static_cast<int>(smem);
  cudaError_t rc;
  switch (vec * 8 + log_cw) {
    case 64 + 3: rc = f::launch<8, 0>(grid, sm, s, x, t, p, sums, a, N); break;
    case 64 + 4: rc = f::launch<8, 1>(grid, sm, s, x, t, p, sums, a, N); break;
    case 64 + 5: rc = f::launch<8, 2>(grid, sm, s, x, t, p, sums, a, N); break;
    case 8 + 0: rc = f::launch<1, 0>(grid, sm, s, x, t, p, sums, a, N); break;
    case 8 + 1: rc = f::launch<1, 1>(grid, sm, s, x, t, p, sums, a, N); break;
    case 8 + 2: rc = f::launch<1, 2>(grid, sm, s, x, t, p, sums, a, N); break;
    case 8 + 3: rc = f::launch<1, 3>(grid, sm, s, x, t, p, sums, a, N); break;
    case 8 + 4: rc = f::launch<1, 4>(grid, sm, s, x, t, p, sums, a, N); break;
    default: rc = f::launch<1, 5>(grid, sm, s, x, t, p, sums, a, N); break;
  }
  if (rc != cudaSuccess || dens_slices <= 1) return static_cast<int>(rc);
  const long long want = (N + 255) / 256, cap = static_cast<long long>(sms) * 8;
  f::cp_sigma_sum_kernel<<<static_cast<int>(want < cap ? want : cap), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(sigma), dens_slices, N);
  return static_cast<int>(cudaGetLastError());
}

// The forward's first design, for lines too long for a column slice in
// shared memory: arguments as iff_cp_features takes them, without the
// plan. Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_cp_features_l1(const void* xyz, long long N, const long long* ptrs,
                                  const int* dims, void* sigma, void* app, int vec, int sms,
                                  void* stream) {
  namespace c = iff::cp;
  c::Lines t;
  if (N < 0 || sms <= 0 || !c::make_lines(ptrs, dims, t) || (vec && (t.rd % 4 || t.ra % 4)) ||
      (t.rd > 0) != (sigma != nullptr) || (t.ra > 0) != (app != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const int v = vec ? 4 : 1;
  const int log_g = c::log_group((t.rd + t.ra) / v);
  const int blocks = c::grid_of(N, log_g, sms);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  if (vec)
    c::cp_features_kernel<4><<<blocks, c::kThreads, 0, s>>>(
        x, t, static_cast<float*>(sigma), static_cast<float*>(app), N, log_g);
  else
    c::cp_features_kernel<1><<<blocks, c::kThreads, 0, s>>>(
        x, t, static_cast<float*>(sigma), static_cast<float*>(app), N, log_g);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of sum(sigma * dsigma) + sum(app * dapp) with respect to the
// lines. xyz, ptrs and dims as iff_cp_features takes them (each L_i below
// 65 535); gptrs: the gradient lines in the same order (float32 [L_i, R],
// zeroed by the caller; 0 for a line not wanted); dsigma [N] and dapp
// [N, Ra] float32 (either null when its kind is not wanted). Columns: the
// density ranks when want_density, the appearance ranks when want_app.
// log_cw: log2 of the columns a block owns; stages: each warp's ring depth
// (2 to 4; the block's shared memory, bwd::smem_bytes, at most 227 KB);
// chunks: blocks a column slice (grid y); queue: an int32 a slice, zeroed.
// Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_cp_features_bwd(const void* xyz, long long N, const long long* ptrs,
                                   const long long* gptrs, const int* dims,
                                   const void* dsigma, const void* dapp, int want_density,
                                   int want_app, int log_cw, int stages, int chunks, void* queue,
                                   void* stream) {
  namespace c = iff::cp;
  namespace b = iff::cp::bwd;
  c::Lines t;
  if (N < 0 || !c::make_lines(ptrs, dims, t) || log_cw < 0 || log_cw > 5 ||
      stages < b::kMinStages || stages > b::kMaxStages || chunks <= 0 || chunks > 65535 ||
      queue == nullptr || (want_density && !dsigma) || (want_app && (!dapp || t.ra == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i)
    if (t.L[i] >= static_cast<int>(b::kNoRow)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || (!want_density && !want_app)) return 0;
  c::Grads gr;
  for (int i = 0; i < 3; ++i) {
    gr.density[i] = want_density ? reinterpret_cast<float*>(gptrs[i]) : nullptr;
    gr.app[i] = want_app ? reinterpret_cast<float*>(gptrs[3 + i]) : nullptr;
  }
  b::Plan p;
  const int cw = 1 << log_cw;
  p.log_cw = log_cw;
  p.groups = (32 >> log_cw) < b::kMaxGroups ? (32 >> log_cw) : b::kMaxGroups;
  p.stages = stages;
  p.col_lo = want_density ? 0 : t.rd;
  p.col_hi = want_app ? t.rd + t.ra : t.rd;
  p.rows = t.L[0] + t.L[1] + t.L[2];
  const long long units = (N + b::kUnit - 1) / b::kUnit;
  const long long smem = b::smem_bytes(p.rows, log_cw, p.groups, stages);
  if (units > INT_MAX || smem > c::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  // the bulk copies take 16-byte aligned rows, whole 16-byte box rows, and
  // slices of one kind
  const auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  bool tma = cw >= 8 && N <= INT_MAX && aligned(xyz) && (!want_density || aligned(dsigma)) &&
             !(want_density && want_app && t.rd % cw != 0);
  if (tma && want_app)
    tma = aligned(dapp) && t.ra % 4 == 0 && t.ra >= cw && b::upstream_map(&map, dapp, N, t.ra, cw);
  p.tma = tma;
  const int slices = (p.col_hi - p.col_lo + cw - 1) / cw;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(b::cp_features_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(slices, chunks);
  b::cp_features_bwd_kernel<<<grid, b::kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dsigma),
      static_cast<const float*>(dapp), map, t, gr, p, N, static_cast<int*>(queue));
  return static_cast<int>(cudaGetLastError());
}

// The gradient of sum(sigma * dsigma) (+ sum(app * dapp) when Ra > 0) with
// respect to xyz: xyz, ptrs, dims and vec as iff_cp_features takes them
// (vec 4: float4 words, Rd and Ra multiples of 4, every line and dapp
// 16-byte aligned; else 0, 4-byte words); dsigma [N] float32 (Rd > 0); dapp
// [N, Ra] float32 or null (Ra 0); dxyz [N, 3] float32, written whole (zeros
// for a sample with no upstream). run: samples a stage (8 or 4); stages:
// each warp's ring depth (2 to 4; the block's shared memory,
// cgrad::smem_bytes, at most 227 KB); blocks: the grid (one block an SM);
// queue: an int32, zeroed. The rings take the stages when vec is 4 and xyz,
// dsigma and dapp are 16-byte aligned. Returns a cudaError_t; N == 0
// launches nothing.
extern "C" int iff_cp_features_coords_grad(const void* xyz, long long N, const long long* ptrs,
                                           const int* dims, const void* dsigma,
                                           const void* dapp, void* dxyz, int vec, int run,
                                           int stages, int blocks, void* queue, void* stream) {
  namespace c = iff::cp;
  namespace g = iff::cp::cgrad;
  c::Lines t;
  if (N < 0 || !c::make_lines(ptrs, dims, t) || (vec && (t.rd % 4 || t.ra % 4)) ||
      t.rd == 0 || !dsigma || (t.ra > 0) != (dapp != nullptr) || (run != 4 && run != 8) ||
      stages < g::kMinStages || stages > g::kMaxStages || blocks <= 0 || queue == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = g::smem_bytes(t.ra, run, stages);
  const long long units = (N + g::kUnit - 1) / g::kUnit;
  if (smem > c::kMaxSmem || units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  g::Plan p;
  p.run = run;
  p.stages = stages;
  p.stage_bytes = run * (16 + 4 * t.ra);
  p.units = static_cast<int>(units);
  const auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  p.tma = vec && aligned(xyz) && aligned(dsigma) && (t.ra == 0 || aligned(dapp));
  auto kernel = vec ? g::cp_coords_grad_kernel<4> : g::cp_coords_grad_kernel<1>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<blocks, g::kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dsigma),
      static_cast<const float*>(dapp), t, p, N, static_cast<float*>(dxyz),
      static_cast<int*>(queue));
  return static_cast<int>(cudaGetLastError());
}
