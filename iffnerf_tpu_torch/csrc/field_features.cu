// The TensorVMSplit field's features in one pass, for sm_90a.
//
// For each sample and each axis pair i: bilerp plane i's 4 corner rows,
// lerp line i's 2 corner rows, multiply the two, sum the density ranks into
// the sigma feature and write the appearance products. This is the work
// of compute_features_fused (iffnerf_tpu/models/field.py:394), whose TPU
// design packs each plane's 4-texel footprint into one row gathered by the
// Pallas kernel pallas_gather (extra/pallas_gather_bench.py:46). On Hopper
// the gather and the lerps are one kernel: the corner texels go to
// registers, are lerped there, and only the features are written. The
// dense route it replaces wrote every corner row to device memory and read
// it back for dozens of elementwise launches.
//
// Bound on an H100 SXM: bytes. Device memory sees the coordinates (12 B a
// sample), the sigma feature (4 B) and the appearance products (4 B a rank)
// once each, plus each plane and line row that the samples touch: 592 B a
// sample at lego's ranks, nearly all of it the appearance products. The
// first design of this kernel (a group of lanes a sample, each lane reading
// its word of all 6 corner rows of all 3 axis pairs afresh) asked L1 for
// 4.6 KB a sample and took 3.5 times the bound at a training step, whose
// samples are ray-major at half a texel a step: consecutive samples mostly
// sit in the same cell, and read the same rows again.
//
// Mapping: a block takes a span of runs of consecutive samples (a run 32
// samples at most; runs cross ray ends freely: a row is a row) in two
// passes. The cell pass, a thread a sample and axis pair, finds each
// sample's cell and slot weights and, for each of the 6 corner slots,
// whether the previous sample of its run held that corner already or the
// row to read; it leaves these 64-byte steps in shared memory. Slots go
// by the corner's parity (slot 0 of an axis holds the even corner), so a
// corner the next cell shares stays in its slot while the cell moves and
// the lerps swap the weights instead. In the word pass a group of g lanes
// walks a run for one axis pair (g the power of two that covers the widest
// pair's density + appearance words, capped at 32: g = 16 at lego's ranks
// 16 + 48 in float4 words, 4 density-only; a pair wider than g takes more
// groups, a run's `parts`). Lanes take neighbouring 16-byte (float4, when
// every rank is a multiple of 4 and every table 16-byte aligned) or 4-byte
// words, the density ranks first, and keep their word of the 6 slots in
// registers: a sample reads only the corners its cell enters (a straight
// ray enters each row once), then lerps and stores its appearance products
// (coalesced, 192 B a pair at lego's ranks, under L2's evict-first policy:
// basis_mat reads them once, and the table rows other rays come back to
// stay longer). The density products' lane sums meet in shared memory and
// a last pass adds them in a fixed order. Resident blocks stride over the
// spans; the host halves the run until each has 4 spans, so that a small
// call still fills the card.
//
// What holds it at a 299^3 training step, from cut-out variants
// (tools/ff_time.py): about 1 ms of instructions (the lerps' 13 rounded
// operations a float, the slot reads and the stores around them, the cell
// pass), and on top of it, not hidden under it, memory traffic: the
// products, and the rows the cells enter, which many rays share but which
// return from far down the memory hierarchy (lego's tables are 69 MB, more
// than L2, a row's next ray comes long after it was read, and the time
// falls as the tables' footprint shrinks).
//
// Numerics are the grid samplers' (ops/grid_sample.py): align_corners=True,
// zeros padding, the lower corner floor(p) as an int with both corners
// clamped and flagged, a flagged-out texel multiplied by 0 (a flag belongs
// to the corner, so a slot keeps its word multiplied). Every product and
// sum of the lerps is rounded on its own (__fmul_rn, __fadd_rn: no FMA
// contraction) in the samplers' order, so the appearance products equal the
// plain route's; only sigma's sum over ranks runs in another order.
//
// The backward (field_features_bwd_kernel, iff_field_features_bwd) is the
// gradient of the same function with respect to the 12 tables: w_corner *
// line * g into each plane corner texel and w_corner * plane * g into each
// line corner texel, g the upstream word (dsigma for the density ranks,
// dapp for the appearance ranks). The JAX package differentiates this work
// in XLA (a sorted scatter-add and a one-hot product,
// iffnerf_tpu/ops/packed_sample.py:234-305), not in a Pallas kernel.
//
// Bound on an H100 SXM: bytes, and nearly all of them the upstream read:
// a training step's dapp is 576 B a sample at lego's ranks (2.44 GB at a
// 300^3 step), most of it zeros (samples outside the AABB or the alpha
// mask, or below the appearance threshold), and each word has to be read
// to know. The touched rows of the tables and of their gradients are a
// few MB. The first design of this backward kept the forward's first mapping
// (a group of lanes a sample, one float4 atomicAdd into each of the 6
// corners a word) and took 4.2 times the bound: training samples are
// ray-major at half a texel a step, so consecutive samples add into the
// same few rows, and those same-address atomics from neighbouring groups
// and warps serialise in L2.
//
// The design here: a group of g lanes (a lane a word of one axis pair, as
// in the forward) walks a run of kRunSamples consecutive samples in order
// and keeps, in registers, the words of its 4 plane and 2 line corner rows
// and a running sum for each. Only when a row leaves the sample's
// footprint (the cell moved; a row that carries over to the next cell
// keeps its sum) and at the end of the run does it add the sum into the
// gradient table, with one float4 (or scalar) atomicAdd whose result is
// unused (a RED). A straight ray leaves each row once, so a run adds into
// a row once. A sample whose upstream words are all zero for the group (a
// warp vote) neither adds nor moves the cell. Runs cross ray boundaries
// freely: a row is a row. A warp-specialised block streams the upstream:
// one producer warp bulk-copies each stage's xyz, dsigma and dapp rows
// (contiguous for a run) into a kStages-deep mbarrier ring in shared
// memory, under an L2 policy that evicts them first, and the consumer
// warps read them from there while the next stages are in flight. The
// stage a run ends with N, and every stage when a pointer is not 16-byte
// aligned, is read from global memory instead. A flagged-out corner adds
// nothing and reads as zero. The additions land in another order on every
// run: the gradient is not bit-stable. What holds the kernel now is the
// REDs that remain (rays cross each other's rows, the line rows most of
// all: a few hundred a pair, which every ray adds into), and the reads of
// the rows a cell enters, which queue behind them in L2.
//
// The coordinate gradient (field_features_coords_grad_kernel,
// iff_field_features_coords_grad) is the gradient of the same function
// with respect to the sample points, which iNeRF needs: the camera pose
// reaches the field through them. For each sample and axis pair, with u
// the upstream word, lerp(L) times the bilerp's derivative in each plane
// weight, and bilerp(P) times (L1 - L0), summed over the ranks and scaled
// by (size - 1) / 2. The JAX package derives it in XLA from the
// interpolation weights' cotangent (g_weights in _gather_contract_bwd and
// _lerp_contract_mm_bwd, iffnerf_tpu/ops/packed_sample.py:256,293), not in
// a Pallas kernel.
//
// Bound on an H100 SXM: bytes, nearly all of them the upstream read: dapp
// is 576 B a sample at lego's ranks, about 0.6 GB at an iNeRF iteration's
// 1.06 M samples, and only about 4 % of those samples (the ones inside the
// alpha mask and above the weight threshold) carry any upstream; each word
// has to be read to know. The first design of this kernel (a group of
// lanes a sample, the pairs in turn, each lane loading its upstream word
// and, when not zero, its 6 corner words) kept one 16-byte load a lane in
// flight, three dependent bursts a sample, and reached a third of the
// device-memory rate: 2.9 times the bound.
//
// The design here streams the upstream and does work only where it is not
// zero. A producer lane bulk-copies each stage's xyz, dsigma and dapp rows
// (contiguous for a stage of consecutive samples) into a kStages-deep
// mbarrier ring under L2's evict-first policy, as the backward does; the
// stage a call ends with, and every stage when a pointer is not 16-byte
// aligned, the consumers copy into its slot themselves. The consumers take
// one vote on each sample's whole upstream row (each word of the stage read
// once, by one thread); a stage with no live sample, most stages of an
// iteration, stores its zeros and releases its slot at once. Otherwise the
// forward's cell pass (make_step, the same axis_floor and step record, so
// each sample's cell is the forward's bit for bit) writes each live
// sample's step, taking as the previous sample the run's previous live
// one, and a group of g lanes for each run of kCoordRun samples and part
// (each axis pair its own groups, as in the forward) walks the run's live
// samples with its words of the 6 corner slots in registers, reading only
// the rows a cell enters. Its lane sums for the run's samples meet by
// shuffles after the walk; the parts' sums of a sample are added in a
// fixed order through shared memory and stored once. No atomics: repeats
// are bit-equal, and a sample with no upstream is exactly 0.
#include <cstdint>
#include <numeric>

#include <cuda_runtime.h>

#include "tma_wgmma.cuh"

namespace iff {

struct FieldArgs {
  const float* dplane[3];  // [H, W, Rd]
  const float* dline[3];   // [L, Rd]
  const float* aplane[3];  // [H, W, Ra], null density-only
  const float* aline[3];   // [L, Ra]
  int h[3], w[3], len[3], rd[3], ra[3];  // ra 0 density-only
  int app_off[3];          // first output column of pair i's products
  int app_cols;
};

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
__device__ __forceinline__ void atomic_add_vec(float* p, const Vec<VEC>& x);

template <>
__device__ __forceinline__ void atomic_add_vec<1>(float* p, const Vec<1>& x) {
  atomicAdd(p, x.v[0]);
}

template <>
__device__ __forceinline__ void atomic_add_vec<4>(float* p, const Vec<4>& x) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
}

template <int VEC>
__device__ __forceinline__ bool any_nonzero(const Vec<VEC>& x) {
  bool nz = false;
#pragma unroll
  for (int q = 0; q < VEC; ++q) nz |= x.v[q] != 0.0f;
  return nz;
}

// The lower corner floor(p) of coordinate g on an axis of `size` texels,
// clamped to [-2, size] (a floor more than a texel outside the grid flags
// both corners out, whatever its value, so clamping it changes no result
// and keeps f + 1 from overflowing), and the upper corner's weight.
struct Floor {
  int f;
  float w, u;  // p - floor(p), 1 - w
};

__device__ __forceinline__ Floor axis_floor(float g, int size) {
  // (g + 1) * 0.5 * (size - 1), each step rounded as torch rounds it
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f),
                            static_cast<float>(size - 1));
  const float f = floorf(p);
  Floor a;
  a.f = static_cast<int>(fminf(fmaxf(f, -2.0f), static_cast<float>(size)));
  a.w = __fsub_rn(p, f);
  a.u = __fsub_rn(1.0f, a.w);
  return a;
}

// lo * (1 - w) + hi * w, as the samplers round it
__device__ __forceinline__ float lerp(float lo, float hi, float u, float w) {
  return __fadd_rn(__fmul_rn(lo, u), __fmul_rn(hi, w));
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> zero_vec() {
  Vec<VEC> x;
#pragma unroll
  for (int q = 0; q < VEC; ++q) x.v[q] = 0.0f;
  return x;
}

template <class T>
__device__ __forceinline__ T of_pair(const T (&x)[3], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}

__device__ __forceinline__ float coord(float x0, float x1, float x2, int k) {
  return k == 0 ? x0 : (k == 1 ? x1 : x2);
}

// An L2 policy for data that streams through once (the forward's products,
// the backward's upstream gradients): evicted first, so that the rows of
// the tables (and of their gradients), which other rays come back to, stay
// longer
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

template <int VEC>
__device__ __forceinline__ void store_stream(float* p, const Vec<VEC>& x, uint64_t policy);

template <>
__device__ __forceinline__ void store_stream<1>(float* p, const Vec<1>& x, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p), "f"(x.v[0]),
               "l"(policy)
               : "memory");
}

template <>
__device__ __forceinline__ void store_stream<4>(float* p, const Vec<4>& x, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
               "f"(x.v[0]), "f"(x.v[1]), "f"(x.v[2]), "f"(x.v[3]), "l"(policy)
               : "memory");
}

namespace fwd {

constexpr int kMaxRun = 32;         // samples a run at most, a power of two
constexpr int kSpansPerBlock = 4;   // the host halves the run until every resident
                                    // block has this many spans to walk
constexpr int kWarps = 8;           // the warps a block aims at
constexpr int kMaxWarps = 16;
constexpr int kSmem = 64 * 1024;    // a block's steps and density sums at most
constexpr int kSmallSmem = 48 * 1024;
constexpr int kNoCell = -(1 << 20);  // a corner no sample has

// The host's split of the work. A run is `run` consecutive samples and
// needs `parts` groups (each axis pair's words, g at a time); a span is
// `runs` runs, a block's work between two barriers.
struct Plan {
  int log_g;  // lanes a group: 1 << log_g
  int red;    // the first lanes of a group, those that can hold density words
  int parts;  // groups a run
  int runs;   // runs a span
  int run;    // samples a run
  long long spans;
};

// One sample's step for one axis pair, made by the cell pass for the word
// pass: the weights of the slots (slot 0 of an axis holds the corner with
// the even index and slot 1 the odd one, so that a row keeps its slot while
// the cell moves; the weights of the lower and the upper corner swap with
// the cell's parity), and for each slot the clamped row it reads, or -1
// when it keeps its word.
struct __align__(16) Step {
  float4 wxy;  // plane slots' weights: x0, x1, y0, y1
  float2 wl;   // line slots' weights: l0, l1
  int2 line;   // rows the line slots read
  int4 plane;  // rows (y * w + x) the plane slots read
  int out;     // bit s: plane slot s's corner lies outside the plane; 4 + s: line slot s's
  int odd;     // bits 0, 1, 2: the cell's lower corner on x, y, the line is odd (slot 1 is
               // then the lower corner: the coordinate kernel's sign)
  int pad[2];
};

// One lane's word of one axis pair: where it reads and writes.
struct Word {
  const float* plane;  // the word's first rank in the table of its kind
  const float* line;
  int c;               // the kind's ranks (the host keeps every table under 2^31 floats)
  int pair;
  int out;             // the word's first column of app; -1 for a density word
};

// Part `part` of a run -> this lane's word (lane `lane` of a group of g);
// false when the lane has none (o.pair is the part's pair either way).
template <int VEC>
__device__ __forceinline__ bool resolve(const FieldArgs& a, int part, int lane, int g, Word& o) {
  int i = 0, first = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int pk = ((a.rd[k] + a.ra[k]) / VEC + g - 1) / g;
    if (part >= 0 && part < pk) {
      i = k;
      first = part * g;
    }
    part -= pk;
  }
  const int nd = of_pair(a.rd, i) / VEC;
  const int j = first + lane;
  o.pair = i;
  if (j >= nd + of_pair(a.ra, i) / VEC) return false;
  const bool dens = j < nd;
  const int col = (dens ? j : j - nd) * VEC;
  o.c = dens ? of_pair(a.rd, i) : of_pair(a.ra, i);
  o.plane = (dens ? of_pair(a.dplane, i) : of_pair(a.aplane, i)) + col;
  o.line = (dens ? of_pair(a.dline, i) : of_pair(a.aline, i)) + col;
  o.out = dens ? -1 : of_pair(a.app_off, i) + col;
  return true;
}

__device__ __forceinline__ void slot_weights(const Floor& f, float& w0, float& w1) {
  const bool odd = f.f & 1;
  w0 = odd ? f.w : f.u;
  w1 = odd ? f.u : f.w;
}

__device__ __forceinline__ int clamp_index(int v, int size) { return min(max(v, 0), size - 1); }

// A coordinate: through the read-only path (kGlobal: the forward's xyz) or
// a generic load (shared memory: the coordinate kernel's staged xyz)
template <bool kGlobal>
__device__ __forceinline__ float load_coord(const float* p) {
  return kGlobal ? __ldg(p) : *p;
}

// The cell pass: sample k of the span (at x, the run's previous sample at
// prev, or null when k starts a run) for axis pair i -> its step.
template <bool kGlobal = true>
__device__ __forceinline__ Step make_step(const FieldArgs& a, int i, const float* x,
                                          const float* prev) {
  // MAT_MODE ((0, 1), (0, 2), (1, 2)), VEC_MODE (2, 1, 0)
  const int mx = i == 2 ? 1 : 0, my = i == 0 ? 1 : 2, ml = 2 - i;
  const int h = of_pair(a.h, i), w = of_pair(a.w, i), len = of_pair(a.len, i);
  const Floor fx = axis_floor(load_coord<kGlobal>(x + mx), w);
  const Floor fy = axis_floor(load_coord<kGlobal>(x + my), h);
  const Floor fl = axis_floor(load_coord<kGlobal>(x + ml), len);
  int cy = kNoCell, cx = kNoCell, cl = kNoCell;  // the cell the slots hold
  if (prev) {
    cx = axis_floor(load_coord<kGlobal>(prev + mx), w).f;
    cy = axis_floor(load_coord<kGlobal>(prev + my), h).f;
    cl = axis_floor(load_coord<kGlobal>(prev + ml), len).f;
  }
  Step st;
  slot_weights(fx, st.wxy.x, st.wxy.y);
  slot_weights(fy, st.wxy.z, st.wxy.w);
  slot_weights(fl, st.wl.x, st.wl.y);
  int rows[4], out = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int y = fy.f + (((s >> 1) ^ fy.f) & 1);
    const int x = fx.f + (((s & 1) ^ fx.f) & 1);
    const bool keep = static_cast<unsigned>(y - cy) <= 1u && static_cast<unsigned>(x - cx) <= 1u;
    rows[s] = keep ? -1 : clamp_index(y, h) * w + clamp_index(x, w);
    if (!keep && (y < 0 || y >= h || x < 0 || x >= w)) out |= 1 << s;
  }
  int lrows[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int z = fl.f + ((s ^ fl.f) & 1);
    const bool keep = static_cast<unsigned>(z - cl) <= 1u;
    lrows[s] = keep ? -1 : clamp_index(z, len);
    if (!keep && (z < 0 || z >= len)) out |= 16 << s;
  }
  st.plane = make_int4(rows[0], rows[1], rows[2], rows[3]);
  st.line = make_int2(lrows[0], lrows[1]);
  st.out = out;
  st.odd = (fx.f & 1) | (fy.f & 1) << 1 | (fl.f & 1) << 2;
  return st;
}

// A corner a slot enters: its row's word.
template <int VEC>
__device__ __forceinline__ void enter(Vec<VEC>& t, const float* base, int row, int c) {
  if (row >= 0) t = load_vec<VEC>(base + row * c);
}

// A corner that lies outside: its word times 0 (the samplers' flag; a slot
// keeps its word multiplied).
template <int VEC>
__device__ __forceinline__ void flag_out(Vec<VEC>& t, bool outside) {
  if (outside) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) t.v[q] = __fmul_rn(t.v[q], 0.0f);
  }
}

// The plane-times-line word of a sample in the samplers' order: each lerp
// lo * (1 - w) + hi * w, with the slots' products added in the other order
// when the cell is odd (the same two rounded products, and a sum of two
// rounds the same either way).
template <int VEC>
__device__ __forceinline__ Vec<VEC> product(const Step& st, const Vec<VEC> (&t)[4],
                                            const Vec<VEC> (&l)[2]) {
  Vec<VEC> p;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const float r0 = lerp(t[0].v[q], t[1].v[q], st.wxy.x, st.wxy.y);
    const float r1 = lerp(t[2].v[q], t[3].v[q], st.wxy.x, st.wxy.y);
    const float pf = lerp(r0, r1, st.wxy.z, st.wxy.w);
    const float lf = lerp(l[0].v[q], l[1].v[q], st.wl.x, st.wl.y);
    p.v[q] = __fmul_rn(pf, lf);
  }
  return p;
}

template <int VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
    field_features_kernel(const float* __restrict__ xyz, float* __restrict__ sigma,
                          float* __restrict__ app, const __grid_constant__ FieldArgs a,
                          const __grid_constant__ Plan p, int64_t N) {
  extern __shared__ __align__(16) unsigned char fsm[];
  const int span = p.runs * p.run;
  Step* steps = reinterpret_cast<Step*>(fsm);                       // [3, span]
  float* part_sigma = reinterpret_cast<float*>(steps + 3 * span);  // [parts, red, span]
  const int g = 1 << p.log_g;
  const int lane = threadIdx.x & (g - 1);
  const int gid = threadIdx.x >> p.log_g;
  const int groups = blockDim.x >> p.log_g;
  const int slots = p.runs * p.parts;
  const uint64_t once = stream_policy();  // the products: basis_mat reads them once
  for (int64_t sp = blockIdx.x; sp < p.spans; sp += gridDim.x) {
    const int64_t n0 = sp * span;
    const int count = N - n0 < span ? static_cast<int>(N - n0) : span;
    // the cell pass: a thread a sample and axis pair
    for (int it = threadIdx.x; it < 3 * count; it += blockDim.x) {
      const int i = it / count;
      const int k = it - i * count;
      const float* x = xyz + 3 * (n0 + k);
      steps[i * span + k] = make_step(a, i, x, k % p.run ? x - 3 : nullptr);
    }
    __syncthreads();
    // the word pass: a group a run and part
    for (int slot = gid; slot < slots; slot += groups) {
      const int r0 = slot / p.parts * p.run;
      const int part = slot % p.parts;
      const int cnt = min(max(count - r0, 0), p.run);
      Word o;
      const bool live = resolve<VEC>(a, part, lane, g, o);
      const Step* st = steps + (live ? o.pair : 0) * span + r0;
      float* sums = part_sigma + (part * p.red + lane) * span + r0;
      float* out = app + (n0 + r0) * a.app_cols + (live ? o.out : 0);
      Vec<VEC> t[4], l[2];
#pragma unroll
      for (int s = 0; s < 4; ++s) t[s] = zero_vec<VEC>();
      l[0] = l[1] = zero_vec<VEC>();
#pragma unroll 2
      for (int u = 0; u < cnt; ++u) {
        float s = 0.0f;
        if (live) {
          const Step e = st[u];
          enter<VEC>(t[0], o.plane, e.plane.x, o.c);
          enter<VEC>(t[1], o.plane, e.plane.y, o.c);
          enter<VEC>(t[2], o.plane, e.plane.z, o.c);
          enter<VEC>(t[3], o.plane, e.plane.w, o.c);
          enter<VEC>(l[0], o.line, e.line.x, o.c);
          enter<VEC>(l[1], o.line, e.line.y, o.c);
          if (e.out) {  // rare: a corner outside the grid
            flag_out<VEC>(t[0], e.out & 1);
            flag_out<VEC>(t[1], e.out & 2);
            flag_out<VEC>(t[2], e.out & 4);
            flag_out<VEC>(t[3], e.out & 8);
            flag_out<VEC>(l[0], e.out & 16);
            flag_out<VEC>(l[1], e.out & 32);
          }
          const Vec<VEC> prod = product<VEC>(e, t, l);
          if (o.out < 0) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) s += prod.v[q];
          } else {
            store_stream<VEC>(out, prod, once);
          }
        }
        if (lane < p.red) sums[u] = s;
        out += a.app_cols;
      }
    }
    __syncthreads();
    // sigma: the groups' density sums in a fixed order
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < p.parts * p.red; ++q) s += part_sigma[q * span + k];
      sigma[n0 + k] = s;
    }
  }
}

}  // namespace fwd

struct FieldGrads {
  float* dplane[3];  // null: that table's gradient is not wanted
  float* dline[3];
  float* aplane[3];
  float* aline[3];
};

namespace bwd {

constexpr int kStageSamples = 8;    // samples of one run a ring stage
constexpr int kRunSamples = 32;     // samples a run, a multiple of kStageSamples: short
                                    // runs keep a block's runs (neighbouring pieces
                                    // of a ray) evenly loaded
constexpr int kStages = 4;          // ring depth
constexpr int kConsumerWarps = 3;   // 6 groups of 16 lanes at lego's ranks: 2 runs
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // and one producer warp
constexpr int kBlocksPerSM = 4;
constexpr int kBarrierBytes = 128;  // the full and empty barriers, then the ring
constexpr int kSmallSmem = 48 * 1024;
constexpr int kNoCell = -(1 << 20);  // a corner no sample has
constexpr int kSpanStages = kRunSamples / kStageSamples;
static_assert(kRunSamples % kStageSamples == 0 && kStageSamples % 4 == 0,
              "a stage's xyz and dsigma are whole 16-byte units");

// The host's split of the work. A span is `runs` consecutive runs, read
// through the ring together; a run needs `parts` groups (each axis pair's
// words, g at a time); a block's groups hold `runs` runs at once, or, when
// a run needs more groups than a block has (runs == 1), pass over the span
// `rounds` times, each time for the next groups' worth of parts.
struct Plan {
  int log_g;      // lanes a group: 1 << log_g
  int parts;      // groups a run
  int runs;       // runs a span
  int rounds;     // passes over a span
  int cols;       // dapp's width, 0 density-only
  int run_bytes;  // a run's share of a stage: xyz, dsigma, dapp rows
  int direct;     // read every stage from global memory (an unaligned pointer)
  long long items;  // spans x rounds
};

// a word from shared or global memory (a generic address)
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_any(const float* p);

template <>
__device__ __forceinline__ Vec<1> load_any<1>(const float* p) {
  return {{*p}};
}

template <>
__device__ __forceinline__ Vec<4> load_any<4>(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}

// One lane's word of one axis pair: where it reads and adds.
struct Word {
  const float* plane;  // the table of its kind (density or appearance)
  const float* line;
  float* gplane;       // their gradients, null when not wanted
  float* gline;
  int64_t c;           // the kind's ranks
  int col;             // the word's first rank
  int h, w, len;
  int mx, my, ml;      // the coordinates of the plane's x and y and of the line
  int up;              // the word's first column of dapp
  bool dens;
};

// Part `part` of a run -> this lane's word (lane `lane` of a group of g);
// false when the lane has none or none of its gradients is wanted.
template <int VEC>
__device__ __forceinline__ bool resolve(const FieldArgs& a, const FieldGrads& gr, int part,
                                        int lane, int g, Word& o) {
  int i = 0, first = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int pk = ((a.rd[k] + a.ra[k]) / VEC + g - 1) / g;
    if (part >= 0 && part < pk) {
      i = k;
      first = part * g;
    }
    part -= pk;
  }
  const int nd = of_pair(a.rd, i) / VEC;
  const int j = first + lane;
  if (j >= nd + of_pair(a.ra, i) / VEC) return false;
  o.dens = j < nd;
  o.col = (o.dens ? j : j - nd) * VEC;
  o.c = o.dens ? of_pair(a.rd, i) : of_pair(a.ra, i);
  o.plane = o.dens ? of_pair(a.dplane, i) : of_pair(a.aplane, i);
  o.line = o.dens ? of_pair(a.dline, i) : of_pair(a.aline, i);
  o.gplane = o.dens ? of_pair(gr.dplane, i) : of_pair(gr.aplane, i);
  o.gline = o.dens ? of_pair(gr.dline, i) : of_pair(gr.aline, i);
  o.h = of_pair(a.h, i);
  o.w = of_pair(a.w, i);
  o.len = of_pair(a.len, i);
  // MAT_MODE ((0, 1), (0, 2), (1, 2)), VEC_MODE (2, 1, 0)
  o.mx = i == 2 ? 1 : 0;
  o.my = i == 0 ? 1 : 2;
  o.ml = 2 - i;
  o.up = of_pair(a.app_off, i) + o.col;
  return o.gplane != nullptr || o.gline != nullptr;
}

// A lane's corners: the plane cell (cy, cx) with its rows (y, x), (y,
// x + 1), (y + 1, x), (y + 1, x + 1) and the line cell cl with rows l, l +
// 1; for each row its table word (zero for a row outside the grid) and the
// running sum of what the run adds to it.
template <int VEC>
struct Corners {
  int cy, cx, cl;
  Vec<VEC> t[4], s[4];
  Vec<VEC> l[2], b[2];
};

template <int VEC>
__device__ __forceinline__ void reset(Corners<VEC>& k) {
  k.cy = k.cx = k.cl = kNoCell;
#pragma unroll
  for (int c = 0; c < 4; ++c) k.s[c] = zero_vec<VEC>();
#pragma unroll
  for (int c = 0; c < 2; ++c) k.b[c] = zero_vec<VEC>();
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

template <int VEC>
__device__ __forceinline__ void flush_plane(const Word& o, int y, int x, const Vec<VEC>& sum) {
  if (o.gplane && inside(y, x, o.h, o.w) && any_nonzero<VEC>(sum))
    atomic_add_vec<VEC>(o.gplane + (static_cast<int64_t>(y) * o.w + x) * o.c + o.col, sum);
}

template <int VEC>
__device__ __forceinline__ void flush_line(const Word& o, int l, const Vec<VEC>& sum) {
  if (o.gline && l >= 0 && l < o.len && any_nonzero<VEC>(sum))
    atomic_add_vec<VEC>(o.gline + static_cast<int64_t>(l) * o.c + o.col, sum);
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> plane_word(const Word& o, int y, int x) {
  return inside(y, x, o.h, o.w)
             ? load_vec<VEC>(o.plane + (static_cast<int64_t>(y) * o.w + x) * o.c + o.col)
             : zero_vec<VEC>();
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> line_word(const Word& o, int l) {
  return l >= 0 && l < o.len ? load_vec<VEC>(o.line + static_cast<int64_t>(l) * o.c + o.col)
                             : zero_vec<VEC>();
}

// Moves the plane cell to (fy, fx): a row that stays in the footprint
// keeps its word and sum, a row that leaves adds its sum to the gradient,
// a row that enters is read.
template <int VEC>
__device__ __forceinline__ void move_plane(const Word& o, Corners<VEC>& k, int fy, int fx) {
  if (fy == k.cy && fx == k.cx) return;
  unsigned need = 0;  // bit c: read row c
  const int dx = fx - k.cx;
  if (dx == 1) {
    flush_plane<VEC>(o, k.cy, k.cx, k.s[0]);
    flush_plane<VEC>(o, k.cy + 1, k.cx, k.s[2]);
    k.t[0] = k.t[1];
    k.s[0] = k.s[1];
    k.t[2] = k.t[3];
    k.s[2] = k.s[3];
    k.s[1] = k.s[3] = zero_vec<VEC>();
    need = 0xa;
  } else if (dx == -1) {
    flush_plane<VEC>(o, k.cy, k.cx + 1, k.s[1]);
    flush_plane<VEC>(o, k.cy + 1, k.cx + 1, k.s[3]);
    k.t[1] = k.t[0];
    k.s[1] = k.s[0];
    k.t[3] = k.t[2];
    k.s[3] = k.s[2];
    k.s[0] = k.s[2] = zero_vec<VEC>();
    need = 0x5;
  } else if (dx != 0) {
    flush_plane<VEC>(o, k.cy, k.cx, k.s[0]);
    flush_plane<VEC>(o, k.cy, k.cx + 1, k.s[1]);
    flush_plane<VEC>(o, k.cy + 1, k.cx, k.s[2]);
    flush_plane<VEC>(o, k.cy + 1, k.cx + 1, k.s[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) k.s[c] = zero_vec<VEC>();
    need = 0xf;
  }
  k.cx = fx;
  const int dy = fy - k.cy;
  if (dy == 1) {
    flush_plane<VEC>(o, k.cy, k.cx, k.s[0]);
    flush_plane<VEC>(o, k.cy, k.cx + 1, k.s[1]);
    k.t[0] = k.t[2];
    k.s[0] = k.s[2];
    k.t[1] = k.t[3];
    k.s[1] = k.s[3];
    k.s[2] = k.s[3] = zero_vec<VEC>();
    need = (need >> 2) | 0xc;
  } else if (dy == -1) {
    flush_plane<VEC>(o, k.cy + 1, k.cx, k.s[2]);
    flush_plane<VEC>(o, k.cy + 1, k.cx + 1, k.s[3]);
    k.t[2] = k.t[0];
    k.s[2] = k.s[0];
    k.t[3] = k.t[1];
    k.s[3] = k.s[1];
    k.s[0] = k.s[1] = zero_vec<VEC>();
    need = ((need & 3) << 2) | 0x3;
  } else if (dy != 0) {
    flush_plane<VEC>(o, k.cy, k.cx, k.s[0]);
    flush_plane<VEC>(o, k.cy, k.cx + 1, k.s[1]);
    flush_plane<VEC>(o, k.cy + 1, k.cx, k.s[2]);
    flush_plane<VEC>(o, k.cy + 1, k.cx + 1, k.s[3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) k.s[c] = zero_vec<VEC>();
    need = 0xf;
  }
  k.cy = fy;
  if (need & 1) k.t[0] = plane_word<VEC>(o, fy, fx);
  if (need & 2) k.t[1] = plane_word<VEC>(o, fy, fx + 1);
  if (need & 4) k.t[2] = plane_word<VEC>(o, fy + 1, fx);
  if (need & 8) k.t[3] = plane_word<VEC>(o, fy + 1, fx + 1);
}

template <int VEC>
__device__ __forceinline__ void move_line(const Word& o, Corners<VEC>& k, int fl) {
  if (fl == k.cl) return;
  const int d = fl - k.cl;
  unsigned need;
  if (d == 1) {
    flush_line<VEC>(o, k.cl, k.b[0]);
    k.l[0] = k.l[1];
    k.b[0] = k.b[1];
    k.b[1] = zero_vec<VEC>();
    need = 2;
  } else if (d == -1) {
    flush_line<VEC>(o, k.cl + 1, k.b[1]);
    k.l[1] = k.l[0];
    k.b[1] = k.b[0];
    k.b[0] = zero_vec<VEC>();
    need = 1;
  } else {
    flush_line<VEC>(o, k.cl, k.b[0]);
    flush_line<VEC>(o, k.cl + 1, k.b[1]);
    k.b[0] = k.b[1] = zero_vec<VEC>();
    need = 3;
  }
  k.cl = fl;
  if (need & 1) k.l[0] = line_word<VEC>(o, fl);
  if (need & 2) k.l[1] = line_word<VEC>(o, fl + 1);
}

template <int VEC>
__device__ __forceinline__ void flush_all(const Word& o, const Corners<VEC>& k) {
  flush_plane<VEC>(o, k.cy, k.cx, k.s[0]);
  flush_plane<VEC>(o, k.cy, k.cx + 1, k.s[1]);
  flush_plane<VEC>(o, k.cy + 1, k.cx, k.s[2]);
  flush_plane<VEC>(o, k.cy + 1, k.cx + 1, k.s[3]);
  flush_line<VEC>(o, k.cl, k.b[0]);
  flush_line<VEC>(o, k.cl + 1, k.b[1]);
}

// One sample at (x0, x1, x2) with upstream word g into the running sums.
template <int VEC>
__device__ __forceinline__ void add_sample(const Word& o, Corners<VEC>& k, float x0, float x1,
                                           float x2, const Vec<VEC>& g) {
  const Floor ax = axis_floor(coord(x0, x1, x2, o.mx), o.w);
  const Floor ay = axis_floor(coord(x0, x1, x2, o.my), o.h);
  const Floor al = axis_floor(coord(x0, x1, x2, o.ml), o.len);
  move_plane<VEC>(o, k, ay.f, ax.f);
  move_line<VEC>(o, k, al.f);
  const float wc[4] = {ay.u * ax.u, ay.u * ax.w, ay.w * ax.u, ay.w * ax.w};
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    // the forward's plane and line values, in its order
    const float top = lerp(k.t[0].v[q], k.t[1].v[q], ax.u, ax.w);
    const float bot = lerp(k.t[2].v[q], k.t[3].v[q], ax.u, ax.w);
    const float pf = lerp(top, bot, ay.u, ay.w);
    const float lf = lerp(k.l[0].v[q], k.l[1].v[q], al.u, al.w);
    const float dpf = lf * g.v[q];  // d/d(plane value)
    const float dlf = pf * g.v[q];  // d/d(line value)
#pragma unroll
    for (int c = 0; c < 4; ++c) k.s[c].v[q] += wc[c] * dpf;
    k.b[0].v[q] += al.u * dlf;
    k.b[1].v[q] += al.w * dlf;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    field_features_bwd_kernel(const float* __restrict__ xyz,
                              const float* __restrict__ dsigma,
                              const float* __restrict__ dapp,
                              const __grid_constant__ FieldArgs a,
                              const __grid_constant__ FieldGrads gr,
                              const __grid_constant__ Plan p, int64_t N) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, kConsumerWarps);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
  const int64_t span_samples = static_cast<int64_t>(p.runs) * kRunSamples;
  const int stage_bytes = p.runs * p.run_bytes;

  if (warp == kConsumerWarps) {
    // producer: each stage's rows of every run of the span, a run a lane
    const uint64_t once = stream_policy();
    int it = 0;
    for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int64_t span0 = item / p.rounds * span_samples;
      for (int st = 0; st < kSpanStages; ++st, ++it) {
        const int s = it % kStages;
        hop::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        uint32_t mine = 0;
        for (int r = lane; r < p.runs; r += 32) {
          const int64_t n0 = span0 + static_cast<int64_t>(r) * kRunSamples + st * kStageSamples;
          if (!p.direct && n0 + kStageSamples <= N) mine += p.run_bytes;
        }
        const uint32_t bytes = __reduce_add_sync(0xffffffffu, mine);
        if (lane == 0) hop::mbar_arrive_expect_tx(full + s, bytes);
        __syncwarp();
        if (bytes == 0) continue;
        unsigned char* stage = ring + s * stage_bytes;
        for (int r = lane; r < p.runs; r += 32) {
          const int64_t n0 = span0 + static_cast<int64_t>(r) * kRunSamples + st * kStageSamples;
          if (n0 + kStageSamples > N) continue;
          unsigned char* dst = stage + r * p.run_bytes;
          hop::bulk_load(dst, xyz + 3 * n0, kStageSamples * 12, full + s, once);
          hop::bulk_load(dst + kStageSamples * 12, dsigma + n0, kStageSamples * 4, full + s,
                         once);
          if (p.cols)
            hop::bulk_load(dst + kStageSamples * 16, dapp + n0 * p.cols,
                           kStageSamples * 4 * p.cols, full + s, once);
        }
      }
    }
    return;
  }

  // consumers: group gid of g lanes, the lanes of a group adjacent in a warp
  const int g = 1 << p.log_g;
  const int gid = threadIdx.x >> p.log_g;
  const int groups = (kConsumerWarps * 32) >> p.log_g;
  const unsigned gmask = g == 32 ? 0xffffffffu : ((1u << g) - 1) << (lane & ~(g - 1));
  int it = 0;
  for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int slot = static_cast<int>(item % p.rounds) * groups + gid;
    Word o;
    bool live = false;
    int run = 0;
    if (slot < p.runs * p.parts) {
      run = slot / p.parts;
      live = resolve<VEC>(a, gr, slot % p.parts, threadIdx.x & (g - 1), g, o);
    }
    Corners<VEC> k;
    reset(k);
    const int64_t first = item / p.rounds * span_samples + static_cast<int64_t>(run) * kRunSamples;
    for (int st = 0; st < kSpanStages; ++st, ++it) {
      const int s = it % kStages;
      hop::mbar_wait(full + s, (it / kStages) & 1);
      const int64_t n0 = first + st * kStageSamples;
      const int64_t left = N - n0;
      const int count = !live || left <= 0 ? 0
                        : left < kStageSamples ? static_cast<int>(left) : kStageSamples;
      const bool staged = !p.direct && left >= kStageSamples;
      const unsigned char* base = ring + s * stage_bytes + run * p.run_bytes;
      const float* sx = staged ? reinterpret_cast<const float*>(base) : xyz + 3 * n0;
      const float* ss = staged ? reinterpret_cast<const float*>(base + kStageSamples * 12)
                               : dsigma + n0;
      const float* sa = staged ? reinterpret_cast<const float*>(base + kStageSamples * 16)
                               : dapp + n0 * p.cols;
#pragma unroll 1
      for (int u = 0; u < kStageSamples; ++u) {
        Vec<VEC> gv = zero_vec<VEC>();
        if (u < count) {
          if (o.dens) {
            const float d = ss[u];
#pragma unroll
            for (int q = 0; q < VEC; ++q) gv.v[q] = d;
          } else {
            gv = load_any<VEC>(sa + u * p.cols + o.up);
          }
        }
        const unsigned vote = __ballot_sync(0xffffffffu, any_nonzero<VEC>(gv)) & gmask;
        if (vote != 0 && u < count)
          add_sample<VEC>(o, k, sx[3 * u], sx[3 * u + 1], sx[3 * u + 2], gv);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(empty + s);
    }
    if (live) flush_all<VEC>(o, k);
  }
}

}  // namespace bwd

namespace cgrad {

constexpr int kCoordRun = 8;        // samples a run, a power of two up to 32: a group walks
                                    // a run's live samples in order
constexpr int kConsumerWarps = 8;   // 16 groups of 16 lanes at lego's ranks: 5 runs a stage
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kStages = 2;          // ring depth
constexpr int kBlocksPerSM = 2;
constexpr int kBarrierBytes = 128;  // the full and empty barriers, then the ring
constexpr int kSmallSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kRunMask = kCoordRun == 32 ? 0xffffffffu : (1u << kCoordRun) - 1;
static_assert(32 % kCoordRun == 0 && kCoordRun % 4 == 0,
              "a run lies in one warp's ballot, a stage's rows are whole 16-byte units");

// The host's split of the work. A stage is `runs` runs of kCoordRun
// consecutive samples, read through the ring at once; a run needs `parts`
// groups (each axis pair's words, g at a time), and a block's groups take
// the stage's runs and parts in turn.
struct Plan {
  int log_g;        // lanes a group: 1 << log_g
  int parts;        // groups a run
  int runs;         // runs a stage
  int stage;        // samples a stage: runs * kCoordRun
  int cols;         // dapp's width, 0 density-only
  int stage_bytes;  // a stage's xyz, dsigma and dapp rows
  int direct;       // read every stage from global memory (an unaligned pointer)
  long long stages;
};

// One of the two buffers the stages take in turn: each sample's step for
// the 3 axis pairs (the forward's cell pass), each sample's and part's
// three sums, whether each sample has upstream, each run's live samples.
__host__ __device__ inline int buffer_bytes(const Plan& p) {
  return (3 * p.stage * static_cast<int>(sizeof(fwd::Step)) + p.stage * p.parts * 12 +
          p.stage * 4 + p.runs * 4 + 15) & ~15;
}

// bar.red.or over the consumer warps (named barrier 2): whether any of
// their threads holds p; it orders their shared-memory writes as a bar.sync
__device__ __forceinline__ bool consumers_any(bool p) {
  int r;
  asm volatile(
      "{\n.reg .pred pi, po;\n"
      "setp.ne.s32 pi, %1, 0;\n"
      "bar.red.or.pred po, 2, %2, pi;\n"
      "selp.s32 %0, 1, 0, po;\n}\n"
      : "=r"(r)
      : "r"(static_cast<int>(p)), "n"(kConsumerThreads)
      : "memory");
  return r != 0;
}

// The coordinate gradient, warp-specialised. A producer lane bulk-copies
// each stage's xyz, dsigma and dapp rows (contiguous) into a kStages-deep
// ring under L2's evict-first policy; the consumer warps, for each stage:
// vote on each sample's whole upstream row (a stage with no live sample
// stores its zeros and is done); the cell pass, a thread a sample and axis
// pair, writes each live sample's step as the forward's cell pass does,
// its previous sample the run's previous live one; a group of g lanes a
// run and part walks the run's live samples in order with its words of the
// 4 plane and 2 line corner slots in registers, reading only the rows a
// cell enters, adds its u lerp(L) dbilerp(P)/dwx, dbilerp/dwy and u
// bilerp(P) dlerp(L)/dwl for each sample, then adds them over the group by
// shuffles and writes each sample's three sums for its part; then a thread
// an output float adds the parts in a fixed order and stores it (0 for a
// sample with no upstream).
template <int VEC>
__global__ void __launch_bounds__(kConsumerThreads + 32, kBlocksPerSM)
    field_features_coords_grad_kernel(const float* __restrict__ xyz,
                                      const float* __restrict__ dsigma,
                                      const float* __restrict__ dapp,
                                      const __grid_constant__ FieldArgs a,
                                      const __grid_constant__ Plan p, int64_t N,
                                      float* __restrict__ dxyz) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;
  unsigned char* buffers = ring + kStages * p.stage_bytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, kConsumerWarps);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: a stage's three rows of samples, one bulk copy each
    if (lane != 0) return;
    const uint64_t once = stream_policy();
    int it = 0;
    for (int64_t item = blockIdx.x; item < p.stages; item += gridDim.x, ++it) {
      const int s = it % kStages;
      hop::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
      const int64_t n0 = item * p.stage;
      const bool staged = !p.direct && n0 + p.stage <= N;
      hop::mbar_arrive_expect_tx(full + s, staged ? p.stage_bytes : 0);
      if (!staged) continue;
      unsigned char* dst = ring + s * p.stage_bytes;
      hop::bulk_load(dst, xyz + 3 * n0, p.stage * 12, full + s, once);
      hop::bulk_load(dst + p.stage * 12, dsigma + n0, p.stage * 4, full + s, once);
      if (p.cols)
        hop::bulk_load(dst + p.stage * 16, dapp + n0 * p.cols, p.stage * 4 * p.cols, full + s,
                       once);
    }
    return;
  }

  // consumers: group gid of g lanes, the lanes of a group adjacent in a warp
  const int g = 1 << p.log_g;
  const int glane = threadIdx.x & (g - 1);
  const int gid = threadIdx.x >> p.log_g;
  const int groups = kConsumerThreads >> p.log_g;
  const unsigned gmask = g == 32 ? ~0u : ((1u << g) - 1) << (lane & ~(g - 1));
  const int slots = p.runs * p.parts;
  const int cells = 3 * p.stage;
  const int bytes = buffer_bytes(p);
  int it = 0;
  for (int64_t item = blockIdx.x; item < p.stages; item += gridDim.x, ++it) {
    const int s = it % kStages;
    unsigned char* buf = buffers + (it & 1) * bytes;
    fwd::Step* steps = reinterpret_cast<fwd::Step*>(buf);           // [3, stage]
    float* sums = reinterpret_cast<float*>(steps + cells);           // [stage, parts, 3]
    int* live = reinterpret_cast<int*>(sums + p.stage * p.parts * 3);  // [stage]
    unsigned* masks = reinterpret_cast<unsigned*>(live + p.stage);   // [runs]
    const int64_t n0 = item * p.stage;
    const int count = N - n0 < p.stage ? static_cast<int>(N - n0) : p.stage;
    // the stage's xyz [stage, 3], dsigma [stage] and dapp [stage, cols] in
    // its ring slot: every read below is a shared-memory load
    float* sx = reinterpret_cast<float*>(ring + s * p.stage_bytes);
    float* ss = sx + 3 * p.stage;
    float* sa = sx + 4 * p.stage;
    hop::mbar_wait(full + s, (it / kStages) & 1);
    if (p.direct || count < p.stage) {
      // not bulk-copied (the call's last stage, or an unaligned pointer):
      // the consumers copy it in, zeros past N (no upstream: dead samples)
      for (int q = threadIdx.x; q < 3 * p.stage; q += kConsumerThreads)
        sx[q] = q < 3 * count ? xyz[3 * n0 + q] : 0.0f;
      for (int q = threadIdx.x; q < p.stage; q += kConsumerThreads)
        ss[q] = q < count ? dsigma[n0 + q] : 0.0f;
      for (int q = threadIdx.x; q < p.stage * p.cols; q += kConsumerThreads)
        sa[q] = q < count * p.cols ? dapp[n0 * p.cols + q] : 0.0f;
      hop::named_sync<kConsumerThreads>();
    }

    // the vote on each sample's whole upstream row: dsigma's word, then
    // every word of the stage's dapp rows at once (a thread a word, which
    // marks its sample live when not zero)
    bool any = false;
    for (int k = threadIdx.x; k < p.stage; k += kConsumerThreads) {
      const bool nz = ss[k] != 0.0f;
      live[k] = nz;
      any |= nz;
    }
    hop::named_sync<kConsumerThreads>();
    const int words = p.stage * p.cols / VEC;
#pragma unroll 4
    for (int w = threadIdx.x; w < words; w += kConsumerThreads) {
      if (any_nonzero<VEC>(bwd::load_any<VEC>(sa + w * VEC))) {
        live[w * VEC / p.cols] = 1;
        any = true;
      }
    }
    if (!consumers_any(any)) {
      if (lane == 0) hop::mbar_arrive(empty + s);
      for (int t = threadIdx.x; t < 3 * count; t += kConsumerThreads) dxyz[3 * n0 + t] = 0.0f;
      continue;
    }

    // the cell pass: a thread a sample and axis pair; a run's threads lie in
    // one warp, its ballot the run's live samples
    for (int t0 = 0; t0 < cells; t0 += kConsumerThreads) {
      const int t = t0 + static_cast<int>(threadIdx.x);
      const int i = t / p.stage;
      const int k = t - i * p.stage;
      const bool on = t < cells && live[k];
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (t < cells) {
        const int u = k & (kCoordRun - 1);
        const unsigned m = (ballot >> (lane - u)) & kRunMask;
        if (i == 0 && u == 0) masks[k / kCoordRun] = m;
        if (on) {
          const unsigned below = m & ((1u << u) - 1);
          const int prev = below ? k - u + 31 - __clz(below) : -1;
          steps[t] = fwd::make_step<false>(a, i, sx + 3 * k, prev >= 0 ? sx + 3 * prev : nullptr);
        }
      }
    }
    hop::named_sync<kConsumerThreads>();

    // the word pass: a group a run and part walks the run's live samples
    for (int job = gid; job < slots; job += groups) {
      const int r = job / p.parts;
      const int part = job - r * p.parts;
      fwd::Word o;
      const bool has = fwd::resolve<VEC>(a, part, glane, g, o);
      const int i = o.pair;
      const fwd::Step* st = steps + i * p.stage + r * kCoordRun;
      // MAT_MODE ((0, 1), (0, 2), (1, 2)), VEC_MODE (2, 1, 0)
      const int mx = i == 2 ? 1 : 0, my = i == 0 ? 1 : 2, ml = 2 - i;
      const float scale_x = 0.5f * static_cast<float>(of_pair(a.w, i) - 1);
      const float scale_y = 0.5f * static_cast<float>(of_pair(a.h, i) - 1);
      const float scale_l = 0.5f * static_cast<float>(of_pair(a.len, i) - 1);
      Vec<VEC> t[4], l[2];
#pragma unroll
      for (int c = 0; c < 4; ++c) t[c] = zero_vec<VEC>();
      l[0] = l[1] = zero_vec<VEC>();
      const unsigned m = masks[r];
      // each live sample's lane sums, added over the group after the walk:
      // no shuffle waits inside it, so a sample's loads need not wait for
      // the previous sample's sums
      float acc[kCoordRun][3];
#pragma unroll
      for (int u = 0; u < kCoordRun; ++u) acc[u][0] = acc[u][1] = acc[u][2] = 0.0f;
#pragma unroll
      for (int u = 0; u < kCoordRun; ++u) {
        if (!has || !((m >> u) & 1)) continue;
        const int k = r * kCoordRun + u;
        const fwd::Step e = st[u];
        fwd::enter<VEC>(t[0], o.plane, e.plane.x, o.c);
        fwd::enter<VEC>(t[1], o.plane, e.plane.y, o.c);
        fwd::enter<VEC>(t[2], o.plane, e.plane.z, o.c);
        fwd::enter<VEC>(t[3], o.plane, e.plane.w, o.c);
        fwd::enter<VEC>(l[0], o.line, e.line.x, o.c);
        fwd::enter<VEC>(l[1], o.line, e.line.y, o.c);
        if (e.out) {  // rare: a corner outside the grid
          fwd::flag_out<VEC>(t[0], e.out & 1);
          fwd::flag_out<VEC>(t[1], e.out & 2);
          fwd::flag_out<VEC>(t[2], e.out & 4);
          fwd::flag_out<VEC>(t[3], e.out & 8);
          fwd::flag_out<VEC>(l[0], e.out & 16);
          fwd::flag_out<VEC>(l[1], e.out & 32);
        }
        Vec<VEC> up;
        if (o.out < 0) {
          const float d = ss[k];
#pragma unroll
          for (int q = 0; q < VEC; ++q) up.v[q] = d;
        } else {
          up = bwd::load_any<VEC>(sa + k * p.cols + o.out);
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          // slots by parity: t[0] (y slot 0, x slot 0), t[1] (0, 1), t[2]
          // (1, 0), t[3] (1, 1); the derivatives in the upper corners'
          // weights, up to the sign of an odd cell
          const float r0 = t[0].v[q] * e.wxy.x + t[1].v[q] * e.wxy.y;
          const float r1 = t[2].v[q] * e.wxy.x + t[3].v[q] * e.wxy.y;
          const float pf = r0 * e.wxy.z + r1 * e.wxy.w;
          const float lf = l[0].v[q] * e.wl.x + l[1].v[q] * e.wl.y;
          const float ul = up.v[q] * lf;
          acc[u][0] += ul * (e.wxy.z * (t[1].v[q] - t[0].v[q]) +
                             e.wxy.w * (t[3].v[q] - t[2].v[q]));
          acc[u][1] += ul * (r1 - r0);
          acc[u][2] += up.v[q] * pf * (l[1].v[q] - l[0].v[q]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        if (off < g) {
#pragma unroll
          for (int u = 0; u < kCoordRun; ++u) {
            acc[u][0] += __shfl_xor_sync(gmask, acc[u][0], off);
            acc[u][1] += __shfl_xor_sync(gmask, acc[u][1], off);
            acc[u][2] += __shfl_xor_sync(gmask, acc[u][2], off);
          }
        }
      }
      if (glane == 0) {
#pragma unroll
        for (int u = 0; u < kCoordRun; ++u) {
          if (!((m >> u) & 1)) continue;
          const int odd = st[u].odd;
          float* out = sums + ((r * kCoordRun + u) * p.parts + part) * 3;
          out[mx] = (odd & 1 ? -acc[u][0] : acc[u][0]) * scale_x;
          out[my] = (odd & 2 ? -acc[u][1] : acc[u][1]) * scale_y;
          out[ml] = (odd & 4 ? -acc[u][2] : acc[u][2]) * scale_l;
        }
      }
    }
    hop::named_sync<kConsumerThreads>();
    if (lane == 0) hop::mbar_arrive(empty + s);

    // the parts' sums in a fixed order, a thread an output float
    for (int t = threadIdx.x; t < 3 * count; t += kConsumerThreads) {
      const int k = t / 3;
      float v = 0.0f;
      if (live[k])
        for (int q = 0; q < p.parts; ++q) v += sums[(k * p.parts + q) * 3 + t - 3 * k];
      dxyz[3 * n0 + t] = v;
    }
  }
}

}  // namespace cgrad
}  // namespace iff

namespace {

// The kernels' table arguments from the wrapper's: ptrs the 12 tables,
// dims as iff_field_features takes them, app whether the appearance ranks
// are read. -> false for what the kernels do not take; log_g the log2 of
// the lanes a sample.
bool fill_args(const long long* ptrs, const int* dims, bool app, int vec,
               iff::FieldArgs& a, int& log_g) {
  const int words = vec ? 4 : 1;
  int widest = 1;
  for (int i = 0; i < 3; ++i) {
    a.dplane[i] = reinterpret_cast<const float*>(ptrs[i]);
    a.dline[i] = reinterpret_cast<const float*>(ptrs[3 + i]);
    a.aplane[i] = reinterpret_cast<const float*>(ptrs[6 + i]);
    a.aline[i] = reinterpret_cast<const float*>(ptrs[9 + i]);
    a.h[i] = dims[5 * i];
    a.w[i] = dims[5 * i + 1];
    a.len[i] = dims[5 * i + 2];
    a.rd[i] = dims[5 * i + 3];
    a.ra[i] = app ? dims[5 * i + 4] : 0;
    a.app_off[i] = dims[15 + i];
    if (a.h[i] < 1 || a.w[i] < 1 || a.len[i] < 1 || a.rd[i] < 1 || a.ra[i] < 0 ||
        !a.dplane[i] || !a.dline[i] || (a.ra[i] && (!a.aplane[i] || !a.aline[i])) ||
        (vec && (a.rd[i] % 4 || a.ra[i] % 4)))
      return false;
    const int nv = (a.rd[i] + a.ra[i]) / words;
    widest = nv > widest ? nv : widest;
  }
  a.app_cols = dims[18];
  log_g = 0;
  while ((1 << log_g) < widest && log_g < 5) ++log_g;
  return true;
}

// The blocks of `threads` threads and `smem` bytes of the forward kernel
// that fit on the current device at once (the kernel's shared-memory limit
// raised to smem first: a launch takes at most the largest smem asked).
int resident_blocks(bool vec, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (vec) {
    if (smem > iff::fwd::kSmallSmem)
      cudaFuncSetAttribute(iff::fwd::field_features_kernel<4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, iff::fwd::field_features_kernel<4>,
                                                  threads, smem);
  } else {
    if (smem > iff::fwd::kSmallSmem)
      cudaFuncSetAttribute(iff::fwd::field_features_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, iff::fwd::field_features_kernel<1>,
                                                  threads, smem);
  }
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

}  // namespace

// xyz [N, 3] float32 normalized coords; ptrs: the 12 tables (density
// planes, density lines, app planes, app lines) as device addresses, all
// float32 and contiguous; dims: (H, W, L, Rd, Ra) for each pair, the first
// output column of each pair's products and their total width. sigma [N]
// float32; app [N, width] float32, or null for density only (then Ra and the
// app tables are not read). vec != 0 takes float4 words (every rank a
// multiple of 4, every table and app 16-byte aligned). max_blocks caps
// the grid. Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_field_features(const void* xyz, long long N, const long long* ptrs,
                                  const int* dims, void* sigma, void* app, int vec,
                                  int max_blocks, void* stream) {
  namespace f = iff::fwd;
  if (N < 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  iff::FieldArgs a;
  int log_g;
  if (!fill_args(ptrs, dims, app != nullptr, vec, a, log_g))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    const long long rows = static_cast<long long>(a.h[i]) * a.w[i] + a.len[i];
    const int ranks = a.rd[i] > a.ra[i] ? a.rd[i] : a.ra[i];
    if (rows * ranks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = vec ? 4 : 1;
  const int g = 1 << log_g;
  f::Plan p;
  p.log_g = log_g;
  p.parts = 0;
  p.red = 1;
  for (int i = 0; i < 3; ++i) {
    p.parts += ((a.rd[i] + a.ra[i]) / words + g - 1) / g;
    const int nd = a.rd[i] / words < g ? a.rd[i] / words : g;
    p.red = nd > p.red ? nd : p.red;
  }
  // a run's share of shared memory: its steps for the 3 pairs and its
  // groups' density sums
  const int run_bytes =
      (3 * static_cast<int>(sizeof(f::Step)) + p.parts * p.red * 4) * f::kMaxRun;
  if (run_bytes > f::kSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int max_runs = f::kSmem / run_bytes;
  // the fewest warps whose groups hold whole runs, doubled up to kWarps
  // while the runs fit; a block whose groups are fewer than a run's parts
  // passes over its runs until every part is done
  const int per_warp = 32 >> log_g;
  int warps = p.parts / std::gcd(p.parts, per_warp);
  if (warps > f::kMaxWarps) warps = f::kMaxWarps;
  while (2 * warps <= f::kWarps && 2 * warps * per_warp / p.parts <= max_runs) warps *= 2;
  p.runs = warps * per_warp / p.parts;
  p.runs = p.runs < 1 ? 1 : (p.runs > max_runs ? max_runs : p.runs);
  const int threads = 32 * warps;
  long long resident = resident_blocks(vec != 0, threads, p.runs * run_bytes);
  if (resident > max_blocks) resident = max_blocks;
  // the longest run that leaves every resident block kSpansPerBlock spans
  p.run = f::kMaxRun;
  while (p.run > 1 && (N + static_cast<long long>(p.runs) * p.run - 1) /
                              (static_cast<long long>(p.runs) * p.run) <
                          f::kSpansPerBlock * resident)
    p.run >>= 1;
  const long long span = static_cast<long long>(p.runs) * p.run;
  p.spans = (N + span - 1) / span;
  const int smem = static_cast<int>(span) * run_bytes / f::kMaxRun;
  const int blocks = static_cast<int>(p.spans < resident ? p.spans : resident);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  auto* sg = static_cast<float*>(sigma);
  auto* ap = static_cast<float*>(app);
  if (vec)
    f::field_features_kernel<4><<<blocks, threads, smem, s>>>(x, sg, ap, a, p, N);
  else
    f::field_features_kernel<1><<<blocks, threads, smem, s>>>(x, sg, ap, a, p, N);
  return static_cast<int>(cudaGetLastError());
}

// The backward of iff_field_features: xyz, ptrs and dims as it takes them;
// grads the 12 gradient tables (the tables' shapes, float32, zeroed by the
// caller; null for one whose gradient is not wanted), to which the kernel
// adds; dsigma [N] float32; dapp [N, width] float32, or null for density
// only. vec != 0 takes float4 words and float4 atomics (every rank a
// multiple of 4, every table, gradient and dapp 16-byte aligned). The
// ring reads xyz, dsigma and dapp only when all three are 16-byte
// aligned. Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_field_features_bwd(const void* xyz, long long N, const long long* ptrs,
                                      const long long* grads, const int* dims,
                                      const void* dsigma, const void* dapp, int vec,
                                      int max_blocks, void* stream) {
  namespace b = iff::bwd;
  if (N < 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  iff::FieldArgs a;
  int log_g;
  if (!fill_args(ptrs, dims, dapp != nullptr, vec, a, log_g))
    return static_cast<int>(cudaErrorInvalidValue);
  iff::FieldGrads gr;
  for (int i = 0; i < 3; ++i) {
    gr.dplane[i] = reinterpret_cast<float*>(grads[i]);
    gr.dline[i] = reinterpret_cast<float*>(grads[3 + i]);
    gr.aplane[i] = reinterpret_cast<float*>(grads[6 + i]);
    gr.aline[i] = reinterpret_cast<float*>(grads[9 + i]);
  }
  const int words = vec ? 4 : 1;
  const int g = 1 << log_g;
  b::Plan p;
  p.log_g = log_g;
  p.parts = 0;
  for (int i = 0; i < 3; ++i) p.parts += ((a.rd[i] + a.ra[i]) / words + g - 1) / g;
  const int groups = (b::kConsumerWarps * 32) >> log_g;
  p.cols = dapp ? a.app_cols : 0;
  p.run_bytes = b::kStageSamples * (16 + 4 * p.cols);
  int smem_cap = b::kSmallSmem;
  if (b::kBarrierBytes + b::kStages * p.run_bytes > smem_cap) smem_cap = 227 * 1024;
  const int fit = (smem_cap - b::kBarrierBytes) / (b::kStages * p.run_bytes);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.runs = groups / p.parts < 1 ? 1 : groups / p.parts;
  if (p.runs > fit) p.runs = fit;
  p.rounds = (p.runs * p.parts + groups - 1) / groups;
  p.direct = ((reinterpret_cast<uintptr_t>(xyz) | reinterpret_cast<uintptr_t>(dsigma) |
               reinterpret_cast<uintptr_t>(dapp)) & 15) != 0;
  const long long span = static_cast<long long>(p.runs) * b::kRunSamples;
  p.items = (N + span - 1) / span * p.rounds;
  const int smem = b::kBarrierBytes + b::kStages * p.runs * p.run_bytes;
  const int blocks = static_cast<int>(p.items < max_blocks ? p.items : max_blocks);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  auto* ds = static_cast<const float*>(dsigma);
  auto* da = static_cast<const float*>(dapp);
  if (vec) {
    if (smem > b::kSmallSmem)
      cudaFuncSetAttribute(b::field_features_bwd_kernel<4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    b::field_features_bwd_kernel<4><<<blocks, b::kThreads, smem, s>>>(x, ds, da, a, gr, p, N);
  } else {
    if (smem > b::kSmallSmem)
      cudaFuncSetAttribute(b::field_features_bwd_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    b::field_features_bwd_kernel<1><<<blocks, b::kThreads, smem, s>>>(x, ds, da, a, gr, p, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// The coordinate gradient of iff_field_features: xyz, ptrs and dims as it
// takes them; dsigma [N] float32; dapp [N, width] float32, or null for
// density only; dxyz [N, 3] float32, written whole (zeros for a sample
// without upstream). vec != 0 takes float4 words (every rank a multiple of
// 4, every table and dapp 16-byte aligned). max_blocks caps the grid.
// Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_field_features_coords_grad(const void* xyz, long long N,
                                              const long long* ptrs, const int* dims,
                                              const void* dsigma, const void* dapp, void* dxyz,
                                              int vec, int max_blocks, void* stream) {
  namespace c = iff::cgrad;
  if (N < 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  iff::FieldArgs a;
  int log_g;
  if (!fill_args(ptrs, dims, dapp != nullptr, vec, a, log_g))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    const long long rows = static_cast<long long>(a.h[i]) * a.w[i] + a.len[i];
    const int ranks = a.rd[i] > a.ra[i] ? a.rd[i] : a.ra[i];
    if (rows * ranks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = vec ? 4 : 1;
  const int g = 1 << log_g;
  c::Plan p;
  p.log_g = log_g;
  p.parts = 0;
  for (int i = 0; i < 3; ++i) p.parts += ((a.rd[i] + a.ra[i]) / words + g - 1) / g;
  const int groups = c::kConsumerThreads >> log_g;
  p.cols = dapp ? a.app_cols : 0;
  // as many runs as the groups take at once, fewer while the ring and the
  // two buffers overflow shared memory
  p.runs = groups / p.parts < 1 ? 1 : groups / p.parts;
  // a consumer warp votes on at most 32 samples a stage
  if (p.runs > 32 * c::kConsumerWarps / c::kCoordRun) p.runs = 32 * c::kConsumerWarps / c::kCoordRun;
  int smem;
  for (;;) {
    p.stage = p.runs * c::kCoordRun;
    p.stage_bytes = p.stage * (16 + 4 * p.cols);
    smem = c::kBarrierBytes + c::kStages * p.stage_bytes + 2 * c::buffer_bytes(p);
    if (smem <= c::kMaxSmem || p.runs == 1) break;
    --p.runs;
  }
  if (smem > c::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ends = reinterpret_cast<uintptr_t>(xyz) | reinterpret_cast<uintptr_t>(dsigma) |
                         reinterpret_cast<uintptr_t>(dapp);
  p.direct = 0 != (ends & 15);
  p.stages = (N + p.stage - 1) / p.stage;
  auto kernel = vec ? c::field_features_coords_grad_kernel<4>
                    : c::field_features_coords_grad_kernel<1>;
  if (smem > c::kSmallSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, c::kThreads, smem);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > p.stages) blocks = p.stages;
  kernel<<<static_cast<int>(blocks), c::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dsigma),
      static_cast<const float*>(dapp), a, p, N, static_cast<float*>(dxyz));
  return static_cast<int>(cudaGetLastError());
}
