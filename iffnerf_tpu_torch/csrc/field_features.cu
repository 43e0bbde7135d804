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
// once each, plus each plane and line row that the samples touch. The
// corner reads themselves (4 plane rows and 2 line rows a sample and axis
// pair, 4.6 KB a sample at lego's ranks) are served by L1 and L2: lego's
// six planes and lines total 69 MB at 300^3, and the texels of one ray's
// samples are close together.
//
// Mapping: a group of g threads owns a sample (g the power of two that
// covers the widest pair's density + appearance words, capped at 32:
// g = 16 at lego's ranks 16 + 48 in float4 words, 4 density-only). Lanes
// take neighbouring 16-byte (float4, when every rank is a multiple of 4 and
// every table 16-byte aligned) or 4-byte words of the corner rows, a lane's
// words running over the density ranks, then the appearance ranks: 64- to
// 256-byte reads of each corner row per group. Each lane lerps its words,
// adds its density products to a partial sigma, and stores its appearance
// products (coalesced, 192 B a pair at lego's ranks). The partial sigmas
// meet with warp shuffles. A grid-stride loop walks the samples; each warp
// loops as long as its first group has a sample, so that every lane
// reaches the shuffles.
//
// Numerics are the grid samplers' (ops/grid_sample.py): align_corners=True,
// zeros padding, the lower corner floor(p) as an int with both corners
// clamped and flagged, a flagged-out texel multiplied by 0. Every product
// and sum of the lerps is rounded on its own (__fmul_rn, __fadd_rn: no FMA
// contraction) in the samplers' order, so the appearance products equal
// the plain route's; only sigma's sum over ranks runs in another order.
//
// The backward (field_features_bwd_kernel, iff_field_features_bwd) is the
// gradient of the same function with respect to the 12 tables. The JAX
// package differentiates this work in XLA (a sorted scatter-add and a
// one-hot product, iffnerf_tpu/ops/packed_sample.py:234-305), not in a
// Pallas kernel. Here it keeps the forward's mapping: each lane recomputes
// its sample's corners, weights and flags as the forward does, reads its
// upstream words (dsigma for the density ranks, dapp for the appearance
// ranks), and only where those are not all zero reads the corner rows and
// adds w_corner * line * g into each plane corner texel and w_corner *
// plane * g into each line corner texel with atomicAdd (float4 atomics on
// global memory, which compute capability 9.x has, when the forward takes
// float4 words). A flagged-out corner adds nothing. Most samples of a
// training step carry no gradient (outside the AABB or the alpha mask, or
// below the appearance threshold), so the zero test keeps their corner
// reads and atomics off the memory system. The additions land in another
// order on every run: the gradient is not bit-stable. Bound: bytes (the
// coordinates and upstream gradients once, each touched row of the tables
// read and of the gradients written once); what holds it is the atomics'
// contention, since consecutive samples of a ray share texels.
#include <cstdint>

#include <cuda_runtime.h>

namespace iff {

constexpr int kFieldThreads = 256;

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
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& x);

template <>
__device__ __forceinline__ void store_vec<1>(float* p, const Vec<1>& x) {
  *p = x.v[0];
}

template <>
__device__ __forceinline__ void store_vec<4>(float* p, const Vec<4>& x) {
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
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

// The two corners of one axis (ops/grid_sample.py::_axis).
struct Axis {
  int i0, i1;     // clamped texel indices
  float v0, v1;   // 1 in range, 0 out of range
  float w, u;     // weight of the upper corner, 1 - w
};

__device__ __forceinline__ Axis make_axis(float g, int size) {
  // (g + 1) * 0.5 * (size - 1), each step rounded as torch rounds it
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f),
                            static_cast<float>(size - 1));
  const float f = floorf(p);
  // A floor more than a texel outside the grid flags both corners out,
  // whatever its value, so clamping it first changes no result and keeps
  // i0 + 1 from overflowing.
  const int i0 = static_cast<int>(fminf(fmaxf(f, -2.0f), static_cast<float>(size)));
  Axis a;
  a.v0 = (i0 >= 0 && i0 <= size - 1) ? 1.0f : 0.0f;
  a.v1 = (i0 + 1 >= 0 && i0 + 1 <= size - 1) ? 1.0f : 0.0f;
  a.i0 = min(max(i0, 0), size - 1);
  a.i1 = min(max(i0 + 1, 0), size - 1);
  a.w = __fsub_rn(p, f);
  a.u = __fsub_rn(1.0f, a.w);
  return a;
}

// lo * (1 - w) + hi * w, as the samplers round it
__device__ __forceinline__ float lerp(float lo, float hi, float u, float w) {
  return __fadd_rn(__fmul_rn(lo, u), __fmul_rn(hi, w));
}

template <int VEC>
__global__ void __launch_bounds__(kFieldThreads)
    field_features_kernel(const float* __restrict__ xyz, float* __restrict__ sigma,
                          float* __restrict__ app, const FieldArgs a, int64_t N,
                          int log_g) {
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> log_g;
  const int64_t warp_first = (tid & ~static_cast<int64_t>(31)) >> log_g;
  int64_t n = tid >> log_g;
  for (int64_t first = warp_first; first < N; first += stride, n += stride) {
    float s = 0.0f;
    if (n < N) {
      const float x[3] = {__ldg(xyz + 3 * n), __ldg(xyz + 3 * n + 1), __ldg(xyz + 3 * n + 2)};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // MAT_MODE ((0, 1), (0, 2), (1, 2)), VEC_MODE (2, 1, 0)
        const int m0 = i == 2 ? 1 : 0;
        const int m1 = i == 0 ? 1 : 2;
        const Axis ax = make_axis(x[m0], a.w[i]);
        const Axis ay = make_axis(x[m1], a.h[i]);
        const Axis al = make_axis(x[2 - i], a.len[i]);
        const int64_t r00 = static_cast<int64_t>(ay.i0) * a.w[i] + ax.i0;
        const int64_t r01 = static_cast<int64_t>(ay.i0) * a.w[i] + ax.i1;
        const int64_t r10 = static_cast<int64_t>(ay.i1) * a.w[i] + ax.i0;
        const int64_t r11 = static_cast<int64_t>(ay.i1) * a.w[i] + ax.i1;
        const float v00 = ay.v0 * ax.v0, v01 = ay.v0 * ax.v1;
        const float v10 = ay.v1 * ax.v0, v11 = ay.v1 * ax.v1;
        const int nd = a.rd[i] / VEC;
        const int nv = nd + a.ra[i] / VEC;
        for (int j = lane; j < nv; j += g) {
          const bool dens = j < nd;
          const float* plane = dens ? a.dplane[i] : a.aplane[i];
          const float* line = dens ? a.dline[i] : a.aline[i];
          const int64_t c = dens ? a.rd[i] : a.ra[i];
          const int col = (dens ? j : j - nd) * VEC;
          const Vec<VEC> t00 = load_vec<VEC>(plane + r00 * c + col);
          const Vec<VEC> t01 = load_vec<VEC>(plane + r01 * c + col);
          const Vec<VEC> t10 = load_vec<VEC>(plane + r10 * c + col);
          const Vec<VEC> t11 = load_vec<VEC>(plane + r11 * c + col);
          const Vec<VEC> l0 = load_vec<VEC>(line + al.i0 * c + col);
          const Vec<VEC> l1 = load_vec<VEC>(line + al.i1 * c + col);
          Vec<VEC> prod;
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const float top = lerp(__fmul_rn(t00.v[q], v00), __fmul_rn(t01.v[q], v01), ax.u, ax.w);
            const float bot = lerp(__fmul_rn(t10.v[q], v10), __fmul_rn(t11.v[q], v11), ax.u, ax.w);
            const float pf = lerp(top, bot, ay.u, ay.w);
            const float lf = lerp(__fmul_rn(l0.v[q], al.v0), __fmul_rn(l1.v[q], al.v1), al.u, al.w);
            prod.v[q] = __fmul_rn(pf, lf);
          }
          if (dens) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) s += prod.v[q];
          } else {
            store_vec<VEC>(app + n * a.app_cols + a.app_off[i] + col, prod);
          }
        }
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off, g);
    if (n < N && lane == 0) sigma[n] = s;
  }
}

struct FieldGrads {
  float* dplane[3];  // null: that table's gradient is not wanted
  float* dline[3];
  float* aplane[3];
  float* aline[3];
};

template <int VEC>
__device__ __forceinline__ void scatter_word(const float* plane, const float* line,
                                             float* gplane, float* gline, int64_t c,
                                             int col, int64_t r00, int64_t r01,
                                             int64_t r10, int64_t r11, const Axis& ax,
                                             const Axis& ay, const Axis& al,
                                             const Vec<VEC>& g) {
  const Vec<VEC> t00 = load_vec<VEC>(plane + r00 * c + col);
  const Vec<VEC> t01 = load_vec<VEC>(plane + r01 * c + col);
  const Vec<VEC> t10 = load_vec<VEC>(plane + r10 * c + col);
  const Vec<VEC> t11 = load_vec<VEC>(plane + r11 * c + col);
  const Vec<VEC> l0 = load_vec<VEC>(line + al.i0 * c + col);
  const Vec<VEC> l1 = load_vec<VEC>(line + al.i1 * c + col);
  const float v[4] = {ay.v0 * ax.v0, ay.v0 * ax.v1, ay.v1 * ax.v0, ay.v1 * ax.v1};
  Vec<VEC> dpf, dlf;  // d/d(plane value), d/d(line value)
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    // the forward's plane and line values, in its order
    const float top = lerp(t00.v[q] * v[0], t01.v[q] * v[1], ax.u, ax.w);
    const float bot = lerp(t10.v[q] * v[2], t11.v[q] * v[3], ax.u, ax.w);
    const float pf = lerp(top, bot, ay.u, ay.w);
    const float lf = lerp(l0.v[q] * al.v0, l1.v[q] * al.v1, al.u, al.w);
    dpf.v[q] = lf * g.v[q];
    dlf.v[q] = pf * g.v[q];
  }
  if (gplane) {
    const float wc[4] = {ay.u * ax.u, ay.u * ax.w, ay.w * ax.u, ay.w * ax.w};
    const int64_t rows[4] = {r00, r01, r10, r11};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v[k] == 0.0f) continue;  // flagged out: the forward read a zero
      Vec<VEC> d;
#pragma unroll
      for (int q = 0; q < VEC; ++q) d.v[q] = wc[k] * dpf.v[q];
      atomic_add_vec<VEC>(gplane + rows[k] * c + col, d);
    }
  }
  if (gline) {
    if (al.v0 != 0.0f) {
      Vec<VEC> d;
#pragma unroll
      for (int q = 0; q < VEC; ++q) d.v[q] = al.u * dlf.v[q];
      atomic_add_vec<VEC>(gline + al.i0 * c + col, d);
    }
    if (al.v1 != 0.0f) {
      Vec<VEC> d;
#pragma unroll
      for (int q = 0; q < VEC; ++q) d.v[q] = al.w * dlf.v[q];
      atomic_add_vec<VEC>(gline + al.i1 * c + col, d);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kFieldThreads)
    field_features_bwd_kernel(const float* __restrict__ xyz,
                              const float* __restrict__ dsigma,
                              const float* __restrict__ dapp, const FieldArgs a,
                              const FieldGrads gr, int64_t N, int log_g) {
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> log_g;
  for (int64_t n = tid >> log_g; n < N; n += stride) {
    const float gs = __ldg(dsigma + n);
    const float x[3] = {__ldg(xyz + 3 * n), __ldg(xyz + 3 * n + 1), __ldg(xyz + 3 * n + 2)};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int m0 = i == 2 ? 1 : 0;
      const int m1 = i == 0 ? 1 : 2;
      const Axis ax = make_axis(x[m0], a.w[i]);
      const Axis ay = make_axis(x[m1], a.h[i]);
      const Axis al = make_axis(x[2 - i], a.len[i]);
      const int64_t r00 = static_cast<int64_t>(ay.i0) * a.w[i] + ax.i0;
      const int64_t r01 = static_cast<int64_t>(ay.i0) * a.w[i] + ax.i1;
      const int64_t r10 = static_cast<int64_t>(ay.i1) * a.w[i] + ax.i0;
      const int64_t r11 = static_cast<int64_t>(ay.i1) * a.w[i] + ax.i1;
      const int nd = gs != 0.0f ? a.rd[i] / VEC : 0;  // no density gradient: skip
      const int start = gs != 0.0f ? 0 : a.rd[i] / VEC;
      const int nv = a.rd[i] / VEC + a.ra[i] / VEC;
      for (int j = start + lane; j < nv; j += g) {
        if (j < nd) {
          Vec<VEC> gv;
#pragma unroll
          for (int q = 0; q < VEC; ++q) gv.v[q] = gs;
          scatter_word<VEC>(a.dplane[i], a.dline[i], gr.dplane[i], gr.dline[i], a.rd[i],
                            j * VEC, r00, r01, r10, r11, ax, ay, al, gv);
        } else {
          const int col = (j - a.rd[i] / VEC) * VEC;
          const Vec<VEC> gv = load_vec<VEC>(dapp + n * a.app_cols + a.app_off[i] + col);
          if (!any_nonzero<VEC>(gv)) continue;
          scatter_word<VEC>(a.aplane[i], a.aline[i], gr.aplane[i], gr.aline[i], a.ra[i],
                            col, r00, r01, r10, r11, ax, ay, al, gv);
        }
      }
    }
  }
}

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

int grid_blocks(long long N, int log_g, int max_blocks) {
  const int64_t per_block = iff::kFieldThreads >> log_g;
  const int64_t want = (N + per_block - 1) / per_block;
  return static_cast<int>(want < max_blocks ? want : max_blocks);
}

}  // namespace

// xyz [N, 3] float32 normalized coords; ptrs: the 12 tables (density
// planes, density lines, app planes, app lines) as device addresses, all
// float32 and contiguous; dims: (H, W, L, Rd, Ra) for each pair, the first
// output column of each pair's products and their total width. sigma [N]
// float32; app [N, width] float32, or null for density only (then Ra and the
// app tables are not read). vec != 0 takes float4 words (every rank a
// multiple of 4, every table and app 16-byte aligned). Returns a
// cudaError_t; N == 0 launches nothing.
extern "C" int iff_field_features(const void* xyz, long long N, const long long* ptrs,
                                  const int* dims, void* sigma, void* app, int vec,
                                  int max_blocks, void* stream) {
  if (N < 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  iff::FieldArgs a;
  int log_g;
  if (!fill_args(ptrs, dims, app != nullptr, vec, a, log_g))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks(N, log_g, max_blocks);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  auto* sg = static_cast<float*>(sigma);
  auto* ap = static_cast<float*>(app);
  if (vec)
    iff::field_features_kernel<4><<<blocks, iff::kFieldThreads, 0, s>>>(x, sg, ap, a, N, log_g);
  else
    iff::field_features_kernel<1><<<blocks, iff::kFieldThreads, 0, s>>>(x, sg, ap, a, N, log_g);
  return static_cast<int>(cudaGetLastError());
}

// The backward of iff_field_features: xyz, ptrs and dims as it takes them;
// grads the 12 gradient tables (the tables' shapes, float32, zeroed by the
// caller; null for one whose gradient is not wanted), to which the kernel
// adds; dsigma [N] float32; dapp [N, width] float32, or null for density
// only. vec != 0 takes float4 words and float4 atomics (every rank a
// multiple of 4, every table, gradient and dapp 16-byte aligned). Returns a
// cudaError_t; N == 0 launches nothing.
extern "C" int iff_field_features_bwd(const void* xyz, long long N, const long long* ptrs,
                                      const long long* grads, const int* dims,
                                      const void* dsigma, const void* dapp, int vec,
                                      int max_blocks, void* stream) {
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
  const int blocks = grid_blocks(N, log_g, max_blocks);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  auto* ds = static_cast<const float*>(dsigma);
  auto* da = static_cast<const float*>(dapp);
  if (vec)
    iff::field_features_bwd_kernel<4><<<blocks, iff::kFieldThreads, 0, s>>>(x, ds, da, a, gr, N, log_g);
  else
    iff::field_features_bwd_kernel<1><<<blocks, iff::kFieldThreads, 0, s>>>(x, ds, da, a, gr, N, log_g);
  return static_cast<int>(cudaGetLastError());
}
