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
// Forward (cp_features_kernel, iff_cp_features). Bound on an H100 SXM:
// bytes. Device memory sees the coordinates (12 B a sample), sigma (4 B)
// and the appearance products (4 B a rank) once each; at ranks 96 / 288
// that is 1 168 B a sample, 8.3 GB at 7.1 M samples, 2.5 ms at 3.35 TB/s.
// The lines are at most 3 x 500 x 384 x 4 B = 2.3 MB and stay in L2.
// Mapping: a group of g lanes owns a sample (g the power of two that covers
// the density + appearance words of a row, capped at 32: a word is a float4
// when every rank is a multiple of 4 and every pointer 16-byte aligned,
// else a float); lanes take neighbouring words, density first, read their
// word of the 6 corner rows through the read-only path (L1), lerp and
// multiply in registers, and store their appearance word: a warp's stores
// are whole 512-byte lines. A group walks a run of kRun consecutive
// samples; a training step's samples are ray-major at half a texel a step,
// so a run's samples mostly read the same rows, which L1 keeps. The lane
// sums of sigma meet by shuffles within the group.
//
// Line gradient (cp_features_bwd_kernel, iff_cp_features_bwd): for each
// sample, axis i and rank c, the upstream u (dsigma for a density rank,
// dapp[c] for an appearance rank) times the other two axes' lerps, times
// (1 - w) into row r0 and times w into row r1 of line i, where the corner
// is in range. Each line row is hit about N / L times a step (14 000 at
// 7.1 M samples and L = 500), so atomics into device memory alone would
// serialise on a few hundred addresses. Design: a block owns a slice of cw
// columns (ranks; density and appearance ranks side by side) and a chunk of
// samples, and keeps its slice's accumulators of all three lines in shared
// memory ([L_0 + L_1 + L_2][cw] floats, at most 112 KB so that two blocks
// fit an SM). A group of cw lanes (a lane a column) walks a contiguous part
// of the chunk in order, keeps each axis's two corner rows' values and
// running sums in registers, and adds a sum to shared memory only when its
// row changes (a straight ray changes row about once every two samples at
// half a texel a step, an axis-aligned ray's other two axes never). A lane
// whose upstream is zero (samples outside the mask or below the weight
// threshold) skips the sample. At the end the block adds its non-zero
// accumulators into the gradient lines with float REDs: a row and column
// takes one RED a chunk. Bound on an H100 SXM: bytes, nearly all of them
// the upstream read (dapp, 1 152 B a sample at 288 ranks). This first
// design takes about 10 times that bound at a lego CP step (PERF.md): the
// shared-memory adds and the per-lane walk, not the bytes, hold it. The
// additions land in another order on every run: the gradient is not
// bit-stable.
//
// Coordinate gradient (cp_coords_grad_kernel, iff_cp_features_coords_grad),
// for iNeRF on a CP field: for each sample and axis i, the sum over ranks
// of u * (f1 - f0) * the other two axes' lerps, scaled by (L_i - 1) / 2,
// into dxyz[2 - i]; f0 and f1 the flagged corner texels, so an axis whose
// corners are out of range adds zero. A kernel of its own with the
// forward's mapping (a group of lanes a sample, its words in registers):
// the group's partial sums meet by shuffles, no atomics. Bound: bytes, the
// upstream read (dapp) and the coordinates.
#include <cstdint>

#include <cuda_runtime.h>

namespace iff {
namespace cp {

constexpr int kThreads = 256;
constexpr int kRun = 8;                  // consecutive samples a group walks (forward)
constexpr int kMaxSmem = 112 * 1024;     // the backward's accumulators: two blocks an SM
constexpr int kBlocksPerSm = 8;          // grid cap of the forward's grid-stride loop

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

// One axis of one sample: clamped corner rows, their in-range flags as 1 or
// 0, the upper corner's weight w and 1 - w (grid_sample_1d's arithmetic).
struct Corner {
  int r0, r1;
  float m0, m1;
  float w, omw;
};

__device__ __forceinline__ Corner corner(float g, int L) {
  Corner c;
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), static_cast<float>(L - 1));
  const int i0 = static_cast<int>(floorf(p));
  const int i1 = i0 + 1;
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

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    cp_coords_grad_kernel(const float* __restrict__ xyz, Lines t,
                          const float* __restrict__ dsigma, const float* __restrict__ dapp,
                          float* __restrict__ dxyz, int64_t N, int log_g) {
  const int g = 1 << log_g;
  const Group grp = group_of(log_g);
  const int wd = t.rd / VEC, words = wd + t.ra / VEC;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t span = static_cast<int64_t>(grp.per_warp) * kRun;
  for (int64_t base = warp * span; base < N; base += warps * span) {
    const int64_t first = base + static_cast<int64_t>(grp.index) * kRun;
    for (int k = 0; k < kRun; ++k) {
      const int64_t n = first + k;
      const bool live = n < N;
      float acc[3] = {0.0f, 0.0f, 0.0f};
      if (live) {
        Corner c[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) c[i] = corner(__ldg(xyz + 3 * n + 2 - i), t.L[i]);
        const float us = __ldg(dsigma + n);
        for (int w = grp.sub; w < words; w += g) {
          const bool dens = w < wd;
          const int stride = dens ? t.rd : t.ra;
          const int col = (dens ? w : w - wd) * VEC;
          Vec<VEC> u;
          if (dens) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) u.v[e] = us;
          } else {
            u = load_vec<VEC>(dapp + n * t.ra + col);
          }
          Vec<VEC> l[3], d[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float* line = dens ? t.density[i] : t.app[i];
            const Vec<VEC> a = load_vec<VEC>(line + static_cast<int64_t>(c[i].r0) * stride + col);
            const Vec<VEC> b = load_vec<VEC>(line + static_cast<int64_t>(c[i].r1) * stride + col);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              l[i].v[e] = lerp(a.v[e], b.v[e], c[i]);
              d[i].v[e] = b.v[e] * c[i].m1 - a.v[e] * c[i].m0;
            }
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            // autograd's order through ((l0 * l1) * l2)
            const float u2 = u.v[e] * l[2].v[e];
            acc[0] += u2 * l[1].v[e] * d[0].v[e];
            acc[1] += u2 * l[0].v[e] * d[1].v[e];
            acc[2] += u.v[e] * (l[0].v[e] * l[1].v[e]) * d[2].v[e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        for (int o = g >> 1; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (live && grp.sub == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          dxyz[3 * n + 2 - i] = acc[i] * static_cast<float>(t.L[i] - 1) * 0.5f;
      }
    }
  }
}

struct Grads {
  float* density[3];
  float* app[3];
};

// Columns [col_lo, col_hi) of the concatenated ranks (density 0 .. rd - 1,
// appearance rd .. rd + ra - 1); block (x, y) takes columns col_lo + x * cw
// and samples [y * chunk, (y + 1) * chunk).
__global__ void __launch_bounds__(kThreads)
    cp_features_bwd_kernel(const float* __restrict__ xyz, Lines t, Grads gr,
                           const float* __restrict__ dsigma, const float* __restrict__ dapp,
                           int64_t N, int col_lo, int col_hi, int log_cw, int64_t chunk) {
  extern __shared__ float acc[];
  const int cw = 1 << log_cw;
  const int rows = t.L[0] + t.L[1] + t.L[2];
  const int total = rows * cw;
  for (int e = threadIdx.x; e < total; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & (cw - 1);
  const int group = threadIdx.x >> log_cw;
  const int groups = blockDim.x >> log_cw;
  const int col = col_lo + blockIdx.x * cw + lane;
  const int64_t n_lo = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t n_hi = n_lo + chunk < N ? n_lo + chunk : N;
  const int64_t per = (n_hi - n_lo + groups - 1) / groups;
  const int64_t s_lo = n_lo + group * per;
  const int64_t s_hi = s_lo + per < n_hi ? s_lo + per : n_hi;
  if (col < col_hi) {
    const bool dens = col < t.rd;
    const int stride = dens ? t.rd : t.ra;
    const int c = dens ? col : col - t.rd;
    const int off[3] = {0, t.L[0] * cw, (t.L[0] + t.L[1]) * cw};
    int cur0[3] = {-1, -1, -1}, cur1[3] = {-1, -1, -1};
    float v0[3] = {0.0f, 0.0f, 0.0f}, v1[3] = {0.0f, 0.0f, 0.0f};
    float a0[3] = {0.0f, 0.0f, 0.0f}, a1[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t n = s_lo; n < s_hi; ++n) {
      const float u = dens ? __ldg(dsigma + n) : __ldg(dapp + n * t.ra + c);
      if (u == 0.0f) continue;
      Corner k[3];
      float l[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        k[i] = corner(__ldg(xyz + 3 * n + 2 - i), t.L[i]);
        if (k[i].r0 != cur0[i] || k[i].r1 != cur1[i]) {
          if (cur0[i] >= 0) {
            atomicAdd(acc + off[i] + cur0[i] * cw + lane, a0[i]);
            atomicAdd(acc + off[i] + cur1[i] * cw + lane, a1[i]);
          }
          a0[i] = a1[i] = 0.0f;
          cur0[i] = k[i].r0;
          cur1[i] = k[i].r1;
          const float* line = dens ? t.density[i] : t.app[i];
          v0[i] = __ldg(line + static_cast<int64_t>(cur0[i]) * stride + c);
          v1[i] = __ldg(line + static_cast<int64_t>(cur1[i]) * stride + c);
        }
        l[i] = lerp(v0[i], v1[i], k[i]);
      }
      // autograd's order through ((l0 * l1) * l2)
      const float u2 = u * l[2];
      const float gi[3] = {u2 * l[1], u2 * l[0], u * (l[0] * l[1])};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a0[i] += gi[i] * k[i].omw * k[i].m0;
        a1[i] += gi[i] * k[i].w * k[i].m1;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (cur0[i] >= 0) {
        atomicAdd(acc + off[i] + cur0[i] * cw + lane, a0[i]);
        atomicAdd(acc + off[i] + cur1[i] * cw + lane, a1[i]);
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const float v = acc[e];
    if (v == 0.0f) continue;
    const int cg = col_lo + blockIdx.x * cw + (e & (cw - 1));
    if (cg >= col_hi) continue;
    int r = e >> log_cw, i = 0;
    if (r >= t.L[0]) {
      r -= t.L[0];
      i = 1;
      if (r >= t.L[1]) {
        r -= t.L[1];
        i = 2;
      }
    }
    const bool dens = cg < t.rd;
    float* grad = dens ? gr.density[i] : gr.app[i];
    if (grad == nullptr) continue;
    const int stride = dens ? t.rd : t.ra;
    atomicAdd(grad + static_cast<int64_t>(r) * stride + (dens ? cg : cg - t.rd), v);
  }
}

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

// xyz [N, 3] float32 normalized coords; ptrs: the density lines then the
// app lines of the 3 axes as device addresses (float32, contiguous [L_i,
// R]; the app ones 0 for density only); dims: (L_0, L_1, L_2, Rd, Ra),
// Rd or Ra 0 for a kind not computed. sigma [N] float32 or null (Rd 0);
// app [N, Ra] float32 or null (Ra 0). vec != 0 takes float4 words (Rd and
// Ra multiples of 4, every pointer 16-byte aligned). sms is the card's SM
// count. Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_cp_features(const void* xyz, long long N, const long long* ptrs,
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
// lines. xyz, ptrs and dims as iff_cp_features takes them; gptrs: the
// gradient lines in the same order (float32 [L_i, R], zeroed by the
// caller; 0 for a line not wanted); dsigma [N] and dapp [N, Ra] float32
// (either null when its kind is not wanted). Columns: the density ranks
// when want_density, the appearance ranks when want_app. log_cw: log2 of
// the columns a block owns (its shared memory (L_0 + L_1 + L_2) << log_cw
// floats, at most 112 KB); chunks: sample chunks (grid y). Returns a
// cudaError_t; N == 0 launches nothing.
extern "C" int iff_cp_features_bwd(const void* xyz, long long N, const long long* ptrs,
                                   const long long* gptrs, const int* dims,
                                   const void* dsigma, const void* dapp, int want_density,
                                   int want_app, int log_cw, int chunks, void* stream) {
  namespace c = iff::cp;
  c::Lines t;
  if (N < 0 || !c::make_lines(ptrs, dims, t) || log_cw < 0 || log_cw > 5 || chunks <= 0 ||
      chunks > 65535 || (want_density && !dsigma) || (want_app && (!dapp || t.ra == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || (!want_density && !want_app)) return 0;
  c::Grads gr;
  for (int i = 0; i < 3; ++i) {
    gr.density[i] = want_density ? reinterpret_cast<float*>(gptrs[i]) : nullptr;
    gr.app[i] = want_app ? reinterpret_cast<float*>(gptrs[3 + i]) : nullptr;
  }
  const int col_lo = want_density ? 0 : t.rd;
  const int col_hi = want_app ? t.rd + t.ra : t.rd;
  const int cw = 1 << log_cw;
  const long long smem = static_cast<long long>(t.L[0] + t.L[1] + t.L[2]) * cw * 4;
  if (smem > c::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (col_hi - col_lo + cw - 1) / cw;
  const int64_t chunk = (N + chunks - 1) / chunks;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(c::cp_features_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(slices, static_cast<unsigned>((N + chunk - 1) / chunk));
  c::cp_features_bwd_kernel<<<grid, c::kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), t, gr, static_cast<const float*>(dsigma),
      static_cast<const float*>(dapp), N, col_lo, col_hi, log_cw, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of sum(sigma * dsigma) (+ sum(app * dapp) when Ra > 0) with
// respect to xyz: xyz, ptrs, dims and vec as iff_cp_features takes them;
// dsigma [N] float32 (Rd > 0); dapp [N, Ra] float32 or null (Ra 0); dxyz
// [N, 3] float32, written whole. Returns a cudaError_t; N == 0 launches
// nothing.
extern "C" int iff_cp_features_coords_grad(const void* xyz, long long N, const long long* ptrs,
                                           const int* dims, const void* dsigma,
                                           const void* dapp, void* dxyz, int vec, int sms,
                                           void* stream) {
  namespace c = iff::cp;
  c::Lines t;
  if (N < 0 || sms <= 0 || !c::make_lines(ptrs, dims, t) || (vec && (t.rd % 4 || t.ra % 4)) ||
      t.rd == 0 || !dsigma || (t.ra > 0) != (dapp != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const int v = vec ? 4 : 1;
  const int log_g = c::log_group((t.rd + t.ra) / v);
  const int blocks = c::grid_of(N, log_g, sms);
  auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const float*>(xyz);
  auto* ds = static_cast<const float*>(dsigma);
  auto* da = static_cast<const float*>(dapp);
  if (vec)
    c::cp_coords_grad_kernel<4><<<blocks, c::kThreads, 0, s>>>(x, t, ds, da,
                                                              static_cast<float*>(dxyz), N, log_g);
  else
    c::cp_coords_grad_kernel<1><<<blocks, c::kThreads, 0, s>>>(x, t, ds, da,
                                                              static_cast<float*>(dxyz), N, log_g);
  return static_cast<int>(cudaGetLastError());
}
