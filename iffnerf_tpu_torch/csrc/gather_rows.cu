// Row gather out[n, :] = table[idx[n], :] for sm_90a, and its backward
// (namespace bwd, below).
//
// Replaces the Pallas TPU kernel pallas_gather of
// extra/pallas_gather_bench.py:46. On the port's main path it serves the
// alpha-mask lookup: grid_sample_3d (ops/grid_sample.py) stacks a sample
// set's 8 trilinear corners into one index array of the [D*H*W, 1] mask
// volume. It also serves the dense feature route of the field (planes
// [H*W, C], lines [L, C]), which the fused field kernel
// (field_features.cu) replaces for TensorVMSplit on the card.
//
// Nothing of the TPU design carries over. Mosaic could only DMA the aligned
// 8-row group around a row (8x the traffic) and needed the whole index array
// prefetched into scalar memory; here each thread group loads its own
// indices and reads just the rows.
//
// Bound on an H100 SXM: bytes. Per gathered row it reads the row (at the
// 32-byte sector granularity of the memory system), 4 bytes of index, and
// writes the row: about 2*N*C*4 + N*4 bytes at 3.35 TB/s. At K3's own bench
// shape ([90000, 256], N = 2^21) the 2.15 GB output goes to HBM and the
// 92 MB table only half fits the 50 MB L2: read in index order, about half
// the 2.15 GB of row reads miss L2 and go to device memory beside the
// writes. So the design:
//   * a bucketed route for such tables (rows_per_bucket > 0, chosen by the
//     wrapper): two short passes over the indices partition their
//     positions by table-row range into buckets that fit L2, and the
//     gather walks the positions bucket by bucket, so each table row comes
//     from device memory about once and the rest of its reads hit L2; the
//     output rows are written where they belong, in another order;
//   * U rows in flight per thread group: a group loads its U indices first,
//     then issues all U row loads, then all U stores, so the dependent
//     index -> row latency is paid once per U rows, not once a row;
//   * outputs are written with streaming stores (st.global.cs, evict-first),
//     so the output's lines do not push the table's rows out of L2;
//   * rows are read through the non-coherent path without L1 allocation
//     (ld.global.nc.L1::no_allocate): a row is read once, L1 keeps nothing
//     worth keeping; on the bucketed route the loads also carry an L2
//     evict_last policy (createpolicy), which asks L2 to keep the bucket's
//     lines;
//   * each route has one launch setting, tuned on an H100 (PERF.md): the
//     direct route 8 rows in flight, 8 blocks an SM, no L2 hint (tuned at
//     the mask lookup's shape); the bucketed route 1 row in flight, 4
//     blocks an SM, evict_last (tuned at the bench shape); the wrapper
//     (ops/gather.py) picks the route and the bucket size.
//
// Mapping: a group of tpr threads owns a row, tpr the power of two that
// covers the row's vectors, capped at 32. Neighbouring threads read
// neighbouring 16-byte (float4, when C % 4 == 0 and both pointers are 16-byte
// aligned) or 4-byte words of one row. A warp covers one row when the row is
// wide (C = 256: 64 float4, two per lane) and several when it is narrow
// (C = 16: 8 rows a warp; the mask's C = 1: 32 rows a warp), so narrow rows
// do not leave lanes idle. In a step the group's U rows are n0 + k * groups
// (k < U), so for each k the warp's stores are contiguous. A grid-stride
// loop walks the steps; offsets are 64-bit (N * C * 4 bytes passes 2^31 at
// the bench shape, 2^21 x 256).
//
// Indices follow jnp.take's default: -R <= i < 0 wraps to i + R, and any
// other index outside [0, R) writes a NaN row. Nothing reads outside the
// table.
#include <cstdint>

#include <cuda_runtime.h>

namespace iff {

constexpr int kGatherThreads = 256;

template <typename V>
__device__ __forceinline__ V nan_fill();

template <>
__device__ __forceinline__ float nan_fill<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ float4 nan_fill<float4>() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Row loads: non-coherent, no L1 allocation, optionally with an L2 policy.
template <bool kHint>
__device__ __forceinline__ float load_row(const float* p, uint64_t policy) {
  float v;
  if (kHint) {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(p), "l"(policy));
  } else {
    asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  }
  return v;
}

template <bool kHint>
__device__ __forceinline__ float4 load_row(const float4* p, uint64_t policy) {
  float4 v;
  if (kHint) {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));
  } else {
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  }
  return v;
}

// jnp.take's rule: -R <= r < 0 wraps to r + R; any other r outside [0, R)
// becomes R, the mark of a NaN row.
__device__ __forceinline__ int wrap_row(int r, int R) {
  if (r < 0) r += R;  // r > -2^31 and R < 2^31: no overflow
  return (r < 0 || r >= R) ? R : r;
}

// cv: vectors (V) per row; tpr = 1 << log_tpr threads per row; U rows in
// flight per group. Position p of the walk writes output row n = p, or
// n = perm[p] on the bucketed route.
template <typename V, int U, bool kHint>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                       const int* __restrict__ perm, V* __restrict__ out, int R,
                       int64_t N, int cv, int log_tpr) {
  const int tpr = 1 << log_tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> log_tpr;
  const int64_t groups = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> log_tpr;
  const uint64_t policy = kHint ? evict_last_policy() : 0;
  for (int64_t p0 = first; p0 < N; p0 += groups * U) {
    int64_t dst[U];  // output row, -1 past the end
    int row[U];      // table row, R for a NaN row
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t p = p0 + k * groups;
      dst[k] = p < N ? (perm ? __ldg(perm + p) : p) : -1;
    }
#pragma unroll
    for (int k = 0; k < U; ++k) row[k] = dst[k] >= 0 ? wrap_row(__ldg(idx + dst[k]), R) : R;
    for (int c = lane; c < cv; c += tpr) {
      V v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        v[k] = nan_fill<V>();
        if (row[k] < R)
          v[k] = load_row<kHint>(table + static_cast<int64_t>(row[k]) * cv + c, policy);
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (dst[k] >= 0) __stcs(out + dst[k] * cv + c, v[k]);
    }
  }
}

// The bucketed route's partition. Bucket b holds the indices of table rows
// [b * rows_per_bucket, (b + 1) * rows_per_bucket); bucket `buckets` the
// NaN rows. Each block takes a contiguous slice of the indices.
constexpr int kMaxBuckets = 64;

__device__ __forceinline__ int bucket_of(int r, int R, int rows_per_bucket, int buckets) {
  r = wrap_row(r, R);
  return r == R ? buckets : r / rows_per_bucket;
}

__device__ __forceinline__ void slice(int64_t N, int64_t& lo, int64_t& hi) {
  const int64_t per = (N + gridDim.x - 1) / gridDim.x;
  lo = blockIdx.x * per;
  hi = lo + per < N ? lo + per : N;
}

// counts[b] += the number of indices in bucket b
__global__ void __launch_bounds__(kGatherThreads)
    bucket_count_kernel(const int* __restrict__ idx, int64_t N, int R, int rows_per_bucket,
                        int buckets, int* __restrict__ counts) {
  __shared__ int hist[kMaxBuckets + 1];
  for (int b = threadIdx.x; b <= buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  int64_t lo, hi;
  slice(N, lo, hi);
  for (int64_t n = lo + threadIdx.x; n < hi; n += blockDim.x)
    atomicAdd(&hist[bucket_of(__ldg(idx + n), R, rows_per_bucket, buckets)], 1);
  __syncthreads();
  for (int b = threadIdx.x; b <= buckets; b += blockDim.x)
    if (hist[b]) atomicAdd(&counts[b], hist[b]);
}

// perm: the index positions n grouped by bucket, bucket 0 first. A block
// reserves its share of each bucket with one atomic (cursors), then places
// its positions; the order inside a bucket is the order the atomics give,
// which changes nothing in the output.
__global__ void __launch_bounds__(kGatherThreads)
    bucket_place_kernel(const int* __restrict__ idx, int64_t N, int R, int rows_per_bucket,
                        int buckets, const int* __restrict__ counts, int* __restrict__ cursors,
                        int* __restrict__ perm) {
  __shared__ int hist[kMaxBuckets + 1];
  __shared__ int base[kMaxBuckets + 1];
  for (int b = threadIdx.x; b <= buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  int64_t lo, hi;
  slice(N, lo, hi);
  for (int64_t n = lo + threadIdx.x; n < hi; n += blockDim.x)
    atomicAdd(&hist[bucket_of(__ldg(idx + n), R, rows_per_bucket, buckets)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
    for (int b = 0; b <= buckets; ++b) {
      base[b] = start + (hist[b] ? atomicAdd(&cursors[b], hist[b]) : 0);
      start += counts[b];
      hist[b] = 0;
    }
  }
  __syncthreads();
  for (int64_t n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const int b = bucket_of(__ldg(idx + n), R, rows_per_bucket, buckets);
    perm[base[b] + atomicAdd(&hist[b], 1)] = static_cast<int>(n);
  }
}

struct Gather {
  const void* table;
  const int* idx;
  const int* perm;
  void* out;
  int R;
  int64_t N;
  int cv;
  int max_blocks;
  cudaStream_t stream;
};

template <typename V, int U, bool kHint>
cudaError_t launch(const Gather& g) {
  int log_tpr = 0;
  while ((1 << log_tpr) < g.cv && log_tpr < 5) ++log_tpr;
  const int64_t rows_per_block = static_cast<int64_t>(kGatherThreads >> log_tpr) * U;
  const int64_t want = (g.N + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(want < g.max_blocks ? want : g.max_blocks);
  gather_rows_kernel<V, U, kHint><<<blocks, kGatherThreads, 0, g.stream>>>(
      static_cast<const V*>(g.table), g.idx, g.perm, static_cast<V*>(g.out), g.R, g.N, g.cv,
      log_tpr);
  return cudaGetLastError();
}

// The routes' launch settings: rows in flight a thread group and the grid
// cap in blocks an SM.
constexpr int kDirectUnroll = 8, kDirectBlocksPerSm = 8;
constexpr int kBucketedUnroll = 1, kBucketedBlocksPerSm = 4;

template <typename V>
cudaError_t launch_route(bool bucketed, const Gather& g) {
  return bucketed ? launch<V, kBucketedUnroll, true>(g) : launch<V, kDirectUnroll, false>(g);
}

// The backward: grad[idx[n], :] += g[n, :] for g [N, C] (the upstream of
// out) and grad [R, C], under the forward's rule: a wrapped index adds into
// its row, an index outside [-R, R) (a NaN row) adds nothing, as XLA's
// scatter drops it. No pallas_call: JAX differentiates jnp.take with XLA's
// scatter-add. It serves the samplers under grad (fused_eval "off"), whose
// gathers stack each sampler's corners corner-major, so that consecutive
// entries are consecutive samples of a ray and often hit the same row.
//
// Bound on an H100 SXM: bytes, g and idx read once and each touched row of
// grad read and written once. The first design (a grid stride of thread
// groups, one RED an entry) sent consecutive entries to different groups,
// merged nothing, and at a line's shape aimed some 29 000 REDs at each of
// its few thousand addresses, serialised in L2. So the design
// (ops/gather.py::backward_plan sets its numbers, the block size too):
//   * the columns are cut into slices of at most 96 (the grid's y); each
//     block of a slice owns a contiguous span of units of consecutive
//     entries, and its warps take the units in turn from a counter in
//     shared memory;
//   * in a step a warp's E = 32 >> log_g groups of 1 << log_g lanes hold E
//     consecutive entries, each lane Q words (float4, or float off the
//     16-byte grid) of the entry's slice, the fewest a lane: a slice of 96
//     columns is one float4 word a lane of 24 (E = 1: no scan), the mask
//     one entry a lane; a group loads K steps at once (kAheadBytes a lane),
//     the indices and the upstream together;
//   * runs of equal rows merge before any add: a segmented shuffle scan
//     over the groups (a head where the row changes) sums each run, the
//     run open at the end of a step is carried into the next in registers,
//     and only a run's last entry adds into grad, one RED a word (a zero
//     word adds nothing).
// A column slice of a line's gradient kept in shared memory (its runs
// added there, flushed once at the end) was built and measured: it saved
// the lines' REDs but not time, and lost on the samplers' step (PERF.md).
// Offsets into g and grad are 64-bit.
namespace bwd {

constexpr int kAheadBytes = 64;  // upstream bytes a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// steps a batch (loaded at once), for Q words of V a lane: 1 to 8
template <typename V, int Q>
__host__ __device__ constexpr int ahead() {
  constexpr int k = kAheadBytes / (Q * static_cast<int>(sizeof(V)));
  return k < 1 ? 1 : (k > 8 ? 8 : k);
}

struct Plan {
  int64_t n;       // entries
  int64_t units;   // ceil(n / unit)
  int rows;        // R
  int cols;        // C, floats a row of g and grad
  int slice_cols;  // columns a slice (a multiple of 4 on the float4 route)
  int log_g;       // log2 of the lanes a group
  int unit;        // entries a unit
};

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ bool nonzero(float x) { return x != 0.0f; }
__device__ __forceinline__ bool nonzero(float4 x) {
  return x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f;
}

__device__ __forceinline__ void acc(float& a, float b) { a += b; }
__device__ __forceinline__ void acc(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float shfl_up(float x, int d) { return __shfl_up_sync(kFull, x, d); }
__device__ __forceinline__ float4 shfl_up(float4 x, int d) {
  return make_float4(shfl_up(x.x, d), shfl_up(x.y, d), shfl_up(x.z, d), shfl_up(x.w, d));
}
__device__ __forceinline__ float shfl(float x, int src) { return __shfl_sync(kFull, x, src); }
__device__ __forceinline__ float4 shfl(float4 x, int src) {
  return make_float4(shfl(x.x, src), shfl(x.y, src), shfl(x.z, src), shfl(x.w, src));
}

// the upstream, read once: streaming loads (evict-first)
template <typename V>
__device__ __forceinline__ V load_up(const float* p);
template <>
__device__ __forceinline__ float load_up<float>(const float* p) {
  return __ldcs(p);
}
template <>
__device__ __forceinline__ float4 load_up<float4>(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void red(float* p, float x) { atomicAdd(p, x); }
__device__ __forceinline__ void red(float* p, float4 x) {
  atomicAdd(reinterpret_cast<float4*>(p), x);
}

// the row of index r under jnp.take's rule, -1 for a NaN row
__device__ __forceinline__ int row_of(int r, int R) {
  r = wrap_row(r, R);
  return r == R ? -1 : r;
}

// Adds a run's sum x (this lane's Q words of the slice) into row `row` of
// grad.
template <typename V, int Q>
__device__ __forceinline__ void add_run(const Plan& p, float* grad, int c0, int words, int j,
                                        int G, int row, const V (&x)[Q]) {
  constexpr int VF = sizeof(V) / 4;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int w = j + q * G;
    if (w >= words || !nonzero(x[q])) continue;
    red(grad + static_cast<int64_t>(row) * p.cols + c0 + w * VF, x[q]);
  }
}

// Blocks of any size up to 1024 threads (the plan's), at most 64 registers
// a thread.
template <typename V, int Q>
__global__ void __launch_bounds__(1024, 1)
    gather_rows_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                           float* __restrict__ grad, Plan p) {
  constexpr int VF = sizeof(V) / 4;
  constexpr int K = ahead<V, Q>();
  __shared__ int next;  // the block's unit counter
  const int c0 = blockIdx.y * p.slice_cols;
  const int words = min(p.slice_cols, p.cols - c0) / VF;  // this slice's words a row
  if (threadIdx.x == 0) next = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int G = 1 << p.log_g, E = 32 >> p.log_g;
  const int e = lane >> p.log_g, j = lane & (G - 1);
  const int last = ((E - 1) << p.log_g) + j;  // this lane's word in the last group
  const int64_t u_lo = p.units * blockIdx.x / gridDim.x;
  const int64_t u_hi = p.units * (blockIdx.x + 1) / gridDim.x;
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(&next, 1);
    u = __shfl_sync(kFull, u, 0);
    if (u_lo + u >= u_hi) break;
    const int64_t lo = (u_lo + u) * p.unit;
    const int64_t hi = min(lo + p.unit, p.n);
    int crow = -1;  // the row of the run carried from the last step (-1: none)
    V carry[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) carry[q] = zero<V>();
    for (int64_t b = lo; b < hi; b += K * E) {
      int row[K];  // a batch of K steps: rows (-1 past hi) and upstream
      V x[K][Q];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t n = b + k * E + e;
        row[k] = n < hi ? row_of(__ldg(idx + n), p.rows) : -1;
        const float* src = g + (n < hi ? n : lo) * p.cols + c0;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int w = j + q * G;
          x[k][q] = n < hi && w < words ? load_up<V>(src + w * VF) : zero<V>();
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = row[k];
        const bool one = E == 1;  // a group is the warp: no neighbours
        const int rp = one ? r : __shfl_up_sync(kFull, r, G);
        const int rn = one ? r : __shfl_down_sync(kFull, r, G);
        int f = e == 0 || rp != r;                // a run starts at this entry
        const bool tail = e == E - 1 || rn != r;  // a run ends at it
        // a segmented inclusive scan over the groups: each entry's sum from
        // its run's head
        for (int d = 1; d < E; d <<= 1) {
          const int fu = __shfl_up_sync(kFull, f, d << p.log_g);
          V up[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) up[q] = shfl_up(x[k][q], d << p.log_g);
          if (e >= d && !f) {
#pragma unroll
            for (int q = 0; q < Q; ++q) acc(x[k][q], up[q]);
            f = fu;
          }
        }
        // the first run's tail, and the row of the step's first entry
        const int t0 = one ? 0 : (__ffs(__ballot_sync(kFull, tail)) - 1) >> p.log_g;
        const int r0 = one ? r : __shfl_sync(kFull, r, 0);
        const bool goes_on = crow >= 0 && crow == r0;  // the carried run goes on
        if (goes_on) {
          if (e <= t0) {
#pragma unroll
            for (int q = 0; q < Q; ++q) acc(x[k][q], carry[q]);
          }
        } else if (crow >= 0 && e == 0) {
          add_run<V, Q>(p, grad, c0, words, j, G, crow, carry);
        }
        if (tail && e < E - 1 && r >= 0) add_run<V, Q>(p, grad, c0, words, j, G, r, x[k]);
#pragma unroll
        for (int q = 0; q < Q; ++q) carry[q] = one ? x[k][q] : shfl(x[k][q], last);
        crow = one ? r : __shfl_sync(kFull, r, 31);
      }
    }
    if (crow >= 0 && e == 0) add_run<V, Q>(p, grad, c0, words, j, G, crow, carry);
  }
}

template <typename V, int Q>
cudaError_t launch(const float* g, const int* idx, float* grad, const Plan& p, dim3 grid,
                   int threads, cudaStream_t s) {
  gather_rows_bwd_kernel<V, Q><<<grid, threads, 0, s>>>(g, idx, grad, p);
  return cudaGetLastError();
}

}  // namespace bwd

}  // namespace iff

// The backward of iff_gather_rows: g [N, C] float32 (the upstream of out),
// idx [N] int32, grad [R, C] float32 zeroed by the caller, all contiguous
// on the device; grad[idx[n]] += g[n] for each n whose index is in range
// after jnp.take's wrap. The plan is ops/gather.py::backward_plan's: vec
// != 0 takes float4 words (C and slice_cols multiples of 4, g and grad
// 16-byte aligned); ceil(C / slice_cols) slices of `blocks` blocks each,
// of `warps` warps (1 to 32); groups of 1 << log_g lanes, q words a lane
// (1 for float4, at most 3 for float; (1 << log_g) * q words cover a
// slice); units of `unit` entries. Returns a cudaError_t,
// cudaErrorInvalidValue for a plan it does not take; N == 0 launches
// nothing.
extern "C" int iff_gather_rows_bwd(const void* g, const void* idx, void* grad, int R,
                                   long long N, int C, int vec, int slice_cols, int blocks,
                                   int warps, int log_g, int q, int unit, void* stream) {
  const int vf = vec ? 4 : 1;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(grad)) & 15) == 0;
  if (R <= 0 || C <= 0 || N < 0 || slice_cols <= 0 || slice_cols > C || log_g < 0 ||
      log_g > 5 || q < 1 || q > (vec ? 1 : 3) || (q << log_g) * vf < slice_cols || blocks < 1 ||
      blocks > 65535 || warps < 1 || warps > 32 || unit <= 0 ||
      (vec && (C % 4 != 0 || slice_cols % 4 != 0 || !aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slices = (C + static_cast<int64_t>(slice_cols) - 1) / slice_cols;
  const int64_t units = (N + unit - 1) / unit;
  if (slices > 65535 || units >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const iff::bwd::Plan p{N, units, R, C, slice_cols, log_g, unit};
  const dim3 grid(blocks, static_cast<unsigned>(slices));
  const int threads = 32 * warps;
  auto* gf = static_cast<const float*>(g);
  auto* ix = static_cast<const int*>(idx);
  auto* out = static_cast<float*>(grad);
  auto s = static_cast<cudaStream_t>(stream);
  namespace b = iff::bwd;
  // float4 words: a slice of at most 96 columns is at most 24, one a lane
  const cudaError_t err =
      vec      ? b::launch<float4, 1>(gf, ix, out, p, grid, threads, s)
      : q == 1 ? b::launch<float, 1>(gf, ix, out, p, grid, threads, s)
      : q == 2 ? b::launch<float, 2>(gf, ix, out, p, grid, threads, s)
               : b::launch<float, 3>(gf, ix, out, p, grid, threads, s);
  return static_cast<int>(err);
}

// table [R, C] float32, idx [N] int32, out [N, C] float32, all contiguous on
// the device. vec != 0 takes float4 words (C % 4 == 0, 16-byte aligned);
// sms is the card's SM count.
//
// rows_per_bucket > 0 takes the bucketed route, for a table too large for
// L2 whose rows the indices read more than once on average: the indices
// are first partitioned by table-row range into ceil(R / rows_per_bucket)
// <= 64 buckets (perm [N] int32, N < 2^31; counts [2 * (buckets + 1)]
// int32, zeroed by the caller), and the gather then walks them bucket by
// bucket, so that the rows in use at any time are one bucket's and stay in
// L2: each table row comes from device memory about once instead of once
// per miss. Three launches. Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_gather_rows(const void* table, const void* idx, void* out, int R,
                               long long N, int C, int vec, int sms, int rows_per_bucket,
                               void* counts, void* perm, void* stream) {
  if (R <= 0 || C <= 0 || N < 0 || sms <= 0 || (vec && C % 4 != 0) || rows_per_bucket < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const bool bucketed = rows_per_bucket > 0;
  const int max_blocks = sms * (bucketed ? iff::kBucketedBlocksPerSm : iff::kDirectBlocksPerSm);
  iff::Gather g{table, static_cast<const int*>(idx), nullptr, out, R, N, vec ? C / 4 : C,
                max_blocks, static_cast<cudaStream_t>(stream)};
  if (bucketed) {
    const int64_t buckets = (R + static_cast<int64_t>(rows_per_bucket) - 1) / rows_per_bucket;
    if (buckets > iff::kMaxBuckets || N >= (int64_t{1} << 31) || !counts || !perm)
      return static_cast<int>(cudaErrorInvalidValue);
    auto* cnt = static_cast<int*>(counts);
    auto* pm = static_cast<int*>(perm);
    const int64_t want = (N + iff::kGatherThreads - 1) / iff::kGatherThreads;
    const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
    const int nb = static_cast<int>(buckets);
    iff::bucket_count_kernel<<<blocks, iff::kGatherThreads, 0, g.stream>>>(
        g.idx, N, R, rows_per_bucket, nb, cnt);
    iff::bucket_place_kernel<<<blocks, iff::kGatherThreads, 0, g.stream>>>(
        g.idx, N, R, rows_per_bucket, nb, cnt, cnt + nb + 1, pm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    g.perm = pm;
  }
  const cudaError_t err = vec ? iff::launch_route<float4>(bucketed, g)
                              : iff::launch_route<float>(bucketed, g);
  return static_cast<int>(err);
}
