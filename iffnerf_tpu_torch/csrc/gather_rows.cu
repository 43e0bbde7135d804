// Row gather out[n, :] = table[idx[n], :] for sm_90a.
//
// Replaces the Pallas TPU kernel pallas_gather of
// extra/pallas_gather_bench.py:46, the row gather that the field
// evaluation is made of: every texel fetch of the grid samplers
// (ops/grid_sample.py) gathers rows of a plane [H*W, C], a line [L, C] or
// the alpha-mask volume [D*H*W, 1].
//
// Nothing of the TPU design carries over. Mosaic could only DMA the aligned
// 8-row group around a row (8x the traffic) and needed the whole index array
// prefetched into scalar memory; here each thread group loads its own index
// and reads just the row, through the read-only path.
//
// Bound on an H100 SXM: bytes. Per gathered row it reads the row (at the
// 32-byte sector granularity of the memory system), 4 bytes of index, and
// writes the row: about 2*N*C*4 + N*4 bytes at 3.35 TB/s. Most of the
// field's tables fit the 50 MB L2 (a 300^2 x 48 plane is 17 MB), so their
// reads mostly hit L2 and the writes dominate; the 300^3 mask volume
// (108 MB) and the 90000 x 256 bench table (92 MB) do not fit.
//
// Mapping: a group of tpr threads owns one row, tpr the power of two that
// covers the row's vectors, capped at 32. Neighbouring threads read
// neighbouring 16-byte (float4, when C % 4 == 0 and both pointers are 16-byte
// aligned) or 4-byte words of one row. A warp covers one row when the row is
// wide (C = 256: 64 float4, two per lane) and several when it is narrow
// (C = 16: 8 rows a warp; the mask's C = 1: 32 rows a warp), so narrow rows
// do not leave lanes idle. A grid-stride loop walks the rows; offsets are
// 64-bit (N * C * 4 bytes passes 2^31 at the bench shape, 2^21 x 256).
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

// cv: vectors (V) per row; tpr = 1 << log_tpr threads per row.
template <typename V>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                       V* __restrict__ out, int R, int64_t N, int cv, int log_tpr) {
  const int tpr = 1 << log_tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> log_tpr;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> log_tpr;
  for (int64_t n = first; n < N; n += stride) {
    int r = __ldg(idx + n);
    if (r < 0) r += R;  // r > -2^31 and R < 2^31: no overflow
    V* dst = out + n * cv;
    if (r >= 0 && r < R) {
      const V* src = table + static_cast<int64_t>(r) * cv;
      for (int c = lane; c < cv; c += tpr) dst[c] = __ldg(src + c);
    } else {
      const V q = nan_fill<V>();
      for (int c = lane; c < cv; c += tpr) dst[c] = q;
    }
  }
}

template <typename V>
cudaError_t launch(const void* table, const int* idx, void* out, int R, int64_t N, int cv,
                   int max_blocks, cudaStream_t stream) {
  int log_tpr = 0;
  while ((1 << log_tpr) < cv && log_tpr < 5) ++log_tpr;
  const int64_t rows_per_block = kGatherThreads >> log_tpr;
  const int64_t want = (N + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  gather_rows_kernel<V><<<blocks, kGatherThreads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), R, N, cv, log_tpr);
  return cudaGetLastError();
}

}  // namespace iff

// table [R, C] float32, idx [N] int32, out [N, C] float32, all contiguous on
// the device. vec != 0 takes float4 words (C % 4 == 0, 16-byte aligned).
// Returns a cudaError_t; N == 0 launches nothing.
extern "C" int iff_gather_rows(const void* table, const void* idx, void* out, int R,
                               long long N, int C, int vec, int max_blocks, void* stream) {
  if (R <= 0 || C <= 0 || N < 0 || max_blocks <= 0 || (vec && C % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* ix = static_cast<const int*>(idx);
  const cudaError_t err = vec ? iff::launch<float4>(table, ix, out, R, N, C / 4, max_blocks, s)
                              : iff::launch<float>(table, ix, out, R, N, C, max_blocks, s);
  return static_cast<int>(err);
}
