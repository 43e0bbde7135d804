// Softmax statistics over the ray axis, shared by the banked-scoring kernel
// (banked_attention.cu) and the fused ray-scoring kernel
// (fused_ray_attention.cu).
//
// Both TPU kernels carry a running max m[p] and denominator d[p] per patch
// across a grid that runs in order. Blocks on the GPU run in no order, so
// here each thread keeps a running (m, d) for its own columns over the ray
// tiles its block walks, the block folds its threads' pairs into one
// partial (m_b[p], d_b[p]), and lse_merge reduces the partials:
//   m = max_b m_b,  d = sum_b d_b * exp(m_b - m),  w = (valid ? 1 : 0) / d.
//
// Each kernel keeps its running pairs in its own accumulator layout (the
// epilogues of banked_attention.cu and of fused_ray_attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iff {

constexpr float kNegInf = -1e30f;   // as the TPU kernels' _NEG_INF
constexpr int kThreads = 256;
constexpr int kPatches = 256;       // patch columns (16 x 16 grid)

// Max (kMax) or sum of v over the block; every thread gets the result.
// `red` holds 32 floats of shared memory.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // an earlier call may still read `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : (kMax ? kNegInf : 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  return v;
}

// Log-sum-exp merge of nb partials [nb, P] -> m, d, w [P]; one block a
// patch column, its threads striding over the partials.
__global__ void __launch_bounds__(kThreads)
    lse_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_d,
                     int nb, int P, const unsigned char* __restrict__ valid, float* m_out,
                     float* d_out, float* w_out) {
  __shared__ float red[32];
  const int p = blockIdx.x;
  float m = kNegInf;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) m = fmaxf(m, part_m[b * P + p]);
  m = block_reduce<true>(m, red);
  float d = 0.f;
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    d += part_d[b * P + p] * expf(part_m[b * P + p] - m);
  d = block_reduce<false>(d, red);
  if (threadIdx.x == 0) {
    m_out[p] = m;
    d_out[p] = d;
    w_out[p] = (valid[p] ? 1.f : 0.f) / d;
  }
}

inline cudaError_t launch_lse_merge(const float* part_m, const float* part_d, int nb, int P,
                                    const unsigned char* valid, float* m, float* d, float* w,
                                    cudaStream_t stream) {
  lse_merge_kernel<<<P, kThreads, 0, stream>>>(part_m, part_d, nb, P, valid, m, d, w);
  return cudaGetLastError();
}

}  // namespace iff
