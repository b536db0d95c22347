// Cross-block reduction shared by the backward kernels (cfconv_bwd.cu,
// ncsn_score.cu). A TPU kernel carries its weight gradients across a
// sequential grid; here each block of a persistent grid (one block per SM)
// writes its own partial sums, and a second launch adds the partials up in a
// fixed order, so the result is the same from run to run on one card.
#pragma once

#include <cuda_runtime.h>

namespace geossl {

// out[k] = sum over r < rows, in order, of part[r * K + k]
__global__ void sum_partials_kernel(const float* __restrict__ part, int rows,
                                    int K, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * K + k];
  out[k] = s;
}

inline void sum_partials(const float* part, int rows, int K, float* out,
                         cudaStream_t stream) {
  sum_partials_kernel<<<(K + 255) / 256, 256, 0, stream>>>(part, rows, K, out);
}

// Blocks of a persistent grid over `items` work items: one per SM at most.
inline int persistent_blocks(int items) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return items < sms ? (items > 0 ? items : 1) : sms;
}

// Sum over the 16 lanes of a half-warp; every lane gets the total.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace geossl
