// Cross-block reduction shared by the backward kernels (cfconv_bwd.cu,
// ncsn_score.cu, painn_bwd.cu), and the vector atomics of the symmetric PaiNN
// pair. A TPU kernel carries its weight gradients across a
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

// dst[0..1] += (a, b) with one vector atomic (global memory, 8-byte
// aligned; compute capability 9.0): painn_bwd.cu's and painn_fwd.cu's
// symmetric modes.
__device__ __forceinline__ void atomic_add2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// dst[0..3] += v with one vector atomic (global memory, 16-byte aligned).
__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

}  // namespace geossl
