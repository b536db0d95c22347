// Shared device code of the pair-tile kernels: tile and width constants, the
// shifted softplus, 16-byte shared-memory access, and the f32 thread layout
// of the CUDA-core tile code (painn_tile.cuh: painn_fwd.cu's symmetric mode,
// painn_bwd.cu).
//
// A block of 256 threads works on a tile of 8 receiving atoms i by 8 sending
// atoms j (64 pairs) at feature width F = 128. Thread t owns 4 pairs and 8
// features:
//   fg = t % 16   -> features feat(fg, kk) = 64*(kk/4) + 4*fg + kk%4, kk < 8
//   pg = t / 16   -> row il = pg / 2, columns jl = (pg % 2)*4 + q, q = 0..3
// so the two half-warps of warp w hold the same row il = w, and a message sum
// over the tile's 8 columns is one register sum plus one __shfl_xor(16).
// The features come in two runs of 4 so that weights and activations move
// between shared memory and registers as 16-byte vectors.
// Shared-memory buffers passed in must be 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace geossl {

constexpr int kThreads = 256;
constexpr int kTile = 8;                 // TI = TJ = 8
constexpr int kPairs = kTile * kTile;    // 64 pairs per tile
constexpr int kF = 128;                  // filter / feature width
constexpr int kFG = 16;                  // feature groups
constexpr int kFPT = kF / kFG;           // 8 features per thread
constexpr int kPPT = 4;                  // 4 pairs per thread

// ssp(v) = softplus(v) - log 2 with the fast exp/log intrinsics: its
// absolute error is a few 1e-8, f32 rounding at the scale of ssp.
__device__ __forceinline__ float ssp_fast(float v) {
  return fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v))) - 0.693147180559945309f;
}

__device__ __forceinline__ int thread_fg() { return threadIdx.x & (kFG - 1); }
__device__ __forceinline__ int thread_il() { return threadIdx.x >> 5; }
__device__ __forceinline__ int thread_jl0() { return ((threadIdx.x >> 4) & 1) * kPPT; }
// feature index of this thread's kk-th feature (kk < 8)
__device__ __forceinline__ int feat(int fg, int kk) {
  return (kk >> 2) * (kF / 2) + fg * 4 + (kk & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// This thread's 8 features of row `row` (stride kF) of a shared-memory matrix.
__device__ __forceinline__ void load_feats(const float* row, int fg, float v[kFPT]) {
  const float4 lo = ld4(row + fg * 4), hi = ld4(row + kF / 2 + fg * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Copies n floats from global to shared memory with the whole block.
__device__ __forceinline__ void block_copy(float* dst, const float* __restrict__ src, int n) {
  for (int idx = threadIdx.x; idx < n; idx += kThreads) dst[idx] = src[idx];
}

}  // namespace geossl
