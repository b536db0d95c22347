// Shared device code of the pair-tile kernels: tile and width constants, the
// shifted softplus and 16-byte shared-memory access.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace geossl {

constexpr int kThreads = 256;           // a block of 8 warps (cfconv_fwd.cu, painn_bwd.cu)
constexpr int kTile = 8;                 // TI = TJ = 8
constexpr int kPairs = kTile * kTile;    // 64 pairs per tile
constexpr int kF = 128;                  // filter / feature width
constexpr int kF3 = 3 * kF;              // PaiNN's filter width 3F = 384

// ssp(v) = softplus(v) - log 2 with the fast exp/log intrinsics: its
// absolute error is a few 1e-8, f32 rounding at the scale of ssp.
__device__ __forceinline__ float ssp_fast(float v) {
  return fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v))) - 0.693147180559945309f;
}

// PaiNN's filter product [phi; 1] [Wk; bk] has K = R RBF rows plus the bias
// row (K row R). Up to R = kOnePassR the kernels hold all K rows at once
// (K padded to 24 or 32). Above it their streamed instances run the product
// in passes over chunks of K rows: ceil((R+1)/32) chunks of near-equal size
// (at most 32 rows each, so a chunk fits the one-pass instances' buffers),
// the bias row at the end of the last. Each pass adds its outputs to the
// previous passes' (every output is linear in the filter, and dWk's rows
// are the chunk's own).
constexpr int kOnePassR = 31;

struct RbfChunk {
  int r0;     // the chunk's first RBF row
  int rows;   // its RBF rows
  bool bias;  // the bias row follows them (the last chunk)
};

// K rows of the largest chunk of an R-row filter product.
__host__ __device__ inline int rbf_chunk_size(int R) {
  const int n = (R + 1 + 31) / 32;
  return (R + 1 + n - 1) / n;
}

// Chunks of an R-row filter product.
__host__ __device__ inline int rbf_chunks(int R) {
  const int size = rbf_chunk_size(R);
  return (R + 1 + size - 1) / size;
}

// Chunk c of an R-row filter product.
__host__ __device__ inline RbfChunk rbf_chunk(int R, int c) {
  const int size = rbf_chunk_size(R), k0 = c * size;
  const int k1 = k0 + size < R + 1 ? k0 + size : R + 1;
  const bool last = k1 == R + 1;
  return {k0, k1 - k0 - (last ? 1 : 0), last};
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

}  // namespace geossl
