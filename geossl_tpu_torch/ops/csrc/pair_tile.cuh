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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

}  // namespace geossl
