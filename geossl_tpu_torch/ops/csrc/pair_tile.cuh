// Shared device code of the SchNet CFConv kernels (cfconv_fwd.cu,
// cfconv_bwd.cu, schnet_stack.cu): the filter network of one 8x8 pair tile.
//
// A block of 256 threads works on a tile of 8 receiving atoms i by 8 sending
// atoms j (64 pairs) at feature width F = 128. Thread t owns 4 pairs and 8
// features:
//   fg = t % 16   -> features feat(fg, kk) = 64*(kk/4) + 4*fg + kk%4, kk < 8
//   pg = t / 16   -> row il = pg / 2, columns jl = (pg % 2)*4 + q, q = 0..3
// so the two half-warps of warp w hold the same row il = w, and a message sum
// over the tile's 8 columns is one register sum plus one __shfl_xor(16).
// The features come in two runs of 4 so that weights and activations move
// between shared memory and registers as 16-byte vectors: per 32 FMAs a
// warp issues 5 shared-memory wavefronts, which keeps the loops FMA bound.
//
// Arithmetic is plain f32 FMA on the CUDA cores (no tensor cores, no TF32).
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

// softplus(v) - log 2, as jax.nn.softplus (logaddexp(v, 0)): no threshold.
__device__ __forceinline__ float ssp(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.693147180559945309f;
}

// ssp(v) = softplus(v) - log 2 with the fast exp/log intrinsics: its
// absolute error is a few 1e-8, f32 rounding at the scale of ssp.
__device__ __forceinline__ float ssp_fast(float v) {
  return fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v))) - 0.693147180559945309f;
}

// ssp'(v) = sigmoid(v)
__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

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

// Filter network of one pair tile: for this thread's 4 pairs and 8 features,
//   w[q][kk] = (ssp(rbf(d) W1 + b1) W2 + b2)[pair q, feature feat(fg, kk)]
// with rbf_g(d) = exp(coeff * (d - (start + delta*g))^2), the offsets made in
// the kernel as cfconv_pallas._offsets does.
//   d_s   [64]        tile distances (row-major [il][jl]), in shared memory
//   rbf_s [G][64]     scratch (RBF, pair index fastest)
//   s_s   [64][kF]    scratch (hidden layer)
//   W1_s  [G][WS], W2_s [kF][WS]  weights in shared memory, row stride WS
//         (kF, or padded so that column reads spread over the banks); b1, b2 global.
//   sig_s [64][kF]     with kSig, also receives sigmoid(rbf W1 + b1) = ssp'
// Every thread of the block must call it (it holds __syncthreads).
template <int WS = kF, bool kSig = false>
__device__ __forceinline__ void filter_tile(
    const float* d_s, float* rbf_s, float* s_s, const float* W1_s,
    const float* __restrict__ b1, const float* W2_s,
    const float* __restrict__ b2, int G, float start, float delta,
    float coeff, float w[kPPT][kFPT], float* sig_s = nullptr) {
  for (int idx = threadIdx.x; idx < kPairs * G; idx += kThreads) {
    const int g = idx / kPairs, p = idx - g * kPairs;
    const float diff = d_s[p] - (start + delta * (float)g);
    rbf_s[idx] = expf(coeff * diff * diff);
  }
  __syncthreads();

  const int fg = thread_fg();
  const int p0 = thread_il() * kTile + thread_jl0();
  float acc[kPPT][kFPT];
#pragma unroll
  for (int q = 0; q < kPPT; ++q)
#pragma unroll
    for (int k = 0; k < kFPT; ++k) acc[q][k] = 0.f;

  // hidden = ssp(rbf @ W1 + b1)
  for (int g = 0; g < G; ++g) {
    const float4 a4 = ld4(rbf_s + g * kPairs + p0);
    const float a[kPPT] = {a4.x, a4.y, a4.z, a4.w};
    float b[kFPT];
    load_feats(W1_s + g * WS, fg, b);
#pragma unroll
    for (int q = 0; q < kPPT; ++q)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) acc[q][k] = fmaf(a[q], b[k], acc[q][k]);
  }
  float bias[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) bias[k] = b1[feat(fg, k)];
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    float* row = s_s + (p0 + q) * kF + fg * 4;
    st4(row, ssp(acc[q][0] + bias[0]), ssp(acc[q][1] + bias[1]),
        ssp(acc[q][2] + bias[2]), ssp(acc[q][3] + bias[3]));
    st4(row + kF / 2, ssp(acc[q][4] + bias[4]), ssp(acc[q][5] + bias[5]),
        ssp(acc[q][6] + bias[6]), ssp(acc[q][7] + bias[7]));
    if (kSig) {
      float* srow = sig_s + (p0 + q) * kF + fg * 4;
      st4(srow, sigm(acc[q][0] + bias[0]), sigm(acc[q][1] + bias[1]),
          sigm(acc[q][2] + bias[2]), sigm(acc[q][3] + bias[3]));
      st4(srow + kF / 2, sigm(acc[q][4] + bias[4]), sigm(acc[q][5] + bias[5]),
          sigm(acc[q][6] + bias[6]), sigm(acc[q][7] + bias[7]));
    }
#pragma unroll
    for (int k = 0; k < kFPT; ++k) acc[q][k] = 0.f;
  }
  // the rows of s_s this thread reads next were written by its own half-warp
  __syncwarp();

  // w = hidden @ W2 + b2, four hidden columns per step
  for (int c = 0; c < kF; c += 4) {
    float a[kPPT][4];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const float4 v = ld4(s_s + (p0 + q) * kF + c);
      a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float b[kFPT];
      load_feats(W2_s + (c + cc) * WS, fg, b);
#pragma unroll
      for (int q = 0; q < kPPT; ++q)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) acc[q][k] = fmaf(a[q][cc], b[k], acc[q][k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    const float bk = b2[feat(fg, k)];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) w[q][k] = acc[q][k] + bk;
  }
}

// Message of this thread's row over the tile's 8 columns:
//   c[kk] = sum_jl env[il, jl] * w[il, jl, f] * x[jl, f],   f = feat(fg, kk)
// e_s [64] is the tile's envelope, x_s points at row 0 of the tile's x rows
// (row stride kF). Both half-warps of a warp return the same full sum.
__device__ __forceinline__ void tile_message(const float* e_s, const float* x_s,
                                             const float w[kPPT][kFPT],
                                             float c[kFPT]) {
  const int fg = thread_fg(), il = thread_il(), jl0 = thread_jl0();
  float sum[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) sum[k] = 0.f;
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const float e = e_s[il * kTile + jl0 + q];
    float xv[kFPT];
    load_feats(x_s + (jl0 + q) * kF, fg, xv);
#pragma unroll
    for (int k = 0; k < kFPT; ++k) sum[k] = fmaf(e * w[q][k], xv[k], sum[k]);
  }
#pragma unroll
  for (int k = 0; k < kFPT; ++k) c[k] = sum[k] + __shfl_xor_sync(0xffffffffu, sum[k], 16);
}

}  // namespace geossl
