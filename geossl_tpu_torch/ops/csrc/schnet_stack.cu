// schnet_stack: all L SchNet interaction blocks in one launch (inference).
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _stack_kernel (schnet_stack_infer).
// Per block k, with h resident across blocks:
//   x = h Wl1[k]                                   (lin1, no bias)
//   w = ssp(rbf(dist) W1[k] + b1[k]) W2[k] + b2[k]  (filter network)
//   m[i] = sum_j env[i,j] w[i,j] x[j]
//   h = h + ssp(m Wa[k] + ba[k]) Wb[k] + bb[k]      (lin2, act, lin)
// env is computed once by the caller, as models/schnet.fused_stack_apply does.
//
// Bound on the H100: operations, as cfconv_fwd (~46k FLOP per pair and
// block for the filter network, plus 6*F*F per atom and block for the three
// dense layers), with f32 FMAs on the CUDA cores (no tensor cores, no TF32).
// What the design does about it: one launch instead of L (h, x and the
// filter tensor never go to device memory), and pair tiles whose envelope is
// all zero (padding atoms, empty graph slots of a partial batch) are skipped:
// the block flags its occupied tiles in one pass over env at the start.
// Skipping a tile drops only exact zeros, so the result does not change.
//
// Work split: one block per graph (N <= 128). Shared memory holds x [N][F]
// for the whole graph, this block's W1/W2 (restaged for each interaction
// block) and the pair-tile scratch; h lives in `out`, which the block owns,
// and is updated row tile by row tile after that tile's messages are
// complete (x, made before the loop, is not touched by the update). The RBF
// is recomputed per tile rather than hoisted, because [N*N, G] does not fit
// in shared memory.
#include "pair_tile.cuh"

namespace geossl {

// y[f] for the 8 rows of a tile: thread (r = tid / 32, lane) computes
// features f = lane + 32*k, k = 0..3, of sum_c A[r][c] W[c][f] (+ bias).
__device__ __forceinline__ void rows_linear(const float* A, const float* __restrict__ W,
                                            const float* __restrict__ bias, float y[4]) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < kF; ++c) {
    const float a = A[r * kF + c];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = fmaf(a, W[c * kF + lane + 32 * k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) y[k] = bias ? acc[k] + bias[lane + 32 * k] : acc[k];
}

__global__ void __launch_bounds__(kThreads)
schnet_stack_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                    const float* __restrict__ h0, const float* __restrict__ wl1,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ wa, const float* __restrict__ ba,
                    const float* __restrict__ wb, const float* __restrict__ bb,
                    float* __restrict__ out, int n, int G, int L, float start,
                    float delta, float coeff) {
  const int nt = (n + kTile - 1) / kTile;
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem;                   // [G][kF]
  float* W2_s = W1_s + G * kF;          // [kF][kF]
  float* rbf_s = W2_s + kF * kF;        // [kPairs][G]
  float* s_s = rbf_s + kPairs * G;      // [kPairs][kF]
  float* x_s = s_s + kPairs * kF;       // [nt*kTile][kF]
  float* m_s = x_s + nt * kTile * kF;   // [kTile][kF]
  float* t_s = m_s + kTile * kF;        // [kTile][kF]
  float* d_s = t_s + kTile * kF;        // [kPairs]
  float* e_s = d_s + kPairs;            // [kPairs]
  int* occ_s = (int*)(e_s + kPairs);    // [nt][nt] tile occupancy

  const int tid = threadIdx.x, b = blockIdx.x;
  const int r = tid >> 5, lane = tid & 31;
  const float* dist_b = dist + (size_t)b * n * n;
  const float* env_b = env + (size_t)b * n * n;
  float* h = out + (size_t)b * n * kF;  // h lives in the output rows
  for (int idx = tid; idx < n * kF; idx += kThreads) h[idx] = h0[(size_t)b * n * kF + idx];
  // env is the same for every block: flag the occupied tiles once
  for (int t = tid; t < nt * nt; t += kThreads) occ_s[t] = 0;
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    if (env_b[idx] != 0.f) occ_s[(i / kTile) * nt + j / kTile] = 1;
  }

  const int fg = thread_fg(), il = thread_il();
  for (int l = 0; l < L; ++l) {
    const float* Wl1 = wl1 + (size_t)l * kF * kF;
    const float* B1 = b1 + (size_t)l * kF;
    const float* B2 = b2 + (size_t)l * kF;
    const float* Wa = wa + (size_t)l * kF * kF;
    const float* Ba = ba + (size_t)l * kF;
    const float* Wb = wb + (size_t)l * kF * kF;
    const float* Bb = bb + (size_t)l * kF;
    __syncthreads();  // h of the previous block is complete
    block_copy(W1_s, w1 + (size_t)l * G * kF, G * kF);
    block_copy(W2_s, w2 + (size_t)l * kF * kF, kF * kF);
    // x = h Wl1 (rows past n are zero)
    for (int r0 = 0; r0 < nt * kTile; r0 += kTile) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (r0 + r < n) {
        const float* hr = h + (size_t)r0 * kF;
        // rows_linear reads A[r * kF + c]; hr is the tile's first row
        rows_linear(hr, Wl1, nullptr, y);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) x_s[(r0 + r) * kF + lane + 32 * k] = y[k];
    }

    for (int pi = 0; pi < nt; ++pi) {
      const int i0 = pi * kTile;
      float macc[kFPT];
#pragma unroll
      for (int k = 0; k < kFPT; ++k) macc[k] = 0.f;
      for (int pj = 0; pj < nt; ++pj) {
        if (!occ_s[pi * nt + pj]) continue;  // block-uniform
        const int j0 = pj * kTile;
        __syncthreads();  // x_s complete; the previous tile is done with d_s/e_s
        if (tid < kPairs) {
          const int i = i0 + tid / kTile, j = j0 + tid % kTile;
          const bool in = i < n && j < n;
          d_s[tid] = in ? dist_b[(size_t)i * n + j] : 0.f;
          e_s[tid] = in ? env_b[(size_t)i * n + j] : 0.f;
        }
        __syncthreads();
        float w[kPPT][kFPT], c[kFPT];
        filter_tile(d_s, rbf_s, s_s, W1_s, B1, W2_s, B2, G, start, delta, coeff, w);
        tile_message(e_s, x_s + (size_t)j0 * kF, w, c);
#pragma unroll
        for (int k = 0; k < kFPT; ++k) macc[k] += c[k];
      }
      if ((tid & 16) == 0) {
#pragma unroll
        for (int k = 0; k < kFPT; ++k) m_s[il * kF + feat(fg, k)] = macc[k];
      }
      __syncthreads();
      float y[4];
      rows_linear(m_s, Wa, Ba, y);
#pragma unroll
      for (int k = 0; k < 4; ++k) t_s[r * kF + lane + 32 * k] = ssp(y[k]);
      __syncthreads();
      rows_linear(t_s, Wb, Bb, y);
      if (i0 + r < n) {
#pragma unroll
        for (int k = 0; k < 4; ++k) h[(size_t)(i0 + r) * kF + lane + 32 * k] += y[k];
      }
    }
  }
}

static size_t smem_bytes(int n, int G) {
  const int nt = (n + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)G * kF + kF * kF + kPairs * G + kPairs * kF +
                          (size_t)nt * kTile * kF + 2 * kTile * kF + 2 * kPairs) +
         sizeof(int) * (size_t)nt * nt;
}

}  // namespace geossl

extern "C" size_t schnet_stack_smem_bytes(int n, int G) { return geossl::smem_bytes(n, G); }

// Returns the cudaError_t of the launch (0 on success). F must be 128.
extern "C" int schnet_stack(const float* dist, const float* env, const float* h0,
                            const float* wl1, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* wa,
                            const float* ba, const float* wb, const float* bb,
                            float* out, int B, int n, int F, int G, int L,
                            float start, float delta, float coeff, void* stream) {
  using namespace geossl;
  if (F != kF) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, G);
  cudaFuncSetAttribute(schnet_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  schnet_stack_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      dist, env, h0, wl1, w1, b1, w2, b2, wa, ba, wb, bb, out, n, G, L, start, delta,
      coeff);
  return (int)cudaGetLastError();
}
