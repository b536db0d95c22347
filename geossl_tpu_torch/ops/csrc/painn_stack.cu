// painn_stack: all L PaiNN interaction and mixing blocks in one launch
// (inference).
//
// Replaces geossl_tpu/ops/painn_pallas.py: _stack_kernel in inference mode
// (painn_stack_infer via _stack_pallas) and, with RES, in save_residuals
// mode (painn_stack_train's forward). Per block k, with q and mu resident
// across blocks (mu starts at zero):
//   x      = silu(q Wd1 + bd1) Wd2 + bd2                      (x-MLP, 3F)
//   q, mu += the message pass of painn_fwd.cu with Wk[k], bk[k]
//   v, w   = split(mu_c Wmix)  per channel c                  (no bias)
//   vn     = sqrt(sum_c v_c^2 + eps)
//   a,g,s  = split(silu([q, vn] W1 + b1) W2 + b2)
//   q     += a + s * sum_c v_c w_c;   mu_c += g * w_c
// The gate and directions are computed once by the caller, as
// models/painn.fused_stack_apply does.
//
// Bound on the H100: operations: per block ~17k FLOP per occupied pair (the
// filter and the message sums, as painn_fwd) plus ~30 F^2 per atom for the
// dense layers (x-MLP 8F^2, mixing 12F^2, context MLP 10F^2). What the
// design does about it: one launch instead of 3L+, the filters never go to
// device memory, and 8x8 tiles whose gate is all zero (padding, empty graph
// slots, pairs beyond the cutoff) are skipped, flagged once per graph.
// Plain f32 FMAs, no tensor cores and no TF32; the dense layers read their
// weights from global memory (L2), coalesced across each warp.
//
// Work split: one block per graph (N <= 128). The state does not fit in
// shared memory at N = 128 (q 64 KB, mu 192 KB, x 192 KB), so q and mu live
// in the outputs and x and the new messages in a workspace [N][6F], all
// owned by the block. The message pass of a row tile reads the OLD mu of
// every column, while other row tiles finish at different times: so the
// messages go to the workspace and are added to mu in the mixing phase,
// after a __syncthreads that closes the message phase (the JAX kernel
// computes the whole dmu array before adding it). q is not read by the
// messages and is updated in place. Phases per block, each closed by
// __syncthreads: x-MLP, messages, mixing. Buffers written inside the kernel
// are read through plain (coherent) loads.
//
// RES (save_residuals, the forward of the differentiable stack): the kernel
// also writes the block boundaries that the backward resumes from, each
// [B, L, N, F or 3F]: qs and mus (q and mu at block entry, mus[:, 0] = 0),
// copied at the start of block k, and qps and mups (q and mu at mixing
// entry), written while the mixing loads its row tiles: mu gets the block's
// messages only there (the workspace sum above), so mups is that sum, and
// q has had its messages added in place by then. 2(F + 3F) N L floats per
// graph more to write (0.2 GB at B=128, N=128, L=3).
#include "painn_tile.cuh"

namespace geossl {

// y[k] = (A[r] W)[lane + 32k] (+ bias) for row r = tid / 32 of an 8-row
// tile: A in shared memory (row stride lda), W [IN][OUT] in global memory.
template <int IN, int OUT>
__device__ __forceinline__ void rows_dense(const float* A, int lda,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           float y[OUT / 32]) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < OUT / 32; ++k) y[k] = bias ? bias[lane + 32 * k] : 0.f;
  for (int c = 0; c < IN; ++c) {
    const float a = A[r * lda + c];
#pragma unroll
    for (int k = 0; k < OUT / 32; ++k) y[k] = fmaf(a, W[(size_t)c * OUT + lane + 32 * k], y[k]);
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <bool RES>
__global__ void __launch_bounds__(kThreads)
painn_stack_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                   const float* __restrict__ dirx, const float* __restrict__ diry,
                   const float* __restrict__ dirz, const float* __restrict__ q0,
                   const float* __restrict__ wd1, const float* __restrict__ bd1,
                   const float* __restrict__ wd2, const float* __restrict__ bd2,
                   const float* __restrict__ wk, const float* __restrict__ bk,
                   const float* __restrict__ wmix, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* qo, float* muo, float* work,
                   float* __restrict__ qs, float* __restrict__ mus,
                   float* __restrict__ qps, float* __restrict__ mups, int n, int R, int L,
                   float delta, float coeff, float eps) {
  const int nt = (n + kTile - 1) / kTile;
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem;                    // [R][kF3]
  float* phi_s = Wk_s + R * kF3;         // [R][kPhiS]
  float* xj_s = phi_s + R * kPhiS;       // [kTile][kF3]
  float* muj_s = xj_s + kTile * kF3;     // [kTile][kF3]
  float* a_s = muj_s + kTile * kF3;      // [kTile][2kF]  dense-layer inputs
  float* h_s = a_s + kTile * 2 * kF;     // [kTile][kF]   hidden layer
  float* pr_s = h_s + kTile * kF;        // [5][kPairs]
  int* occ_s = (int*)(pr_s + 5 * kPairs);  // [nt][nt]

  const int tid = threadIdx.x, b = blockIdx.x;
  const int r = tid >> 5, lane = tid & 31;
  const size_t grid_off = (size_t)b * n * n;
  const float* gate_b = gate + grid_off;
  float* q = qo + (size_t)b * n * kF;      // [n][kF]
  float* mu = muo + (size_t)b * n * kF3;   // [n][kF3]
  float* xw = work + (size_t)b * n * 2 * kF3;  // [n][2 kF3]: x, then new messages
  for (int idx = tid; idx < n * kF; idx += kThreads) q[idx] = q0[(size_t)b * n * kF + idx];
  for (int idx = tid; idx < n * kF3; idx += kThreads) mu[idx] = 0.f;
  // the gate is the same for every block: flag the occupied tiles once
  for (int t = tid; t < nt * nt; t += kThreads) occ_s[t] = 0;
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    if (gate_b[idx] != 0.f) occ_s[(i / kTile) * nt + j / kTile] = 1;
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();  // q and mu of the previous block are complete
    // this block's slice of the residuals, [n][F] and [n][3F]
    const size_t res_q = ((size_t)b * L + l) * n * kF, res_mu = 3 * res_q;
    if (RES) {
      for (int idx = tid; idx < n * kF; idx += kThreads) qs[res_q + idx] = q[idx];
      for (int idx = tid; idx < n * kF3; idx += kThreads) mus[res_mu + idx] = mu[idx];
    }
    block_copy(Wk_s, wk + (size_t)l * R * kF3, R * kF3);
    const float* Bk = bk + (size_t)l * kF3;

    // x-MLP, 8 rows at a time: x = silu(q Wd1 + bd1) Wd2 + bd2
    for (int r0 = 0; r0 < n; r0 += kTile) {
      const int row = r0 + r;
      __syncthreads();  // the previous row tile is done with a_s, h_s
      for (int idx = tid; idx < kTile * kF; idx += kThreads) {
        const int i = r0 + idx / kF;
        a_s[idx] = i < n ? q[(size_t)i * kF + idx % kF] : 0.f;
      }
      __syncthreads();
      float y[4];
      rows_dense<kF, kF>(a_s, kF, wd1 + (size_t)l * kF * kF, bd1 + (size_t)l * kF, y);
#pragma unroll
      for (int k = 0; k < 4; ++k) h_s[r * kF + lane + 32 * k] = silu(y[k]);
      __syncwarp();  // row r of h_s is this warp's
      float x[12];
      rows_dense<kF, kF3>(h_s, kF, wd2 + (size_t)l * kF * kF3, bd2 + (size_t)l * kF3, x);
      if (row < n) {
#pragma unroll
        for (int k = 0; k < 12; ++k) xw[(size_t)row * 2 * kF3 + lane + 32 * k] = x[k];
      }
    }
    __syncthreads();  // x is complete and no thread reads q until the mixing

    // messages from the old mu: q += dq in place, dmu into the workspace
    for (int pi = 0; pi < nt; ++pi) {
      const int i0 = pi * kTile;
      float aq[kFPT], am[3][kFPT];
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        aq[k] = 0.f;
        am[0][k] = am[1][k] = am[2][k] = 0.f;
      }
      for (int pj = 0; pj < nt; ++pj) {
        if (!occ_s[pi * nt + pj]) continue;  // block-uniform
        const int j0 = pj * kTile;
        __syncthreads();  // x is complete; the previous tile is done with the scratch
        if (tid < kPairs)
          painn_load_pairs(pr_s, dist + grid_off, gate_b, dirx + grid_off,
                           diry + grid_off, dirz + grid_off, i0 + tid / kTile,
                           j0 + tid % kTile, n, n, tid);
        for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
          const int j = j0 + idx / kF3, t = idx % kF3;
          xj_s[idx] = j < n ? xw[(size_t)j * 2 * kF3 + t] : 0.f;
          muj_s[idx] = j < n ? mu[(size_t)j * kF3 + t] : 0.f;
        }
        __syncthreads();
        painn_rbf(pr_s, phi_s, R, delta, coeff);
        __syncthreads();
        painn_tile_messages<kF3>(pr_s, phi_s, Wk_s, Bk, R, xj_s, muj_s, aq, am);
      }
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        aq[k] += __shfl_xor_sync(0xffffffffu, aq[k], 16);
#pragma unroll
        for (int c = 0; c < 3; ++c) am[c][k] += __shfl_xor_sync(0xffffffffu, am[c][k], 16);
      }
      const int fg = thread_fg(), i = i0 + thread_il();
      if ((tid & 16) == 0 && i < n) {
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          const int f = feat(fg, k);
          q[(size_t)i * kF + f] += aq[k];
#pragma unroll
          for (int c = 0; c < 3; ++c) xw[(size_t)i * 2 * kF3 + kF3 + c * kF + f] = am[c][k];
        }
      }
    }
    __syncthreads();  // every row's messages are complete

    // mixing, 8 rows at a time (thread: row r, features f = lane + 32k)
    const float* Wmix = wmix + (size_t)l * kF * 2 * kF;
    for (int r0 = 0; r0 < n; r0 += kTile) {
      const int row = r0 + r;
      __syncthreads();  // the previous row tile is done with muj_s, a_s, h_s
      for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
        const int i = r0 + idx / kF3, t = idx % kF3;
        const float v =
            i < n ? mu[(size_t)i * kF3 + t] + xw[(size_t)i * 2 * kF3 + kF3 + t] : 0.f;
        muj_s[idx] = v;
        if (RES && i < n) mups[res_mu + (size_t)i * kF3 + t] = v;
      }
      for (int idx = tid; idx < kTile * kF; idx += kThreads) {
        const int i = r0 + idx / kF;
        const float v = i < n ? q[(size_t)i * kF + idx % kF] : 0.f;
        a_s[(idx / kF) * 2 * kF + idx % kF] = v;
        if (RES && i < n) qps[res_q + (size_t)i * kF + idx % kF] = v;
      }
      __syncthreads();
      float v[3][4], w[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float y[8];
        rows_dense<kF, 2 * kF>(muj_s + c * kF, kF3, Wmix, nullptr, y);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[c][k] = y[k];
          w[c][k] = y[4 + k];
        }
      }
      float vw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float vn = sqrtf(v[0][k] * v[0][k] + v[1][k] * v[1][k] + v[2][k] * v[2][k] + eps);
        a_s[r * 2 * kF + kF + lane + 32 * k] = vn;
        vw[k] = v[0][k] * w[0][k] + v[1][k] * w[1][k] + v[2][k] * w[2][k];
      }
      __syncwarp();  // row r of a_s is this warp's
      float y[4];
      rows_dense<2 * kF, kF>(a_s, 2 * kF, w1 + (size_t)l * 2 * kF * kF, b1 + (size_t)l * kF, y);
#pragma unroll
      for (int k = 0; k < 4; ++k) h_s[r * kF + lane + 32 * k] = silu(y[k]);
      __syncwarp();
      float x2[12];
      rows_dense<kF, kF3>(h_s, kF, w2 + (size_t)l * kF * kF3, b2 + (size_t)l * kF3, x2);
      if (row < n) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int f = lane + 32 * k;
          q[(size_t)row * kF + f] = a_s[r * 2 * kF + f] + x2[k] + x2[8 + k] * vw[k];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            mu[(size_t)row * kF3 + c * kF + f] = muj_s[r * kF3 + c * kF + f] + x2[4 + k] * w[c][k];
        }
      }
    }
  }
}

static size_t smem_bytes(int n, int R) {
  const int nt = (n + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)R * kF3 + (size_t)R * kPhiS + 2 * kTile * kF3 +
                          3 * kTile * kF + 5 * kPairs) +
         sizeof(int) * (size_t)nt * nt;
}

}  // namespace geossl

extern "C" size_t painn_stack_smem_bytes(int n, int R) { return geossl::smem_bytes(n, R); }

// Returns the cudaError_t of the launch (0 on success). F must be 128 and
// n <= 128. `work` holds B*n*6F floats of scratch. With `save_residuals`,
// qs/qps hold B*L*n*F floats and mus/mups B*L*n*3F each (else they are
// not read and may be null).
extern "C" int painn_stack(const float* dist, const float* gate, const float* dirx,
                           const float* diry, const float* dirz, const float* q0,
                           const float* wd1, const float* bd1, const float* wd2,
                           const float* bd2, const float* wk, const float* bk,
                           const float* wmix, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* q, float* mu,
                           float* work, float* qs, float* mus, float* qps, float* mups,
                           int B, int n, int F, int R, int L, float delta, float coeff,
                           float eps, int save_residuals, void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || n > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, R);
  cudaStream_t s = (cudaStream_t)stream;
  if (save_residuals) {
    cudaFuncSetAttribute(painn_stack_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    painn_stack_kernel<true><<<B, kThreads, smem, s>>>(
        dist, gate, dirx, diry, dirz, q0, wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2,
        b2, q, mu, work, qs, mus, qps, mups, n, R, L, delta, coeff, eps);
  } else {
    cudaFuncSetAttribute(painn_stack_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    painn_stack_kernel<false><<<B, kThreads, smem, s>>>(
        dist, gate, dirx, diry, dirz, q0, wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2,
        b2, q, mu, work, qs, mus, qps, mups, n, R, L, delta, coeff, eps);
  }
  return (int)cudaGetLastError();
}
