// cfconv_fwd: SchNet's continuous-filter convolution, forward, in one kernel.
//
//   m[b,i,f] = sum_j env[b,i,j] * (ssp(rbf(dist[b,i,j]) W1 + b1) W2 + b2)[f] * x[b,j,f]
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _fwd_kernel (cfconv_fused) and,
// with SYM, _fwd_sym_kernel (cfconv_fused_sym). As there, the [B,N,N,F]
// filter tensor never leaves the chip: it reads dist/env [B,N,N] and
// x [B,N,F] and writes m [B,N,F].
//
// Bound on the H100: operations. The filter MLP costs
// 2*G*F + 2*F*F + 2*F FLOP per pair (~46k at G=51, F=128) against 8 bytes of
// dist/env per pair, far above the card's f32 ridge of ~20 FLOP/byte. The
// design attacks that bound only by not doing work: tiles whose envelope is
// all zero (out of cutoff, padding, empty graph slots) are skipped when
// `sparse` is set, and SYM skips the tiles below the diagonal. The arithmetic
// itself is plain f32 FMA from shared memory with a 4x8 register tile per
// thread (no tensor cores and no TF32, so the kernel matches f32 math).
//
// Work split: one block per (graph, 8-row i tile); the block loops over the
// 8-column j tiles, which takes the place of the TPU's sequential j grid
// axis, and keeps its rows' sums in registers. W1 and W2 are staged in shared
// memory once per block, at its first computed tile. Each block finds its
// own occupied tiles in one pass over its env rows before the loop (the
// TPU kernels got flags from a separate occupancy pass by scalar prefetch).
//
// SYM (symmetric dist/env only): with square 8x8 tiles, tile (pi, pj) is
// skipped iff (pj+1)*8 <= pi*8, i.e. pj < pi. Every cell of a computed tile
// with pj > pi has its mirror in a skipped tile, so that tile also adds
// env[i,j] W[i,j,:] x[i,:] into m[j,:]: summed over i in shared memory, then
// added to the j rows with global atomicAdd. All output writes are atomic in
// this mode, so `out` must be zero on entry and the summation order varies
// from run to run.
#include "pair_tile.cuh"

namespace geossl {

template <bool SYM>
__global__ void __launch_bounds__(kThreads)
cfconv_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int ni,
                  int nj, int G, float start, float delta, float coeff,
                  int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem;                   // [G][kF]
  float* W2_s = W1_s + G * kF;          // [kF][kF]
  float* rbf_s = W2_s + kF * kF;        // [kPairs][G]
  float* s_s = rbf_s + kPairs * G;      // [kPairs][kF]
  float* xj_s = s_s + kPairs * kF;      // [kTile][kF]
  float* xi_s = xj_s + kTile * kF;      // [kTile][kF]   (SYM)
  float* mir_s = xi_s + kTile * kF;     // [kTile][kF]   (SYM)
  float* d_s = mir_s + kTile * kF;      // [kPairs]
  float* e_s = d_s + kPairs;            // [kPairs]
  int* occ_s = (int*)(e_s + kPairs);    // [ntj] tile occupancy of this row block

  const int tid = threadIdx.x;
  const int pi = blockIdx.x, b = blockIdx.y;
  const int i0 = pi * kTile;
  const float* dist_b = dist + (size_t)b * ni * nj;
  const float* env_b = env + (size_t)b * ni * nj;
  const float* x_b = x + (size_t)b * nj * kF;
  float* out_b = out + (size_t)b * ni * kF;

  if (SYM) {
    for (int idx = tid; idx < kTile * kF; idx += kThreads) {
      const int i = i0 + idx / kF;
      xi_s[idx] = i < ni ? x_b[(size_t)i * kF + idx % kF] : 0.f;
    }
  }

  const int fg = thread_fg(), il = thread_il(), jl0 = thread_jl0();
  float macc[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) macc[k] = 0.f;

  // occupancy: one coalesced pass over this block's env rows flags the
  // tiles with a nonzero entry, so an empty tile costs no further read
  const int ntj = (nj + kTile - 1) / kTile;
  const int jstart = SYM ? i0 : 0;
  if (sparse) {
    for (int t = tid; t < ntj; t += kThreads) occ_s[t] = 0;
    __syncthreads();
    const int rows = min(kTile, ni - i0), cols = nj - jstart;
    for (int idx = tid; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, j = jstart + idx - r * cols;
      if (env_b[(size_t)(i0 + r) * nj + j] != 0.f) occ_s[j / kTile] = 1;
    }
    __syncthreads();
  }

  // the weights are staged at the first tile computed: a block whose rows
  // are all padding (an empty graph slot) reads nothing but its envelope
  bool staged = false;
  for (int pj = SYM ? pi : 0; pj < ntj; ++pj) {
    if (sparse && !occ_s[pj]) continue;  // block-uniform
    const int j0 = pj * kTile;
    __syncthreads();  // the previous tile is done with d_s/e_s/xj_s/mir_s
    if (tid < kPairs) {
      const int i = i0 + tid / kTile, j = j0 + tid % kTile;
      const bool in = i < ni && j < nj;
      d_s[tid] = in ? dist_b[(size_t)i * nj + j] : 0.f;
      e_s[tid] = in ? env_b[(size_t)i * nj + j] : 0.f;
    }
    if (!staged) {
      block_copy(W1_s, w1, G * kF);
      block_copy(W2_s, w2, kF * kF);
      staged = true;
    }
    for (int idx = tid; idx < kTile * kF; idx += kThreads) {
      const int j = j0 + idx / kF;
      xj_s[idx] = j < nj ? x_b[(size_t)j * kF + idx % kF] : 0.f;
      if (SYM) mir_s[idx] = 0.f;
    }
    __syncthreads();

    float w[kPPT][kFPT], c[kFPT];
    filter_tile(d_s, rbf_s, s_s, W1_s, b1, W2_s, b2, G, start, delta, coeff, w);
    tile_message(e_s, xj_s, w, c);
#pragma unroll
    for (int k = 0; k < kFPT; ++k) macc[k] += c[k];

    if (SYM && pj != pi) {
      // mirror messages m[j] += env[i,j] W[i,j] x[i] of the skipped tile (pj, pi)
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const float e = e_s[il * kTile + jl0 + q];
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          const int f = feat(fg, k);
          atomicAdd(&mir_s[(jl0 + q) * kF + f], e * w[q][k] * xi_s[il * kF + f]);
        }
      }
      __syncthreads();
      for (int idx = tid; idx < kTile * kF; idx += kThreads) {
        const int j = j0 + idx / kF;
        if (j < nj) atomicAdd(&out_b[(size_t)j * kF + idx % kF], mir_s[idx]);
      }
    }
  }

  // lanes 0-15 of each warp hold their row's sums (lanes 16-31 the same)
  const int i = i0 + il;
  if ((tid & 16) == 0 && i < ni) {
#pragma unroll
    for (int k = 0; k < kFPT; ++k) {
      const int f = feat(fg, k);
      if (SYM)
        atomicAdd(&out_b[(size_t)i * kF + f], macc[k]);
      else
        out_b[(size_t)i * kF + f] = macc[k];
    }
  }
}

static size_t smem_bytes(int G, int nj) {
  return sizeof(float) * ((size_t)G * kF + kF * kF + kPairs * G + kPairs * kF +
                          3 * kTile * kF + 2 * kPairs) +
         sizeof(int) * (size_t)((nj + kTile - 1) / kTile);
}

}  // namespace geossl

extern "C" size_t cfconv_fwd_smem_bytes(int G, int nj) { return geossl::smem_bytes(G, nj); }

// Returns the cudaError_t of the launch (0 on success). `out` must be zero on
// entry when symmetric != 0. F must be 128.
extern "C" int cfconv_fwd(const float* dist, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int B, int ni, int nj,
                          int F, int G, float start, float delta, float coeff,
                          int symmetric, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || (symmetric && ni != nj)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, nj);
  const dim3 grid((ni + kTile - 1) / kTile, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (symmetric) {
    cudaFuncSetAttribute(cfconv_fwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cfconv_fwd_kernel<true><<<grid, kThreads, smem, s>>>(
        dist, env, x, w1, b1, w2, b2, out, ni, nj, G, start, delta, coeff, sparse);
  } else {
    cudaFuncSetAttribute(cfconv_fwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cfconv_fwd_kernel<false><<<grid, kThreads, smem, s>>>(
        dist, env, x, w1, b1, w2, b2, out, ni, nj, G, start, delta, coeff, sparse);
  }
  return (int)cudaGetLastError();
}
