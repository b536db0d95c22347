// The filter network and the messages of one 8x8 pair tile on the tensor
// cores, shared by the kernels that walk a list of pair tiles with a block of
// 8 warps (schnet_stack.cu's message phase, both modes of cfconv_fwd.cu).
//
// Pair p = jl*8 + il of the tile is row p of its 64-row operands. Warp
// (wm, wn) = (warp & 1, warp >> 1) owns rows 32*wm.. and columns 32*wn.. of
// each 64 x F product, so lane (g, t) holds pairs (jl = 4*wm + 2*mb + h,
// il = g) and columns 32*wn + 8*nb + 2*t + c.
#pragma once

#include "mma_tf32.cuh"
#include "pair_tile.cuh"

namespace geossl {

constexpr int kSGP = 64;      // G padded (G <= 64): rows of W1_s, columns of rbf_s
constexpr int kSRS = kF + 8;  // row stride of the 8-row x tiles (bank spread)

// acc = ssp(rbf(d) W1 + b1) W2 of the tile (b2 not added), in 3xTF32
// (kPrecise: mma_tf32.cuh's precise mode), with the RBF exp and ssp on the
// CUDA cores (fast intrinsics). d_t: the tile's distances [il][jl]; rbf_s
// [kPairs][gp] scratch; s_s [kPairs][kF] scratch for the hidden layer;
// W1_s [gp][kF] (rows >= G zero) and W2_s [kF][kF]; all swizzled. gp, the
// padded G: kSGP, or a multiple of 32 above it (the first product then runs
// in k steps of 32). rbf_s's columns >= G must be zero, but with kAlias,
// where s_s is rbf_s (a kernel short of shared memory): then the hidden
// layer overwrites the RBF after a barrier, and the RBF pass writes the
// padding's zeros itself. Every thread of the block calls it (it holds two
// barriers, three with kAlias; rbf_s and s_s are free on entry).
template <bool kPrecise, bool kAlias = false>
__device__ __forceinline__ void filter_tile_mma(const float* d_t, float* rbf_s, float* s_s,
                                                const float* W1_s, const float* W2_s,
                                                const float* b1_s, int G, int gp, float start,
                                                float delta, float coeff, float acc[2][4][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int gw = kAlias ? gp : G;  // the columns the RBF pass writes
  for (int idx = tid; idx < kPairs * gp; idx += kThreads) {
    const int p = idx / gp, gg = idx % gp;
    if (gg < gw) {
      float v = 0.f;
      if (gg < G) {
        const float diff = d_t[(p & 7) * kTile + (p >> 3)] - (start + delta * (float)gg);
        v = __expf(coeff * diff * diff);
      }
      rbf_s[swz_at(gp, p, gg)] = v;
    }
  }
  __syncthreads();

  // hidden s = ssp(rbf W1 + b1) into s_s
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
  if (G <= 56) {
    warp_tile_mma<2, 4, 56, false, false, false, kPrecise>(acc, rbf_s, gp, 32 * wm, W1_s, kF, 32 * wn);
  } else if (gp == kSGP) {
    warp_tile_mma<2, 4, kSGP, false, false, false, kPrecise>(acc, rbf_s, gp, 32 * wm, W1_s, kF, 32 * wn);
  } else {
    for (int k0 = 0; k0 < gp; k0 += 32)
      warp_tile_mma<2, 4, 32, false, false, false, kPrecise>(acc, rbf_s + k0, gp, 32 * wm,
                                                             W1_s + k0 * kF, kF, 32 * wn);
  }
  if (kAlias) __syncthreads();  // every warp is done with the RBF
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store2(s_s, kF, 32 * wm + 16 * mb + 8 * hh + g, c0,
               ssp_fast(acc[mb][nb][2 * hh] + b1_s[c0]),
               ssp_fast(acc[mb][nb][2 * hh + 1] + b1_s[c0 + 1]));
    }
  __syncthreads();

  // the filter, s W2, in registers
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
  warp_tile_mma<2, 4, kF, false, false, false, kPrecise>(acc, s_s, kF, 32 * wm, W2_s, kF, 32 * wn);
}

// The tile's messages from its filter (acc + b2): this lane's rows i
// (il = g) get racc += env w x_j over the warp's four jl. With SYM and
// `mirror` (block-uniform: a tile above the diagonal) the mirrored messages
// env w x_i, summed over the tile's 8 rows i, are added to rows j0 + jl < n
// of m_b (the graph's rows, stride kF) with atomicAdd. e_t: the tile's env
// [il][jl]; xj_t, xi_t: the x rows of its j and i tiles (stride kSRS).
template <bool SYM>
__device__ __forceinline__ void tile_messages(const float acc[2][4][4], const float* b2_s,
                                              const float* e_t, const float* xj_t,
                                              const float* xi_t, float racc[4][2], float* m_b,
                                              int j0, int n, bool mirror) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  float v[32];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jl = 4 * wm + 2 * mb + hh;
      const float e = e_t[g * kTile + jl];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int c0 = 32 * wn + 8 * nb + 2 * t;
        const float ew0 = e * (acc[mb][nb][2 * hh] + b2_s[c0]);
        const float ew1 = e * (acc[mb][nb][2 * hh + 1] + b2_s[c0 + 1]);
        const float2 xj = *reinterpret_cast<const float2*>(xj_t + jl * kSRS + c0);
        racc[nb][0] = fmaf(ew0, xj.x, racc[nb][0]);
        racc[nb][1] = fmaf(ew1, xj.y, racc[nb][1]);
        if (SYM) {
          const float2 xi = *reinterpret_cast<const float2*>(xi_t + g * kSRS + c0);
          v[16 * mb + 8 * hh + 2 * nb] = ew0 * xi.x;
          v[16 * mb + 8 * hh + 2 * nb + 1] = ew1 * xi.y;
        }
      }
    }
  if (SYM && mirror) {
    rs_lanes<2>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 4 * g + q, j = j0 + 4 * wm + (e >> 3);
      const int c = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
      if (j < n) atomicAdd(m_b + (size_t)j * kF + c, v[q]);
    }
  }
}

}  // namespace geossl
