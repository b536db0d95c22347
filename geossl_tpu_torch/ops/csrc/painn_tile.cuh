// Shared device code of the PaiNN kernels on the CUDA cores (painn_fwd.cu's
// symmetric mode, painn_bwd.cu; painn_mma.cuh takes kF3 from here): the RBF
// and gated filters of one 8x8 pair tile and the forward message sums over it.
//
// Thread layout as pair_tile.cuh: 256 threads on a tile of 64 pairs, thread
// t owns 4 consecutive pairs p0..p0+3 and the 8 features feat(fg, k) of
// each 128-wide chunk of the 3F = 384 filter (chunk 0 = q, 1 = r, 2 = m).
// Per pair tile the shared-memory buffer `pr_s` holds five rows of 64:
// dist, gate and the three direction components, pair index fastest.
//
// The RBF is PaiNN's: offsets delta*r for r < R (delta = cutoff/(R-1)),
// coefficient -0.5/delta^2, made in the kernel as painn_pallas._offsets
// does (about 1 ulp from linspace).
#pragma once

#include "pair_tile.cuh"

namespace geossl {

constexpr int kF3 = 3 * kF;         // filter width 3F = 384
constexpr int kPhiS = kPairs + 4;   // padded row stride of phi_s

// phi_s[r][p] = exp(coeff (d_p - delta r)^2), r < R, row stride kPhiS.
__device__ __forceinline__ void painn_rbf(const float* pr_s, float* phi_s, int R,
                                          float delta, float coeff) {
  for (int idx = threadIdx.x; idx < R * kPairs; idx += kThreads) {
    const int r = idx / kPairs, p = idx - r * kPairs;
    const float diff = pr_s[p] - delta * (float)r;
    phi_s[r * kPhiS + p] = expf(coeff * diff * diff);
  }
}

// Raw (ungated) filter of chunk c for pairs p0..p0+3:
//   w[q][k] = sum_r phi[r][p0+q] Wk[r][c*kF + feat(fg, k)] + bk[c*kF + feat(fg, k)]
// Wk_s has row stride WS (16-byte aligned rows).
template <int WS>
__device__ __forceinline__ void painn_filter_chunk(const float* phi_s, const float* Wk_s,
                                                   const float* __restrict__ bk, int R,
                                                   int p0, int fg, int c,
                                                   float w[kPPT][kFPT]) {
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    const float b = bk[c * kF + feat(fg, k)];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) w[q][k] = b;
  }
  for (int r = 0; r < R; ++r) {
    const float4 a4 = ld4(phi_s + r * kPhiS + p0);
    const float a[kPPT] = {a4.x, a4.y, a4.z, a4.w};
    float wv[kFPT];
    load_feats(Wk_s + r * WS + c * kF, fg, wv);
#pragma unroll
    for (int q = 0; q < kPPT; ++q)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) w[q][k] = fmaf(a[q], wv[k], w[q][k]);
  }
}

// Width of one row of mirrored messages: dq (F) then dmu (3F).
constexpr int kF4 = 4 * kF;

// Forward messages of one pair tile (tile layout p = il*8 + jl, rows i of
// the block, columns j of the tile) added to this thread's sums:
//   aq[k]     += sum_q gate wq xq_j
//   am[c][k]  += sum_q gate (wr xr_j dir_c + wm xm_j mu_c[j])
// for its row il and features feat(fg, k); the two half-warps of a warp
// hold columns 0-3 and 4-7 of the same row. xj_s / muj_s: the tile's 8
// rows of x and mu (stride kF3). phi_s must hold the tile's RBF.
//
// MIRROR (painn_fwd.cu's symmetric mode, symmetric dist/gate and
// antisymmetric directions): each cell also adds the messages of its mirror
// cell (j, i), whose filter is the same and whose directions flip sign,
// into row j of mir_s [kTile][kF4] (dq, then the three dmu channels):
//   mir[j]        += gate wq xq_i
//   mir[j][F + c] += gate (wr xr_i (-dir_c) + wm xm_i mu_c[i])
// by shared-memory atomics (the 8 rows i of a column are 8 warps).
// xi_s / mui_s: the block's 8 rows of x and mu.
template <int WS, bool MIRROR = false>
__device__ __forceinline__ void painn_tile_messages(const float* pr_s, const float* phi_s,
                                                    const float* Wk_s,
                                                    const float* __restrict__ bk, int R,
                                                    const float* xj_s, const float* muj_s,
                                                    float aq[kFPT], float am[3][kFPT],
                                                    const float* xi_s = nullptr,
                                                    const float* mui_s = nullptr,
                                                    float* mir_s = nullptr) {
  const int fg = thread_fg(), jl0 = thread_jl0(), il = thread_il();
  const int p0 = il * kTile + jl0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float w[kPPT][kFPT];
    painn_filter_chunk<WS>(phi_s, Wk_s, bk, R, p0, fg, c, w);
    float xiv[kFPT];
    if (MIRROR) load_feats(xi_s + il * kF3 + c * kF, fg, xiv);
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int p = p0 + q;
      const float g = pr_s[kPairs + p];
      float xv[kFPT];
      load_feats(xj_s + (jl0 + q) * kF3 + c * kF, fg, xv);
      float* mir_row = mir_s + (jl0 + q) * kF4;
      if (c == 0) {
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          aq[k] = fmaf(g * w[q][k], xv[k], aq[k]);
          if (MIRROR) atomicAdd(&mir_row[feat(fg, k)], g * w[q][k] * xiv[k]);
        }
      } else if (c == 1) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float dc = pr_s[(2 + cc) * kPairs + p];
#pragma unroll
          for (int k = 0; k < kFPT; ++k) {
            am[cc][k] = fmaf(g * w[q][k] * xv[k], dc, am[cc][k]);
            if (MIRROR)
              atomicAdd(&mir_row[kF + cc * kF + feat(fg, k)], -(g * w[q][k] * xiv[k]) * dc);
          }
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          float mv[kFPT], miv[kFPT];
          load_feats(muj_s + (jl0 + q) * kF3 + cc * kF, fg, mv);
          if (MIRROR) load_feats(mui_s + il * kF3 + cc * kF, fg, miv);
#pragma unroll
          for (int k = 0; k < kFPT; ++k) {
            am[cc][k] = fmaf(g * w[q][k] * xv[k], mv[k], am[cc][k]);
            if (MIRROR)
              atomicAdd(&mir_row[kF + cc * kF + feat(fg, k)], g * w[q][k] * xiv[k] * miv[k]);
          }
        }
      }
    }
  }
}

// Loads the pair tile (i0.., j0..) of the five [n_i, n_j] grids into pr_s
// (zeros outside); tid < 64 only, pair p = (p / 8) row, (p % 8) column.
__device__ __forceinline__ void painn_load_pairs(float* pr_s, const float* __restrict__ dist,
                                                 const float* __restrict__ gate,
                                                 const float* __restrict__ dirx,
                                                 const float* __restrict__ diry,
                                                 const float* __restrict__ dirz, int i, int j,
                                                 int ni, int nj, int p) {
  const bool in = i < ni && j < nj;
  const size_t off = (size_t)i * nj + j;
  pr_s[p] = in ? dist[off] : 0.f;
  pr_s[kPairs + p] = in ? gate[off] : 0.f;
  pr_s[2 * kPairs + p] = in ? dirx[off] : 0.f;
  pr_s[3 * kPairs + p] = in ? diry[off] : 0.f;
  pr_s[4 * kPairs + p] = in ? dirz[off] : 0.f;
}

}  // namespace geossl
