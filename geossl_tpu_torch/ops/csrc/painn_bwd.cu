// painn_bwd: backward of PaiNN's message pass in one kernel (plus a small
// reduction launch for the filter weights' gradients).
//
// Replaces geossl_tpu/ops/painn_pallas.py: _bwd_kernel (via _bwd_pallas and
// _painn_bwd) and, with SYM, _bwd_sym_kernel (via _bwd_sym_pallas and
// _painn_sym_bwd, the VJP of painn_message_fused_sym). For the cotangents gq [B,Ni,F] and gmu [B,Ni,3F] it
// recomputes every pair tile's filter and emits the nine cotangents as the
// TPU kernel does, with D[f] = sum_c dir_c gmu_c[i,f] and
// M[f] = sum_c mu_c[j,f] gmu_c[i,f]:
//   dw       = [gq_i xq_j, D xr_j, M xm_j]  (cotangent of the gated filter)
//   dx[j]    = sum_i [wq gq_i, wr D, wm M]
//   dmu_c[j] = sum_i wm gmu_c[i] xm_j
//   ddir_c   = sum_f wr xr_j gmu_c[i]     dgate = sum_t w_raw dw
//   dwg = dw gate:  dWk += phi^T dwg,  dbk += sum dwg,
//   ddist = sum_r (dwg Wk^T)[r] phi_r 2 coeff (d - off_r)
// w_raw = phi Wk + bk is recomputed for dgate (the gate may be zero, so it
// is never divided out). The [B,N,N,3F] tensors never leave the chip.
//
// Bound on the H100: operations. Per occupied pair: the filter recomputed
// (2*R*3F), dWk and dbk (2*(R+1)*3F), dphi (2*R*3F) and ~40F elementwise:
// ~52k FLOP at R=20, F=128, against ~40 bytes of pair grids read and
// written. With `sparse`, 8x8 tiles whose gate is all zero are skipped and
// their five pair cotangents written as zero (the occupancy contract of
// geossl_tpu/ops/pallas_utils.py: exact downstream, since the gate has value
// and slope zero there and every other pair cotangent carries a gate
// factor). Plain f32 FMAs, no tensor cores.
//
// Work split. The TPU grid is transposed ((b, j, i), i innermost) so that the
// j-indexed dx and dmu accumulate over i. Here a persistent grid (one block
// per SM: the block's shared memory is ~178 KB) walks the (graph, 8-column
// j tile) items; a block loops over the i tiles of its item, keeps dx and
// dmu of its j rows in registers, and keeps its share of dWk and dbk in
// registers over all its items: dbk is row R of the same product, with a
// row of ones under the RBF rows. At the end each block writes one partial
// row of (R+1)*3F floats and a second launch sums them in block order
// (reduce.cuh): no atomics, bitwise the same from run to run on one card.
//
// Pair tile layout: p = jl*8 + il (j-major), so a thread's 4 pairs share one
// j (its warp) and the dx sum over i is a register sum plus one
// __shfl_xor(16). Wk and the staged dwg tile have a padded row stride
// (kWS3 = 388), so the products that read them by column spread over the
// banks.
//
// SYM (symmetric dist/gate, antisymmetric directions, square grid), the
// scheme of cfconv_bwd.cu's SYM mode: tile (pi, pj) is computed iff
// pi <= pj; item pj walks i tiles 0..pj, items by descending pj. On a tile
// with pi < pj every cell (i, j) also carries its mirror (j, i), which has
// the same filter and the negated directions, as _bwd_sym_kernel does with
//   DB = sum_c (-dir_c) gmu_c[j],   MB = sum_c mu_c[i] gmu_c[j]:
//   dw      += [xq_i gq_j, DB xr_i, MB xm_i]   (the filter cotangent is
//              A + mirror B, so the filter chain, dgate, ddist, dWk and dbk
//              run once on the sum)
//   ddir_c  -= sum_f gate wr xr_i gmu_c[j]
//   dx[i]   += [sum_j gate wq gq_j, sum_j gate wr DB, sum_c mu_c[i] T_c]
//   dmu_c[i]+= xm_i T_c,    T_c = sum_j gate wm gmu_c[j]
// The i-indexed sums run over the tile's 8 columns (8 warps): they go
// through shared-memory atomics into five 8 x F tiles (Q, U, T_0..2) and
// are then added to dx and dmu with global atomicAdd, and so is each item's
// j-indexed part: dx and dmu must be zero on entry and their summation
// order varies from run to run. ddist and dgate are written PLACED
// symmetric, the three ddir placed antisymmetric (ops/cfconv.py
// place_sym_cotangent): a cell of a tile pi < pj holds its own cotangent
// plus (minus, for ddir) its mirror's, a diagonal tile its own, a tile
// pi > pj (and, with `sparse`, an unoccupied one) zero; exact upstream of
// the positions. dWk and dbk stay per-block partials summed in block
// order: they repeat bitwise. Shared memory: the gq/gmu rows of the j tile,
// the x rows of the i tile and the five mirror tiles (~48 KB more, 227 KB
// at R=20; mu of the i rows is read from global memory).
#include "painn_tile.cuh"
#include "reduce.cuh"

namespace geossl {

constexpr int kWS3 = kF3 + 4;

template <bool SYM>
__global__ void __launch_bounds__(kThreads, 1)
painn_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                 const float* __restrict__ dirx, const float* __restrict__ diry,
                 const float* __restrict__ dirz, const float* __restrict__ x,
                 const float* __restrict__ mu, const float* __restrict__ wk,
                 const float* __restrict__ bk, const float* __restrict__ gq,
                 const float* __restrict__ gmu, float* __restrict__ dx,
                 float* __restrict__ dmu_in, float* __restrict__ ddist,
                 float* __restrict__ dgate, float* __restrict__ ddx,
                 float* __restrict__ ddy, float* __restrict__ ddz,
                 float* __restrict__ part, int B, int ni, int nj, int R, float delta,
                 float coeff, int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem;                      // [R][kWS3]
  float* phi_s = Wk_s + R * kWS3;          // [R+1][kPhiS], row R = 1
  float* dwg_s = phi_s + (R + 1) * kPhiS;  // [kPairs][kWS3]
  float* xj_s = dwg_s + kPairs * kWS3;     // [kTile][kF3]  x rows of the j tile
  float* muj_s = xj_s + kTile * kF3;       // [kTile][kF3]  mu rows of the j tile
  float* gq_s = muj_s + kTile * kF3;       // [kTile][kF]   gq rows of the i tile
  float* gmu_s = gq_s + kTile * kF;        // [kTile][kF3]  gmu rows of the i tile
  float* pr_s = gmu_s + kTile * kF3;       // [5][kPairs]
  float* xi_s = pr_s + 5 * kPairs;         // [kTile][kF3]  SYM: x rows of the i tile
  float* gqj_s = xi_s + kTile * kF3;       // [kTile][kF]   SYM: gq rows of the j tile
  float* gmuj_s = gqj_s + kTile * kF;      // [kTile][kF3]  SYM: gmu rows of the j tile
  float* acc_s = gmuj_s + kTile * kF3;     // [5][kTile][kF] SYM: Q, U, T_0..2 of the i rows
  int* occ_s = (int*)(SYM ? acc_s + 5 * kTile * kF : xi_s);  // [nti]

  const int tid = threadIdx.x;
  const int fg = tid & (kFG - 1), hw = tid >> 4;
  const int jl = tid >> 5, il0 = (hw & 1) * kPPT;  // this thread's j and first i
  const int p0 = jl * kTile + il0;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;

  for (int idx = tid; idx < R * kF3; idx += kThreads)
    Wk_s[(idx / kF3) * kWS3 + idx % kF3] = wk[idx];
  for (int idx = tid; idx < kPairs; idx += kThreads) phi_s[R * kPhiS + idx] = 1.f;

  // this block's share of [dWk; dbk]: rows r = hw + 16m, chunk c, feat(fg, k)
  float gw[2][3][kFPT];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) gw[m][c][k] = 0.f;

  for (int item = blockIdx.x; item < B * ntj; item += gridDim.x) {
    // SYM: by descending pj (item length pj + 1), graphs interleaved
    const int b = SYM ? item % B : item / ntj;
    const int pj = SYM ? ntj - 1 - item / B : item % ntj;
    const int j0 = pj * kTile;
    // SYM: i tiles 0..pj are computed; rows from i_end on lie below the band
    const int n_it = SYM ? pj + 1 : nti;
    const int i_end = min(ni, n_it * kTile);
    const size_t grid_off = (size_t)b * ni * nj;
    const float* gate_b = gate + grid_off;
    const float* gq_b = gq + (size_t)b * ni * kF;
    const float* gmu_b = gmu + (size_t)b * ni * kF3;

    if (SYM) {  // the skipped tiles below the band hold zero
      for (int idx = tid; idx < (ni - i_end) * kTile; idx += kThreads) {
        const int i = i_end + idx / kTile, j = j0 + idx % kTile;
        if (j < nj) {
          const size_t off = grid_off + (size_t)i * nj + j;
          ddist[off] = dgate[off] = ddx[off] = ddy[off] = ddz[off] = 0.f;
        }
      }
    }
    __syncthreads();  // the previous item is done with xj_s, muj_s, gqj_s, gmuj_s, occ_s
    for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
      const int j = j0 + idx / kF3;
      const size_t src = ((size_t)b * nj + j) * kF3 + idx % kF3;
      xj_s[idx] = j < nj ? x[src] : 0.f;
      muj_s[idx] = j < nj ? mu[src] : 0.f;
      if (SYM) {
        gmuj_s[idx] = j < nj ? gmu_b[(size_t)j * kF3 + idx % kF3] : 0.f;
        if (idx < kTile * kF) {
          const int jj = j0 + idx / kF;
          gqj_s[idx] = jj < nj ? gq_b[(size_t)jj * kF + idx % kF] : 0.f;
        }
      }
    }
    if (sparse) {
      for (int t = tid; t < n_it; t += kThreads) occ_s[t] = 0;
      __syncthreads();
      for (int idx = tid; idx < i_end * kTile; idx += kThreads) {
        const int i = idx / kTile, j = j0 + idx % kTile;
        if (j < nj && gate_b[(size_t)i * nj + j] != 0.f) occ_s[i / kTile] = 1;
      }
      __syncthreads();
    }

    float dxa[3][kFPT], dma[3][kFPT];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) dxa[c][k] = dma[c][k] = 0.f;
    bool any_tile = false;  // block-uniform: a tile of this item was computed

    for (int pi = 0; pi < n_it; ++pi) {
      const int i0 = pi * kTile;
      if (sparse && !occ_s[pi]) {  // block-uniform
        if (tid < kPairs) {
          const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
          if (i < ni && j < nj) {
            const size_t off = grid_off + (size_t)i * nj + j;
            ddist[off] = dgate[off] = ddx[off] = ddy[off] = ddz[off] = 0.f;
          }
        }
        continue;
      }
      any_tile = true;
      // a tile below the diagonal of the last tile row cannot be computed, so
      // every i row of a mirror tile is < ni
      const bool mirror = SYM && pi != pj;  // block-uniform
      __syncthreads();  // the previous tile is done with the tile scratch
      if (tid < kPairs)
        painn_load_pairs(pr_s, dist + grid_off, gate_b, dirx + grid_off,
                         diry + grid_off, dirz + grid_off, i0 + (tid & 7),
                         j0 + (tid >> 3), ni, nj, tid);
      for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
        const int i = i0 + idx / kF3;
        gmu_s[idx] = i < ni ? gmu_b[(size_t)i * kF3 + idx % kF3] : 0.f;
        if (idx < kTile * kF) {
          const int ii = i0 + idx / kF;
          gq_s[idx] = ii < ni ? gq_b[(size_t)ii * kF + idx % kF] : 0.f;
        }
        if (mirror) xi_s[idx] = x[((size_t)b * nj + i) * kF3 + idx % kF3];
      }
      if (mirror)
        for (int idx = tid; idx < 5 * kTile * kF; idx += kThreads) acc_s[idx] = 0.f;
      __syncthreads();
      painn_rbf(pr_s, phi_s, R, delta, coeff);
      __syncthreads();

      // per pair: dgate and ddir partial sums over this thread's features
      float pg[kPPT], pd[3][kPPT];
#pragma unroll
      for (int q = 0; q < kPPT; ++q) pg[q] = pd[0][q] = pd[1][q] = pd[2][q] = 0.f;

#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float w[kPPT][kFPT];
        painn_filter_chunk<kWS3>(phi_s, Wk_s, bk, R, p0, fg, c, w);  // raw
        float xv[kFPT];
        load_feats(xj_s + jl * kF3 + c * kF, fg, xv);
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const int p = p0 + q, il = il0 + q;
          const float g = pr_s[kPairs + p];
          float dw[kFPT];
          if (c == 0) {
            float gv[kFPT];
            load_feats(gq_s + il * kF, fg, gv);
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              dw[k] = gv[k] * xv[k];
              dxa[0][k] = fmaf(g * w[q][k], gv[k], dxa[0][k]);
            }
            if (SYM && mirror) {  // mirror: dw += xq_i gq_j, dx[i] += g wq gq_j
              float xiv[kFPT], gjv[kFPT];
              load_feats(xi_s + il * kF3, fg, xiv);
              load_feats(gqj_s + jl * kF, fg, gjv);
#pragma unroll
              for (int k = 0; k < kFPT; ++k) {
                dw[k] = fmaf(xiv[k], gjv[k], dw[k]);
                atomicAdd(&acc_s[il * kF + feat(fg, k)], g * w[q][k] * gjv[k]);
              }
            }
          } else {
            // s = D (c == 1: sum_c dir_c gmu_c) or M (c == 2: sum_c mu_c[j] gmu_c)
            float s[kFPT], wx[kFPT];
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              s[k] = 0.f;
              wx[k] = g * w[q][k] * xv[k];
            }
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              float gm[kFPT], by[kFPT];
              load_feats(gmu_s + il * kF3 + cc * kF, fg, gm);
              if (c == 1) {
                const float dc = pr_s[(2 + cc) * kPairs + p];
#pragma unroll
                for (int k = 0; k < kFPT; ++k) {
                  s[k] = fmaf(dc, gm[k], s[k]);
                  pd[cc][q] = fmaf(wx[k], gm[k], pd[cc][q]);
                }
              } else {
                load_feats(muj_s + jl * kF3 + cc * kF, fg, by);
#pragma unroll
                for (int k = 0; k < kFPT; ++k) {
                  s[k] = fmaf(by[k], gm[k], s[k]);
                  dma[cc][k] = fmaf(wx[k], gm[k], dma[cc][k]);
                }
              }
            }
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              dw[k] = s[k] * xv[k];
              dxa[c][k] = fmaf(g * w[q][k], s[k], dxa[c][k]);
            }
            if (SYM && mirror) {
              // the mirror cell (j, i): sb = DB (c == 1) or MB (c == 2)
              float xiv[kFPT], sb[kFPT];
              load_feats(xi_s + il * kF3 + c * kF, fg, xiv);
#pragma unroll
              for (int k = 0; k < kFPT; ++k) sb[k] = 0.f;
#pragma unroll
              for (int cc = 0; cc < 3; ++cc) {
                float gmj[kFPT];
                load_feats(gmuj_s + jl * kF3 + cc * kF, fg, gmj);
                if (c == 1) {
                  const float dc = pr_s[(2 + cc) * kPairs + p];
                  float t = 0.f;
#pragma unroll
                  for (int k = 0; k < kFPT; ++k) {
                    sb[k] = fmaf(-dc, gmj[k], sb[k]);
                    t = fmaf(g * w[q][k] * xiv[k], gmj[k], t);
                  }
                  pd[cc][q] -= t;  // ddir placed antisymmetric
                } else {
                  float miv[kFPT];
                  load_feats(mu + ((size_t)b * nj + i0 + il) * kF3 + cc * kF, fg, miv);
#pragma unroll
                  for (int k = 0; k < kFPT; ++k) {
                    sb[k] = fmaf(miv[k], gmj[k], sb[k]);
                    atomicAdd(&acc_s[(2 + cc) * kTile * kF + il * kF + feat(fg, k)],
                              g * w[q][k] * gmj[k]);
                  }
                }
              }
#pragma unroll
              for (int k = 0; k < kFPT; ++k) {
                dw[k] = fmaf(sb[k], xiv[k], dw[k]);
                if (c == 1)
                  atomicAdd(&acc_s[kTile * kF + il * kF + feat(fg, k)], g * w[q][k] * sb[k]);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kFPT; ++k) pg[q] = fmaf(w[q][k], dw[k], pg[q]);
          float* row = dwg_s + p * kWS3 + c * kF + fg * 4;
          st4(row, dw[0] * g, dw[1] * g, dw[2] * g, dw[3] * g);
          st4(row + kF / 2, dw[4] * g, dw[5] * g, dw[6] * g, dw[7] * g);
        }
      }
      {
        float sg[kPPT], sd[3][kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          sg[q] = half_warp_sum(pg[q]);
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) sd[cc][q] = half_warp_sum(pd[cc][q]);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) {
              const size_t off = grid_off + (size_t)i * nj + j;
              dgate[off] = sg[q];
              ddx[off] = sd[0][q];
              ddy[off] = sd[1][q];
              ddz[off] = sd[2][q];
            }
          }
        }
      }
      __syncthreads();  // dwg_s (and, SYM, the mirror tiles) complete

      if (SYM && mirror) {
        // the tile's i-indexed dx and dmu: rows owned by other items
        for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
          const int r = idx / kF3, t = idx % kF3, c = t / kF, f = t % kF;
          const size_t row = ((size_t)b * nj + i0 + r) * kF3;
          const float* T = acc_s + 2 * kTile * kF + r * kF + f;  // T_0 of row r
          float v;
          if (c < 2) {
            v = acc_s[c * kTile * kF + r * kF + f];
          } else {
            v = mu[row + f] * T[0] + mu[row + kF + f] * T[kTile * kF] +
                mu[row + 2 * kF + f] * T[2 * kTile * kF];
          }
          atomicAdd(&dx[row + t], v);
          atomicAdd(&dmu_in[row + t], x[row + 2 * kF + f] * T[c * kTile * kF]);
        }
      }

      // ddist = sum_r (dwg Wk^T)[r] phi_r 2 coeff (d - delta r), r = fg + 16m
      {
        float dr[kPPT][2];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) dr[q][0] = dr[q][1] = 0.f;
        const int r0 = min(fg, R - 1), r1 = min(fg + 16, R - 1);
        for (int t0 = 0; t0 < kF3; t0 += 4) {
          const float4 w0 = ld4(Wk_s + r0 * kWS3 + t0), w1 = ld4(Wk_s + r1 * kWS3 + t0);
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float4 a = ld4(dwg_s + (p0 + q) * kWS3 + t0);
            dr[q][0] = fmaf(a.x, w0.x, fmaf(a.y, w0.y, fmaf(a.z, w0.z, fmaf(a.w, w0.w, dr[q][0]))));
            dr[q][1] = fmaf(a.x, w1.x, fmaf(a.y, w1.y, fmaf(a.z, w1.z, fmaf(a.w, w1.w, dr[q][1]))));
          }
        }
        float dd[kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const int p = p0 + q;
          const float d = pr_s[p];
          float s = 0.f;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int r = fg + 16 * m;
            if (r < R) {
              const float diff = d - delta * (float)r;
              s = fmaf(dr[q][m] * phi_s[r * kPhiS + p], 2.f * coeff * diff, s);
            }
          }
          dd[q] = half_warp_sum(s);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) ddist[grid_off + (size_t)i * nj + j] = dd[q];
          }
        }
      }

      // [dWk; dbk] += [phi; 1]^T dwg over the tile's 64 pairs, rows hw + 16m
      {
        const int r0 = min(hw, R), r1 = min(hw + 16, R);
        for (int p = 0; p < kPairs; ++p) {
          const float a0 = phi_s[r0 * kPhiS + p], a1 = phi_s[r1 * kPhiS + p];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float dv[kFPT];
            load_feats(dwg_s + p * kWS3 + c * kF, fg, dv);
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              gw[0][c][k] = fmaf(a0, dv[k], gw[0][c][k]);
              gw[1][c][k] = fmaf(a1, dv[k], gw[1][c][k]);
            }
          }
        }
      }
    }

    // dx and dmu rows: the two half-warps hold i 0-3 and 4-7 of every tile
    const int j = j0 + jl;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        dxa[c][k] += __shfl_xor_sync(0xffffffffu, dxa[c][k], 16);
        dma[c][k] += __shfl_xor_sync(0xffffffffu, dma[c][k], 16);
      }
    if ((tid & 16) == 0 && j < nj) {
      const size_t row = ((size_t)b * nj + j) * kF3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          if (!SYM) {
            dx[row + c * kF + feat(fg, k)] = dxa[c][k];
            dmu_in[row + c * kF + feat(fg, k)] = dma[c][k];
          } else if (any_tile) {
            atomicAdd(&dx[row + c * kF + feat(fg, k)], dxa[c][k]);
            atomicAdd(&dmu_in[row + c * kF + feat(fg, k)], dma[c][k]);
          }
        }
    }
  }

  // this block's partial [dWk; dbk], rows 0..R
  float* out = part + (size_t)blockIdx.x * (R + 1) * kF3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = hw + 16 * m;
    if (r <= R) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) out[r * kF3 + c * kF + feat(fg, k)] = gw[m][c][k];
    }
  }
}

static size_t smem_bytes(int R, int ni, int symmetric) {
  return sizeof(float) * ((size_t)R * kWS3 + (size_t)(R + 1) * kPhiS + kPairs * kWS3 +
                          2 * kTile * kF3 + kTile * kF + kTile * kF3 + 5 * kPairs +
                          (symmetric ? 2 * kTile * kF3 + kTile * kF + 5 * kTile * kF : 0)) +
         sizeof(int) * (size_t)((ni + kTile - 1) / kTile);
}

template <bool SYM>
static cudaError_t launch(const float* dist, const float* gate, const float* dirx,
                          const float* diry, const float* dirz, const float* x,
                          const float* mu, const float* wk, const float* bk,
                          const float* gq, const float* gmu, float* dx, float* dmu_in,
                          float* ddist, float* dgate, float* ddx, float* ddy, float* ddz,
                          float* part, int blocks, size_t smem, int B, int ni, int nj,
                          int R, float delta, float coeff, int sparse, cudaStream_t s) {
  cudaFuncSetAttribute(painn_bwd_kernel<SYM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  painn_bwd_kernel<SYM><<<blocks, kThreads, smem, s>>>(
      dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in, ddist, dgate,
      ddx, ddy, ddz, part, B, ni, nj, R, delta, coeff, sparse);
  return cudaGetLastError();
}

}  // namespace geossl

extern "C" size_t painn_bwd_smem_bytes(int R, int ni, int symmetric) {
  return geossl::smem_bytes(R, ni, symmetric);
}

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int painn_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// painn_bwd_blocks(B, nj) rows of (R+1)*3F floats; `wgrad` (one such row)
// receives dWk [R,3F] and then dbk [3F]. F must be 128 and 2 <= R <= 31.
// With `symmetric` (square grid only) the five pair cotangents are placed as
// the header says and dx and dmu_in must be zero on entry.
extern "C" int painn_bwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk,
                         const float* gq, const float* gmu, float* dx, float* dmu_in,
                         float* ddist, float* dgate, float* ddx, float* ddy, float* ddz,
                         float* part, float* wgrad, int B, int ni, int nj, int F, int R,
                         float delta, float coeff, int symmetric, int sparse,
                         void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > 31 || (symmetric && ni != nj))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, ni, symmetric);
  const int blocks = painn_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      symmetric ? launch<true>(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx,
                               dmu_in, ddist, dgate, ddx, ddy, ddz, part, blocks, smem, B,
                               ni, nj, R, delta, coeff, sparse, s)
                : launch<false>(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx,
                                dmu_in, ddist, dgate, ddx, ddy, ddz, part, blocks, smem, B,
                                ni, nj, R, delta, coeff, sparse, s);
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, (R + 1) * kF3, wgrad, s);
  return (int)cudaGetLastError();
}
