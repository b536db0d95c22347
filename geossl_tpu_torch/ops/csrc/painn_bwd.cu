// painn_bwd: backward of PaiNN's message pass (plus a small reduction launch
// for the filter weights' gradients).
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
// One kernel, painn_bwd_mma_kernel<SYM>, for both modes. Bound on the H100:
// operations. Per computed pair: the filter recomputed (2*R*3F), dWk and
// dbk (2*(R+1)*3F), dphi (2*R*3F) and ~40F elementwise: ~52k FLOP at
// R=20, F=128, against ~40 bytes of pair grids read and written. The three
// products are ~90% of it and run on the tensor cores with
// mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh: within f32 rounding of the
// plain version, as the CFConv backward): per 8x8 tile, with pair
// p = jl*8 + il as row p,
//   w_raw [64 x 3F]  = [phi; 1]^T^T [Wk; bk]   K = R+1 padded to 24 (32 for R > 23)
//   dphi  [64 x 32]  = dwg Wk^T                 K = 3F, in two halves
//   [dWk; dbk] [32 x 3F] += [phi; 1] dwg        K = 64 pairs (precise mode)
// phi is kept transposed ([r][p], a row of ones at r = R and zeros below),
// and bk sits at row R of the staged Wk, so the bias rides in the products.
// The elementwise terms stay on the CUDA cores, in the mma fragments'
// layout: lane (g, t) holds pairs il = g, so the dx/dmu sums over i are
// sums over the 8 lanes of one t (rs_lanes), and the per-pair sums over f
// (dgate, ddir, ddist) sums over t and then over the column warps, in a
// fixed order.
//
// Work split. An occupancy pass and a scan (worklist.cuh) make a work list
// on the device, with no host sync: items are (graph, 8-column j tile) with
// their computed i tiles (with `sparse`, 8x8 tiles whose gate is all zero
// are skipped and their five pair cotangents written as zero: the
// occupancy contract of geossl_tpu/ops/pallas_utils.py, exact downstream,
// since the gate has value and slope zero there and every other pair
// cotangent carries a gate factor). A persistent grid (one block of 8 warps
// per SM, 255 registers a thread: the block's shared memory is ~217 KB,
// ~221 KB with SYM) splits the items into contiguous runs of equal work by
// the prefix sums; items are never split. For each item the block stages
// its x and mu rows; then it walks the item's computed i tiles with the
// next tile's pair grids and gq/gmu rows in flight (cp.async) while the
// current tile's products run. dWk and dbk stay in the warps' mma
// accumulators over all of a block's tiles; each block writes one partial
// row of (R+1)*3F floats and a last launch sums them in block order
// (reduce.cuh), so they repeat bitwise, as do the five pair cotangents
// (each written once, its cross-warp sums in a fixed order). Plain mode
// writes each dx and dmu row once, from registers: every output is bitwise
// the same from run to run on one card.
//
// SYM (symmetric dist/gate, antisymmetric directions, square grid), the
// scheme of cfconv_bwd.cu's SYM mode: tile (pi, pj) is computed iff pi <=
// pj (the occupancy pass writes zero on the five pair cotangents of the
// others), so an item (graph, pj) walks i tiles 0..pj. On a tile with
// pi < pj every cell (i, j) also carries its mirror (j, i), which has the
// same filter and the negated directions, as _bwd_sym_kernel does with
//   DB = sum_c (-dir_c) gmu_c[j],   MB = sum_c mu_c[i] gmu_c[j]:
//   dw      += [xq_i gq_j, DB xr_i, MB xm_i]   (the filter cotangent is
//              A + mirror B, so the filter chain, dgate, ddist, dWk and dbk
//              run once on the sum)
//   ddir_c  -= sum_f gate wr xr_i gmu_c[j]
//   dx[i]   += [sum_j gate wq gq_j, sum_j gate wr DB, sum_c mu_c[i] T_c]
//   dmu_c[i]+= xm_i T_c,    T_c = sum_j gate wm gmu_c[j]
// ddist and dgate come out PLACED symmetric, the three ddir placed
// antisymmetric (ops/cfconv.py place_sym_cotangent): a cell of a tile
// pi < pj holds its own cotangent plus (minus, for ddir) its mirror's, a
// diagonal tile its own, every other tile zero; exact upstream of the
// positions. The elementwise part takes another warp layout: warp w owns
// all 64 pairs of a tile and features 16 w.. of each chunk, so lane (g, t)
// holds row il = g with all eight jl, and the mirror's sums over j (the
// i-indexed Q, U, T_c above) complete in the lane's registers; they are
// added to the tile's i rows (rows that other items own) with float2
// atomics, once per tile. The j rows' sums (over i, rs_lanes) stay in
// registers over the item and are added once per item, also with atomics:
// dx and dmu must be zero on entry and their summation order varies from
// run to run. The item's gq and gmu rows are staged beside its x and mu
// rows; the i tile's x and mu rows are read from global memory (L1/L2) at
// their use, and its gq/gmu rows have one buffer, loaded while the tile's
// ddist and dWk products run, so that shared memory holds one block.
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

constexpr int kRP = 32;       // rows of Wk_s and phiT_s: R filter rows, the bias row, zeros
constexpr int kS3 = kF3 + 8;  // row stride of the 8-row node tiles, 3F wide (bank spread)
constexpr int kS1 = kF + 8;   // the same, F wide

// shared memory of painn_bwd_mma_kernel<SYM>, in floats
template <bool SYM>
struct BwdSmem {
  static constexpr int kRowBufs = SYM ? 1 : 2;  // buffers of the i tile's gq/gmu rows
  static constexpr int kColWarps = SYM ? 8 : 4;  // warps over the features of a chunk
  static constexpr int Wk = 0;                         // [kRP][kF3] swizzled: Wk, bk at row R
  static constexpr int Phi = Wk + kRP * kF3;           // [kRP][kPairs] swizzled: phi^T, row R = 1
  static constexpr int Dwg = Phi + kRP * kPairs;       // [kPairs][kF3] swizzled: dwg
  static constexpr int Xj = Dwg + kPairs * kF3;        // [8][kS3] x rows of the item
  static constexpr int Muj = Xj + kTile * kS3;         // [8][kS3] mu rows of the item
  static constexpr int Gq = Muj + kTile * kS3;         // [kRowBufs][8][kS1] gq rows of the i tile
  static constexpr int Gmu = Gq + kRowBufs * kTile * kS1;    // [kRowBufs][8][kS3] gmu rows
  static constexpr int Gqj = Gmu + kRowBufs * kTile * kS3;   // SYM: [8][kS1] gq rows of the item
  static constexpr int Gmuj = Gqj + (SYM ? kTile * kS1 : 0);  // SYM: [8][kS3] gmu rows of the item
  static constexpr int Pr = Gmuj + (SYM ? kTile * kS3 : 0);   // [2][5][64] dist, gate, dir x/y/z
  static constexpr int Pg = Pr + 2 * 5 * kPairs;             // [kColWarps][64] dgate partials
  static constexpr int Pd = Pg + kColWarps * kPairs;         // [kColWarps][3][64] ddir partials
  static constexpr int Dd = Pd + 3 * kColWarps * kPairs;     // [2][64] ddist partials
  static constexpr int Floats = Dd + 2 * kPairs;  // then ints: misc[4], tile list [nti]
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// w_raw of chunk c (columns c*F..) for this warp's 32 pairs x 32 features
template <int K>
__device__ __forceinline__ void filter_chunk_mma(float acc[2][4][4], const float* phi_s,
                                                 const float* Wk_s, int wm, int wn, int c) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
  warp_tile_mma<2, 4, K, true, false>(acc, phi_s, kPairs, 32 * wm, Wk_s, kF3, c * kF + 32 * wn);
}

// SYM: w_raw of chunk c for all 64 pairs x this warp's 16 features
template <int K>
__device__ __forceinline__ void filter_chunk_sym(float acc[4][2][4], const float* phi_s,
                                                 const float* Wk_s, int warp, int c) {
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
  warp_tile_mma<4, 2, K, true, false>(acc, phi_s, kPairs, 0, Wk_s, kF3, c * kF + 16 * warp);
}

// The elementwise part of one tile in plain mode: warp (wm, wn) owns pairs
// 32*wm.. and features 32*wn.. of each chunk. dwg into dwg_s, the dgate and
// ddir partials of the column warps into pg_p / pd_p, the item's dx and dmu
// sums (rows j) into dxa / dma.
__device__ __forceinline__ void tile_plain(const float* pr, const float* gq_t,
                                           const float* gmu_t, const float* xj_s,
                                           const float* muj_s, const float* phi_s,
                                           const float* Wk_s, float* dwg_s, float* pg_p,
                                           float* pd_p, int R, float dxa[3][4],
                                           float dma[3][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  // per pair of this lane (q = 2 mb + h): dgate and ddir partial sums over its features
  float pgv[4], pdv[3][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pgv[q] = pdv[0][q] = pdv[1][q] = pdv[2][q] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc[2][4][4];
    if (R < 24)
      filter_chunk_mma<24>(acc, phi_s, Wk_s, wm, wn, c);
    else
      filter_chunk_mma<kRP>(acc, phi_s, Wk_s, wm, wn, c);
    float v[32];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 32 * wm + 16 * mb + 8 * h + g, jl = p >> 3;
        const float gt = pr[kPairs + g * kTile + jl];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int col = 32 * wn + 8 * nb + 2 * t;
          const float w0 = acc[mb][nb][2 * h], w1 = acc[mb][nb][2 * h + 1];
          const float2 xv = ld2(xj_s + jl * kS3 + c * kF + col);
          float2 s;
          if (c == 0) {
            s = ld2(gq_t + g * kS1 + col);
          } else {
            s = make_float2(0.f, 0.f);
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              const float2 gm = ld2(gmu_t + g * kS3 + cc * kF + col);
              if (c == 1) {
                const float dc = pr[(2 + cc) * kPairs + g * kTile + jl];
                s.x = fmaf(dc, gm.x, s.x);
                s.y = fmaf(dc, gm.y, s.y);
                pdv[cc][2 * mb + h] += gt * fmaf(w0 * xv.x, gm.x, w1 * xv.y * gm.y);
              } else {
                const float2 mj = ld2(muj_s + jl * kS3 + cc * kF + col);
                s.x = fmaf(mj.x, gm.x, s.x);
                s.y = fmaf(mj.y, gm.y, s.y);
              }
            }
          }
          const float dw0 = s.x * xv.x, dw1 = s.y * xv.y;
          pgv[2 * mb + h] += fmaf(w0, dw0, w1 * dw1);
          store2(dwg_s, kF3, p, c * kF + col, dw0 * gt, dw1 * gt);
          v[16 * mb + 8 * h + 2 * nb] = gt * w0 * s.x;
          v[16 * mb + 8 * h + 2 * nb + 1] = gt * w1 * s.y;
        }
      }
    rs_lanes<2>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[c][q] += v[q];
    if (c == 2) {  // dmu_c[j] = sum_i gate wm xm_j gmu_c[i]
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jl = 4 * wm + 2 * mb + h;
            const float gt = pr[kPairs + g * kTile + jl];
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              const int col = 32 * wn + 8 * nb + 2 * t;
              const float2 xv = ld2(xj_s + jl * kS3 + 2 * kF + col);
              const float2 gm = ld2(gmu_t + g * kS3 + cc * kF + col);
              v[16 * mb + 8 * h + 2 * nb] = gt * acc[mb][nb][2 * h] * xv.x * gm.x;
              v[16 * mb + 8 * h + 2 * nb + 1] = gt * acc[mb][nb][2 * h + 1] * xv.y * gm.y;
            }
          }
        rs_lanes<2>(v);
#pragma unroll
        for (int q = 0; q < 4; ++q) dma[cc][q] += v[q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = 32 * wm + 16 * (q >> 1) + 8 * (q & 1) + g;
    const float sg = quad_sum(pgv[q]);
    if (t == 0) pg_p[wn * kPairs + p] = sg;
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float sd = quad_sum(pdv[cc][q]);
      if (t == 0) pd_p[(wn * 3 + cc) * kPairs + p] = sd;
    }
  }
}

// The elementwise part of one tile in SYM mode: warp w owns all 64 pairs
// (p = 16 mb + 8 h + g: jl = 2 mb + h, il = g) and features 16*w + 8*nb +
// 2*t (+1) of each chunk. As tile_plain, plus on a mirror tile (pi < pj)
// the mirror cells: their filter cotangent added to dwg, their ddir
// subtracted, and their dx/dmu sums over j (rows i, complete in this
// lane's registers) added to dx_g / dmu_g, this lane's row i of dx and dmu,
// with atomics. xi_g / mui_g: this lane's row i of x and mu (global). The
// item's own sums (rows j) go to dxa / dma: after rs_lanes lane (g, t)
// holds row jl = g, features 16*w + 8*(q >> 1) + 2*t + (q & 1).
__device__ __forceinline__ void tile_sym(const float* pr, const float* gq_t,
                                         const float* gmu_t, const float* xj_s,
                                         const float* muj_s, const float* gqj_s,
                                         const float* gmuj_s, const float* phi_s,
                                         const float* Wk_s, float* dwg_s, float* pg_p,
                                         float* pd_p, int R, bool mirror,
                                         const float* __restrict__ xi_g,
                                         const float* __restrict__ mui_g, float* dx_g,
                                         float* dmu_g, float dxa[3][4], float dma[3][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float pgv[8];  // dgate partials of this lane's pairs jl = 0..7
#pragma unroll
  for (int q = 0; q < 8; ++q) pgv[q] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc[4][2][4];
    if (R < 24)
      filter_chunk_sym<24>(acc, phi_s, Wk_s, warp, c);
    else
      filter_chunk_sym<kRP>(acc, phi_s, Wk_s, warp, c);
    // mirror: this lane's row i of x (this chunk) and, for chunk 2, of mu
    float2 xi[2], mui[3][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int col = 16 * warp + 8 * nb + 2 * t;
      xi[nb] = mirror ? __ldg(reinterpret_cast<const float2*>(xi_g + c * kF + col))
                      : make_float2(0.f, 0.f);
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        mui[cc][nb] = mirror && c == 2
                          ? __ldg(reinterpret_cast<const float2*>(mui_g + cc * kF + col))
                          : make_float2(0.f, 0.f);
    }
    // the mirror's sums over j: Q (c = 0) or U (c = 1) in ms[0], T_cc in ms[cc]
    float2 ms[3][2];
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) ms[cc][nb] = make_float2(0.f, 0.f);
    float pdv[3][8];  // c = 1: ddir partials of this lane's pairs
#pragma unroll
    for (int q = 0; q < 8; ++q) pdv[0][q] = pdv[1][q] = pdv[2][q] = 0.f;
    float v[32];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jl = 2 * mb + h, p = 8 * jl + g, at = g * kTile + jl;
        const float gt = pr[kPairs + at];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int col = 16 * warp + 8 * nb + 2 * t;
          const float w0 = acc[mb][nb][2 * h], w1 = acc[mb][nb][2 * h + 1];
          const float2 xv = ld2(xj_s + jl * kS3 + c * kF + col);
          float2 s, sb = make_float2(0.f, 0.f);
          if (c == 0) {
            s = ld2(gq_t + g * kS1 + col);
            if (mirror) sb = ld2(gqj_s + jl * kS1 + col);
          } else {
            s = make_float2(0.f, 0.f);
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              const float2 gm = ld2(gmu_t + g * kS3 + cc * kF + col);
              const float2 gj =
                  mirror ? ld2(gmuj_s + jl * kS3 + cc * kF + col) : make_float2(0.f, 0.f);
              if (c == 1) {
                const float dc = pr[(2 + cc) * kPairs + at];
                s.x = fmaf(dc, gm.x, s.x);
                s.y = fmaf(dc, gm.y, s.y);
                pdv[cc][jl] += gt * fmaf(w0 * xv.x, gm.x, w1 * xv.y * gm.y);
                if (mirror) {  // DB, and the mirror's ddir (placed antisymmetric)
                  sb.x = fmaf(-dc, gj.x, sb.x);
                  sb.y = fmaf(-dc, gj.y, sb.y);
                  pdv[cc][jl] -= gt * fmaf(w0 * xi[nb].x, gj.x, w1 * xi[nb].y * gj.y);
                }
              } else {
                const float2 mj = ld2(muj_s + jl * kS3 + cc * kF + col);
                s.x = fmaf(mj.x, gm.x, s.x);
                s.y = fmaf(mj.y, gm.y, s.y);
                if (mirror) {  // MB, and T_cc
                  sb.x = fmaf(mui[cc][nb].x, gj.x, sb.x);
                  sb.y = fmaf(mui[cc][nb].y, gj.y, sb.y);
                  ms[cc][nb].x = fmaf(gt * w0, gj.x, ms[cc][nb].x);
                  ms[cc][nb].y = fmaf(gt * w1, gj.y, ms[cc][nb].y);
                }
              }
            }
          }
          float dw0 = s.x * xv.x, dw1 = s.y * xv.y;
          if (mirror) {
            dw0 = fmaf(sb.x, xi[nb].x, dw0);
            dw1 = fmaf(sb.y, xi[nb].y, dw1);
            if (c < 2) {  // Q or U
              ms[0][nb].x = fmaf(gt * w0, sb.x, ms[0][nb].x);
              ms[0][nb].y = fmaf(gt * w1, sb.y, ms[0][nb].y);
            }
          }
          pgv[jl] += fmaf(w0, dw0, w1 * dw1);
          store2(dwg_s, kF3, p, c * kF + col, dw0 * gt, dw1 * gt);
          v[8 * mb + 4 * h + 2 * nb] = gt * w0 * s.x;
          v[8 * mb + 4 * h + 2 * nb + 1] = gt * w1 * s.y;
        }
      }
    rs_lanes<2>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[c][q] += v[q];
    if (c == 1) {
#pragma unroll
      for (int jl = 0; jl < 8; ++jl)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float sd = quad_sum(pdv[cc][jl]);
          if (t == 0) pd_p[(warp * 3 + cc) * kPairs + 8 * jl + g] = sd;
        }
    }
    if (c == 2) {  // dmu_c[j] = sum_i gate wm xm_j gmu_c[i]
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
#pragma unroll
        for (int mb = 0; mb < 4; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jl = 2 * mb + h;
            const float gt = pr[kPairs + g * kTile + jl];
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              const int col = 16 * warp + 8 * nb + 2 * t;
              const float2 xv = ld2(xj_s + jl * kS3 + 2 * kF + col);
              const float2 gm = ld2(gmu_t + g * kS3 + cc * kF + col);
              v[8 * mb + 4 * h + 2 * nb] = gt * acc[mb][nb][2 * h] * xv.x * gm.x;
              v[8 * mb + 4 * h + 2 * nb + 1] = gt * acc[mb][nb][2 * h + 1] * xv.y * gm.y;
            }
          }
        rs_lanes<2>(v);
#pragma unroll
        for (int q = 0; q < 4; ++q) dma[cc][q] += v[q];
      }
    }
    if (mirror) {  // this lane's row i: dx chunk c and, after chunk 2, dmu
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int col = 16 * warp + 8 * nb + 2 * t;
        if (c < 2) {
          atomic_add2(dx_g + c * kF + col, ms[0][nb].x, ms[0][nb].y);
        } else {
          float2 d = make_float2(0.f, 0.f);
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            d.x = fmaf(mui[cc][nb].x, ms[cc][nb].x, d.x);
            d.y = fmaf(mui[cc][nb].y, ms[cc][nb].y, d.y);
            atomic_add2(dmu_g + cc * kF + col, xi[nb].x * ms[cc][nb].x,
                        xi[nb].y * ms[cc][nb].y);
          }
          atomic_add2(dx_g + 2 * kF + col, d.x, d.y);
        }
      }
    }
  }
#pragma unroll
  for (int jl = 0; jl < 8; ++jl) {
    const float sg = quad_sum(pgv[jl]);
    if (t == 0) pg_p[warp * kPairs + 8 * jl + g] = sg;
  }
}

template <bool SYM>
__global__ void __launch_bounds__(kThreads, 1)
painn_bwd_mma_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                     const float* __restrict__ dirx, const float* __restrict__ diry,
                     const float* __restrict__ dirz, const float* __restrict__ x,
                     const float* __restrict__ mu, const float* __restrict__ wk,
                     const float* __restrict__ bk, const float* __restrict__ gq,
                     const float* __restrict__ gmu, float* __restrict__ dx,
                     float* __restrict__ dmu, float* __restrict__ ddist,
                     float* __restrict__ dgate, float* __restrict__ ddx,
                     float* __restrict__ ddy, float* __restrict__ ddz,
                     const int* __restrict__ occ, const int* __restrict__ pre,
                     float* __restrict__ part, int B, int ni, int nj, int R, float delta,
                     float coeff) {
  using L = BwdSmem<SYM>;
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem + L::Wk;
  float* phi_s = smem + L::Phi;
  float* dwg_s = smem + L::Dwg;
  const float* xj_s = smem + L::Xj;
  const float* muj_s = smem + L::Muj;
  float* pg_p = smem + L::Pg;
  float* pd_p = smem + L::Pd;
  float* dd_p = smem + L::Dd;
  int* misc = reinterpret_cast<int*>(smem + L::Floats);  // [0] it0 [1] it1 [2] tiles
  int* tl_s = misc + 4;                                  // the item's computed i tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * ntj;
  const float* grids[5] = {dist, gate, dirx, diry, dirz};
  float* pair_out[4] = {dgate, ddx, ddy, ddz};

  for (int idx = tid; idx < kRP * kF3; idx += kThreads) {
    const int r = idx / kF3, c = idx % kF3;
    Wk_s[swz_at(kF3, r, c)] = r < R ? wk[idx] : (r == R ? bk[c] : 0.f);
  }
  for (int idx = tid; idx < (kRP - R) * kPairs; idx += kThreads) {
    const int r = R + idx / kPairs, p = idx % kPairs;
    phi_s[swz_at(kPairs, r, p)] = r == R ? 1.f : 0.f;
  }
  if (tid == 0) {
    misc[0] = first_item(pre, n_items, gridDim.x, blockIdx.x);
    misc[1] = first_item(pre, n_items, gridDim.x, blockIdx.x + 1);
  }
  __syncthreads();
  const int it0 = misc[0], it1 = misc[1];

  // this block's share of [dWk; dbk] over all its tiles: rows 16*(warp & 1)..,
  // columns 96*(warp >> 1) + 32 q..
  float aw[3][1][4][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int k = 0; k < 4; ++k) aw[q][0][nb][k] = 0.f;

  for (int item = it0; item < it1; ++item) {
    const int b = item / ntj, pj = item - b * ntj, j0 = pj * kTile;
    __syncthreads();  // the previous item is done with tl_s and its rows
    if (warp == 0) {
      const int n = item_tiles(occ + (size_t)item * nti, SYM ? pj + 1 : nti, tl_s);
      if (lane == 0) misc[2] = n;
    }
    __syncthreads();
    const int n_t = misc[2];
    if (n_t > 0) {  // the item's x and mu rows (SYM: and its gq and gmu rows)
      for (int c = tid; c < (SYM ? 3 : 2) * kTile * kF3 / 4; c += kThreads) {
        const int side = c / (kTile * kF3 / 4), cc = c % (kTile * kF3 / 4);
        const int r = cc / (kF3 / 4), f = (cc % (kF3 / 4)) * 4, j = j0 + r;
        const int dst = side == 0 ? L::Xj : (side == 1 ? L::Muj : L::Gmuj);
        const float* src = side == 0 ? x : (side == 1 ? mu : gmu);
        cp_async16(smem + dst + r * kS3 + f,
                   src + (j < nj ? ((size_t)b * nj + j) * kF3 + f : 0), j < nj);
      }
      if (SYM)
        for (int c = tid; c < kTile * kF / 4; c += kThreads) {
          const int r = c / (kF / 4), f = (c % (kF / 4)) * 4, j = j0 + r;
          cp_async16(smem + L::Gqj + r * kS1 + f,
                     gq + (j < nj ? ((size_t)b * nj + j) * kF + f : 0), j < nj);
        }
      cp_async_commit();
    }

    // issues the cp.async loads of tile pi: the five pair grids into grid
    // buffer buf, then the gq and gmu rows of the i tile in 16-byte pieces
    // into row buffer buf (SYM: the one row buffer)
    auto load_tile = [&](int pi, int buf) {
      const int i0 = pi * kTile, rb = SYM ? 0 : buf;
      for (int idx = tid; idx < 5 * kPairs; idx += kThreads) {
        const int k = idx / kPairs, p = idx % kPairs, i = i0 + (p >> 3), j = j0 + (p & 7);
        const bool in = i < ni && j < nj;
        cp_async4(smem + L::Pr + (buf * 5 + k) * kPairs + p,
                  grids[k] + (in ? ((size_t)b * ni + i) * nj + j : 0), in);
      }
      for (int c = tid; c < kTile * (kF + kF3) / 4; c += kThreads) {
        const bool m = c >= kTile * kF / 4;
        const int cc = m ? c - kTile * kF / 4 : c;
        const int w4 = m ? kF3 / 4 : kF / 4, r = cc / w4, f = (cc % w4) * 4, i = i0 + r;
        if (m)
          cp_async16(smem + L::Gmu + rb * kTile * kS3 + r * kS3 + f,
                     gmu + (i < ni ? ((size_t)b * ni + i) * kF3 + f : 0), i < ni);
        else
          cp_async16(smem + L::Gq + rb * kTile * kS1 + r * kS1 + f,
                     gq + (i < ni ? ((size_t)b * ni + i) * kF + f : 0), i < ni);
      }
      cp_async_commit();
    };

    // dx and dmu of the item's rows j, summed over its tiles (plain: lane
    // (g, t) holds entry e = 4 g + q (q < 4) of its warp: row jl = 4 wm +
    // (e >> 3), feature 32 wn + 8 ((e >> 1) & 3) + 2 t + (e & 1); SYM: see
    // tile_sym)
    float dxa[3][4], dma[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[c][q] = dma[c][q] = 0.f;

    if (n_t > 0) load_tile(tl_s[0], 0);
    for (int k = 0; k < n_t; ++k) {
      const int pi = tl_s[k], buf = k & 1, i0 = pi * kTile;
      if (!SYM && k + 1 < n_t) {
        load_tile(tl_s[k + 1], buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile k's rows (and the item's rows) have landed
      const float* pr = smem + L::Pr + buf * 5 * kPairs;  // [5][il*8 + jl]
      const float* gq_t = smem + L::Gq + (SYM ? 0 : buf) * kTile * kS1;
      const float* gmu_t = smem + L::Gmu + (SYM ? 0 : buf) * kTile * kS3;

      // phi^T of the tile's 64 pairs (pair p = jl*8 + il)
      for (int idx = tid; idx < R * kPairs; idx += kThreads) {
        const int r = idx / kPairs, p = idx % kPairs;
        const float diff = pr[(p & 7) * kTile + (p >> 3)] - delta * (float)r;
        phi_s[swz_at(kPairs, r, p)] = __expf(coeff * diff * diff);
      }
      __syncthreads();

      if (SYM) {
        // a mirror tile lies above the diagonal, so all its i rows are < ni
        const size_t row_i = ((size_t)b * nj + i0 + g) * kF3;
        tile_sym(pr, gq_t, gmu_t, xj_s, muj_s, smem + L::Gqj, smem + L::Gmuj, phi_s, Wk_s,
                 dwg_s, pg_p, pd_p, R, pi != pj, x + row_i, mu + row_i, dx + row_i,
                 dmu + row_i, dxa, dma);
      } else {
        tile_plain(pr, gq_t, gmu_t, xj_s, muj_s, phi_s, Wk_s, dwg_s, pg_p, pd_p, R, dxa, dma);
      }
      __syncthreads();  // dwg_s and the dgate/ddir partials complete
      if (SYM && k + 1 < n_t) load_tile(tl_s[k + 1], buf ^ 1);  // the row buffer is free

      if (tid < kPairs) {  // pair p = jl*8 + il, column warps summed in order
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        if (i < ni && j < nj) {
          const size_t off = ((size_t)b * ni + i) * nj + j;
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2) {
            const float* src = k2 == 0 ? pg_p : pd_p + (k2 - 1) * kPairs;
            const int st = k2 == 0 ? kPairs : 3 * kPairs;
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < L::kColWarps; ++w) s += src[w * st + tid];
            pair_out[k2][off] = s;
          }
        }
      }

      // ddist = sum_r (dwg Wk^T)[r] phi_r 2 coeff (d - delta r), linear in
      // dwg: warp w owns pairs 16*(w & 3).., all 32 r, and half the 3F
      // columns of the product (192*(w >> 2)..), so that four
      // accumulators per warp hide the mma latency; the two halves' ddist
      // partials are summed in order below
      {
        float ar[1][4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) ar[0][nb][q] = 0.f;
        const int kh = (warp >> 2) * (kF3 / 2);
        warp_tile_mma<1, 4, kF3 / 2, false, true>(ar, dwg_s + kh, kF3, 16 * (warp & 3),
                                                  Wk_s + kh, kF3, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 16 * (warp & 3) + g + 8 * h;
          const float d = pr[(p & 7) * kTile + (p >> 3)];
          float s = 0.f;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 8 * nb + 2 * t + c;
              if (r < R) {
                const float diff = d - delta * (float)r;
                s = fmaf(ar[0][nb][2 * h + c] * phi_s[swz_at(kPairs, r, p)], 2.f * coeff * diff,
                         s);
              }
            }
          s = quad_sum(s);
          if (t == 0) dd_p[(warp >> 2) * kPairs + p] = s;
        }
      }

      // [dWk; dbk] += [phi; 1] dwg over the tile's 64 pairs, in the precise
      // mode (mma_tf32.cuh): these accumulators run over all of the block's
      // tiles, where the tensor core's truncating additions would drift
#pragma unroll
      for (int q = 0; q < 3; ++q)
        warp_tile_mma<1, 4, kPairs, false, false, false, true>(
            aw[q], phi_s, kPairs, 16 * (warp & 1), dwg_s, kF3, 96 * (warp >> 1) + 32 * q);
      __syncthreads();  // the tile's scratch is free; dd_p complete

      if (tid < kPairs) {
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        if (i < ni && j < nj) ddist[((size_t)b * ni + i) * nj + j] = dd_p[tid] + dd_p[kPairs + tid];
      }
    }

    // the item's dx and dmu rows: plain mode writes them (zero when the
    // item has no computed tile); SYM adds them (mirrors of other items'
    // tiles land there too)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (SYM) {
        const int j = j0 + g, col = 16 * warp + 8 * (q >> 1) + 2 * t;
        if ((q & 1) == 0 && n_t > 0 && j < nj) {
          const size_t row = ((size_t)b * nj + j) * kF3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            atomic_add2(dx + row + c * kF + col, dxa[c][q], dxa[c][q + 1]);
            atomic_add2(dmu + row + c * kF + col, dma[c][q], dma[c][q + 1]);
          }
        }
        continue;
      }
      const int wm = warp & 1, wn = warp >> 1;
      const int e = 4 * g + q, j = j0 + 4 * wm + (e >> 3);
      const int col = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
      if (j < nj) {
        const size_t row = ((size_t)b * nj + j) * kF3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dx[row + c * kF + col] = dxa[c][q];
          dmu[row + c * kF + col] = dma[c][q];
        }
      }
    }
  }

  // this block's partial [dWk; dbk], rows 0..R
  float* out = part + (size_t)blockIdx.x * (R + 1) * kF3;
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp & 1) + g + 8 * h, col = 96 * (warp >> 1) + 32 * q + 8 * nb + 2 * t;
        if (r <= R) {
          out[r * kF3 + col] = aw[q][0][nb][2 * h];
          out[r * kF3 + col + 1] = aw[q][0][nb][2 * h + 1];
        }
      }
}

static size_t smem_bytes(int ni, int symmetric) {
  const size_t ints = sizeof(int) * (4 + (size_t)((ni + kTile - 1) / kTile));
  return sizeof(float) * (size_t)(symmetric ? BwdSmem<true>::Floats : BwdSmem<false>::Floats) +
         ints;
}

template <bool SYM>
static cudaError_t launch(const float* dist, const float* gate, const float* dirx,
                          const float* diry, const float* dirz, const float* x,
                          const float* mu, const float* wk, const float* bk, const float* gq,
                          const float* gmu, float* dx, float* dmu_in, float* ddist,
                          float* dgate, float* ddx, float* ddy, float* ddz, float* part,
                          int* ws, int blocks, int B, int ni, int nj, int R, float delta,
                          float coeff, int sparse, cudaStream_t s) {
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const size_t items = (size_t)B * ntj;
  ZeroGrids zero = {{ddist, dgate, ddx, ddy, ddz}, 5};
  cudaError_t err = make_worklist<SYM, false>(gate, ws, zero, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(ni, SYM);
  err = cudaFuncSetAttribute(painn_bwd_mma_kernel<SYM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  painn_bwd_mma_kernel<SYM><<<blocks, kThreads, smem, s>>>(
      dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in, ddist, dgate, ddx, ddy,
      ddz, ws, ws + items * nti + items, part, B, ni, nj, R, delta, coeff);
  return cudaGetLastError();
}

}  // namespace geossl

extern "C" size_t painn_bwd_smem_bytes(int ni, int symmetric) {
  return geossl::smem_bytes(ni, symmetric);
}

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int painn_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Ints of the workspace (both modes): tile flags [B*ntj*nti], item counts
// [B*ntj] and their prefix sums [B*ntj + 1].
extern "C" size_t painn_bwd_ws_ints(int B, int ni, int nj) {
  return geossl::worklist_ints((size_t)B * ((nj + geossl::kTile - 1) / geossl::kTile),
                               (ni + geossl::kTile - 1) / geossl::kTile);
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// painn_bwd_blocks(B, nj) rows of (R+1)*3F floats; `wgrad` (one such row)
// receives dWk [R,3F] and then dbk [3F]; `ws` holds painn_bwd_ws_ints(B, ni,
// nj) ints. F must be 128 and 2 <= R <= 31. With `symmetric` (square grid
// only) the five pair cotangents are placed as the header says and dx and
// dmu_in must be zero on entry.
extern "C" int painn_bwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk,
                         const float* gq, const float* gmu, float* dx, float* dmu_in,
                         float* ddist, float* dgate, float* ddx, float* ddy, float* ddz,
                         float* part, float* wgrad, int* ws, int B, int ni, int nj, int F,
                         int R, float delta, float coeff, int symmetric, int sparse,
                         void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > 31 || (symmetric && ni != nj))
    return (int)cudaErrorInvalidValue;
  const int blocks = painn_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      symmetric ? launch<true>(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in,
                               ddist, dgate, ddx, ddy, ddz, part, ws, blocks, B, ni, nj, R,
                               delta, coeff, sparse, s)
                : launch<false>(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx,
                                dmu_in, ddist, dgate, ddx, ddy, ddz, part, ws, blocks, B, ni,
                                nj, R, delta, coeff, sparse, s);
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, (R + 1) * kF3, wgrad, s);
  return (int)cudaGetLastError();
}
