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
// Plain mode (painn_bwd_mma_kernel). Bound on the H100: operations. Per
// occupied pair: the filter recomputed (2*R*3F), dWk and dbk
// (2*(R+1)*3F), dphi (2*R*3F) and ~40F elementwise: ~52k FLOP at R=20,
// F=128, against ~40 bytes of pair grids read and written. The three
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
// Work split (plain mode). An occupancy pass and a scan (worklist.cuh) make
// a work list on the device, with no host sync: items are (graph, 8-column
// j tile) with their computed i tiles (with `sparse`, 8x8 tiles whose gate
// is all zero are skipped and their five pair cotangents written as zero:
// the occupancy contract of geossl_tpu/ops/pallas_utils.py, exact
// downstream, since the gate has value and slope zero there and every
// other pair cotangent carries a gate factor). A persistent grid (one block
// of 8 warps per SM, 255 registers a thread: the block's shared memory is
// ~217 KB) splits the items into contiguous runs of equal work by the
// prefix sums; items are never split, so dx and dmu rows are written by one
// block, from registers. For each item the block stages its x and mu rows;
// then it walks the item's computed i tiles with the next tile's pair grids
// and gq/gmu rows in flight (cp.async, double buffer) while the current
// tile's products run. dWk and dbk stay in the warps' mma accumulators over
// all of a block's tiles; each block writes one partial row of (R+1)*3F
// floats and a last launch sums them in block order (reduce.cuh). No
// atomics: every output is bitwise the same from run to run on one card.
//
// SYM (symmetric dist/gate, antisymmetric directions, square grid;
// painn_bwd_sym_kernel, plain f32 FMAs on the CUDA cores), the scheme of
// cfconv_bwd.cu's SYM mode: tile (pi, pj) is computed iff
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
// order: they repeat bitwise. A block of 256 threads owns 4 pairs x 8
// features per thread (painn_tile.cuh); the persistent grid walks the
// (graph, j tile) items round-robin; shared memory holds Wk, the RBF, the
// staged dwg tile, the gq/gmu rows of the j tile, the x rows of the i tile
// and the five mirror tiles (227 KB at R=20; mu of the i rows is read from
// global memory).
#include "mma_tf32.cuh"
#include "painn_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

constexpr int kWS3 = kF3 + 4;  // SYM: padded row stride of Wk_s and dwg_s

// -- plain mode: tensor-core products ------------------------------------------

constexpr int kRP = 32;       // rows of Wk_s and phiT_s: R filter rows, the bias row, zeros
constexpr int kS3 = kF3 + 8;  // row stride of the 8-row node tiles, 3F wide (bank spread)
constexpr int kS1 = kF + 8;   // the same, F wide
// shared memory of the plain-mode kernel, in floats
constexpr int kOffWk = 0;                          // [kRP][kF3] swizzled: Wk, bk at row R
constexpr int kOffPhi = kOffWk + kRP * kF3;        // [kRP][kPairs] swizzled: phi^T, row R = 1
constexpr int kOffDwg = kOffPhi + kRP * kPairs;    // [kPairs][kF3] swizzled: dwg
constexpr int kOffXj = kOffDwg + kPairs * kF3;     // [8][kS3] x rows of the item
constexpr int kOffMuj = kOffXj + kTile * kS3;      // [8][kS3] mu rows of the item
constexpr int kOffGq = kOffMuj + kTile * kS3;      // [2][8][kS1] gq rows of the i tile
constexpr int kOffGmu = kOffGq + 2 * kTile * kS1;  // [2][8][kS3] gmu rows of the i tile
constexpr int kOffPr = kOffGmu + 2 * kTile * kS3;  // [2][5][64] dist, gate, dir x/y/z, [il][jl]
constexpr int kOffPg = kOffPr + 2 * 5 * kPairs;    // [4][64] dgate partials
constexpr int kOffPd = kOffPg + 4 * kPairs;        // [4][3][64] ddir partials
constexpr int kOffDd = kOffPd + 12 * kPairs;       // [2][64] ddist partials
constexpr int kMmaFloats = kOffDd + 2 * kPairs;    // then ints: misc[4], tile list [nti]

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
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem + kOffWk;
  float* phi_s = smem + kOffPhi;
  float* dwg_s = smem + kOffDwg;
  const float* xj_s = smem + kOffXj;
  const float* muj_s = smem + kOffMuj;
  float* pg_p = smem + kOffPg;
  float* pd_p = smem + kOffPd;
  float* dd_p = smem + kOffDd;
  int* misc = reinterpret_cast<int*>(smem + kMmaFloats);  // [0] it0 [1] it1 [2] tiles
  int* tl_s = misc + 4;                                   // the item's computed i tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the filter chunks: warp (wm, wn) owns pairs 32*wm.. and features 32*wn..
  const int wm = warp & 1, wn = warp >> 1;
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
    __syncthreads();  // the previous item is done with tl_s, xj_s and muj_s
    if (warp == 0) {
      const int n = item_tiles(occ + (size_t)item * nti, nti, tl_s);
      if (lane == 0) misc[2] = n;
    }
    __syncthreads();
    const int n_t = misc[2];
    if (n_t > 0) {  // the item's x and mu rows
      for (int c = tid; c < 2 * kTile * kF3 / 4; c += kThreads) {
        const bool m = c >= kTile * kF3 / 4;
        const int cc = m ? c - kTile * kF3 / 4 : c, r = cc / (kF3 / 4), f = (cc % (kF3 / 4)) * 4;
        const int j = j0 + r;
        cp_async16(smem + (m ? kOffMuj : kOffXj) + r * kS3 + f,
                   (m ? mu : x) + (j < nj ? ((size_t)b * nj + j) * kF3 + f : 0), j < nj);
      }
      cp_async_commit();
    }

    // issues the cp.async loads of tile pi into buffer buf: the five pair
    // grids, then the gq and gmu rows of the i tile in 16-byte pieces
    auto load_tile = [&](int pi, int buf) {
      const int i0 = pi * kTile;
      for (int idx = tid; idx < 5 * kPairs; idx += kThreads) {
        const int k = idx / kPairs, p = idx % kPairs, i = i0 + (p >> 3), j = j0 + (p & 7);
        const bool in = i < ni && j < nj;
        cp_async4(smem + kOffPr + (buf * 5 + k) * kPairs + p,
                  grids[k] + (in ? ((size_t)b * ni + i) * nj + j : 0), in);
      }
      for (int c = tid; c < kTile * (kF + kF3) / 4; c += kThreads) {
        const bool m = c >= kTile * kF / 4;
        const int cc = m ? c - kTile * kF / 4 : c;
        const int w4 = m ? kF3 / 4 : kF / 4, r = cc / w4, f = (cc % w4) * 4, i = i0 + r;
        if (m)
          cp_async16(smem + kOffGmu + buf * kTile * kS3 + r * kS3 + f,
                     gmu + (i < ni ? ((size_t)b * ni + i) * kF3 + f : 0), i < ni);
        else
          cp_async16(smem + kOffGq + buf * kTile * kS1 + r * kS1 + f,
                     gq + (i < ni ? ((size_t)b * ni + i) * kF + f : 0), i < ni);
      }
      cp_async_commit();
    };

    // dx and dmu of the item's rows: after rs_lanes, lane (g, t) holds entry
    // e = 4 g + q (q < 4) of its warp: row jl = 4 wm + (e >> 3), feature
    // 32 wn + 8 ((e >> 1) & 3) + 2 t + (e & 1)
    float dxa[3][4], dma[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[c][q] = dma[c][q] = 0.f;

    if (n_t > 0) load_tile(tl_s[0], 0);
    for (int k = 0; k < n_t; ++k) {
      const int pi = tl_s[k], buf = k & 1, i0 = pi * kTile;
      if (k + 1 < n_t) {
        load_tile(tl_s[k + 1], buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile k's rows (and the item's x, mu rows) have landed
      const float* pr = smem + kOffPr + buf * 5 * kPairs;  // [5][il*8 + jl]
      const float* gq_t = smem + kOffGq + buf * kTile * kS1;
      const float* gmu_t = smem + kOffGmu + buf * kTile * kS3;

      // phi^T of the tile's 64 pairs (pair p = jl*8 + il)
      for (int idx = tid; idx < R * kPairs; idx += kThreads) {
        const int r = idx / kPairs, p = idx % kPairs;
        const float diff = pr[(p & 7) * kTile + (p >> 3)] - delta * (float)r;
        phi_s[swz_at(kPairs, r, p)] = __expf(coeff * diff * diff);
      }
      __syncthreads();

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
      __syncthreads();  // dwg_s and the dgate/ddir partials complete

      if (tid < kPairs) {  // pair p = jl*8 + il, column warps summed in order
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        if (i < ni && j < nj) {
          const size_t off = ((size_t)b * ni + i) * nj + j;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float* src = k == 0 ? pg_p : pd_p + (k - 1) * kPairs;
            const int st = k == 0 ? kPairs : 3 * kPairs;
            pair_out[k][off] = src[tid] + src[st + tid] + src[2 * st + tid] + src[3 * st + tid];
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

    // the item's dx and dmu rows (zero when it has no computed tile)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
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

// -- symmetric mode: f32 FMAs on the CUDA cores ----------------------------------

__global__ void __launch_bounds__(kThreads, 1)
painn_bwd_sym_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
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
  float* xi_s = pr_s + 5 * kPairs;         // [kTile][kF3]  x rows of the i tile
  float* gqj_s = xi_s + kTile * kF3;       // [kTile][kF]   gq rows of the j tile
  float* gmuj_s = gqj_s + kTile * kF;      // [kTile][kF3]  gmu rows of the j tile
  float* acc_s = gmuj_s + kTile * kF3;     // [5][kTile][kF] Q, U, T_0..2 of the i rows
  int* occ_s = (int*)(acc_s + 5 * kTile * kF);  // [nti]

  const int tid = threadIdx.x;
  const int fg = tid & (kFG - 1), hw = tid >> 4;
  const int jl = tid >> 5, il0 = (hw & 1) * kPPT;  // this thread's j and first i
  const int p0 = jl * kTile + il0;
  const int ntj = (nj + kTile - 1) / kTile;

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
    // by descending pj (item length pj + 1), graphs interleaved
    const int b = item % B;
    const int pj = ntj - 1 - item / B;
    const int j0 = pj * kTile;
    // i tiles 0..pj are computed; rows from i_end on lie below the band
    const int n_it = pj + 1;
    const int i_end = min(ni, n_it * kTile);
    const size_t grid_off = (size_t)b * ni * nj;
    const float* gate_b = gate + grid_off;
    const float* gq_b = gq + (size_t)b * ni * kF;
    const float* gmu_b = gmu + (size_t)b * ni * kF3;

    {  // the skipped tiles below the band hold zero
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
      gmuj_s[idx] = j < nj ? gmu_b[(size_t)j * kF3 + idx % kF3] : 0.f;
      if (idx < kTile * kF) {
        const int jj = j0 + idx / kF;
        gqj_s[idx] = jj < nj ? gq_b[(size_t)jj * kF + idx % kF] : 0.f;
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
      const bool mirror = pi != pj;  // block-uniform
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
            if (mirror) {  // mirror: dw += xq_i gq_j, dx[i] += g wq gq_j
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
            if (mirror) {
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
      __syncthreads();  // dwg_s and the mirror tiles complete

      if (mirror) {
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
          if (any_tile) {
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
  const size_t tiles = sizeof(int) * (size_t)((ni + kTile - 1) / kTile);
  if (!symmetric) return sizeof(float) * (size_t)kMmaFloats + sizeof(int) * 4 + tiles;
  return sizeof(float) * ((size_t)R * kWS3 + (size_t)(R + 1) * kPhiS + kPairs * kWS3 +
                          2 * kTile * kF3 + kTile * kF + kTile * kF3 + 5 * kPairs +
                          2 * kTile * kF3 + kTile * kF + 5 * kTile * kF) +
         tiles;
}

}  // namespace geossl

extern "C" size_t painn_bwd_smem_bytes(int R, int ni, int symmetric) {
  return geossl::smem_bytes(R, ni, symmetric);
}

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int painn_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Ints of the plain mode's workspace: tile flags [B*ntj*nti], item counts
// [B*ntj] and their prefix sums [B*ntj + 1].
extern "C" size_t painn_bwd_ws_ints(int B, int ni, int nj) {
  return geossl::worklist_ints((size_t)B * ((nj + geossl::kTile - 1) / geossl::kTile),
                               (ni + geossl::kTile - 1) / geossl::kTile);
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// painn_bwd_blocks(B, nj) rows of (R+1)*3F floats; `wgrad` (one such row)
// receives dWk [R,3F] and then dbk [3F]; `ws` holds painn_bwd_ws_ints(B, ni,
// nj) ints (plain mode). F must be 128 and 2 <= R <= 31. With `symmetric`
// (square grid only) the five pair cotangents are placed as the header says
// and dx and dmu_in must be zero on entry.
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
  const size_t smem = smem_bytes(R, ni, symmetric);
  const int blocks = painn_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  if (symmetric) {
    cudaFuncSetAttribute(painn_bwd_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    painn_bwd_sym_kernel<<<blocks, kThreads, smem, s>>>(
        dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in, ddist, dgate, ddx,
        ddy, ddz, part, B, ni, nj, R, delta, coeff, sparse);
  } else {
    const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
    const size_t items = (size_t)B * ntj;
    ZeroGrids zero = {{ddist, dgate, ddx, ddy, ddz}, 5};
    cudaError_t err = make_worklist<false, false>(gate, ws, zero, B, ni, nj, sparse, s);
    if (err != cudaSuccess) return (int)err;
    cudaFuncSetAttribute(painn_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    painn_bwd_mma_kernel<<<blocks, kThreads, smem, s>>>(
        dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in, ddist, dgate, ddx,
        ddy, ddz, ws, ws + items * nti + items, part, B, ni, nj, R, delta, coeff);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, (R + 1) * kF3, wgrad, s);
  return (int)cudaGetLastError();
}
