// PaiNN's gated filter and forward message sums on the tensor cores, over a
// block's run of whole items of a device tile list: both modes of
// painn_fwd.cu (painn_fwd_mma_kernel<KS, SYM>) and the message phase of each
// interaction block of painn_stack.cu. painn_fwd.cu's header describes the
// design: operands in mma fragment order ([Wk; bk] split once per call, the
// gated A rows [phi; 1] gate once per tile), the filter in 3xTF32's plain
// split, the three message sums on the CUDA cores with each row summed in
// registers over its item and written once, grids two tiles and x/mu rows
// one tile ahead (cp.async), one barrier per tile.
//
// painn_fwd_items takes a block of kFwdThreads threads (16 warps, at most 128
// registers each) and kFwdFloats floats of shared memory at `smem`
// (kFwdSymFloats with SYM); x and mu are read with cp.async.cg (through L2),
// so a persistent kernel may call it on buffers that other blocks wrote
// before a grid barrier.
#pragma once

#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

constexpr int kRP = 32;       // K of the filter product at most: R RBF rows, the bias row, zeros
constexpr int kS3 = kF3 + 8;  // row stride of the 8-row x/mu tiles (bank spread)

// -- the filter's operands in mma fragment order --------------------------------
//
// For a block of kFwdThreads threads, 16 warps (wm, wn) = (warp & 1,
// warp >> 1): pairs 32*wm.. and features 16*wn.. of a chunk. The warp's 16
// columns are permuted so that lane (g, t) holds pairs (jl = 4*wm + 2*mb +
// h, il = g) and the four consecutive features 16*wn + 4*t + 2*nb + c (mb,
// nb, h, c < 2): C column 8*nb + j (j < 8) of the warp's mma is feature
// 16*wn + fwd_col(8*nb + j), so that a lane reads x and mu, and writes its
// rows, 16 bytes at a time.
//
// B = [Wk; bk; 0]: WkF [3 chunks][16 groups of 8 columns][kKS k steps][32
// lanes] float4 {b0 hi, b1 hi, b0 lo, b1 lo}, b0 = B[8 ks + t][128 c + 16
// (grp / 2) + fwd_col(8 (grp % 2) + g)], b1 four rows below (mma.m16n8k8's
// B fragment), split once per block. A = [phi; 1] gate of a tile (the
// gate folded in, so that the product is the gated filter): a buffer holds
// the high parts [4 blocks of 16 pairs][kKS][32 lanes] float4 {a0, a1, a2,
// a3}, then the low parts in the same order, with a0 = A[16 blk + g][8 ks +
// t], a1 eight rows below, a2 and a3 four columns right of them (the A
// fragment). Both parts are split once, so that a warp loads a k step's
// fragments with 128-bit loads and splits nothing in its loop.

constexpr int kFwdThreads = 512;

// The feature (within the warp's 16) of C column n = 8*nb + j.
__host__ __device__ constexpr int fwd_col(int n) {
  return 4 * ((n & 7) >> 1) + 2 * (n >> 3) + (n & 1);
}
constexpr int kKS = kRP / 8;                 // k steps, at most
constexpr int kWkFFloats = 3 * 16 * kKS * 32 * 4;
constexpr int kPhiFLo = 4 * kKS * 32 * 4;    // the low parts' offset in a phi buffer
constexpr int kPhiFFloats = 2 * kPhiFLo;

// Stages WkF (split_b: both parts rounded). Every thread of the block calls it.
__device__ __forceinline__ void painn_stage_wkf(float* WkF, const float* __restrict__ wk,
                                                const float* __restrict__ bk, int R) {
  for (int e = threadIdx.x; e < kWkFFloats / 4; e += kFwdThreads) {
    const int lane = e & 31, ks = (e >> 5) % kKS, cg = (e >> 5) / kKS;  // cg = 16 c + grp
    const int k0 = 8 * ks + (lane & 3);
    const int n = 16 * (cg >> 1) + fwd_col(8 * (cg & 1) + (lane >> 2));
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + 4 * u;
      v[u] = k < R ? wk[k * kF3 + n] : (k == R ? bk[n] : 0.f);
    }
    float4 f;
    split_b(v[0], f.x, f.z);
    split_b(v[1], f.y, f.w);
    reinterpret_cast<float4*>(WkF)[e] = f;
  }
}

// The A fragments [phi; 1] gate of a tile into phi buffer phiF, split into
// their TF32 parts (split_tf32: the plain split). d_t and g_t: the tile's
// distances and gates [il][jl]. KS k steps (K = 8 KS >= R+1). Every thread
// of the block calls it.
template <int KS>
__device__ __forceinline__ void painn_phi_frags(const float* d_t, const float* g_t, float* phiF,
                                                int R, float delta, float coeff) {
  for (int e = threadIdx.x; e < 4 * KS * 32; e += kFwdThreads) {
    const int lane = e & 31, ks = (e >> 5) % KS, blk = (e >> 5) / KS;
    const int g = lane >> 2, t = lane & 3;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 16 * blk + g + 8 * (q & 1), r = 8 * ks + t + 4 * (q >> 1);
      const int at = (p & 7) * kTile + (p >> 3);
      const float gp = g_t[at], diff = d_t[at] - delta * (float)r;
      const float v = r < R ? gp * __expf(coeff * diff * diff) : (r == R ? gp : 0.f);
      split_tf32(__float_as_uint(v), hi[q], lo[q]);
    }
    const int at4 = (blk * kKS + ks) * 32 + lane;
    reinterpret_cast<uint4*>(phiF)[at4] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(phiF + kPhiFLo)[at4] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// This warp's A fragments of a tile (its 32 pairs, blocks 2 wm + mb), all KS
// k steps: loaded once, read by the three chunks.
template <int KS>
__device__ __forceinline__ void painn_load_a(const float* phiF, int wm, uint32_t ah[KS][2][4],
                                             uint32_t al[KS][2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int at4 = ((2 * wm + mb) * kKS + ks) * 32 + lane;
      const uint4 h = reinterpret_cast<const uint4*>(phiF)[at4];
      const uint4 l = reinterpret_cast<const uint4*>(phiF + kPhiFLo)[at4];
      ah[ks][mb][0] = h.x, ah[ks][mb][1] = h.y, ah[ks][mb][2] = h.z, ah[ks][mb][3] = h.w;
      al[ks][mb][0] = l.x, al[ks][mb][1] = l.y, al[ks][mb][2] = l.z, al[ks][mb][3] = l.w;
    }
}

// k step ks of chunk c for this warp's 2 x 2 blocks: acc += A B over k =
// 8 ks.., the three passes of 3xTF32 (mma_tf32.cuh).
__device__ __forceinline__ void painn_kstep(float acc[2][2][4], const uint32_t ah[2][4],
                                            const uint32_t al[2][4], const float* WkF, int c,
                                            int wn, int ks) {
  const int lane = threadIdx.x & 31;
  uint32_t bh[2][2], bl[2][2];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    const float4 v = reinterpret_cast<const float4*>(
        WkF)[((16 * c + 2 * wn + nb) * kKS + ks) * 32 + lane];
    bh[nb][0] = __float_as_uint(v.x), bh[nb][1] = __float_as_uint(v.y);
    bl[nb][0] = __float_as_uint(v.z), bl[nb][1] = __float_as_uint(v.w);
  }
  mma_passes<2, 2>(acc, ah, al, bh, bl);
}

// SYM: the messages of a mirror tile to its j rows, after chunk c = 0 (dq
// from wq = acc[0]) or c = 2 (the three dmu channels from wr = acc[1] and
// wm = acc[0]): for this lane's row il = g of the i tile (xi_s: the item's
// x rows, then its mu rows) and its pairs jl = jw + 2 mb + h, features f =
// 16 wn + 4 t + u, summed over the 8 lanes of one t (rs_lanes) and added
// to rows j = j0 + jl of graph b, two features per lane.
__device__ __forceinline__ void painn_mirror_rows(int c, float acc[2][2][2][4],
                                                  const float* xi_s, const float* pr, float* dq,
                                                  float* dmu, int b, int ni, int nj, int jw,
                                                  int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, f = 16 * wn + 4 * t;
  // after rs_lanes, entries 2 g, 2 g + 1: pair mb = g >> 2, h = (g >> 1) & 1,
  // features f + 2 (g & 1) + (0, 1)
  const int j = jw + 2 * (g >> 2) + ((g >> 1) & 1), fo = f + 2 * (g & 1);
  const float* xrow = xi_s + g * kS3;
  // the filter of pair (mb, h) at features f + u, u = 2*nb + c'
  auto wv = [&](int a, int mb, int h, int u) { return acc[a][mb][u >> 1][2 * h + (u & 1)]; };
  if (c == 0) {
    const float4 xq = ld4(xrow + f);
    const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
    float v[16];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u) v[8 * mb + 4 * h + u] = wv(0, mb, h, u) * xv[u];
    rs_lanes<1>(v);
    if (j < nj) atomic_add2(dq + ((size_t)b * ni + j) * kF + fo, v[0], v[1]);
    return;
  }
  const float4 xr4 = ld4(xrow + kF + f), xm4 = ld4(xrow + 2 * kF + f);
  const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w}, xm[4] = {xm4.x, xm4.y, xm4.z, xm4.w};
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) {
    const float4 m4 = ld4(xrow + kTile * kS3 + cc * kF + f);
    const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
    float v[16];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dc = pr[(2 + cc) * kPairs + g * kTile + (jw & 7) + 2 * mb + h];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[8 * mb + 4 * h + u] = fmaf(wv(0, mb, h, u) * xm[u], mv[u], -(wv(1, mb, h, u) * xr[u]) * dc);
      }
    rs_lanes<1>(v);
    if (j < nj) atomic_add2(dmu + ((size_t)b * ni + j) * kF3 + cc * kF + fo, v[0], v[1]);
  }
}

// shared memory of painn_fwd_items, in floats
constexpr int kFOffWk = 0;                           // WkF (above)
constexpr int kFOffPhi = kFOffWk + kWkFFloats;       // [2] phi buffers, fragment order
constexpr int kFOffX = kFOffPhi + 2 * kPhiFFloats;   // [2][2][8][kS3] x, mu rows of the j tile
constexpr int kFOffPr = kFOffX + 4 * kTile * kS3;    // [3][5][64] dist, gate, dir x/y/z, [il][jl]
constexpr int kFOffRed = kFOffPr + 3 * 5 * kPairs;   // [8][32][16] row sums of the warps wm = 1
constexpr int kFwdFloats = kFOffRed + 8 * 32 * 16;
constexpr int kFOffXi = kFwdFloats;                  // SYM: [2][8][kS3] x, mu rows of the item
constexpr int kFwdSymFloats = kFOffXi + 2 * kTile * kS3;

// Block k runs items [first_item(k), first_item(k + 1)) of the tile list
// (worklist.cuh: items (graph, 8-row i tile), each listing its j tiles), in
// list order, i.e. listed tiles [pre[first], pre[last]), with 16 warps
// (the fragment order above). One barrier per tile: the pair grids
// load two tiles ahead and the x/mu rows one tile ahead (cp.async), and each
// tile's A fragments are made in the previous tile's iteration (double
// buffer, made while the tile's first products run), so that the barrier
// that opens tile k finds them, its rows and the next tile's grids in place.
// A warp loads its A fragments once a tile; the k steps of chunk c + 1 are
// issued between the four message groups of chunk c. KS k steps: K = 8 KS >=
// R + 1.
//
// SYM (painn_fwd.cu's symmetric mode: a tile list of the tiles pi <= pj,
// symmetric dist/gate, antisymmetric directions, square grid): a tile with
// pi < pj also emits the messages of its mirror tile (pj, pi), which has
// the same gated filter and the direction terms negated, to the tile's j
// rows:
//   dq[j]    += sum_i wq xq_i
//   dmu_c[j] += sum_i (wr xr_i (-dir_c[i,j]) + wm xm_i mu_c[i])
// with the item's x and mu rows (the i tile) staged once per item. A lane
// holds il = g, so these sums over i are sums over the 8 lanes of one t
// (rs_lanes), taken once per tile (the q sums after chunk 0, the three
// channels' after chunk 2, whose r filter stays in its accumulators) and
// added to dq/dmu with float2 atomics; the item's own rows are added with
// float4 atomics when it ends. dq and dmu must be zero on entry, and their
// summation order varies from run to run.
template <int KS, bool SYM = false>
__device__ __forceinline__ void painn_fwd_items(
    float* smem, const float* __restrict__ dist, const float* __restrict__ gate,
    const float* __restrict__ dirx, const float* __restrict__ diry,
    const float* __restrict__ dirz, const float* x, const float* mu,
    const float* __restrict__ wk, const float* __restrict__ bk, float* dq, float* dmu,
    const int* __restrict__ pre, const int* __restrict__ list, int B, int ni, int nj, int R,
    float delta, float coeff) {
  const float* WkF = smem + kFOffWk;
  float* red_s = smem + kFOffRed;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * nti;
  const float* grids[5] = {dist, gate, dirx, diry, dirz};

  __shared__ int run_s[2];  // the first listed tiles of this block's run and the next one's

  // warps 0 and 1 find the run; every warp writes zero to the rows of its
  // items with no listed tile (any block may write them: no other block
  // does), one item a warp at a time
  if (warp < 2 && lane == 0)
    run_s[warp] = pre[first_item(pre, n_items, gridDim.x, blockIdx.x + warp)];
  for (int item = blockIdx.x + gridDim.x * warp; item < (SYM ? 0 : n_items);
       item += gridDim.x * (kFwdThreads / 32)) {  // SYM: zero on entry
    if (pre[item] != pre[item + 1]) continue;  // warp-uniform
    const int b = item / nti, i0 = (item - b * nti) * kTile;
    for (int idx = lane; idx < kTile * (kF + kF3) / 4; idx += 32) {
      const bool m = idx >= kTile * kF / 4;
      const int c = m ? idx - kTile * kF / 4 : idx;
      const int w4 = m ? kF3 / 4 : kF / 4, r = c / w4, f = (c % w4) * 4, i = i0 + r;
      if (i < ni)
        *reinterpret_cast<float4*>((m ? dmu : dq) + ((size_t)b * ni + i) * (m ? kF3 : kF) + f) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int t_begin = run_s[0], t_end = run_s[1];
  if (t_begin >= t_end) return;  // block-uniform: no listed tile

  // the cp.async loads of the tile with list entry v: its five pair grids
  // into grid buffer buf, the x and mu rows of its j tile into row buffer
  // buf (16-byte pieces); the caller commits
  auto load_grids = [&](int v, int buf) {
    const int item = v / ntj, pj = v - item * ntj, b = item / nti;
    const int i0 = (item - b * nti) * kTile, j0 = pj * kTile;
    float* dst = smem + kFOffPr + buf * 5 * kPairs;
    for (int idx = tid; idx < 5 * kPairs; idx += kFwdThreads) {
      const int q = idx / kPairs, p = idx % kPairs, i = i0 + (p >> 3), j = j0 + (p & 7);
      const bool in = i < ni && j < nj;
      cp_async4(dst + idx, grids[q] + (in ? ((size_t)b * ni + i) * nj + j : 0), in);
    }
  };
  auto load_rows = [&](int v, int buf) {
    const int item = v / ntj, pj = v - item * ntj, b = item / nti, j0 = pj * kTile;
    float* dst = smem + kFOffX + buf * 2 * kTile * kS3;
    for (int c = tid; c < 2 * kTile * kF3 / 4; c += kFwdThreads) {
      const int side = c / (kTile * kF3 / 4), r = (c / (kF3 / 4)) % kTile;
      const int f = (c % (kF3 / 4)) * 4, j = j0 + r;
      cp_async16(dst + (side * kTile + r) * kS3 + f,
                 (side ? mu : x) + (j < nj ? ((size_t)b * nj + j) * kF3 + f : 0), j < nj);
    }
  };
  // the A fragments of the q-th tile of the run (its grids in buffer q %
  // 3) into phi buffer q & 1
  auto make_phi = [&](int q) {
    const float* pr = smem + kFOffPr + q % 3 * 5 * kPairs;
    painn_phi_frags<KS>(pr, pr + kPairs, smem + kFOffPhi + (q & 1) * kPhiFFloats, R,
                                     delta, coeff);
  };

  // SYM: the x and mu rows of item `it` (its i tile) into the row buffer,
  // zeros past ni; the caller syncs
  auto load_irows = [&](int it) {
    const int b = it / nti, i0 = (it - b * nti) * kTile;
    float* dst = smem + kFOffXi;
    for (int c = tid; c < 2 * kTile * kF3 / 4; c += kFwdThreads) {
      const int side = c / (kTile * kF3 / 4), r = (c / (kF3 / 4)) % kTile;
      const int f = (c % (kF3 / 4)) * 4, i = i0 + r;
      const float4 v = i < ni ? __ldcg(reinterpret_cast<const float4*>(
                                    (side ? mu : x) + ((size_t)b * nj + i) * kF3 + f))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + (side * kTile + r) * kS3 + f) = v;
    }
  };

  // this lane's share of row il = g of the current item, features 16*wn +
  // 4*t + u (u = 2*nb + c) of dq and of each dmu channel, summed over this
  // warp's four jl of every tile of the item
  float aq[4], am[3][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) aq[u] = am[0][u] = am[1][u] = am[2][u] = 0.f;
  // the list entries of tiles k .. k + 2, read a tile ahead of their use
  int v0 = list[t_begin], v1 = t_begin + 1 < t_end ? list[t_begin + 1] : 0;
  int v2 = t_begin + 2 < t_end ? list[t_begin + 2] : 0;
  int cur = v0 / ntj;  // the item whose rows the sums hold
  // writes the rows of item `cur` (warps wm = 1 hand their sums to wm = 0
  // through red_s) and zeroes the sums; every thread calls it
  auto flush = [&]() {
    float* red = red_s + (wn * 32 + lane) * 16;
    __syncthreads();  // the warps wm = 0 are done reading red_s (the previous flush)
    if (wm == 1) {
      st4(red, aq[0], aq[1], aq[2], aq[3]);
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) st4(red + 4 + 4 * cc, am[cc][0], am[cc][1], am[cc][2], am[cc][3]);
    }
    __syncthreads();
    const int b = cur / nti, i = (cur - b * nti) * kTile + g;
    if (wm == 0 && i < ni) {
      const int f = 16 * wn + 4 * t;
      const float4 r = ld4(red);
      float* row_q = dq + ((size_t)b * ni + i) * kF + f;
      if (SYM)  // mirrors of other items' tiles land on these rows too
        atomic_add4(row_q, make_float4(aq[0] + r.x, aq[1] + r.y, aq[2] + r.z, aq[3] + r.w));
      else
        st4(row_q, aq[0] + r.x, aq[1] + r.y, aq[2] + r.z, aq[3] + r.w);
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float4 rm = ld4(red + 4 + 4 * cc);
        float* row_m = dmu + ((size_t)b * ni + i) * kF3 + cc * kF + f;
        if (SYM)
          atomic_add4(row_m, make_float4(am[cc][0] + rm.x, am[cc][1] + rm.y, am[cc][2] + rm.z,
                                         am[cc][3] + rm.w));
        else
          st4(row_m, am[cc][0] + rm.x, am[cc][1] + rm.y, am[cc][2] + rm.z, am[cc][3] + rm.w);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) aq[u] = am[0][u] = am[1][u] = am[2][u] = 0.f;
  };

  // prologue: the grids of the first two tiles and the rows of the first,
  // then the first tile's A fragments
  load_grids(v0, 0);
  if (t_begin + 1 < t_end) load_grids(v1, 1);
  load_rows(v0, 0);
  cp_async_commit();
  if (SYM) load_irows(cur);
  painn_stage_wkf(smem + kFOffWk, wk, bk, R);  // while the first tile's loads fly
  cp_async_wait<0>();
  __syncthreads();
  make_phi(0);
  for (int k = t_begin; k < t_end; ++k) {
    const int item = v0 / ntj, q = k - t_begin;
    const int v3 = k + 3 < t_end ? list[k + 3] : 0;  // used in the next iteration
    cp_async_wait<0>();
    __syncthreads();  // tile k's A fragments and rows, tile k + 1's grids (and
                      // WkF) are in place; every warp is done with tile k - 1
    if (k + 2 < t_end) load_grids(v2, (q + 2) % 3);
    if (k + 1 < t_end) load_rows(v1, (q + 1) & 1);
    cp_async_commit();
    if (item != cur) {  // block-uniform: the run moves to the next item
      flush();
      cur = item;
      if (SYM) {
        load_irows(cur);
        __syncthreads();
      }
    }
    // SYM: a tile above the diagonal carries its mirror (block-uniform)
    const int pj = v0 - item * ntj;
    const bool mirror = SYM && pj != item % nti;
    const float* pr = smem + kFOffPr + q % 3 * 5 * kPairs;  // [5][il*8 + jl]
    const float* xj = smem + kFOffX + (q & 1) * 2 * kTile * kS3;
    const float* muj = xj + kTile * kS3;
    uint32_t ah[KS][2][4], al[KS][2][4];
    painn_load_a<KS>(smem + kFOffPhi + (q & 1) * kPhiFFloats, wm, ah, al);

    // the gated filter of chunk c in acc[c & 1]
    float acc[2][2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[a][mb][nb][u] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      painn_kstep(acc[0], ah[ks], al[ks], WkF, 0, wn, ks);
    // the next tile's A fragments while chunk 0's products run (its grids
    // landed before this tile's barrier)
    if (k + 1 < t_end) make_phi(q + 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float(*w)[2][4] = acc[c & 1];
      float(*wn1)[2][4] = acc[(c + 1) & 1];
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        // a k step of chunk c + 1 before each message group of chunk c
        if (c < 2 && grp < KS)
          painn_kstep(wn1, ah[grp], al[grp], WkF, c + 1, wn, grp);
        const int mb = grp >> 1, h = grp & 1, jl = 4 * wm + 2 * mb + h, at = g * kTile + jl;
        const int f = c * kF + 16 * wn + 4 * t;  // this lane's four features
        // the filter of pair (jl, il = g) at features f + u, u = 2*nb + c'
        const float wv[4] = {w[mb][0][2 * h], w[mb][0][2 * h + 1], w[mb][1][2 * h],
                             w[mb][1][2 * h + 1]};
        const float4 x4 = ld4(xj + jl * kS3 + f);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        if (c == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) aq[u] = fmaf(wv[u], xv[u], aq[u]);
        } else {
          float wx[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) wx[u] = wv[u] * xv[u];
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            float s[4];
            if (c == 1) {
              s[0] = s[1] = s[2] = s[3] = pr[(2 + cc) * kPairs + at];
            } else {
              const float4 m4 = ld4(muj + jl * kS3 + cc * kF + 16 * wn + 4 * t);
              s[0] = m4.x, s[1] = m4.y, s[2] = m4.z, s[3] = m4.w;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) am[cc][u] = fmaf(wx[u], s[u], am[cc][u]);
          }
        }
      }
      if (mirror && c != 1)
        painn_mirror_rows(c, acc, smem + kFOffXi, pr, dq, dmu, item / nti, ni, nj,
                          pj * kTile + 4 * wm, wn);
      if (c == 0) {  // chunk 0's filter is consumed: zero it for chunk 2
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int u = 0; u < 4; ++u) w[mb][nb][u] = 0.f;
      }
    }
    v0 = v1;
    v1 = v2;
    v2 = v3;
  }
  flush();
}

}  // namespace geossl
