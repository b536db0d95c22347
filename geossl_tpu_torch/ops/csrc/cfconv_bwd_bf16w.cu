// cfconv_bwd_bf16w: the bf16 backward of SchNet's continuous-filter
// convolution above F = 128 filters, one launch per hidden block.
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _bwd_kernel (via _bwd_pallas)
// and, with SYM, _bwd_sym_kernel (via _bwd_sym_pallas) with mxu='bf16' at a
// filter width F above the 128 that cfconv_bwd.cu's register tiling is
// written for. It computes what cfconv_bwd.cu's bf16 instances compute (the
// seven cotangents; see that file for the math, the work list, the
// symmetric placement and which operands are rounded to bf16), at any F
// padded to k * 128.
//
// Why its own kernel. The f32 backward above 128 runs cfconv_bwd.cu once per
// (hidden block i, output block o) pair of W2 (ops/cfconv.filter_blocks_bwd),
// and each of those k^2 launches forms its own partial dh = qe_o W2[i, o]^T.
// The JAX kernel forms dh = qe W2^T over all F output columns with f32
// accumulation and rounds it to bf16 once, as the operand of dW1 = rbf^T dh
// and drbf = dh W1^T. Rounding each partial apart moves ddist past JAX's
// bf16 bound. So here one launch takes hidden block i (W1's 128 columns, b1
// and W2's 128 rows of block i) and walks every output block o inside the
// launch; per pair tile:
//   s_i = ssp(rbf W1[:, i] + b1[i])                       once
//   per o: the W2[i, o] piece (128 x 128 f32, 64 KiB) and the tile's x / g
//          rows of block o into shared memory; w_o = s_i W2[i, o]
//          (+ b2[o] in launch i = 0 only); qe_o = env g_o x_o (SYM: with the
//          mirror's term, before any rounding); the denv partials, dx's
//          terms, db2; dW2[i, o] += s_i^T qe_o; dh_i += qe_o W2[i, o]^T in
//          the warps' f32 mma accumulators
//   after the last o: dh_i *= sigmoid(pre1); db1[i]; dh_i is rounded once,
//          as the bf16 operand of dW1[:, i] = rbf^T dh_i and of
//          drbf = dh_i W1[:, i]^T (-> ddist)
// The k launches of a call (the C entry runs them all) sum their ddist,
// denv and dx in f32 in launch order: launch 0 writes, each later one adds
// to what the earlier ones wrote (each cell by the one thread that owns it;
// SYM's dx by atomics, as cfconv_bwd.cu's). Shared memory does not grow with
// F: every buffer is one 128-column block (smem_bytes below, about 194 KiB
// at N = 512).
//
// Bound on the H100: operations, as cfconv_bwd.cu's bf16 instances (the six
// products on bf16 operands, mma.sync.m16n8k16 with f32 accumulation,
// mma_bf16.cuh): per pair ~2 (G F + F^2) for the filter and 4 F^2 + 4 G F
// for the rest, k launches a call. Beside them each (tile, o) step moves the
// W2 piece from L2 into shared memory and reads and writes this block's
// dW2[i, o] partial (64 KiB each way), through L2: no 64 KiB of shared
// memory is left for a second W2 piece or a dW2 accumulator, and dW2's
// k pieces would need k times a kernel's registers. That traffic, not the
// products, is what this first, simple instance pays for its width
// (PERF.md's rows 2bw / 4bw).
//
// Weight gradients: each block of the persistent grid sums its tiles' terms
// into its own row of the partials buffer (dW2 [128][F] and db2 [8][F] by
// read-modify-write, each element by the one thread that owns it; dW1
// [G][128] in the warps' accumulators, or, G > 64, read-modify-written as
// cfconv_bwd.cu's kBig instance does), and reduce.cuh's sum adds the rows
// in block order after each launch. Everything but SYM's dx is bitwise the
// same from run to run on one card.
#include "filter_mma.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

namespace bf16w {

constexpr int kBT = kThreads;  // 8 warps (255 registers each)
constexpr int kRB = 2;         // warp rows over a 64-row product (4 column quarters)
constexpr int kMB = 2;         // 16-row blocks of a warp in a 64-row product
constexpr int kGP = 64;        // G padded: rows of W1_s, columns of rbf_s
constexpr int kRS = kF + 8;    // row stride of the 8-row tiles (bank spread)
constexpr int kTR = kTile * kRS;

// shared memory, in floats
constexpr int kOffW1 = 0;                        // [kGP][kF] swizzled (G > 64: 2 chunks)
constexpr int kOffW2 = kOffW1 + kGP * kF;        // [kF][kF] swizzled: the W2[i, o] piece
constexpr int kOffRbf = kOffW2 + kF * kF;        // [kPairs][kGP] swizzled (G > 64: 2 chunks)
constexpr int kOffS = kOffRbf + kPairs * kGP;    // [kPairs][kF] swizzled: s, then dh
constexpr int kOffQe = kOffS + kPairs * kF;      // [kPairs][kF] swizzled: qe_o
constexpr int kOffX = kOffQe + kPairs * kF;      // [8][kRS] x rows of the item, block o
constexpr int kOffGj = kOffX + kTR;              // [8][kRS] SYM: g rows of the item, block o
constexpr int kOffG = kOffGj + kTR;              // [8][kRS] g rows of the i tile, block o
constexpr int kOffXi = kOffG + kTR;              // [8][kRS] SYM: x rows of the i tile, block o
constexpr int kOffD = kOffXi + kTR;              // [64] dist, [il][jl]
constexpr int kOffE = kOffD + kPairs;            // [64] env, [il][jl]
constexpr int kOffB1 = kOffE + kPairs;           // [kF] b1 of block i
constexpr int kOffB2 = kOffB1 + kF;              // [kF] b2 of block o (zero in launches i > 0)
constexpr int kOffDen = kOffB2 + kF;             // [4][64] denv partials
constexpr int kOffDd = kOffDen + 4 * kPairs;     // [4][64] ddist partials (G > 64: [2][64])
constexpr int kSmemFloats = kOffDd + 4 * kPairs; // then ints: misc[4], tile list [nti]

// Floats of one block's partial weight gradients (and of one launch's share
// of the result): [dW1 G*128][db1 128][dW2 128*F][db2 8*F, row 0 the sum]
__host__ __device__ inline size_t wgrad_size(int G, int F) {
  return (size_t)G * kF + kF + (size_t)kF * F + 8 * (size_t)F;
}

// G > 64: the dW1 rows of chunk c that lane (g, t) of warp w owns in pass 2
// (cfconv_bwd.cu's dw1_chunk_cells).
template <typename Fn>
__device__ __forceinline__ void dw1_cells(float* pw1, int c, int G, Fn f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c * kKC + 16 * mb + g + 8 * h;
      if (r >= G) continue;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        f(mb, nb, h, reinterpret_cast<float2*>(pw1 + (size_t)r * kF + 16 * warp + 8 * nb + 2 * t));
    }
}

// Hidden block hb of the backward (kBig: G > kGP, W1 streamed in chunks as
// cfconv_bwd.cu's kBig instance). x [B,nj,F], gr [B,ni,F], w1 [k][G][kF]
// (W1's column blocks, block hb at w1 + hb G kF), b1, b2 [F], w2 [F][F].
template <bool SYM, bool kBig>
__global__ void __launch_bounds__(kBT, 1)
cfconv_bwd_bf16w_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                        const float* __restrict__ x, const float* __restrict__ gr,
                        const float* __restrict__ w1, const float* __restrict__ rbf_tab,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, const int* __restrict__ occ,
                        const int* __restrict__ pre, float* __restrict__ ddist,
                        float* __restrict__ denv, float* __restrict__ dx,
                        float* __restrict__ part, int B, int ni, int nj, int F, int G, int hb,
                        float start, float delta, float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem + kOffW1;
  float* W2_s = smem + kOffW2;
  float* rbf_s = smem + kOffRbf;
  float* s_s = smem + kOffS;
  float* qe_s = smem + kOffQe;
  float* x_s = smem + kOffX;
  float* gj_s = smem + kOffGj;
  float* g_t = smem + kOffG;
  float* xi_t = smem + kOffXi;
  float* d_t = smem + kOffD;
  float* e_t = smem + kOffE;
  float* b1_s = smem + kOffB1;
  float* b2_s = smem + kOffB2;
  float* den_p = smem + kOffDen;
  float* dd_p = smem + kOffDd;
  int* misc = reinterpret_cast<int*>(smem + kSmemFloats);  // [0] it0 [1] it1 [2] tiles
  int* tl_s = misc + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kRB, wn = warp / kRB;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * ntj, k_out = F / kF;
  const bool add = hb > 0;  // launches after the first add to ddist / denv

  const float* w1b = w1 + (size_t)hb * G * kF;
  W1Stream w1s(W1_s, w1b, G, rbf_tab);
  float* pw1 = part + (size_t)blockIdx.x * wgrad_size(G, F);
  float* pb1 = pw1 + (size_t)G * kF;
  float* pw2 = pb1 + kF;                   // [kF][F]
  float* pb2 = pw2 + (size_t)kF * F;       // [8][F]
  for (size_t idx = tid; idx < (size_t)kF * F + 8 * (size_t)F; idx += kBT) pw2[idx] = 0.f;
  if (kBig) {
    load_w1_chunk(W1_s, w1b, 0, G);  // the first tile's first chunk
    for (int c = 0; c < w1s.n; ++c)
      dw1_cells(pw1, c, G, [](int, int, int, float2* d) { *d = make_float2(0.f, 0.f); });
  } else {
    for (int idx = tid; idx < kGP * kF; idx += kBT) {
      const int r = idx / kF, c = idx % kF;
      W1_s[swz_at(kF, r, c)] = r < G ? w1b[idx] : 0.f;
    }
    for (int idx = tid; idx < kPairs * kGP; idx += kBT) rbf_s[idx] = 0.f;  // columns >= G stay 0
  }
  if (tid < kF) b1_s[tid] = b1[hb * kF + tid];
  if (tid == 0) {
    misc[0] = first_item(pre, n_items, gridDim.x, blockIdx.x);
    misc[1] = first_item(pre, n_items, gridDim.x, blockIdx.x + 1);
  }
  __syncthreads();
  const int it0 = misc[0], it1 = misc[1];

  // dW1 rows 16*kMB*wm.. (G <= 64) and db1 over all of the block's tiles
  float aw1[kMB][4][4], db1a[2 * kMB];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) aw1[mb][nb][q] = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * kMB; ++i) db1a[i] = 0.f;

  for (int item = it0; item < it1; ++item) {
    const int b = item / ntj, pj = item - b * ntj, j0 = pj * kTile;
    const int n_it = SYM ? pj + 1 : nti;
    __syncthreads();  // the previous item is done with tl_s
    if (warp == 0) {
      const int n = item_tiles(occ + (size_t)item * nti, n_it, tl_s);
      if (lane == 0) misc[2] = n;
    }
    __syncthreads();
    const int n_t = misc[2];
    float* ddist_b = ddist + (size_t)b * ni * nj;
    float* denv_b = denv + (size_t)b * ni * nj;

    for (int k = 0; k < n_t; ++k) {
      const int pi = tl_s[k], i0 = pi * kTile;
      const bool mirror = SYM && pi != pj;  // block-uniform
      if (tid < 2 * kPairs) {  // dist / env of pair p = il*8 + jl
        const int p = tid & (kPairs - 1), i = i0 + (p >> 3), j = j0 + (p & 7);
        const float* src = tid < kPairs ? dist : env;
        (tid < kPairs ? d_t : e_t)[p] = i < ni && j < nj ? src[((size_t)b * ni + i) * nj + j] : 0.f;
      }
      if (kBig) cp_async_wait<0>();  // W1's chunk 0 (fetched by the previous tile or the start)
      __syncthreads();

      // hidden s = ssp(rbf W1_i + b1_i) into s_s (kBig: pass 1 over W1's
      // chunks, chunk 0 fetched again for pass 2)
      float acc[kMB][4][4];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
      if (kBig) {
        rbf_w1_streamed<kMB, false, true>(w1s, rbf_s, d_t, 16 * kMB * wm, 32 * wn, true, acc);
      } else {
        for (int idx = tid; idx < kPairs * kGP; idx += kBT) {
          const int p = idx / kGP, gg = idx % kGP;
          if (gg < G) {
            const float diff = d_t[(p & 7) * kTile + (p >> 3)] - (start + delta * (float)gg);
            rbf_s[swz_at(kGP, p, gg)] = __expf(coeff * diff * diff);
          }
        }
        __syncthreads();
        if (G <= 56)
          tile_mma<true, kMB, 4, 56, false, false>(acc, rbf_s, kGP, 16 * kMB * wm, W1_s, kF, 32 * wn);
        else
          tile_mma<true, kMB, 4, kGP, false, false>(acc, rbf_s, kGP, 16 * kMB * wm, W1_s, kF, 32 * wn);
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, c0,
                   ssp_fast(acc[mb][nb][2 * h] + b1_s[c0]),
                   ssp_fast(acc[mb][nb][2 * h + 1] + b1_s[c0 + 1]));
        }

      // the output blocks: dh_i summed over o in f32 (the mma accumulators),
      // denv's row partials over o in den
      float dh[kMB][4][4], den[kMB][2];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        den[mb][0] = den[mb][1] = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) dh[mb][nb][q] = 0.f;
      }
      for (int o = 0; o < k_out; ++o) {
        const int f0 = o * kF;
        __syncthreads();  // s_s complete; every warp done with block o - 1's buffers
        for (int idx = tid; idx < kF * kF / 4; idx += kBT) {
          const int r = idx >> 5, c = (idx & 31) * 4;
          *reinterpret_cast<float4*>(W2_s + swz_at(kF, r, c)) = __ldg(
              reinterpret_cast<const float4*>(w2 + ((size_t)hb * kF + r) * F + f0 + c));
        }
        for (int idx = tid; idx < (SYM ? 4 : 2) * kTile * kF / 4; idx += kBT) {
          const int which = idx / (kTile * kF / 4), cc = idx % (kTile * kF / 4);
          const int r = cc >> 5, c = (cc & 31) * 4;
          // 0: x rows j, 1: g rows i, 2: g rows j, 3: x rows i
          const int a = (which == 0 || which == 2 ? j0 : i0) + r;
          const bool in = a < (which == 0 || which == 2 ? nj : ni);
          const float* src = which == 0 || which == 3 ? x + ((size_t)b * nj + a) * F
                                                       : gr + ((size_t)b * ni + a) * F;
          float* dst = which == 0 ? x_s : which == 1 ? g_t : which == 2 ? gj_s : xi_t;
          *reinterpret_cast<float4*>(dst + r * kRS + c) =
              in ? __ldg(reinterpret_cast<const float4*>(src + f0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (tid < kF) b2_s[tid] = add ? 0.f : b2[f0 + tid];
        __syncthreads();

        // the filter w_o = s W2[i, o] (+ b2[o]), in registers
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
        tile_mma<true, kMB, 4, kF, false, false>(acc, s_s, kF, 16 * kMB * wm, W2_s, kF, 32 * wn);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              acc[mb][nb][2 * h] += b2_s[c0];
              acc[mb][nb][2 * h + 1] += b2_s[c0 + 1];
            }
          }

        // qe_o = env q into qe_s, denv's partials, db2 (rows of pb2)
        {
          float v[16 * kMB];
#pragma unroll
          for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int jl = 2 * (kMB * wm + mb) + h, row = 8 * jl + g;
              const float e = e_t[g * kTile + jl];
              float s = 0.f;
#pragma unroll
              for (int nb = 0; nb < 4; ++nb) {
                const int c0 = 32 * wn + 8 * nb + 2 * t;
                const float2 xj = *reinterpret_cast<const float2*>(x_s + jl * kRS + c0);
                const float2 gi = *reinterpret_cast<const float2*>(g_t + g * kRS + c0);
                float q0 = gi.x * xj.x, q1 = gi.y * xj.y;
                if (mirror) {  // the mirror cell (j, i): q += x_i g_j
                  const float2 xi = *reinterpret_cast<const float2*>(xi_t + g * kRS + c0);
                  const float2 gj = *reinterpret_cast<const float2*>(gj_s + jl * kRS + c0);
                  q0 = fmaf(xi.x, gj.x, q0);
                  q1 = fmaf(xi.y, gj.y, q1);
                }
                s = fmaf(acc[mb][nb][2 * h], q0, fmaf(acc[mb][nb][2 * h + 1], q1, s));
                v[16 * mb + 8 * h + 2 * nb] = e * q0;
                v[16 * mb + 8 * h + 2 * nb + 1] = e * q1;
                store2(qe_s, kF, row, c0, e * q0, e * q1);
              }
              den[mb][h] += s;
            }
          rs_lanes<kMB>(v);
#pragma unroll
          for (int i = 0; i < 2 * kMB; ++i) {  // entry g*2*kMB + i: row r of pb2, column c
            const int e = g * 2 * kMB + i;
            const int c = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
            pb2[(size_t)(2 * kMB * wm + (e >> 3)) * F + f0 + c] += v[i];
          }
        }

        // dx: the j rows' part (sum over i); SYM also the mirrors' i rows
        {
          float v[16 * kMB], mv[4][2];
#pragma unroll
          for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int jl = 2 * (kMB * wm + mb) + h;
              const float e = e_t[g * kTile + jl];
#pragma unroll
              for (int nb = 0; nb < 4; ++nb) {
                const int c0 = 32 * wn + 8 * nb + 2 * t;
                const float ew0 = e * acc[mb][nb][2 * h], ew1 = e * acc[mb][nb][2 * h + 1];
                const float2 gi = *reinterpret_cast<const float2*>(g_t + g * kRS + c0);
                v[16 * mb + 8 * h + 2 * nb] = ew0 * gi.x;
                v[16 * mb + 8 * h + 2 * nb + 1] = ew1 * gi.y;
                if (mirror) {
                  const float2 gj = *reinterpret_cast<const float2*>(gj_s + jl * kRS + c0);
                  const bool first = mb == 0 && h == 0;
                  mv[nb][0] = first ? ew0 * gj.x : fmaf(ew0, gj.x, mv[nb][0]);
                  mv[nb][1] = first ? ew1 * gj.y : fmaf(ew1, gj.y, mv[nb][1]);
                }
              }
            }
          rs_lanes<kMB>(v);
#pragma unroll
          for (int i = 0; i < 2 * kMB; i += 2) {  // entry g*2*kMB + i: c = 0, 1
            const int e = g * 2 * kMB + i, nb = (e >> 1) & 3;
            const int j = j0 + 2 * kMB * wm + (e >> 3);
            if (j >= nj) continue;
            float* d = dx + ((size_t)b * nj + j) * F + f0 + 32 * wn + 8 * nb + 2 * t;
            if (SYM) {
              atomic_add2(d, v[i], v[i + 1]);
            } else {  // this block owns the item's rows
              float2* d2 = reinterpret_cast<float2*>(d);
              const float2 old = *d2;
              *d2 = make_float2(old.x + v[i], old.y + v[i + 1]);
            }
          }
          if (mirror && i0 + g < ni) {
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
              atomic_add2(dx + ((size_t)b * nj + i0 + g) * F + f0 + 32 * wn + 8 * nb + 2 * t,
                          mv[nb][0], mv[nb][1]);
          }
        }
        __syncthreads();  // qe_s complete

        // dW2[i, o] += s^T qe_o: this tile's product added in f32 to this
        // block's partial (rows 32*kMB*wm.., columns f0 + 32*wn..)
        {
          float aw2[2 * kMB][4][4];
#pragma unroll
          for (int mb = 0; mb < 2 * kMB; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
#pragma unroll
              for (int q = 0; q < 4; ++q) aw2[mb][nb][q] = 0.f;
          tile_mma<true, 2 * kMB, 4, kPairs, true, false, true>(aw2, s_s, kF, 32 * kMB * wm, qe_s,
                                                               kF, 32 * wn);
#pragma unroll
          for (int mb = 0; mb < 2 * kMB; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 16 * (2 * kMB * wm + mb) + g + 8 * h;
                float2* d2 = reinterpret_cast<float2*>(pw2 + (size_t)r * F + f0 + 32 * wn +
                                                       8 * nb + 2 * t);
                const float2 old = *d2;
                *d2 = make_float2(old.x + aw2[mb][nb][2 * h], old.y + aw2[mb][nb][2 * h + 1]);
              }
        }
        // dh_i += qe_o W2[i, o]^T
        tile_mma<true, kMB, 4, kF, false, true>(dh, qe_s, kF, 16 * kMB * wm, W2_s, kF, 32 * wn);
      }

      // denv's partials of this thread's rows, over the column quarters
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = quad_sum(den[mb][h]);
          if (t == 0) den_p[wn * kPairs + 8 * (2 * (kMB * wm + mb) + h) + g] = s;
        }
      // dh = (sum_o qe_o W2[i, o]^T) ssp'(pre1), from s (cfconv_bwd.cu), db1
      {
        float v[16 * kMB];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 sv =
                  load2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, 32 * wn + 8 * nb + 2 * t);
              float* a = dh[mb][nb] + 2 * h;
              a[0] *= fmaf(-0.5f, __expf(-sv.x), 1.f);
              a[1] *= fmaf(-0.5f, __expf(-sv.y), 1.f);
              v[16 * mb + 8 * h + 2 * nb] = a[0];
              v[16 * mb + 8 * h + 2 * nb + 1] = a[1];
            }
        rs_lanes<kMB>(v);
#pragma unroll
        for (int i = 0; i < 2 * kMB; ++i) db1a[i] += v[i];
      }
      __syncthreads();  // the last dW2 product is done with s_s; den_p complete
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, 32 * wn + 8 * nb + 2 * t,
                   dh[mb][nb][2 * h], dh[mb][nb][2 * h + 1]);
      if (tid < kPairs) {  // denv of pair p = jl*8 + il, column quarters in order
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        const float s = den_p[tid] + den_p[kPairs + tid] + den_p[2 * kPairs + tid] +
                        den_p[3 * kPairs + tid];
        if (i < ni && j < nj) {
          float* d = denv_b + (size_t)i * nj + j;
          *d = add ? *d + s : s;
        }
      }
      __syncthreads();  // dh complete in s_s

      if (kBig) {
        // pass 2 over W1's chunks (cfconv_bwd.cu's): drbf = dh W1_c^T and its
        // ddist terms, dW1's chunk rows += rbf_c^T dh in this block's partial
        const int wr = warp & 3, wc = warp >> 2;
        float dds[2] = {0.f, 0.f};
        cp_async_wait<0>();  // chunk 0 (fetched by pass 1's last chunk) has landed
        for (int c = 0; c < w1s.n; ++c) {
          if (c > 0) cp_async_wait<0>();
          float* rb = w1s.rbf(rbf_s);
          rbf_chunk(rb, d_t, c, G, w1s.off, w1s.coeff);
          __syncthreads();  // chunk c and its RBF visible; every warp done with chunk c - 1
          w1s.fetch(c + 1 < w1s.n ? c + 1 : 0);  // after the last: the next tile's pass 1
          float ar[1][2][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) ar[0][nb][q] = 0.f;
          tile_mma<true, 1, 2, kF, false, true>(ar, s_s, kF, 16 * wr, w1s.cur(), kF, 16 * wc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * wr + g + 8 * h;
            const float d = d_t[(p & 7) * kTile + (p >> 3)];
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int gl = 16 * wc + 8 * nb + 2 * t + cc, gg = c * kKC + gl;
                if (gg < G) {
                  const float diff = d - __ldg(w1s.off + gg);
                  dds[h] = fmaf(ar[0][nb][2 * h + cc] * rb[swz_at(kKC, p, gl)],
                                2.f * w1s.coeff * diff, dds[h]);
                }
              }
          }
          float2 old[2][2][2];
          dw1_cells(pw1, c, G, [&](int mb, int nb, int h, float2* d) { old[mb][nb][h] = *d; });
          float aw[2][2][4];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
              for (int q = 0; q < 4; ++q) aw[mb][nb][q] = 0.f;
          tile_mma<true, 2, 2, kPairs, true, false>(aw, rb, kKC, 0, s_s, kF, 16 * warp);
          dw1_cells(pw1, c, G, [&](int mb, int nb, int h, float2* d) {
            *d = make_float2(old[mb][nb][h].x + aw[mb][nb][2 * h],
                             old[mb][nb][h].y + aw[mb][nb][2 * h + 1]);
          });
          ++w1s.k;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = quad_sum(dds[h]);
          if (t == 0) dd_p[wc * kPairs + 16 * wr + g + 8 * h] = v;
        }
        __syncthreads();  // dd_p complete
      } else {
        // ddist = sum_g (dh W1^T)[g] rbf_g 2 coeff (d - off_g), columns 16*wn..
        float ar[kMB][2][4];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) ar[mb][nb][q] = 0.f;
        tile_mma<true, kMB, 2, kF, false, true>(ar, s_s, kF, 16 * kMB * wm, W1_s, kF, 16 * wn);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * (kMB * wm + mb) + g + 8 * h;
            const float d = d_t[(p & 7) * kTile + (p >> 3)];
            float s = 0.f;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int gg = 16 * wn + 8 * nb + 2 * t + c;
                if (gg < G) {
                  const float diff = d - (start + delta * (float)gg);
                  s = fmaf(ar[mb][nb][2 * h + c] * rbf_s[swz_at(kGP, p, gg)], 2.f * coeff * diff,
                           s);
                }
              }
            s = quad_sum(s);
            if (t == 0) dd_p[wn * kPairs + p] = s;
          }
        // dW1 += rbf^T dh
        tile_mma<true, kMB, 4, kPairs, true, false>(aw1, rbf_s, kGP, 16 * kMB * wm, s_s, kF, 32 * wn);
        __syncthreads();  // dd_p complete
      }
      if (tid < kPairs) {
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        const float s = kBig ? dd_p[tid] + dd_p[kPairs + tid]
                             : dd_p[tid] + dd_p[kPairs + tid] + dd_p[2 * kPairs + tid] +
                                   dd_p[3 * kPairs + tid];
        if (i < ni && j < nj) {
          float* d = ddist_b + (size_t)i * nj + j;
          *d = add ? *d + s : s;
        }
      }
    }
  }

  // dW1 (G <= 64) and db1 of this block; db2's 8 rows summed into row 0
  if (kBig) cp_async_wait<0>();  // the last tile's fetch of a chunk nobody reads
  if (!kBig) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
          const int r = 16 * (kMB * wm + mb) + g + 8 * h, c0 = 32 * wn + 8 * nb + 2 * t;
          if (r < G) {
            pw1[r * kF + c0] = aw1[mb][nb][2 * h];
            pw1[r * kF + c0 + 1] = aw1[mb][nb][2 * h + 1];
          }
        }
  }
  __syncthreads();  // the tile scratch is free; pb2's rows are complete
  float* red_s = qe_s;  // [8 jl][kF]
#pragma unroll
  for (int i = 0; i < 2 * kMB; ++i) {
    const int e = g * 2 * kMB + i, c = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
    red_s[(2 * kMB * wm + (e >> 3)) * kF + c] = db1a[i];
  }
  __syncthreads();
  for (int c = tid; c < kF; c += kBT) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += red_s[r * kF + c];
    pb1[c] = s;
  }
  for (int c = tid; c < F; c += kBT) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += pb2[(size_t)r * F + c];
    pb2[c] = s;
  }
}

static size_t smem_bytes(int ni) {
  return sizeof(float) * (size_t)kSmemFloats + sizeof(int) * (4 + (size_t)((ni + kTile - 1) / kTile));
}

}  // namespace bf16w
}  // namespace geossl

extern "C" size_t cfconv_bwd_bf16w_smem_bytes(int ni) { return geossl::bf16w::smem_bytes(ni); }

// Floats of one hidden block's share of the weight gradients (and of one row
// of the partials buffer): dW1[:, i] [G][128], db1[i] [128], dW2[i, :]
// [128][F], db2 [8][F] (row 0 holds db2; the same in every share).
extern "C" size_t cfconv_bwd_bf16w_wgrad_size(int G, int F) {
  return geossl::bf16w::wgrad_size(G, F);
}

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int cfconv_bwd_bf16w_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Ints of the workspace (tile flags, item counts, prefix sums), as cfconv_bwd's.
extern "C" size_t cfconv_bwd_bf16w_ws_ints(int B, int ni, int nj) {
  return geossl::worklist_ints((size_t)B * ((nj + geossl::kTile - 1) / geossl::kTile),
                               (ni + geossl::kTile - 1) / geossl::kTile);
}

// The bf16 backward at F = 128 k (k >= 1; the wrapper pads): k launches, one
// per hidden block, after one work list. x [B,nj,F], g [B,ni,F], w1 [k][G][128]
// (W1's column blocks), b1 [F], w2 [F][F], b2 [F]; ddist, denv [B,ni,nj]; dx
// [B,nj,F] zero on entry; `part` holds cfconv_bwd_bf16w_blocks(B, nj) rows of
// cfconv_bwd_bf16w_wgrad_size(G, F) floats, `wgrad` k such rows (launch i's
// share in row i); `ws` cfconv_bwd_bf16w_ws_ints(B, ni, nj) ints; rbf_tab as
// cfconv_bwd's (G > 64). With `symmetric` (square grid) ddist/denv are placed
// as cfconv_bwd.cu's. Returns the cudaError_t of the launches (0 on success).
extern "C" int cfconv_bwd_bf16w(const float* dist, const float* env, const float* x,
                                const float* g, const float* w1, const float* rbf_tab,
                                const float* b1, const float* w2, const float* b2, float* ddist,
                                float* denv, float* dx, float* part, float* wgrad, int* ws, int B,
                                int ni, int nj, int F, int G, float start, float delta,
                                float coeff, int symmetric, int sparse, void* stream) {
  using namespace geossl;
  using namespace geossl::bf16w;
  if (F < kF || F % kF != 0 || G < 1 || (symmetric && ni != nj) || (G > kGP && !rbf_tab))
    return (int)cudaErrorInvalidValue;
  const int blocks = cfconv_bwd_bf16w_blocks(B, nj);
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * ntj;
  cudaStream_t s = (cudaStream_t)stream;
  int* occ = ws;
  int* pre = occ + (size_t)n_items * nti + n_items;
  ZeroGrids zero = {{ddist, denv}, 2};
  cudaError_t err = symmetric ? make_worklist<true, false>(env, ws, zero, B, ni, nj, sparse, s)
                              : make_worklist<false, false>(env, ws, zero, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(ni);
  auto kernel = symmetric ? (G > kGP ? cfconv_bwd_bf16w_kernel<true, true>
                                     : cfconv_bwd_bf16w_kernel<true, false>)
                          : (G > kGP ? cfconv_bwd_bf16w_kernel<false, true>
                                     : cfconv_bwd_bf16w_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t size = wgrad_size(G, F);
  for (int hb = 0; hb < F / kF; ++hb) {
    kernel<<<blocks, kBT, smem, s>>>(dist, env, x, g, w1, rbf_tab, b1, w2, b2, occ, pre, ddist,
                                     denv, dx, part, B, ni, nj, F, G, hb, start, delta, coeff);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials(part, blocks, (int)size, wgrad + (size_t)hb * size, s);
  }
  return (int)cudaGetLastError();
}
