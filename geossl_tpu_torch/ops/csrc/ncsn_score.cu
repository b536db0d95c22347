// ncsn_score: the DDM score-matching head (NCSN_version_03) per pair, fused,
// forward and backward.
//
// Replaces geossl_tpu/ops/ncsn_pallas.py: _fwd_kernel and _bwd_kernel
// (ncsn_score_loss). Per pair (i, j) of graph b, with sigma = sigma[b]:
//   dp    = dist + noise sigma
//   demb  = relu(dp w_d1 + b_d1) . w_d2 + b_d2                 (1 -> E -> 1)
//   l1    = relu(u_i + u_j + demb w_od + b_od)                 [E]
//   x2    = relu(l1 W2 + b2)                                   [E/2]
//   score = (x2 . w3 + b3) / sigma,  target = -noise / sigma
//   loss  = 1/2 (score - target)^2 sigma^anneal sel
// The forward writes the row sums rows[b,i] = sum_j loss; the backward takes
// their cotangent and writes du [B,N,E] and the ten weight gradients (dist,
// noise, sel and sigma are data and get none). The dense PyTorch head writes
// several [B,N,N,E] tensors per direction; here only the [B,N,N] grids and
// [B,N,E] node rows cross device memory.
//
// Bound on the H100: operations. The E -> E/2 product (2 E^2/2 FLOP per
// pair, 16k at E=128) dominates, next to 16 bytes of dist/noise/sel per pair.
// Tiles of 8x8 pairs whose `sel` is all zero are skipped: DDM's selection is
// the strict upper triangle, so the tiles below the diagonal (and all padding)
// cost nothing. Plain f32 FMAs, no tensor cores.
//
// Work split. Forward: one block per (graph, 8-row i tile), looping over the
// j tiles and keeping its rows' sums in registers. Backward: a persistent
// grid (one block per SM) walks the (graph, i tile) items. The i side of du
// is summed in registers per item; the j side is written as per-i-tile
// partials [B, nI, N, E] (as the TPU kernel does) and a second launch adds
// them to du; the weight gradients are per-block partials summed by a third
// launch (reduce.cuh). No atomics: bitwise the same from run to run on one
// card.
//
// Thread layout (256 threads, 8x8 pair tile): thread t owns the 4 pairs
// p = il*8 + jl0 + q (row il = t/32, columns jl0 = ((t/16)%2)*4 + q) and
// either 8 features e = feat(fg, k) / fg + 16k (fg = t%16) of the E-wide
// layers or 4 outputs h = 4fg.. of the E/2-wide one.
#include "pair_tile.cuh"
#include "reduce.cuh"

namespace geossl {

constexpr int kE = 128;        // head width (emb)
constexpr int kH = kE / 2;     // second layer width
constexpr int kHS = kH + 4;    // padded row stride of W2 in shared memory

struct HeadWeights {
  const float *wd1, *bd1, *wd2, *bd2, *wod, *bod, *w2, *b2, *w3, *b3;
};

// Floats of the weight gradients, in this order:
// [w_d1 E][b_d1 E][w_d2 E][b_d2 1][w_od E][b_od E][w2 E*H][b2 H][w3 H][b3 1]
constexpr int kOffWd1 = 0, kOffBd1 = kE, kOffWd2 = 2 * kE, kOffBd2 = 3 * kE,
              kOffWod = 3 * kE + 1, kOffBod = 4 * kE + 1, kOffW2 = 5 * kE + 1,
              kOffB2 = kOffW2 + kE * kH, kOffW3 = kOffB2 + kH, kOffB3 = kOffW3 + kH,
              kWgrad = kOffB3 + 1;
// the per-half-warp vectors summed over the block at the end: all but w2
constexpr int kVec = kWgrad - kE * kH;

struct HeadSmem {
  float *W2;                          // [kE][kHS]
  float *wd1, *bd1, *wd2, *wod, *bod; // [kE]
  float *b2, *w3;                     // [kH]
  float *ui, *uj;                     // [kTile][kE] u rows of the i and j tile
  float *l1;                          // [kPairs][kE]
  float *d, *nz, *sel;                // [kPairs]
};

__device__ float* carve(float* base, HeadSmem& S) {
  S.W2 = base;
  S.wd1 = S.W2 + kE * kHS;
  S.bd1 = S.wd1 + kE;
  S.wd2 = S.bd1 + kE;
  S.wod = S.wd2 + kE;
  S.bod = S.wod + kE;
  S.b2 = S.bod + kE;
  S.w3 = S.b2 + kH;
  S.ui = S.w3 + kH;
  S.uj = S.ui + kTile * kE;
  S.l1 = S.uj + kTile * kE;
  S.d = S.l1 + kPairs * kE;
  S.nz = S.d + kPairs;
  S.sel = S.nz + kPairs;
  return S.sel + kPairs;
}
constexpr int kHeadSmemFloats = kE * kHS + 5 * kE + 2 * kH + 2 * kTile * kE +
                                kPairs * kE + 3 * kPairs;

__device__ void stage_weights(const HeadWeights& W, const HeadSmem& S) {
  for (int idx = threadIdx.x; idx < kE * kH; idx += kThreads)
    S.W2[(idx / kH) * kHS + idx % kH] = W.w2[idx];
  for (int idx = threadIdx.x; idx < kE; idx += kThreads) {
    S.wd1[idx] = W.wd1[idx];
    S.bd1[idx] = W.bd1[idx];
    S.wd2[idx] = W.wd2[idx];
    S.wod[idx] = W.wod[idx];
    S.bod[idx] = W.bod[idx];
    if (idx < kH) {
      S.b2[idx] = W.b2[idx];
      S.w3[idx] = W.w3[idx];
    }
  }
}

// Copies `rows` node rows of u (row stride kE) starting at r0 into dst,
// zero past n.
__device__ void load_rows(float* dst, const float* __restrict__ u_b, int r0, int n) {
  for (int idx = threadIdx.x; idx < kTile * kE; idx += kThreads) {
    const int r = r0 + idx / kE;
    dst[idx] = r < n ? u_b[(size_t)r * kE + idx % kE] : 0.f;
  }
}

// Loads the tile's dist/noise/sel (pair p = il*8 + jl) and the j tile's u rows.
__device__ void load_tile(const HeadSmem& S, const float* __restrict__ dist_b,
                          const float* __restrict__ noise_b,
                          const float* __restrict__ sel_b,
                          const float* __restrict__ u_b, int i0, int j0, int n) {
  const int tid = threadIdx.x;
  if (tid < kPairs) {
    const int i = i0 + tid / kTile, j = j0 + tid % kTile;
    const bool in = i < n && j < n;
    const size_t at = (size_t)i * n + j;
    S.d[tid] = in ? dist_b[at] : 0.f;
    S.nz[tid] = in ? noise_b[at] : 0.f;
    S.sel[tid] = in ? sel_b[at] : 0.f;
  }
  load_rows(S.uj, u_b, j0, n);
}

// Forward chain of this thread's 4 pairs: dp, demb, pre2 (before the relu,
// outputs h = 4fg + hh) and score_raw (the same in all 16 lanes); writes l1
// rows of its pairs into S.l1. Called by all threads of the block.
__device__ void tile_forward(const HeadSmem& S, float sig, float bd2, float b3,
                             float dp[kPPT], float demb[kPPT],
                             float pre2[kPPT][4], float sr[kPPT]) {
  const int fg = thread_fg(), il = thread_il(), jl0 = thread_jl0();
  float wd1[kFPT], bd1[kFPT], wd2[kFPT];
  load_feats(S.wd1, fg, wd1);
  load_feats(S.bd1, fg, bd1);
  load_feats(S.wd2, fg, wd2);
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int p = il * kTile + jl0 + q;
    dp[q] = fmaf(S.nz[p], sig, S.d[p]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kFPT; ++k) s = fmaf(fmaxf(fmaf(dp[q], wd1[k], bd1[k]), 0.f), wd2[k], s);
    demb[q] = half_warp_sum(s) + bd2;
  }
  float ui[kFPT], wod[kFPT], bod[kFPT];
  load_feats(S.ui + il * kE, fg, ui);
  load_feats(S.wod, fg, wod);
  load_feats(S.bod, fg, bod);
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    float uj[kFPT], v[kFPT];
    load_feats(S.uj + (jl0 + q) * kE, fg, uj);
#pragma unroll
    for (int k = 0; k < kFPT; ++k)
      v[k] = fmaxf(ui[k] + uj[k] + fmaf(demb[q], wod[k], bod[k]), 0.f);
    float* row = S.l1 + (il * kTile + jl0 + q) * kE + fg * 4;
    st4(row, v[0], v[1], v[2], v[3]);
    st4(row + kE / 2, v[4], v[5], v[6], v[7]);
  }
  __syncwarp();  // the l1 rows read next were written by this half-warp

  const float4 b2v = ld4(S.b2 + 4 * fg);
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    pre2[q][0] = b2v.x; pre2[q][1] = b2v.y; pre2[q][2] = b2v.z; pre2[q][3] = b2v.w;
  }
  for (int e0 = 0; e0 < kE; e0 += 4) {
    float a[kPPT][4];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const float4 v = ld4(S.l1 + (il * kTile + jl0 + q) * kE + e0);
      a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
    }
#pragma unroll
    for (int ee = 0; ee < 4; ++ee) {
      const float4 wv = ld4(S.W2 + (e0 + ee) * kHS + 4 * fg);
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        pre2[q][0] = fmaf(a[q][ee], wv.x, pre2[q][0]);
        pre2[q][1] = fmaf(a[q][ee], wv.y, pre2[q][1]);
        pre2[q][2] = fmaf(a[q][ee], wv.z, pre2[q][2]);
        pre2[q][3] = fmaf(a[q][ee], wv.w, pre2[q][3]);
      }
    }
  }
  const float4 w3v = ld4(S.w3 + 4 * fg);
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const float s = fmaxf(pre2[q][0], 0.f) * w3v.x + fmaxf(pre2[q][1], 0.f) * w3v.y +
                    fmaxf(pre2[q][2], 0.f) * w3v.z + fmaxf(pre2[q][3], 0.f) * w3v.w;
    sr[q] = half_warp_sum(s) + b3;
  }
}

// Occupancy of the j tiles of rows i0..i0+7: occ[t] = 1 where sel has a
// nonzero entry. Called by all threads; ends in __syncthreads.
__device__ void sel_occupancy(int* occ, const float* __restrict__ sel_b, int i0, int n) {
  const int ntj = (n + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < ntj; t += kThreads) occ[t] = 0;
  __syncthreads();
  const int rows = min(kTile, n - i0);
  for (int idx = threadIdx.x; idx < rows * n; idx += kThreads) {
    const int r = idx / n, j = idx - r * n;
    if (sel_b[(size_t)(i0 + r) * n + j] != 0.f) occ[j / kTile] = 1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ncsn_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                const float* __restrict__ sel, const float* __restrict__ sigma,
                const float* __restrict__ u, HeadWeights W, float* __restrict__ rows,
                int n, float anneal) {
  extern __shared__ float4 smem_v4[];
  HeadSmem S;
  int* occ = (int*)carve(reinterpret_cast<float*>(smem_v4), S);
  const int pi = blockIdx.x, b = blockIdx.y, i0 = pi * kTile;
  const size_t grid_at = (size_t)b * n * n;
  const float* u_b = u + (size_t)b * n * kE;
  const float sig = sigma[b], wsig = expf(anneal * logf(sig));
  const float bd2 = W.bd2[0], b3 = W.b3[0];
  const int ntj = (n + kTile - 1) / kTile;

  sel_occupancy(occ, sel + grid_at, i0, n);
  float racc = 0.f;
  bool staged = false;
  for (int pj = 0; pj < ntj; ++pj) {
    if (!occ[pj]) continue;  // block-uniform
    __syncthreads();  // the previous tile is done with the tile scratch
    if (!staged) {
      stage_weights(W, S);
      load_rows(S.ui, u_b, i0, n);
      staged = true;
    }
    load_tile(S, dist + grid_at, noise + grid_at, sel + grid_at, u_b, i0, pj * kTile, n);
    __syncthreads();
    float dp[kPPT], demb[kPPT], pre2[kPPT][4], sr[kPPT];
    tile_forward(S, sig, bd2, b3, dp, demb, pre2, sr);
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int p = thread_il() * kTile + thread_jl0() + q;
      const float r = sr[q] / sig + S.nz[p] / sig;  // score - target
      racc += 0.5f * r * r * wsig * S.sel[p];
    }
  }
  racc += __shfl_xor_sync(0xffffffffu, racc, 16);
  const int i = i0 + thread_il();
  if ((threadIdx.x & 31) == 0 && i < n) rows[(size_t)b * n + i] = racc;
}

__global__ void __launch_bounds__(kThreads, 1)
ncsn_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                const float* __restrict__ sel, const float* __restrict__ sigma,
                const float* __restrict__ u, const float* __restrict__ grows,
                HeadWeights W, float* __restrict__ du, float* __restrict__ partj,
                float* __restrict__ part, int B, int n, float anneal) {
  extern __shared__ float4 smem_v4[];
  HeadSmem S;
  float* dx2_s = carve(reinterpret_cast<float*>(smem_v4), S);  // [kPairs][kH]
  float* dl1_s = dx2_s + kPairs * kH;                           // [kPairs][kE]
  int* occ = (int*)(dl1_s + kPairs * kE);

  const int tid = threadIdx.x, fg = thread_fg(), hw = tid >> 4;
  const int il = thread_il(), jl0 = thread_jl0();
  const int nti = (n + kTile - 1) / kTile, ntj = nti;
  const float bd2 = W.bd2[0], b3 = W.b3[0];

  stage_weights(W, S);
  // this block's share of the weight gradients over all its items
  float gw2[kFPT][4];  // dW2[feat(hw, a)][4fg + hh]
  float gwd1[kFPT], gbd1[kFPT], gwd2[kFPT], gwod[kFPT], gbod[kFPT];  // e = fg + 16k
  float gb2[4], gw3[4];  // h = 4fg + hh
  float gbd2 = 0.f, gb3 = 0.f;
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    gwd1[k] = gbd1[k] = gwd2[k] = gwod[k] = gbod[k] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) gw2[k][hh] = 0.f;
  }
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) gb2[hh] = gw3[hh] = 0.f;

  for (int item = blockIdx.x; item < B * nti; item += gridDim.x) {
    const int b = item / nti, pi = item % nti, i0 = pi * kTile;
    const size_t grid_at = (size_t)b * n * n;
    const float* u_b = u + (size_t)b * n * kE;
    const float sig = sigma[b], wsig = expf(anneal * logf(sig));
    const int i = i0 + il;
    const float gi = i < n ? grows[(size_t)b * n + i] : 0.f;
    float* partj_b = partj + ((size_t)b * nti + pi) * n * kE;

    __syncthreads();  // the previous item is done with ui and occ
    load_rows(S.ui, u_b, i0, n);
    sel_occupancy(occ, sel + grid_at, i0, n);

    float dui[kFPT];  // du[i][fg + 16k], this half-warp's columns
#pragma unroll
    for (int k = 0; k < kFPT; ++k) dui[k] = 0.f;

    for (int pj = 0; pj < ntj; ++pj) {
      const int j0 = pj * kTile;
      if (!occ[pj]) {  // block-uniform: no contribution to the j rows
        for (int idx = tid; idx < kTile * kE; idx += kThreads) {
          const int j = j0 + idx / kE;
          if (j < n) partj_b[(size_t)j * kE + idx % kE] = 0.f;
        }
        continue;
      }
      __syncthreads();  // the previous tile is done with the tile scratch
      load_tile(S, dist + grid_at, noise + grid_at, sel + grid_at, u_b, i0, j0, n);
      __syncthreads();
      float dp[kPPT], demb[kPPT], pre2[kPPT][4], sr[kPPT];
      tile_forward(S, sig, bd2, b3, dp, demb, pre2, sr);

      // d loss / d score_raw, then the last two layers
      float ds[kPPT];
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const int p = il * kTile + jl0 + q;
        const float r = sr[q] / sig + S.nz[p] / sig;
        ds[q] = r * (wsig * gi) * S.sel[p] / sig;
      }
      const float4 w3v = ld4(S.w3 + 4 * fg);
      const float w3a[4] = {w3v.x, w3v.y, w3v.z, w3v.w};
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        float dx2[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          gw3[hh] = fmaf(fmaxf(pre2[q][hh], 0.f), ds[q], gw3[hh]);
          dx2[hh] = pre2[q][hh] > 0.f ? ds[q] * w3a[hh] : 0.f;
          gb2[hh] += dx2[hh];
        }
        st4(dx2_s + (il * kTile + jl0 + q) * kH + 4 * fg, dx2[0], dx2[1], dx2[2], dx2[3]);
      }
      if (fg == 0) gb3 += ds[0] + ds[1] + ds[2] + ds[3];
      __syncthreads();  // dx2_s and l1 complete

      // dW2 += l1^T dx2 over the tile's pairs
      for (int p = 0; p < kPairs; ++p) {
        float lv[kFPT];
        load_feats(S.l1 + p * kE, hw, lv);
        const float4 dv = ld4(dx2_s + p * kH + 4 * fg);
#pragma unroll
        for (int a = 0; a < kFPT; ++a) {
          gw2[a][0] = fmaf(lv[a], dv.x, gw2[a][0]);
          gw2[a][1] = fmaf(lv[a], dv.y, gw2[a][1]);
          gw2[a][2] = fmaf(lv[a], dv.z, gw2[a][2]);
          gw2[a][3] = fmaf(lv[a], dv.w, gw2[a][3]);
        }
      }

      // dl1 = (dx2 W2^T) relu'(pre1), features e = fg + 16k
      float dl1[kPPT][kFPT];
#pragma unroll
      for (int q = 0; q < kPPT; ++q)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) dl1[q][k] = 0.f;
      for (int h0 = 0; h0 < kH; h0 += 4) {
        float a[kPPT][4];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const float4 v = ld4(dx2_s + (il * kTile + jl0 + q) * kH + h0);
          a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          const float4 wv = ld4(S.W2 + (fg + 16 * k) * kHS + h0);
#pragma unroll
          for (int q = 0; q < kPPT; ++q)
            dl1[q][k] = fmaf(a[q][0], wv.x, fmaf(a[q][1], wv.y,
                        fmaf(a[q][2], wv.z, fmaf(a[q][3], wv.w, dl1[q][k]))));
        }
      }
      float ddemb[kPPT];
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const int p = il * kTile + jl0 + q;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          const int e = fg + 16 * k;
          const float v = S.l1[p * kE + e] > 0.f ? dl1[q][k] : 0.f;
          dl1_s[p * kE + e] = v;
          dui[k] += v;
          gwod[k] = fmaf(v, demb[q], gwod[k]);
          gbod[k] += v;
          s = fmaf(v, S.wod[e], s);
        }
        ddemb[q] = half_warp_sum(s);
      }
      // the distance MLP
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        const int e = fg + 16 * k;
        const float wd1 = S.wd1[e], bd1 = S.bd1[e], wd2 = S.wd2[e];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const float t1 = fmaxf(fmaf(dp[q], wd1, bd1), 0.f);
          gwd2[k] = fmaf(t1, ddemb[q], gwd2[k]);
          const float dt1 = t1 > 0.f ? ddemb[q] * wd2 : 0.f;
          gwd1[k] = fmaf(dt1, dp[q], gwd1[k]);
          gbd1[k] += dt1;
        }
      }
      if (fg == 0) gbd2 += ddemb[0] + ddemb[1] + ddemb[2] + ddemb[3];
      __syncthreads();  // dl1_s complete

      // j side of du: this i tile's partial sum over its 8 rows
      for (int idx = tid; idx < kTile * kE; idx += kThreads) {
        const int jl = idx / kE, e = idx % kE;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kTile; ++r) s += dl1_s[(r * kTile + jl) * kE + e];
        if (j0 + jl < n) partj_b[(size_t)(j0 + jl) * kE + e] = s;
      }
    }

    // i side of du: the two half-warps hold columns 0-3 and 4-7 of each tile
#pragma unroll
    for (int k = 0; k < kFPT; ++k) dui[k] += __shfl_xor_sync(0xffffffffu, dui[k], 16);
    if ((tid & 16) == 0 && i < n) {
#pragma unroll
      for (int k = 0; k < kFPT; ++k) du[((size_t)b * n + i) * kE + fg + 16 * k] = dui[k];
    }
  }

  // this block's partial weight gradients
  float* out = part + (size_t)blockIdx.x * kWgrad;
#pragma unroll
  for (int a = 0; a < kFPT; ++a)
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) out[kOffW2 + feat(hw, a) * kH + 4 * fg + hh] = gw2[a][hh];
  // the vectors: sum the 16 half-warps' copies in a fixed order
  __syncthreads();  // the tile scratch is free
  float* red_s = S.l1;  // [16][kVec], vector offsets as in the output minus w2
  float* mine = red_s + hw * kVec;
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    const int e = fg + 16 * k;
    mine[kOffWd1 + e] = gwd1[k];
    mine[kOffBd1 + e] = gbd1[k];
    mine[kOffWd2 + e] = gwd2[k];
    mine[kOffWod + e] = gwod[k];
    mine[kOffBod + e] = gbod[k];
  }
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    mine[kOffB2 - kE * kH + 4 * fg + hh] = gb2[hh];
    mine[kOffW3 - kE * kH + 4 * fg + hh] = gw3[hh];
  }
  if (fg == 0) {
    mine[kOffBd2] = gbd2;
    mine[kOffB3 - kE * kH] = gb3;
  }
  __syncthreads();
  for (int c = tid; c < kVec; c += kThreads) {
    float s = 0.f;
    for (int h = 0; h < 16; ++h) s += red_s[h * kVec + c];
    out[c < kOffW2 ? c : c + kE * kH] = s;
  }
}

// du[b,j,:] += sum over the i tiles of partj[b, it, j, :]
__global__ void add_j_partials_kernel(const float* __restrict__ partj,
                                      float* __restrict__ du, int B, int n, int nti) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_graph = (size_t)n * kE;
  if (idx >= (size_t)B * per_graph) return;
  const size_t b = idx / per_graph, r = idx % per_graph;
  float s = du[idx];
  for (int it = 0; it < nti; ++it) s += partj[(b * nti + it) * per_graph + r];
  du[idx] = s;
}

static size_t fwd_smem_bytes(int n) {
  return sizeof(float) * (size_t)kHeadSmemFloats + sizeof(int) * (size_t)((n + kTile - 1) / kTile);
}
static size_t bwd_smem_bytes(int n) {
  return sizeof(float) * (size_t)(kHeadSmemFloats + kPairs * kH + kPairs * kE) +
         sizeof(int) * (size_t)((n + kTile - 1) / kTile);
}

static HeadWeights head(const float* wd1, const float* bd1, const float* wd2,
                        const float* bd2, const float* wod, const float* bod,
                        const float* w2, const float* b2, const float* w3,
                        const float* b3) {
  return HeadWeights{wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3};
}

}  // namespace geossl

extern "C" size_t ncsn_fwd_smem_bytes(int n) { return geossl::fwd_smem_bytes(n); }
extern "C" size_t ncsn_bwd_smem_bytes(int n) { return geossl::bwd_smem_bytes(n); }
extern "C" int ncsn_wgrad_size() { return geossl::kWgrad; }
// Blocks of the backward's persistent grid, i.e. rows of its partials buffer.
extern "C" int ncsn_bwd_blocks(int B, int n) {
  return geossl::persistent_blocks(B * ((n + geossl::kTile - 1) / geossl::kTile));
}

// Row sums of the annealed loss, rows [B, n]. Returns the cudaError_t of the
// launch (0 on success). E must be 128.
extern "C" int ncsn_score_fwd(const float* dist, const float* noise, const float* sel,
                              const float* sigma, const float* u, const float* wd1,
                              const float* bd1, const float* wd2, const float* bd2,
                              const float* wod, const float* bod, const float* w2,
                              const float* b2, const float* w3, const float* b3,
                              float* rows, int B, int n, int E, float anneal,
                              void* stream) {
  using namespace geossl;
  if (E != kE) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(n);
  cudaFuncSetAttribute(ncsn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((n + kTile - 1) / kTile, B);
  ncsn_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      dist, noise, sel, sigma, u, head(wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3),
      rows, n, anneal);
  return (int)cudaGetLastError();
}

// Backward: du [B, n, E], and the ten weight gradients into `wgrad`
// (ncsn_wgrad_size() floats, in the order of the offsets above). `partj`
// holds B * ceil(n/8) * n * E floats, `part` ncsn_bwd_blocks(B, n) rows of
// ncsn_wgrad_size() floats. Returns the cudaError_t of the launches.
extern "C" int ncsn_score_bwd(const float* dist, const float* noise, const float* sel,
                              const float* sigma, const float* u, const float* grows,
                              const float* wd1, const float* bd1, const float* wd2,
                              const float* bd2, const float* wod, const float* bod,
                              const float* w2, const float* b2, const float* w3,
                              const float* b3, float* du, float* partj, float* part,
                              float* wgrad, int B, int n, int E, float anneal,
                              void* stream) {
  using namespace geossl;
  if (E != kE) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(n);
  const int blocks = ncsn_bwd_blocks(B, n), nti = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(ncsn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  ncsn_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, noise, sel, sigma, u, grows,
      head(wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3), du, partj, part, B, n, anneal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * n * kE;
  add_j_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(partj, du, B, n, nti);
  sum_partials(part, blocks, kWgrad, wgrad, s);
  return (int)cudaGetLastError();
}
