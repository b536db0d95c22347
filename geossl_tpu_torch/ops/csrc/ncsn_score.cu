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
// Bound on the H100: operations. Per selected pair the forward's E -> E/2
// product costs 2 E H FLOP (16k at E=128); the backward recomputes it and
// adds dl1 = dx2 W2^T and dW2 += l1^T dx2, 6 E H (49k) of products beside
// ~3k of elementwise terms, against 16 bytes of dist/noise/sel per pair.
// Tiles of 8x8 pairs whose `sel` is all zero are skipped: DDM's selection is
// the strict upper triangle, so the tiles below the diagonal (and all
// padding) cost nothing.
//
// Forward (ncsn_fwd_kernel): plain f32 FMAs on the CUDA cores, one block per
// (graph, 8-row i tile), looping over the j tiles and keeping its rows' sums
// in registers. Thread layout (256 threads, 8x8 pair tile): thread t owns
// the 4 pairs p = il*8 + jl0 + q (row il = t/32, columns jl0 =
// ((t/16)%2)*4 + q) and either 8 features feat(fg, k) (fg = t%16) of the
// E-wide layers or 4 outputs h = 4fg.. of the E/2-wide one.
//
// Backward (ncsn_bwd_kernel, then ncsn_du_kernel and reduce.cuh's sum):
// - work list: the tiles where sel is not all zero, listed on the device
//   (worklist.cuh, no host sync) in (graph, 8-row i tile) items; a
//   persistent grid (one 8-warp block per SM) gives each block an equal run
//   of the list;
// - products: the recomputed l1 W2, dl1 = dx2 W2^T and dW2 += l1^T dx2 on
//   the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh).
//   W2, the B operand of the first two, is split into its TF32 parts once
//   per block. l1 W2 runs in the precise mode: in the plain split its error
//   moves relu'(pre2) off the plain version's side several times as often
//   (PERF.md). dW2 is summed over every tile of a run, so each tile's
//   product is added to that sum in f32 on the CUDA cores (the tensor
//   core's truncating accumulator would drift). The rest (the distance MLP,
//   relu', the score, the vector weight gradients) runs on the CUDA cores;
// - loads: the next tile's dist/noise/sel, row cotangents and u rows load
//   with cp.async (double buffer) while the current tile runs;
// - du: partials only where a tile is listed. The j side of each listed
//   tile (its 8 rows j summed over the tile's rows i) goes to slot `list
//   position`; the i side is summed in registers over the consecutive tiles
//   of one row tile in a run and written once per (block, item) segment.
//   ncsn_du_kernel then sums, per row, the i-side segments in list order and
//   the j sides in order of the row tile that holds them;
// - weight gradients: per-block partials in a fixed order, summed in block
//   order by a last launch.
// No atomics anywhere: the result is bitwise the same from run to run on one
// card.
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

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

// -- backward ------------------------------------------------------------------

constexpr int kBS = kE + 8;  // row stride of the 8-row u tiles (bank spread)
// shared memory of the backward, in floats
constexpr int kW2Lo = kE * kH;                      // the low parts' offset
constexpr int kBOffW2 = 0;                          // [2][kE][kH] swizzled: W2 split, hi, lo
constexpr int kBOffL1 = kBOffW2 + 2 * kE * kH;      // [kPairs][kE] swizzled: l1
constexpr int kBOffDx2 = kBOffL1 + kPairs * kE;     // [kPairs][kH] swizzled: dx2
constexpr int kBOffU = kBOffDx2 + kPairs * kH;      // [2][2][8][kBS] u rows: j tile, i tile
constexpr int kBOffGrid = kBOffU + 4 * kTile * kBS; // [2][3][64] dist, noise, sel, [il][jl]
constexpr int kBOffGi = kBOffGrid + 6 * kPairs;     // [2][8] the row cotangents g_i, [2] sigma
constexpr int kBOffVec = kBOffGi + 2 * kTile + 4;   // wd1, bd1, wd2, wod, bod [kE]; b2, w3 [kH]
// per pair: dp [2][64], ddemb's four column-warp partials [2][64][4] (double:
// the distance MLP of a tile runs in the next tile's iteration), demb [64],
// sr [2][64]
constexpr int kBOffPair = kBOffVec + 5 * kE + 2 * kH;
constexpr int kBwdFloats = kBOffPair + 13 * kPairs;
// The per-tile du partials: the j side of every listed tile (its 8 rows j
// summed over the tile's rows i), the i side of every (block, item) segment
// of the runs (8 rows i summed over the segment's tiles), in two halves.
constexpr int kTileRows = kTile * kE;  // floats of one 8-row partial

// Backward of the head, per listed tile of the tile list (worklist.cuh:
// the tiles where sel is not all zero, in (graph, 8-row i tile) items),
// block k computing the run [run_begin(k), run_begin(k + 1)). Pair
// p = jl*8 + il of a tile is row p of its 64-row operands. Per tile:
//   1. dp, demb (CUDA cores), l1 = relu(u_i + u_j + demb w_od + b_od) into l1_s
//   2. pre2 = l1 W2 (+ b2) on the tensor cores (3xTF32): warp (wq, wh) owns
//      rows 16*wq.. and columns 32*wh.. of the 64 x H product; the score,
//      ds = d loss / d score_raw, dx2 = relu'(pre2) ds w3 into dx2_s
//   3. dW2 += l1^T dx2 (3xTF32; each tile's product added to the run's sum
//      in f32) and dl1 = (dx2 W2^T) relu'(l1) (3xTF32): warp (wm, wn) owns rows
//      32*wm.. and columns 32*wn.. of the 64 x E product, lane (g, t) pairs
//      (jl = 4*wm + 2*mb + h, il = g)
//   4. the j side of du (dl1 summed over the tile's rows i) into
//      dpart_j[tile]; the i side summed in registers over the segment's tiles;
//      the vector weight gradients in registers
//   5. the distance MLP's weight gradients (thread: one feature, 32 pairs),
//      in the next tile's iteration, after its first barrier
// Every sum is taken in a fixed order and nothing is added atomically.
__global__ void __launch_bounds__(kThreads, 1)
ncsn_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                const float* __restrict__ sel, const float* __restrict__ sigma,
                const float* __restrict__ u, const float* __restrict__ grows,
                HeadWeights W, const int* __restrict__ list,
                const int* __restrict__ total_p, float* __restrict__ dpart_j,
                float* __restrict__ dpart_i, float* __restrict__ part, int n,
                float anneal) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W2_s = smem + kBOffW2;
  float* l1_s = smem + kBOffL1;
  float* dx2_s = smem + kBOffDx2;
  float* wd1_s = smem + kBOffVec;
  float* bd1_s = wd1_s + kE;
  float* wd2_s = bd1_s + kE;
  float* wod_s = wd2_s + kE;
  float* bod_s = wod_s + kE;
  float* b2_s = bod_s + kE;
  float* w3_s = b2_s + kH;
  float* dp_s = smem + kBOffPair;    // [2][64]
  float* dde_s = dp_s + 2 * kPairs;  // [2][64][4]
  float* demb_s = dde_s + 8 * kPairs;
  float* sr_s = demb_s + kPairs;     // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (n + kTile - 1) / kTile;
  const long long total = *total_p;
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  const float bd2 = W.bd2[0], b3 = W.b3[0];

  // W2 split once into its TF32 parts: the B operand of l1 W2 and dx2 W2^T
  for (int c = tid; c < kE * kH / 4; c += kThreads) {
    const int r = c / (kH / 4), f = (c % (kH / 4)) * 4;
    const float4 w = *reinterpret_cast<const float4*>(W.w2 + r * kH + f);
    float4 hi, lo;
    split_b(w.x, hi.x, lo.x);
    split_b(w.y, hi.y, lo.y);
    split_b(w.z, hi.z, lo.z);
    split_b(w.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(W2_s + swz_at(kH, r, f)) = hi;
    *reinterpret_cast<float4*>(W2_s + kW2Lo + swz_at(kH, r, f)) = lo;
  }
  if (tid < kE) {
    wd1_s[tid] = W.wd1[tid];
    bd1_s[tid] = W.bd1[tid];
    wd2_s[tid] = W.wd2[tid];
    wod_s[tid] = W.wod[tid];
    bod_s[tid] = W.bod[tid];
    if (tid < kH) {
      b2_s[tid] = W.b2[tid];
      w3_s[tid] = W.w3[tid];
    }
  }

  // this block's share of the weight gradients over its run
  float gw2[2][4][4];  // dW2 rows 32*(warp&3) + 16*mb + 8*h + g, columns 32*(warp>>2) + 8*nb + 2*t + c
  float gw3[4][2], gb2[4][2];  // columns h = 32*(warp>>2) + 8*nb + 2*t + c
  float gwod[4][2], gbod[4][2];  // columns e = 32*(warp>>1) + 8*nb + 2*t + c
  float racc[4][2];  // du rows i (il = g) of the segment, the same columns
  // feature tid & 127: d w_d2, and d w_d1 and d b_d1 over w_d2
  float gwd1 = 0.f, gbd1 = 0.f, gwd2 = 0.f;
  float gb3 = 0.f, gbd2 = 0.f;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      gw3[nb][c] = gb2[nb][c] = gwod[nb][c] = gbod[nb][c] = racc[nb][c] = 0.f;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int q = 0; q < 4; ++q) gw2[mb][nb][q] = 0.f;
  }

  // issues the cp.async loads of listed tile v into buffer buf: dist,
  // noise, sel, the row cotangents, and the u rows of its j and i tiles
  auto load_tile = [&](int v, int buf) {
    const int item = v / nt, pj = v - item * nt, b = item / nt;
    const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
    if (tid < 3 * kPairs) {
      const int p = tid & (kPairs - 1), q = tid >> 6, i = i0 + (p >> 3), j = j0 + (p & 7);
      const bool in = i < n && j < n;
      const float* src = q == 0 ? dist : (q == 1 ? noise : sel);
      cp_async4(smem + kBOffGrid + (3 * buf + q) * kPairs + p,
                src + (in ? ((size_t)b * n + i) * n + j : 0), in);
    } else if (tid < 3 * kPairs + kTile) {
      const int i = i0 + tid - 3 * kPairs;
      cp_async4(smem + kBOffGi + buf * kTile + tid - 3 * kPairs,
                grows + (i < n ? (size_t)b * n + i : 0), i < n);
    } else if (tid == 3 * kPairs + kTile) {
      cp_async4(smem + kBOffGi + 2 * kTile + buf, sigma + b, true);
    }
    for (int c = tid; c < 2 * kTile * kE / 4; c += kThreads) {
      const int side = c / (kTile * kE / 4), r = (c / (kE / 4)) % kTile;
      const int f = (c % (kE / 4)) * 4, a = (side ? i0 : j0) + r;
      cp_async16(smem + kBOffU + ((2 * buf + side) * kTile + r) * kBS + f,
                 u + (a < n ? ((size_t)b * n + a) * kE + f : 0), a < n);
    }
    cp_async_commit();
  };

  int cur = t_begin < t_end ? list[t_begin] / nt : 0;  // the item racc sums
  // writes this warp's half of the segment's i side to dpart_i and zeroes
  // racc: segment (item cur, this block) is slot cur + blockIdx.x
  auto flush = [&]() {
    float* dst = dpart_i + ((size_t)(cur + blockIdx.x) * 2 + (warp & 1)) * kTileRows + g * kE;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      *reinterpret_cast<float2*>(dst + 32 * (warp >> 1) + 8 * nb + 2 * t) =
          make_float2(racc[nb][0], racc[nb][1]);
      racc[nb][0] = racc[nb][1] = 0.f;
    }
  };

  // 5. the distance MLP of the tile in buffer pb: feature tid & 127 over
  // pairs 32*(tid >> 7)..
  // (d b_d1 and d w_d1 are w_d2 times sum_p [t1 > 0] ddemb (dp); the sums
  // are scaled once, at the end)
  auto dist_mlp = [&](int pb) {
    const int e = tid & (kE - 1), p0 = 32 * (tid >> 7);
    const float w1e = wd1_s[e], b1e = bd1_s[e];
    const float4* dd_t = reinterpret_cast<const float4*>(dde_s) + pb * kPairs;
    const float* dp_t = dp_s + pb * kPairs;
#pragma unroll 8
    for (int p = p0; p < p0 + 32; ++p) {
      const float4 d4 = dd_t[p];
      const float dd = d4.x + d4.y + d4.z + d4.w;
      const float dp = dp_t[p];
      const float t1 = fmaf(dp, w1e, b1e);
      if (t1 > 0.f) {
        gwd2 = fmaf(t1, dd, gwd2);
        gwd1 = fmaf(dd, dp, gwd1);
        gbd1 += dd;
      }
      if (e == 0) gbd2 += dd;
    }
  };

  int v = t_begin < t_end ? list[t_begin] : 0;
  if (t_begin < t_end) load_tile(v, 0);
  for (int k = t_begin; k < t_end; ++k) {
    const int v_next = k + 1 < t_end ? list[k + 1] : 0;
    const int item = v / nt;
    const int buf = (k - t_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k's data (and W2) have landed; every warp is
                      // done with tile k - 1 but its distance MLP
    if (k + 1 < t_end) load_tile(v_next, buf ^ 1);
    if (item != cur) {  // block-uniform: the run moves to the next row tile
      flush();
      cur = item;
    }
    if (k > t_begin) dist_mlp(buf ^ 1);
    const float* d_t = smem + kBOffGrid + 3 * buf * kPairs;  // [il][jl]
    const float* nz_t = d_t + kPairs;
    const float* sel_t = nz_t + kPairs;
    const float* gi_t = smem + kBOffGi + buf * kTile;
    const float* uj_t = smem + kBOffU + 2 * buf * kTile * kBS;
    const float* ui_t = uj_t + kTile * kBS;
    const float sig = smem[kBOffGi + 2 * kTile + buf], wsig = expf(anneal * logf(sig));

    // 1. dp and demb: four threads per pair, features 4*(q + 4m) + c; then l1
    {
      const int p = tid >> 2, q = tid & 3, at = (p & 7) * kTile + (p >> 3);
      const float dp = fmaf(nz_t[at], sig, d_t[at]);
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kE / 16; ++m) {
        const int e = 4 * (q + 4 * m);
        const float4 w1 = ld4(wd1_s + e), b1 = ld4(bd1_s + e), w2 = ld4(wd2_s + e);
        s = fmaf(fmaxf(fmaf(dp, w1.x, b1.x), 0.f), w2.x, s);
        s = fmaf(fmaxf(fmaf(dp, w1.y, b1.y), 0.f), w2.y, s);
        s = fmaf(fmaxf(fmaf(dp, w1.z, b1.z), 0.f), w2.z, s);
        s = fmaf(fmaxf(fmaf(dp, w1.w, b1.w), 0.f), w2.w, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) {
        dp_s[buf * kPairs + p] = dp;
        demb_s[p] = s + bd2;
      }
    }
    __syncthreads();
    {  // warp w: pairs p = jl*8 + w (il = w), lane: features 4*lane..
      const int e = 4 * lane;
      const float4 a = ld4(ui_t + warp * kBS + e), wo = ld4(wod_s + e), bo = ld4(bod_s + e);
#pragma unroll 4
      for (int jl = 0; jl < kTile; ++jl) {
        const int p = jl * kTile + warp;
        const float4 bj = ld4(uj_t + jl * kBS + e);
        const float de = demb_s[p];
        *reinterpret_cast<float4*>(l1_s + swz_at(kE, p, e)) =
            make_float4(fmaxf(a.x + bj.x + fmaf(de, wo.x, bo.x), 0.f),
                        fmaxf(a.y + bj.y + fmaf(de, wo.y, bo.y), 0.f),
                        fmaxf(a.z + bj.z + fmaf(de, wo.z, bo.z), 0.f),
                        fmaxf(a.w + bj.w + fmaf(de, wo.w, bo.w), 0.f));
      }
    }
    __syncthreads();

    // 2. pre2 = l1 W2 + b2; the score's partial sums over this warp's columns
    const int wq = warp & 3, wh = warp >> 2;
    float p2[1][4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) p2[0][nb][q] = 0.f;
    warp_tile_mma<1, 4, kE, false, false, false, true, kW2Lo>(p2, l1_s, kE, 16 * wq, W2_s, kH,
                                                              32 * wh);
    {
      float sr[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = 32 * wh + 8 * nb + 2 * t + (q & 1);
          p2[0][nb][q] += b2_s[h];
          sr[q >> 1] = fmaf(fmaxf(p2[0][nb][q], 0.f), w3_s[h], sr[q >> 1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float s = quad_sum(sr[hh]);
        if (t == 0) sr_s[wh * kPairs + 16 * wq + 8 * hh + g] = s;
      }
    }
    __syncthreads();
    // ds = d loss / d score_raw per pair; dx2 = relu'(pre2) ds w3 into dx2_s
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = 16 * wq + 8 * hh + g, at = (p & 7) * kTile + (p >> 3);
      const float r = (sr_s[p] + sr_s[kPairs + p] + b3) / sig + nz_t[at] / sig;
      const float ds = r * (wsig * gi_t[p & 7]) * sel_t[at] / sig;
      if (wh == 0 && t == 0) gb3 += ds;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int h = 32 * wh + 8 * nb + 2 * t;
        float dx[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pre = p2[0][nb][2 * hh + c];
          gw3[nb][c] = fmaf(fmaxf(pre, 0.f), ds, gw3[nb][c]);
          dx[c] = pre > 0.f ? ds * w3_s[h + c] : 0.f;
          gb2[nb][c] += dx[c];
        }
        store2(dx2_s, kH, p, h, dx[0], dx[1]);
      }
    }
    __syncthreads();

    // 3. dW2 += l1^T dx2: the tile's product, added to the run's sum in f32
    // (the tensor core's truncating accumulator would drift over a run),
    // then dl1 = dx2 W2^T
    {
      float t3[2][4][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) t3[mb][nb][q] = 0.f;
      warp_tile_mma<2, 4, kPairs, true, false>(t3, l1_s, kE, 32 * wq, dx2_s, kH, 32 * wh);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) gw2[mb][nb][q] += t3[mb][nb][q];
    }
    const int wm = warp & 1, wn = warp >> 1;
    float dl[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) dl[mb][nb][q] = 0.f;
    warp_tile_mma<2, 4, kH, false, true, false, false, kW2Lo>(dl, dx2_s, kH, 32 * wm, W2_s, kH,
                                                              32 * wn);

    // 4. relu'(l1); du's i side (rows il = g), the vector weight gradients,
    // ddemb's partial sums over this warp's columns; the j side per tile
    float vj[32];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 32 * wm + 16 * mb + 8 * hh + g;
        const float de = demb_s[p];
        float s = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int e = 32 * wn + 8 * nb + 2 * t;
          const float2 l1 = load2(l1_s, kE, p, e);
          const float v0 = l1.x > 0.f ? dl[mb][nb][2 * hh] : 0.f;
          const float v1 = l1.y > 0.f ? dl[mb][nb][2 * hh + 1] : 0.f;
          racc[nb][0] += v0;
          racc[nb][1] += v1;
          gwod[nb][0] = fmaf(v0, de, gwod[nb][0]);
          gwod[nb][1] = fmaf(v1, de, gwod[nb][1]);
          gbod[nb][0] += v0;
          gbod[nb][1] += v1;
          s = fmaf(v0, wod_s[e], fmaf(v1, wod_s[e + 1], s));
          vj[16 * mb + 8 * hh + 2 * nb] = v0;
          vj[16 * mb + 8 * hh + 2 * nb + 1] = v1;
        }
        s = quad_sum(s);
        if (t == 0) dde_s[(buf * kPairs + p) * 4 + wn] = s;
      }
    rs_lanes<2>(vj);  // summed over the tile's 8 rows i
    {
      float* dst = dpart_j + (size_t)k * kTileRows;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * g + q, jl = 4 * wm + (e >> 3);
        __stcg(dst + jl * kE + 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1), vj[q]);
      }
    }
    v = v_next;
  }
  if (t_begin < t_end) {
    flush();
    __syncthreads();  // the last tile's ddemb is complete
    dist_mlp((t_end - 1 - t_begin) & 1);
  }

  // this block's partial weight gradients, each a sum in a fixed order
  __syncthreads();  // the tile scratch is free
  float* out = part + (size_t)blockIdx.x * kWgrad;
  {
    const int wq = warp & 3, wh = warp >> 2;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 32 * wq + 16 * mb + 8 * hh + g, h = 32 * wh + 8 * nb + 2 * t;
          out[kOffW2 + e * kH + h] = gw2[mb][nb][2 * hh];  // kOffW2 is odd
          out[kOffW2 + e * kH + h + 1] = gw2[mb][nb][2 * hh + 1];
        }
  }
  // the vectors: over the 8 lanes of one t, then over the warps in order
  float* red_s = l1_s;  // [4][kH] w3, [4][kH] b2, [2][kE] wod, [2][kE] bod,
                        // [2][kE] wd1, bd1, wd2; [4] b3; [2] bd2
  float* r_w3 = red_s;
  float* r_b2 = r_w3 + 4 * kH;
  float* r_wod = r_b2 + 4 * kH;
  float* r_bod = r_wod + 2 * kE;
  float* r_wd1 = r_bod + 2 * kE;
  float* r_bd1 = r_wd1 + 2 * kE;
  float* r_wd2 = r_bd1 + 2 * kE;
  float* r_b3 = r_wd2 + 2 * kE;
  float* r_bd2 = r_b3 + 4;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float a[4] = {gw3[nb][c], gb2[nb][c], gwod[nb][c], gbod[nb][c]};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) a[q] += __shfl_xor_sync(0xffffffffu, a[q], off);
      if (g == 0) {
        const int h = 32 * (warp >> 2) + 8 * nb + 2 * t + c;
        const int e = 32 * (warp >> 1) + 8 * nb + 2 * t + c;
        r_w3[(warp & 3) * kH + h] = a[0];
        r_b2[(warp & 3) * kH + h] = a[1];
        r_wod[(warp & 1) * kE + e] = a[2];
        r_bod[(warp & 1) * kE + e] = a[3];
      }
    }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) gb3 += __shfl_xor_sync(0xffffffffu, gb3, off);
  if (lane == 0 && warp < 4) r_b3[warp] = gb3;
  r_wd1[tid] = gwd1 * wd2_s[tid & (kE - 1)];  // [tid >> 7][tid & 127]
  r_bd1[tid] = gbd1 * wd2_s[tid & (kE - 1)];
  r_wd2[tid] = gwd2;
  if ((tid & (kE - 1)) == 0) r_bd2[tid >> 7] = gbd2;
  __syncthreads();
  if (tid < kH) {
    out[kOffW3 + tid] = r_w3[tid] + r_w3[kH + tid] + r_w3[2 * kH + tid] + r_w3[3 * kH + tid];
    out[kOffB2 + tid] = r_b2[tid] + r_b2[kH + tid] + r_b2[2 * kH + tid] + r_b2[3 * kH + tid];
  }
  if (tid < kE) {
    out[kOffWod + tid] = r_wod[tid] + r_wod[kE + tid];
    out[kOffBod + tid] = r_bod[tid] + r_bod[kE + tid];
    out[kOffWd1 + tid] = r_wd1[tid] + r_wd1[kE + tid];
    out[kOffBd1 + tid] = r_bd1[tid] + r_bd1[kE + tid];
    out[kOffWd2 + tid] = r_wd2[tid] + r_wd2[kE + tid];
  }
  if (tid == 0) {
    out[kOffB3] = r_b3[0] + r_b3[1] + r_b3[2] + r_b3[3];
    out[kOffBd2] = r_bd2[0] + r_bd2[1];
  }
}

// du of rows i0.. of graph b (block (pi, b), one float4 a thread): the i
// side's segment partials of item (b, pi) in list order, then the j sides
// of the tiles (qi, pi) of graph b in order of qi. `blocks` is the grid of
// ncsn_bwd_kernel.
__global__ void __launch_bounds__(kThreads)
ncsn_du_kernel(const float* __restrict__ dpart_j, const float* __restrict__ dpart_i,
               const int* __restrict__ pre, const int* __restrict__ pos,
               float* __restrict__ du, int n, int blocks) {
  const int pi = blockIdx.x, b = blockIdx.y, nt = gridDim.x, item = b * nt + pi;
  const int r = threadIdx.x >> 5, f = (threadIdx.x & 31) * 4;
  const long long total = pre[gridDim.y * nt];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float* src) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + r * kE + f));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  };
  const int t0 = pre[item], t1 = pre[item + 1];
  if (t1 > t0) {
    // the blocks whose runs hold tiles t0 .. t1 - 1: from the last block
    // starting at or before t0 (blocks with empty runs wrote nothing)
    int k = (int)(((long long)(t0 + 1) * blocks + total - 1) / total) - 1;
    for (; k < blocks && run_begin(total, blocks, k) < t1; ++k) {
      if (run_begin(total, blocks, k + 1) == run_begin(total, blocks, k)) continue;
      add(dpart_i + ((size_t)(item + k) * 2) * kTileRows);
      add(dpart_i + ((size_t)(item + k) * 2 + 1) * kTileRows);
    }
  }
  for (int qi = 0; qi < nt; ++qi) {
    const int p = pos[((size_t)b * nt + qi) * nt + pi];
    if (p >= 0) add(dpart_j + (size_t)p * kTileRows);
  }
  const int i = pi * kTile + r;
  if (i < n) *reinterpret_cast<float4*>(du + ((size_t)b * n + i) * kE + f) = s;
}

static size_t fwd_smem_bytes(int n) {
  return sizeof(float) * (size_t)kHeadSmemFloats + sizeof(int) * (size_t)((n + kTile - 1) / kTile);
}
static size_t bwd_smem_bytes() { return sizeof(float) * (size_t)kBwdFloats; }

static HeadWeights head(const float* wd1, const float* bd1, const float* wd2,
                        const float* bd2, const float* wod, const float* bod,
                        const float* w2, const float* b2, const float* w3,
                        const float* b3) {
  return HeadWeights{wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3};
}

}  // namespace geossl

extern "C" size_t ncsn_fwd_smem_bytes(int n) { return geossl::fwd_smem_bytes(n); }
extern "C" size_t ncsn_bwd_smem_bytes() { return geossl::bwd_smem_bytes(); }
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

// Ints of the backward's workspace: the tile list over sel (worklist.cuh).
extern "C" size_t ncsn_bwd_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::tile_list_ints((size_t)B * nt, nt);
}

// Floats of the backward's du partials: the j side of every tile that could
// be listed, then the i side of every possible (block, item) segment.
extern "C" size_t ncsn_bwd_dpart_floats(int B, int n) {
  const size_t nt = (n + geossl::kTile - 1) / geossl::kTile, items = (size_t)B * nt;
  return (items * nt + 2 * (items + (size_t)ncsn_bwd_blocks(B, n))) * geossl::kTileRows;
}

// Backward: du [B, n, E], and the ten weight gradients into `wgrad`
// (ncsn_wgrad_size() floats, in the order of the offsets above). `ws` holds
// ncsn_bwd_ws_ints(B, n) ints, `dpart` ncsn_bwd_dpart_floats(B, n) floats
// (written only where a tile or segment is listed), `part`
// ncsn_bwd_blocks(B, n) rows of ncsn_wgrad_size() floats. Returns the
// cudaError_t of the launches. No atomics: the result is the same from run
// to run on one card.
extern "C" int ncsn_score_bwd(const float* dist, const float* noise, const float* sel,
                              const float* sigma, const float* u, const float* grows,
                              const float* wd1, const float* bd1, const float* wd2,
                              const float* bd2, const float* wod, const float* bod,
                              const float* w2, const float* b2, const float* w3,
                              const float* b3, float* du, float* dpart, float* part,
                              float* wgrad, int* ws, int B, int n, int E, float anneal,
                              void* stream) {
  using namespace geossl;
  if (E != kE) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes();
  const int blocks = ncsn_bwd_blocks(B, n), nt = (n + kTile - 1) / kTile, items = B * nt;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = make_tile_list<false>(sel, ws, B, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  const int* pos = list + (size_t)items * nt;
  float* dpart_j = dpart;
  float* dpart_i = dpart + (size_t)items * nt * kTileRows;
  err = cudaFuncSetAttribute(ncsn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ncsn_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, noise, sel, sigma, u, grows, head(wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3),
      list, pre + items, dpart_j, dpart_i, part, n, anneal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ncsn_du_kernel<<<dim3(nt, B), kThreads, 0, s>>>(dpart_j, dpart_i, pre, pos, du, n, blocks);
  sum_partials(part, blocks, kWgrad, wgrad, s);
  return (int)cudaGetLastError();
}
