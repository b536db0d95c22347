// ncsn_score_wide: the DDM score-matching head (NCSN_version_03) per pair at
// any head width E above 256, forward and backward, streamed over E.
//
// Replaces geossl_tpu/ops/ncsn_pallas.py: _fwd_kernel and _bwd_kernel
// (ncsn_score_loss) for heads wider than ncsn_score.cu's two fixed-width
// instances (E = 128 and 256). The math is that file's (the header there):
//   dp = dist + noise sigma, demb = relu(dp w_d1 + b_d1) . w_d2 + b_d2,
//   l1 = relu(u_i + u_j + demb w_od + b_od) [E], x2 = relu(l1 W2 + b2) [H],
//   score = (x2 . w3 + b3) / sigma, loss = 1/2 (score + noise / sigma)^2
//   sigma^anneal sel; the forward writes the row sums, the backward du and
// the ten weight gradients for their cotangent.
//
// Why its own instance. ncsn_score.cu holds a tile's l1 [64][E] whole (its
// forward two tiles of it: 128 KiB at E = 256, 256 KiB at 512, above a
// block's 227 KiB). Here E is a runtime width, a multiple of 128 (the
// wrapper pads, ops/ncsn.pad_head: exact), and no buffer grows with it.
// Everything in the head is per column or linear in l1, so E streams in
// 128-column chunks ec and H in 64-column groups hg:
// - demb: one pass over all of E, elementwise (four threads a pair);
// - per hg: pre2_hg = sum over ec of l1_ec W2[ec, hg], l1_ec regenerated from
//   the u rows for each chunk (never all of l1), each chunk's product in a
//   zeroed fragment added to the sum in f32; then relu(pre2_hg + b2) . w3
//   into the score. Exact: relu acts per column of pre2.
// - backward: the score needs every group, and dx2 = relu'(pre2) ds w3 needs
//   the score, so the groups' pre2 are kept (each thread its own fragments,
//   in a device scratch row of its own) while the score is formed; then per
//   hg: dx2_hg, its column sums (b2, w3), and a second pass over the chunks:
//   l1_ec again, dW2[ec, hg] += l1_ec^T dx2_hg and dl1_ec = dx2_hg W2[ec, hg]^T
//   masked by relu'(l1_ec), whose contributions to du_i, du_j, w_od, b_od and
//   ddemb are linear in it and are added chunk by chunk: no full-width dl1.
//   ddemb then feeds the distance MLP's gradients.
// W2 is split once per launch into its TF32 parts (ncsn_wide_split_kernel:
// 128 x 64 pieces, high then low part, swizzled), and each (ec, hg) step
// copies its piece (64 KiB) into shared memory: both products read it there,
// the backward's dl1 transposed with ldmatrix.
//
// Products: mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh), as the fixed
// instances: the forward's l1 W2 in the plain split, the backward's in the
// precise mode; dW2's and dl1's as the E = 256 instance's. The tile list,
// the run split, the row partials (forward) and the du partials (backward)
// are ncsn_score.cu's; the weight gradients and du's partials are summed in
// each block's own rows by read-modify-write, each element by the one thread
// that owns it, and the rows in block order by reduce.cuh. No atomics: every
// output is bitwise the same from run to run on one card.
//
// Bound on the H100: operations, as the fixed instances (per selected pair
// 2 E H FLOP forward, 6 E H backward, beside elementwise terms of order E).
// This first, simple instance runs one tile at a time with no copy in flight
// and regenerates l1 for every (ec, hg) step (H / 64 times per tile and
// pass); its time is in PERF.md (rows 6x / 7x).
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {
namespace nwide {

constexpr int kEC = 128;             // columns of an E chunk (l1, u, W2's rows)
constexpr int kHG = 64;              // columns of an H group (pre2, W2's columns)
constexpr int kPiece = kEC * kHG;    // floats of one TF32 part of a W2 piece
constexpr int kUS = kEC + 8;         // row stride of the 8-row u tiles (bank spread)
constexpr int kTileRows = kTile;     // rows of a du partial (its width is E)

struct HeadWeights {
  const float *wd1, *bd1, *wd2, *bd2, *wod, *bod, *w2, *b2, *w3, *b3;
};

// Offsets of the ten weight gradients in a partial row (ncsn_score.cu's order):
// [w_d1 E][b_d1 E][w_d2 E][b_d2 1][w_od E][b_od E][w2 E*H][b2 H][w3 H][b3 1]
struct Offsets {
  int wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3, size;
  __host__ __device__ explicit Offsets(int E) {
    const int H = E / 2;
    wd1 = 0, bd1 = E, wd2 = 2 * E, bd2 = 3 * E, wod = 3 * E + 1, bod = 4 * E + 1;
    w2 = 5 * E + 1, b2 = w2 + E * H, w3 = b2 + H, b3 = w3 + H, size = b3 + 1;
  }
};

// shared memory, in floats
constexpr int kOffL1 = 0;                          // [kPairs][kEC] swizzled: l1 of chunk ec
constexpr int kOffW2 = kOffL1 + kPairs * kEC;      // [2][kEC][kHG] swizzled: the piece, hi, lo
constexpr int kOffDx2 = kOffW2 + 2 * kPiece;       // [kPairs][kHG] swizzled: dx2 of group hg
constexpr int kOffX2 = kOffDx2 + kPairs * kHG;     // [kPairs][kHG] relu(pre2) ds
constexpr int kOffU = kOffX2 + kPairs * kHG;       // [2][8][kUS] u rows of chunk ec: j, i
constexpr int kOffVec = kOffU + 2 * kTile * kUS;   // w_od, b_od of chunk ec [2][kEC]
constexpr int kOffGrid = kOffVec + 2 * kEC;        // [3][64] dist, noise, sel, [il][jl]
constexpr int kOffGi = kOffGrid + 3 * kPairs;      // [8] row cotangents, [4] sigma
constexpr int kOffPair = kOffGi + kTile + 4;       // per pair: dp, demb, score, ds, ddemb
constexpr int kOffSr = kOffPair + 5 * kPairs;      // [2][64] score partials, column halves
constexpr int kOffDde = kOffSr + 2 * kPairs;       // [4][64] ddemb partials, column quarters
constexpr int kOffRed = kOffDde + 4 * kPairs;      // [2 warp rows][2][kEC] w_od, b_od sums
constexpr int kSmemFloats = kOffRed + 4 * kEC;

// W2 [E][H] split into its TF32 parts (split_b), piece (ec, hg) at
// (ec * H / kHG + hg) * 2 * kPiece: its high parts [kEC][kHG] swizzled,
// then its low parts.
__global__ void __launch_bounds__(kThreads)
ncsn_wide_split_kernel(const float* __restrict__ w2, float* __restrict__ w2s, int E) {
  const int H = E / 2;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= E * H) return;
  const int r = idx / H, h = idx - r * H;
  const size_t q = (size_t)(r / kEC) * (H / kHG) + h / kHG;
  float hi, lo;
  split_b(w2[idx], hi, lo);
  float* piece = w2s + q * 2 * kPiece;
  piece[swz_at(kHG, r % kEC, h % kHG)] = hi;
  piece[kPiece + swz_at(kHG, r % kEC, h % kHG)] = lo;
}

// The grids (dist, noise, sel [il][jl]), sigma and, for the backward, the
// row cotangents of list entry v into shared memory. Every thread calls it.
__device__ __forceinline__ void load_grids(float* smem, const float* dist, const float* noise,
                                           const float* sel, const float* sigma,
                                           const float* grows, int v, int n) {
  const int nt = (n + kTile - 1) / kTile, tid = threadIdx.x;
  const int item = v / nt, pj = v - item * nt, b = item / nt;
  const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
  if (tid < 3 * kPairs) {
    const int p = tid & (kPairs - 1), q = tid >> 6, i = i0 + (p >> 3), j = j0 + (p & 7);
    const float* src = q == 0 ? dist : (q == 1 ? noise : sel);
    smem[kOffGrid + q * kPairs + p] = i < n && j < n ? src[((size_t)b * n + i) * n + j] : 0.f;
  } else if (tid < 3 * kPairs + kTile) {
    const int r = tid - 3 * kPairs, i = i0 + r;
    smem[kOffGi + r] = grows && i < n ? grows[(size_t)b * n + i] : 0.f;
  } else if (tid == 3 * kPairs + kTile) {
    smem[kOffGi + kTile] = sigma[b];
  }
}

// Chunk ec of the tile of list entry v: its W2 piece (ec, hg), the u rows of
// its j and i tiles, w_od and b_od; then (after a barrier) l1_ec into l1_s.
// Every thread calls it; it ends with a barrier (l1_s and the piece visible).
__device__ __forceinline__ void load_chunk(float* smem, const float* __restrict__ u,
                                           const HeadWeights& W, const float* __restrict__ w2s,
                                           int v, int n, int E, int ec, int hg) {
  const int nt = (n + kTile - 1) / kTile, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = v / nt, pj = v - item * nt, b = item / nt;
  const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
  const float4* piece = reinterpret_cast<const float4*>(
      w2s + ((size_t)ec * (E / 2 / kHG) + hg) * 2 * kPiece);
  float4* w2_s = reinterpret_cast<float4*>(smem + kOffW2);
  for (int c = tid; c < 2 * kPiece / 4; c += kThreads) w2_s[c] = __ldg(piece + c);
  for (int c = tid; c < 2 * kTile * kEC / 4; c += kThreads) {
    const int side = c / (kTile * kEC / 4), r = (c / (kEC / 4)) % kTile;
    const int f = (c % (kEC / 4)) * 4, a = (side ? i0 : j0) + r;
    *reinterpret_cast<float4*>(smem + kOffU + (side * kTile + r) * kUS + f) =
        a < n ? __ldg(reinterpret_cast<const float4*>(u + ((size_t)b * n + a) * E + ec * kEC + f))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < kEC) {
    smem[kOffVec + tid] = W.wod[ec * kEC + tid];
    smem[kOffVec + kEC + tid] = W.bod[ec * kEC + tid];
  }
  __syncthreads();
  // warp w: pairs p = jl*8 + w (il = w); lane: features 4*lane..
  const float* uj_t = smem + kOffU;
  const float* ui_t = uj_t + kTile * kUS;
  const int f = 4 * lane;
  const float4 a = ld4(ui_t + warp * kUS + f), wo = ld4(smem + kOffVec + f),
               bo = ld4(smem + kOffVec + kEC + f);
  const float* demb_s = smem + kOffPair + kPairs;
#pragma unroll 4
  for (int jl = 0; jl < kTile; ++jl) {
    const int p = jl * kTile + warp;
    const float4 bj = ld4(uj_t + jl * kUS + f);
    const float de = demb_s[p];
    *reinterpret_cast<float4*>(smem + kOffL1 + swz_at(kEC, p, f)) =
        make_float4(fmaxf(a.x + bj.x + fmaf(de, wo.x, bo.x), 0.f),
                    fmaxf(a.y + bj.y + fmaf(de, wo.y, bo.y), 0.f),
                    fmaxf(a.z + bj.z + fmaf(de, wo.z, bo.z), 0.f),
                    fmaxf(a.w + bj.w + fmaf(de, wo.w, bo.w), 0.f));
  }
  __syncthreads();
}

// The tile's score sums (score_s, before b3 and sigma) from its grids in
// shared memory: dp and demb, then per H group the streamed pre2 (kBwd: in
// the precise mode, kept in this thread's scratch row `keep`, b2 added).
// Every thread calls it; on return score_s is complete.
template <bool kBwd>
__device__ __forceinline__ void tile_scores(float* smem, const float* __restrict__ u,
                                            const HeadWeights& W, const float* __restrict__ w2s,
                                            float* __restrict__ keep, int v, int n, int E) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int H = E / 2, n_ec = E / kEC, n_hg = H / kHG;
  float* dp_s = smem + kOffPair;
  float* demb_s = dp_s + kPairs;
  float* score_s = demb_s + kPairs;
  float* sr_s = smem + kOffSr;
  {  // dp, demb: four threads a pair, features 4 (q + 4 m) + c
    const int p = tid >> 2, q = tid & 3, at = (p & 7) * kTile + (p >> 3);
    const float sig = smem[kOffGi + kTile];
    const float dp = fmaf(smem[kOffGrid + kPairs + at], sig, smem[kOffGrid + at]);
    float s = 0.f;
    for (int m = 0; m < E / 16; ++m) {
      const int e = 4 * (q + 4 * m);
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(W.wd1 + e));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(W.bd1 + e));
      const float4 w2 = __ldg(reinterpret_cast<const float4*>(W.wd2 + e));
      s = fmaf(fmaxf(fmaf(dp, w1.x, b1.x), 0.f), w2.x, s);
      s = fmaf(fmaxf(fmaf(dp, w1.y, b1.y), 0.f), w2.y, s);
      s = fmaf(fmaxf(fmaf(dp, w1.z, b1.z), 0.f), w2.z, s);
      s = fmaf(fmaxf(fmaf(dp, w1.w, b1.w), 0.f), w2.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) {
      dp_s[p] = dp;
      demb_s[p] = s + __ldg(W.bd2);
      score_s[p] = 0.f;
    }
  }
  // warp (wq, wh): pre2 rows 16*wq.., columns 32*wh.. of the group
  const int wq = warp & 3, wh = warp >> 2;
  for (int hg = 0; hg < n_hg; ++hg) {
    float p2[1][4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) p2[0][nb][q] = 0.f;
    for (int ec = 0; ec < n_ec; ++ec) {
      __syncthreads();  // demb complete; every warp done with the previous chunk
      load_chunk(smem, u, W, w2s, v, n, E, ec, hg);
      float part[1][4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[0][nb][q] = 0.f;
      warp_tile_mma<1, 4, kEC, false, false, false, kBwd, kPiece>(
          part, smem + kOffL1, kEC, 16 * wq, smem + kOffW2, kHG, 32 * wh);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) p2[0][nb][q] += part[0][nb][q];
    }
    float sr[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = hg * kHG + 32 * wh + 8 * nb + 2 * t + (q & 1);
        p2[0][nb][q] += __ldg(W.b2 + h);
        sr[q >> 1] = fmaf(fmaxf(p2[0][nb][q], 0.f), __ldg(W.w3 + h), sr[q >> 1]);
      }
    if (kBwd) {
      float4* k4 = reinterpret_cast<float4*>(keep + (size_t)hg * 16);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        k4[nb] = make_float4(p2[0][nb][0], p2[0][nb][1], p2[0][nb][2], p2[0][nb][3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float s = quad_sum(sr[hh]);
      if (t == 0) sr_s[wh * kPairs + 16 * wq + 8 * hh + g] = s;
    }
    __syncthreads();
    if (tid < kPairs) score_s[tid] += sr_s[tid] + sr_s[kPairs + tid];
  }
  __syncthreads();
}

// -- forward -------------------------------------------------------------------

// Block k computes the run [run_begin(k), run_begin(k + 1)) of the tile list
// (items (graph, 8-row i tile)), one tile at a time; the row sums of the run's
// consecutive tiles of one item are summed in registers (threads 0-7: row il)
// and written once per (block, item) segment, at slot item + block.
__global__ void __launch_bounds__(kThreads, 1)
ncsn_wide_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                     const float* __restrict__ sel, const float* __restrict__ sigma,
                     const float* __restrict__ u, HeadWeights W, const float* __restrict__ w2s,
                     const int* __restrict__ list, const int* __restrict__ total_p,
                     float* __restrict__ rpart, int n, int E, float anneal) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int tid = threadIdx.x, nt = (n + kTile - 1) / kTile;
  const long long total = *total_p;
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  if (t_begin >= t_end) return;  // block-uniform: an empty run
  const float b3 = __ldg(W.b3);
  float* loss_s = smem + kOffPair + 3 * kPairs;
  float racc = 0.f;  // threads 0-7: row il = tid of the segment
  int cur = list[t_begin] / nt;
  for (int k = t_begin; k < t_end; ++k) {
    const int v = list[k], item = v / nt;
    if (item != cur) {  // block-uniform: the run moves to the next row tile
      if (tid < kTile) rpart[(size_t)(cur + blockIdx.x) * kTile + tid] = racc;
      racc = 0.f;
      cur = item;
    }
    __syncthreads();  // every warp done with the previous tile
    load_grids(smem, dist, noise, sel, sigma, nullptr, v, n);
    __syncthreads();
    tile_scores<false>(smem, u, W, w2s, nullptr, v, n, E);
    if (tid < kPairs) {
      const int p = tid, at = (p & 7) * kTile + (p >> 3);
      const float sig = smem[kOffGi + kTile], wsig = expf(anneal * logf(sig));
      const float r = (smem[kOffPair + 2 * kPairs + p] + b3) / sig +
                      smem[kOffGrid + kPairs + at] / sig;
      loss_s[p] = 0.5f * r * r * wsig * smem[kOffGrid + 2 * kPairs + at];
    }
    __syncthreads();
    if (tid < kTile) {
      float s = 0.f;
      for (int jl = 0; jl < kTile; ++jl) s += loss_s[jl * kTile + tid];
      racc += s;
    }
  }
  if (tid < kTile) rpart[(size_t)(cur + blockIdx.x) * kTile + tid] = racc;
}

// rows[b, i]: the segment partials of item (b, i / 8) in block order (as
// ncsn_score.cu's ncsn_rows_kernel); zero for a row tile with no listed tile.
__global__ void __launch_bounds__(kThreads)
ncsn_wide_rows_kernel(const float* __restrict__ rpart, const int* __restrict__ pre,
                      float* __restrict__ rows, int B, int n, int blocks) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * n) return;
  const int nt = (n + kTile - 1) / kTile, b = idx / n, i = idx - b * n;
  const int item = b * nt + i / kTile;
  const long long total = pre[B * nt];
  const int t0 = pre[item], t1 = pre[item + 1];
  float s = 0.f;
  if (t1 > t0) {
    for (int k = first_run_block(t0, total, blocks);
         k < blocks && run_begin(total, blocks, k) < t1; ++k) {
      if (run_begin(total, blocks, k + 1) == run_begin(total, blocks, k)) continue;
      s += rpart[(size_t)(item + k) * kTile + (i & (kTile - 1))];
    }
  }
  rows[idx] = s;
}

// -- backward ------------------------------------------------------------------

// Block k computes its run of the tile list, one tile at a time (see the
// header). Its row of `part` (Offsets(E).size floats) holds its weight
// gradients, `keep` its threads' pre2 (kThreads * H / 4 floats); du's
// partials go to dpart_j (slot: list position; [8 rows j][E]) and dpart_i
// (slot item + block, two halves by warp row; [8 rows i][E]), as
// ncsn_score.cu's.
__global__ void __launch_bounds__(kThreads, 1)
ncsn_wide_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                     const float* __restrict__ sel, const float* __restrict__ sigma,
                     const float* __restrict__ u, const float* __restrict__ grows,
                     HeadWeights W, const float* __restrict__ w2s, const int* __restrict__ list,
                     const int* __restrict__ total_p, float* __restrict__ dpart_j,
                     float* __restrict__ dpart_i, float* __restrict__ part,
                     float* __restrict__ keep_all, int n, int E, float anneal) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nt = (n + kTile - 1) / kTile, H = E / 2, n_ec = E / kEC, n_hg = H / kHG;
  const Offsets off(E);
  const long long total = *total_p;
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  float* out = part + (size_t)blockIdx.x * off.size;
  for (int idx = tid; idx < off.size; idx += kThreads) out[idx] = 0.f;
  if (t_begin >= t_end) return;  // block-uniform: an empty run (its row is zero)
  float* keep = keep_all + ((size_t)blockIdx.x * kThreads + tid) * (H / 4);
  float* dx2_s = smem + kOffDx2;
  float* x2_s = smem + kOffX2;
  float* dp_s = smem + kOffPair;
  float* demb_s = dp_s + kPairs;
  float* score_s = demb_s + kPairs;
  float* ds_s = score_s + kPairs;
  float* dde_s = ds_s + kPairs;
  float* dde_p = smem + kOffDde;
  float* red_s = smem + kOffRed;
  const float* l1_s = smem + kOffL1;
  const float b3 = __ldg(W.b3);
  float gb3 = 0.f, gbd2 = 0.f;  // thread 0
  int cur = -1;                 // the item of the segment dpart_i's slot holds
  for (int k = t_begin; k < t_end; ++k) {
    const int v = list[k], item = v / nt;
    const bool seg_first = item != cur;  // block-uniform
    cur = item;
    __syncthreads();  // every warp done with the previous tile
    load_grids(smem, dist, noise, sel, sigma, grows, v, n);
    __syncthreads();
    tile_scores<true>(smem, u, W, w2s, keep, v, n, E);
    if (tid < kPairs) {  // ds = d loss / d score_raw; ddemb's sum starts
      const int p = tid, at = (p & 7) * kTile + (p >> 3);
      const float sig = smem[kOffGi + kTile], wsig = expf(anneal * logf(sig));
      const float r = (score_s[p] + b3) / sig + smem[kOffGrid + kPairs + at] / sig;
      ds_s[p] = r * (wsig * smem[kOffGi + (p & 7)]) * smem[kOffGrid + 2 * kPairs + at] / sig;
      dde_s[p] = 0.f;
    }
    __syncthreads();
    if (tid == 0)
      for (int p = 0; p < kPairs; ++p) gb3 += ds_s[p];
    float* dj = dpart_j + (size_t)k * kTileRows * E;
    float* di = dpart_i + ((size_t)(item + blockIdx.x) * 2 + (warp & 1)) * kTileRows * E;
    const int wq = warp & 3, wh = warp >> 2;  // the pre2 / dW2 layouts
    const int wm = warp & 1, wn = warp >> 1;  // the dl1 layout
    for (int hg = 0; hg < n_hg; ++hg) {
      // dx2 = relu'(pre2) ds w3 into dx2_s, relu(pre2) ds into x2_s
      const float4* k4 = reinterpret_cast<const float4*>(keep + (size_t)hg * 16);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float4 pv = k4[nb];
        const float pre[4] = {pv.x, pv.y, pv.z, pv.w};
        const int hl = 32 * wh + 8 * nb + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 16 * wq + 8 * hh + g;
          const float ds = ds_s[p];
          float d2[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pr = pre[2 * hh + c];
            d2[c] = pr > 0.f ? ds * __ldg(W.w3 + hg * kHG + hl + c) : 0.f;
            x2_s[p * kHG + hl + c] = fmaxf(pr, 0.f) * ds;
          }
          store2(dx2_s, kHG, p, hl, d2[0], d2[1]);
        }
      }
      __syncthreads();  // dx2_s, x2_s complete
      if (tid < 2 * kHG) {  // b2's and w3's column sums, pairs in order
        const int h = tid & (kHG - 1);
        float s = 0.f;
        if (tid < kHG)
          for (int p = 0; p < kPairs; ++p) s += dx2_s[swz_at(kHG, p, h)];
        else
          for (int p = 0; p < kPairs; ++p) s += x2_s[p * kHG + h];
        out[(tid < kHG ? off.b2 : off.w3) + hg * kHG + h] += s;
      }
      for (int ec = 0; ec < n_ec; ++ec) {
        __syncthreads();  // every warp done with the previous chunk (and its sums)
        load_chunk(smem, u, W, w2s, v, n, E, ec, hg);
        // dW2[ec, hg] += l1_ec^T dx2 (warp (wq, wh): rows 32*wq.., columns 32*wh..)
        {
          float t3[2][4][4];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
#pragma unroll
              for (int q = 0; q < 4; ++q) t3[mb][nb][q] = 0.f;
          warp_tile_mma<2, 4, kPairs, true, false>(t3, l1_s, kEC, 32 * wq, dx2_s, kHG, 32 * wh);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int r = ec * kEC + 32 * wq + 16 * mb + 8 * (q >> 1) + g;
                const int h = hg * kHG + 32 * wh + 8 * nb + 2 * t + (q & 1);
                out[off.w2 + (size_t)r * H + h] += t3[mb][nb][q];
              }
        }
        // dl1 = dx2 W2[ec, hg]^T (warp (wm, wn): rows 32*wm.., columns 32*wn..)
        float dl[2][4][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) dl[mb][nb][q] = 0.f;
        warp_tile_mma<2, 4, kHG, false, true, false, false, kPiece>(dl, dx2_s, kHG, 32 * wm,
                                                                    smem + kOffW2, kHG, 32 * wn);
        // relu'(l1): du's i side (rows il = g), w_od, b_od, ddemb's partials; the j side
        const float* wod_s = smem + kOffVec;
        float vj[32], vi[4][2], gwo[4][2], gbo[4][2];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) vi[nb][c] = gwo[nb][c] = gbo[nb][c] = 0.f;
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
              const float2 l1 = load2(l1_s, kEC, p, e);
              const float v0 = l1.x > 0.f ? dl[mb][nb][2 * hh] : 0.f;
              const float v1 = l1.y > 0.f ? dl[mb][nb][2 * hh + 1] : 0.f;
              vi[nb][0] += v0;
              vi[nb][1] += v1;
              gwo[nb][0] = fmaf(v0, de, gwo[nb][0]);
              gwo[nb][1] = fmaf(v1, de, gwo[nb][1]);
              gbo[nb][0] += v0;
              gbo[nb][1] += v1;
              s = fmaf(v0, wod_s[e], fmaf(v1, wod_s[e + 1], s));
              vj[16 * mb + 8 * hh + 2 * nb] = v0;
              vj[16 * mb + 8 * hh + 2 * nb + 1] = v1;
            }
            s = quad_sum(s);
            if (t == 0) dde_p[wn * kPairs + p] = s;
          }
        // du's i side: this block's segment slot, rows il = g (first write of
        // the segment's first tile in group 0)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          float2* d = reinterpret_cast<float2*>(di + (size_t)g * E + ec * kEC + 32 * wn + 8 * nb +
                                                2 * t);
          const float2 old = seg_first && hg == 0 ? make_float2(0.f, 0.f) : *d;
          *d = make_float2(old.x + vi[nb][0], old.y + vi[nb][1]);
        }
        rs_lanes<2>(vj);  // summed over the tile's 8 rows i
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * g + q, jl = 4 * wm + (e >> 3);
          float* d = dj + (size_t)jl * E + ec * kEC + 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
          *d = hg == 0 ? vj[q] : *d + vj[q];
        }
        // w_od's and b_od's column sums: over the 8 lanes of one t, then the
        // two warp rows in order
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float a0 = gwo[nb][c], a1 = gbo[nb][c];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              a0 += __shfl_xor_sync(0xffffffffu, a0, o);
              a1 += __shfl_xor_sync(0xffffffffu, a1, o);
            }
            if (g == 0) {
              const int e = 32 * wn + 8 * nb + 2 * t + c;
              red_s[(wm * 2) * kEC + e] = a0;
              red_s[(wm * 2 + 1) * kEC + e] = a1;
            }
          }
        __syncthreads();  // red_s, dde_p complete
        if (tid < kEC) {
          out[off.wod + ec * kEC + tid] += red_s[tid] + red_s[2 * kEC + tid];
          out[off.bod + ec * kEC + tid] += red_s[kEC + tid] + red_s[3 * kEC + tid];
        } else if (tid < kEC + kPairs) {
          const int p = tid - kEC;
          dde_s[p] += dde_p[p] + dde_p[kPairs + p] + dde_p[2 * kPairs + p] + dde_p[3 * kPairs + p];
        }
      }
      __syncthreads();  // every warp done with dx2_s and x2_s
    }
    __syncthreads();  // ddemb complete
    // the distance MLP's gradients: feature e over the tile's pairs in order
    for (int e = tid; e < E; e += kThreads) {
      const float w1e = __ldg(W.wd1 + e), b1e = __ldg(W.bd1 + e), w2e = __ldg(W.wd2 + e);
      float gw1 = 0.f, gb1 = 0.f, gw2 = 0.f;
      for (int p = 0; p < kPairs; ++p) {
        const float dd = dde_s[p], dp = dp_s[p];
        const float t1 = fmaf(dp, w1e, b1e);
        if (t1 > 0.f) {
          gw2 = fmaf(t1, dd, gw2);
          gw1 = fmaf(dd, dp, gw1);
          gb1 += dd;
        }
      }
      out[off.wd2 + e] += gw2;
      out[off.wd1 + e] += gw1 * w2e;
      out[off.bd1 + e] += gb1 * w2e;
    }
    if (tid == 0)
      for (int p = 0; p < kPairs; ++p) gbd2 += dde_s[p];
  }
  if (tid == 0) {
    out[off.b3] = gb3;
    out[off.bd2] = gbd2;
  }
}

// du of rows i0.. of graph b (block (pi, b)): the i side's segment partials
// of item (b, pi) in block order, then the j sides of the tiles (qi, pi) of
// graph b in order of qi (ncsn_score.cu's ncsn_du_kernel at width E).
__global__ void __launch_bounds__(kThreads)
ncsn_wide_du_kernel(const float* __restrict__ dpart_j, const float* __restrict__ dpart_i,
                    const int* __restrict__ pre, const int* __restrict__ pos,
                    float* __restrict__ du, int n, int E, int blocks) {
  const int pi = blockIdx.x, b = blockIdx.y, nt = gridDim.x, item = b * nt + pi;
  const long long total = pre[gridDim.y * nt];
  const int t0 = pre[item], t1 = pre[item + 1];
  const size_t rows = (size_t)kTileRows * E;
  for (int c = threadIdx.x; c < kTile * E / 4; c += kThreads) {
    const int r = c / (E / 4), f = (c % (E / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float* src) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * E + f));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    };
    if (t1 > t0) {
      for (int k = first_run_block(t0, total, blocks);
           k < blocks && run_begin(total, blocks, k) < t1; ++k) {
        if (run_begin(total, blocks, k + 1) == run_begin(total, blocks, k)) continue;
        add(dpart_i + ((size_t)(item + k) * 2) * rows);
        add(dpart_i + ((size_t)(item + k) * 2 + 1) * rows);
      }
    }
    for (int qi = 0; qi < nt; ++qi) {
      const int p = pos[((size_t)b * nt + qi) * nt + pi];
      if (p >= 0) add(dpart_j + (size_t)p * rows);
    }
    const int i = pi * kTile + r;
    if (i < n) *reinterpret_cast<float4*>(du + ((size_t)b * n + i) * E + f) = s;
  }
}

static cudaError_t split_w2(const float* w2, float* w2s, int E, cudaStream_t s) {
  const int count = E * (E / 2);
  ncsn_wide_split_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(w2, w2s, E);
  return cudaGetLastError();
}

static bool width_ok(int E) { return E >= kEC && E % kEC == 0; }

}  // namespace nwide
}  // namespace geossl

using geossl::nwide::HeadWeights;

// Shared memory of either kernel's block (the same layout): constant in E.
extern "C" size_t ncsn_wide_smem_bytes() {
  return sizeof(float) * (size_t)geossl::nwide::kSmemFloats;
}
extern "C" int ncsn_wide_wgrad_size(int E) { return geossl::nwide::Offsets(E).size; }
// Floats of the split-W2 buffer: both TF32 parts of W2 [E][E/2].
extern "C" size_t ncsn_wide_w2_floats(int E) { return 2 * (size_t)E * (E / 2); }
// Blocks of either kernel's persistent grid (rows of the backward's partials).
extern "C" int ncsn_wide_blocks(int B, int n) {
  return geossl::persistent_blocks(B * ((n + geossl::kTile - 1) / geossl::kTile));
}
extern "C" size_t ncsn_wide_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::tile_list_ints((size_t)B * nt, nt);
}
// Floats of the forward's row partials: 8 rows for every possible (block,
// item) segment.
extern "C" size_t ncsn_wide_rpart_floats(int B, int n) {
  const size_t items = (size_t)B * ((n + geossl::kTile - 1) / geossl::kTile);
  return (items + (size_t)ncsn_wide_blocks(B, n)) * geossl::kTile;
}
// Floats of the backward's du partials at width E: the j side of every tile
// that could be listed, then the i side of every possible (block, item)
// segment, in two halves.
extern "C" size_t ncsn_wide_dpart_floats(int B, int n, int E) {
  const size_t nt = (n + geossl::kTile - 1) / geossl::kTile, items = (size_t)B * nt;
  return (items * nt + 2 * (items + (size_t)ncsn_wide_blocks(B, n))) * geossl::kTile * E;
}
// Floats of the backward's pre2 scratch: each thread of the grid keeps its
// fragments of every H group.
extern "C" size_t ncsn_wide_keep_floats(int B, int n, int E) {
  return (size_t)ncsn_wide_blocks(B, n) * geossl::kThreads * (E / 2 / 4);
}

// Row sums of the annealed loss, rows [B, n], for a head of width E (a
// multiple of 128, at least 128). `ws` holds ncsn_wide_ws_ints(B, n) ints,
// `rpart` ncsn_wide_rpart_floats(B, n) floats, `w2s` ncsn_wide_w2_floats(E).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int ncsn_wide_fwd(const float* dist, const float* noise, const float* sel,
                             const float* sigma, const float* u, const float* wd1,
                             const float* bd1, const float* wd2, const float* bd2,
                             const float* wod, const float* bod, const float* w2, const float* b2,
                             const float* w3, const float* b3, float* rows, float* rpart, int* ws,
                             float* w2s, int B, int n, int E, float anneal, void* stream) {
  using namespace geossl;
  using namespace geossl::nwide;
  if (!width_ok(E)) return (int)cudaErrorInvalidValue;
  const size_t smem = ncsn_wide_smem_bytes();
  const int blocks = ncsn_wide_blocks(B, n), nt = (n + kTile - 1) / kTile, items = B * nt;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = make_tile_list<false>(sel, ws, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  err = split_w2(w2, w2s, E, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  err = cudaFuncSetAttribute(ncsn_wide_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ncsn_wide_fwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, noise, sel, sigma, u, HeadWeights{wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3}, w2s,
      list, pre + items, rpart, n, E, anneal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ncsn_wide_rows_kernel<<<(B * n + kThreads - 1) / kThreads, kThreads, 0, s>>>(rpart, pre, rows,
                                                                                B, n, blocks);
  return (int)cudaGetLastError();
}

// Backward: du [B, n, E] and the ten weight gradients into `wgrad`
// (ncsn_wide_wgrad_size(E) floats, in ncsn_score.cu's order). `ws` holds
// ncsn_wide_ws_ints(B, n) ints, `dpart` ncsn_wide_dpart_floats(B, n, E),
// `part` ncsn_wide_blocks(B, n) rows of ncsn_wide_wgrad_size(E) floats,
// `keep` ncsn_wide_keep_floats(B, n, E), `w2s` ncsn_wide_w2_floats(E).
// Returns the cudaError_t of the launches.
extern "C" int ncsn_wide_bwd(const float* dist, const float* noise, const float* sel,
                             const float* sigma, const float* u, const float* grows,
                             const float* wd1, const float* bd1, const float* wd2,
                             const float* bd2, const float* wod, const float* bod, const float* w2,
                             const float* b2, const float* w3, const float* b3, float* du,
                             float* dpart, float* part, float* wgrad, float* keep, int* ws,
                             float* w2s, int B, int n, int E, float anneal, void* stream) {
  using namespace geossl;
  using namespace geossl::nwide;
  if (!width_ok(E)) return (int)cudaErrorInvalidValue;
  const size_t smem = ncsn_wide_smem_bytes();
  const int blocks = ncsn_wide_blocks(B, n), nt = (n + kTile - 1) / kTile, items = B * nt;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = make_tile_list<false>(sel, ws, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  const int* pos = list + (size_t)items * nt;
  float* dpart_j = dpart;
  float* dpart_i = dpart + (size_t)items * nt * kTile * E;
  err = split_w2(w2, w2s, E, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ncsn_wide_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ncsn_wide_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, noise, sel, sigma, u, grows,
      HeadWeights{wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3}, w2s, list, pre + items, dpart_j,
      dpart_i, part, keep, n, E, anneal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ncsn_wide_du_kernel<<<dim3(nt, B), kThreads, 0, s>>>(dpart_j, dpart_i, pre, pos, du, n, E,
                                                      blocks);
  sum_partials(part, blocks, Offsets(E).size, wgrad, s);
  return (int)cudaGetLastError();
}
