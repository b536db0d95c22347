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
// Both directions walk the same device tile list: the tiles where sel is
// not all zero, listed on the device (worklist.cuh, no host sync) in (graph,
// 8-row i tile) items; a persistent grid (one block per SM) gives each block
// an equal run of the list. The weights are staged once per block, W2 split
// into its TF32 parts (the B operand of the products), and the next tiles'
// dist/noise/sel, sigma (and the backward's row cotangents) and the u rows
// of their j and i tiles load with cp.async while the current tile runs. No
// atomics anywhere: every output is bitwise the same from run to run on one
// card.
//
// Forward (ncsn_fwd_kernel, then ncsn_rows_kernel), 12 warps in a pipeline
// of one barrier a tile: warps 0-7 run pre2 = l1 W2 of tile k on the tensor
// cores with mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh; W2 stored in
// mma fragment order) and the relu, w3 and score sums, while warps 8-11
// make l1 of tile k + 1 and demb of tile k + 2 on the CUDA cores and sum
// the loss of tile k - 1. l1 W2 runs in the plain split: the forward reads
// relu(pre2) as a value, not its slope, and the rows stay at ~2% of
// chip_smoke.py's row tolerance (the precise mode: ~0.3%, for 6% more time;
// PERF.md); on the CPU, the emulation holds both splits at sigma = 0.01
// and 10. The row sums: each pair's loss is summed over the tile's 8
// columns by shuffles and over the run's consecutive tiles of one row tile
// in registers, then written once per (block, item) segment;
// ncsn_rows_kernel adds each row's segments in block order.
//
// Backward (ncsn_bwd_kernel, then ncsn_du_kernel and reduce.cuh's sum), 8
// warps:
// - products: the recomputed l1 W2, dl1 = dx2 W2^T and dW2 += l1^T dx2 on
//   the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh).
//   W2, the B operand of the first two, is split into its TF32 parts once
//   per block. l1 W2 runs in the precise mode: in the plain split its error
//   moves relu'(pre2) off the plain version's side several times as often
//   (PERF.md). dW2 is summed over every tile of a run, so each tile's
//   product is added to that sum in f32 on the CUDA cores (the tensor
//   core's truncating accumulator would drift). The rest (the distance MLP,
//   relu', the score, the vector weight gradients) runs on the CUDA cores;
// - du: partials only where a tile is listed. The j side of each listed
//   tile (its 8 rows j summed over the tile's rows i) goes to slot `list
//   position`; the i side is summed in registers over the consecutive tiles
//   of one row tile in a run and written once per (block, item) segment.
//   ncsn_du_kernel then sums, per row, the i-side segments in list order and
//   the j sides in order of the row tile that holds them;
// - weight gradients: per-block partials in a fixed order, summed in block
//   order by a last launch.
//
// Widths. The source builds once per head width, NCSN_E = 128 (the default)
// or 256, into a library of its own (ops/_build.py); a narrower head is
// zero-padded to the instance's width by the wrapper (ops/ncsn.py), which is
// exact: every padded unit is relu(0) = 0 and meets zero weights. Both
// instances walk the same tile list with the same warps, the same fixed
// orders and the same 3xTF32 products; the 256 instance gives each warp
// twice the columns (loops over 128-wide column groups, kC). Its W2 hi/lo
// parts (2 kE kH floats, 256 KiB) do not fit in a block's 227 KiB beside the
// tiles, so ncsn_split_w2_kernel splits W2 once per launch into a device
// buffer (row-major and transposed, swizzled) that the products read
// through L2 (warp_tile_mma's scalar B loads), and its dW2 (32k floats, 128
// a thread) is summed over a run in the block's own row of the partials
// buffer, each thread adding its elements tile by tile, instead of in
// registers. Shared memory: 175,632 bytes forward (one block's l1 pair
// buffers at 128 KiB dominate), 143,184 backward.
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

#ifndef NCSN_E
#define NCSN_E 128
#endif

namespace geossl {

constexpr int kE = NCSN_E;     // head width (emb)
constexpr int kH = kE / 2;     // second layer width
static_assert(kE == 128 || kE == 256, "ncsn_score builds for E = 128 or 256");
// the 256 instance: W2 read from device memory, dW2 summed in device memory
constexpr bool kWide = kE > 128;
constexpr int kC = kE / 128;   // 128-wide column groups of the node rows
constexpr int kHW = kH / 2;    // pre2's columns per column-half warp

struct HeadWeights {
  const float *wd1, *bd1, *wd2, *bd2, *wod, *bod, *w2, *b2, *w3, *b3;
};

// Floats of the weight gradients, in this order:
// [w_d1 E][b_d1 E][w_d2 E][b_d2 1][w_od E][b_od E][w2 E*H][b2 H][w3 H][b3 1]
constexpr int kOffWd1 = 0, kOffBd1 = kE, kOffWd2 = 2 * kE, kOffBd2 = 3 * kE,
              kOffWod = 3 * kE + 1, kOffBod = 4 * kE + 1, kOffW2 = 5 * kE + 1,
              kOffB2 = kOffW2 + kE * kH, kOffW3 = kOffB2 + kH, kOffB3 = kOffW3 + kH,
              kWgrad = kOffB3 + 1;

constexpr int kBS = kE + 8;     // row stride of the 8-row u tiles (bank spread)
// the offset of W2's low parts from its high parts: in the backward's shared
// memory, or (kWide) in the split buffer of ncsn_split_w2_kernel
constexpr int kW2Lo = kE * kH;
// shared memory that holds W2's parts (none in the 256 instance)
constexpr int kW2SmemFloats = kWide ? 0 : 2 * kE * kH;
// floats of the 256 instance's split W2 buffer: [hi][lo] of W2 [kE][kH],
// then [hi][lo] of W2^T [kH][kE], each swizzled
constexpr int kW2SplitFloats = kWide ? 4 * kE * kH : 0;

// W2 split into its TF32 parts (split_b) for the 256 instance's products,
// once per launch: w2s holds W2 [kE][kH] (hi, then lo kW2Lo floats on) and
// W2^T [kH][kE] (hi, lo) after it, swizzled as warp_tile_mma reads them.
__global__ void __launch_bounds__(kThreads)
ncsn_split_w2_kernel(const float* __restrict__ w2, float* __restrict__ w2s) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= kE * kH) return;
  const int r = idx / kH, h = idx - r * kH;
  float hi, lo;
  split_b(w2[idx], hi, lo);
  w2s[swz_at(kH, r, h)] = hi;
  w2s[kW2Lo + swz_at(kH, r, h)] = lo;
  w2s[2 * kW2Lo + swz_at(kE, h, r)] = hi;
  w2s[3 * kW2Lo + swz_at(kE, h, r)] = lo;
}

// -- forward -------------------------------------------------------------------

// the forward's block: warps 0-7 run the tensor-core product (as the
// backward's step 2), warps 8-11 the elementwise stages
constexpr int kFwdThreads = 384;
// shared memory of the forward, in floats
constexpr int kFOffW2 = 0;                             // W2F: W2 in fragment order (below)
constexpr int kFOffL1 = kFOffW2 + kW2SmemFloats;       // [2][kPairs][kE] swizzled: l1 of two tiles
constexpr int kFOffU = kFOffL1 + 2 * kPairs * kE;      // [2][2][8][kBS] u rows: j tile, i tile
constexpr int kFOffGrid = kFOffU + 4 * kTile * kBS;    // [4][3][64] dist, noise, sel, [il][jl]
constexpr int kFOffSig = kFOffGrid + 12 * kPairs;      // [4] sigma of the grid buffers
constexpr int kFOffVec = kFOffSig + 4;                 // the head's vectors (stage_head)
constexpr int kFOffDemb = kFOffVec + 5 * kE + 2 * kH;  // [2][64] demb
constexpr int kFOffSr = kFOffDemb + 2 * kPairs;        // [2][2][64] score sums over column halves
constexpr int kFwdFloats = kFOffSr + 4 * kPairs;

// The forward stages W2 in mma fragment order, split into its TF32 parts
// (split_b): W2F [2 wh][16 k steps][4 nb][32 lanes] float4 {b0 hi, b1 hi,
// b0 lo, b1 lo}, b0 = W2[8 ks + t][32 wh + 8 nb + g], b1 four rows below, so
// that a warp loads a B fragment with one 128-bit load; and the head's
// vectors (wd1, bd1, wd2, wod, bod [kE]; b2, w3 [kH]). Every thread of the
// block calls it. (The 256 instance stages the vectors only: its product
// reads W2 from the split buffer.)
__device__ __forceinline__ void stage_fwd_head(const HeadWeights& W, float* W2F, float* vec) {
  const int tid = threadIdx.x;
  if constexpr (!kWide) {
    for (int e = tid; e < kE * kH / 2; e += kFwdThreads) {
      const int lane = e & 31, nb = (e >> 5) & 3, ks = (e >> 7) & 15, wh = e >> 11;
      const int k = 8 * ks + (lane & 3), h = 32 * wh + 8 * nb + (lane >> 2);
      float4 f;
      split_b(W.w2[k * kH + h], f.x, f.z);
      split_b(W.w2[(k + 4) * kH + h], f.y, f.w);
      reinterpret_cast<float4*>(W2F)[e] = f;
    }
  }
  if (tid < kE) {
    vec[tid] = W.wd1[tid];
    vec[kE + tid] = W.bd1[tid];
    vec[2 * kE + tid] = W.wd2[tid];
    vec[3 * kE + tid] = W.wod[tid];
    vec[4 * kE + tid] = W.bod[tid];
    if (tid < kH) {
      vec[5 * kE + tid] = W.b2[tid];
      vec[5 * kE + kH + tid] = W.w3[tid];
    }
  }
}

// Forward of the head, per listed tile, block k computing the run
// [run_begin(k), run_begin(k + 1)) of the tile list (items (graph, 8-row i
// tile)) in a pipeline of one barrier a tile. In the iteration of tile k,
// after its barrier:
// - warps 0-7: pre2 = l1 W2 + b2 of tile k on the tensor cores (warp (wq,
//   wh): rows 16*wq.., columns 32*wh..), relu, w3 and the score's partial
//   sums over the warp's columns;
// - warps 8-11: l1 of tile k + 1 (warp e: jl 2e, 2e + 1, lane: features
//   4*lane..) and demb of tile k + 2 (two threads per pair); warp 8 also
//   adds the loss of tile k - 1 (lane l: pairs l and l + 32 of row il = l &
//   7, summed over the tile's columns by shuffles and over the run's
//   consecutive tiles of one item in registers) and keeps tile k's noise,
//   sel and sigma for it.
// The cp.async loads run ahead: dist/noise/sel/sigma three tiles, the u
// rows two tiles. One 8-row partial of the rows per (block, item) segment,
// at slot item + block (unique: both grow along the list).
__global__ void __launch_bounds__(kFwdThreads, 1)
ncsn_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ noise,
                const float* __restrict__ sel, const float* __restrict__ sigma,
                const float* __restrict__ u, HeadWeights W, const float* __restrict__ w2s,
                const int* __restrict__ list, const int* __restrict__ total_p,
                float* __restrict__ rpart, int n, float anneal) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  const float* vec = smem + kFOffVec;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (n + kTile - 1) / kTile;
  const long long total = *total_p;
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  if (t_begin >= t_end) return;  // block-uniform: an empty run
  const float bd2 = W.bd2[0], b3 = W.b3[0];

  // the cp.async loads of the tile with list entry v: dist, noise, sel and
  // sigma into grid buffer buf; the u rows of its j and i tiles into row
  // buffer buf
  auto load_grids = [&](int v, int buf) {
    const int item = v / nt, pj = v - item * nt, b = item / nt;
    const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
    if (tid < 3 * kPairs) {
      const int p = tid & (kPairs - 1), q = tid >> 6, i = i0 + (p >> 3), j = j0 + (p & 7);
      const bool in = i < n && j < n;
      const float* src = q == 0 ? dist : (q == 1 ? noise : sel);
      cp_async4(smem + kFOffGrid + (3 * buf + q) * kPairs + p,
                src + (in ? ((size_t)b * n + i) * n + j : 0), in);
    } else if (tid == 3 * kPairs) {
      cp_async4(smem + kFOffSig + buf, sigma + b, true);
    }
  };
  auto load_rows = [&](int v, int buf) {
    const int item = v / nt, pj = v - item * nt, b = item / nt;
    const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
    for (int c = tid; c < 2 * kTile * kE / 4; c += kFwdThreads) {
      const int side = c / (kTile * kE / 4), r = (c / (kE / 4)) % kTile;
      const int f = (c % (kE / 4)) * 4, a = (side ? i0 : j0) + r;
      cp_async16(smem + kFOffU + ((2 * buf + side) * kTile + r) * kBS + f,
                 u + (a < n ? ((size_t)b * n + a) * kE + f : 0), a < n);
    }
  };
  // warps 8-11: demb of the tile in grid buffer gb into demb buffer db
  auto make_demb = [&](int gb, int db) {
    const int e = tid - 8 * 32, p = e >> 1, half = e & 1, at = (p & 7) * kTile + (p >> 3);
    const float* d_t = smem + kFOffGrid + 3 * gb * kPairs;
    const float dp = fmaf(d_t[kPairs + at], smem[kFOffSig + gb], d_t[at]);
    float s = 0.f;
#pragma unroll 4
    for (int m = 0; m < kE / 8; ++m) {
      const int f = 4 * (half + 2 * m);
      const float4 w1 = ld4(vec + f), b1 = ld4(vec + kE + f), w2 = ld4(vec + 2 * kE + f);
      s = fmaf(fmaxf(fmaf(dp, w1.x, b1.x), 0.f), w2.x, s);
      s = fmaf(fmaxf(fmaf(dp, w1.y, b1.y), 0.f), w2.y, s);
      s = fmaf(fmaxf(fmaf(dp, w1.z, b1.z), 0.f), w2.z, s);
      s = fmaf(fmaxf(fmaf(dp, w1.w, b1.w), 0.f), w2.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) smem[kFOffDemb + db * kPairs + p] = s + bd2;
  };
  // warps 8-11: l1 = relu(u_i + u_j + demb w_od + b_od) of the tile whose
  // rows are in row buffer rb and demb in demb buffer db, into l1 buffer lb
  // (lane: features 4*lane.. of each 128-wide column group)
  auto make_l1 = [&](int rb, int db, int lb) {
    const float* uj_t = smem + kFOffU + 2 * rb * kTile * kBS;
    const float* ui_t = uj_t + kTile * kBS;
    float* l1_s = smem + kFOffL1 + lb * kPairs * kE;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int f = 128 * cc + 4 * lane;
      const float4 wo = ld4(vec + 3 * kE + f), bo = ld4(vec + 4 * kE + f);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int jl = 2 * (warp - 8) + jj;
        const float4 bj = ld4(uj_t + jl * kBS + f);
#pragma unroll 4
        for (int il = 0; il < kTile; ++il) {
          const int p = jl * kTile + il;
          const float4 a = ld4(ui_t + il * kBS + f);
          const float de = smem[kFOffDemb + db * kPairs + p];
          *reinterpret_cast<float4*>(l1_s + swz_at(kE, p, f)) =
              make_float4(fmaxf(a.x + bj.x + fmaf(de, wo.x, bo.x), 0.f),
                          fmaxf(a.y + bj.y + fmaf(de, wo.y, bo.y), 0.f),
                          fmaxf(a.z + bj.z + fmaf(de, wo.z, bo.z), 0.f),
                          fmaxf(a.w + bj.w + fmaf(de, wo.w, bo.w), 0.f));
        }
      }
    }
  };
  // warps 0-7: pre2 of the tile in l1 buffer lb, the score sums into sr
  // buffer sb: warp (wq, wh) = (warp & 3, warp >> 2) owns rows 16*wq.. and
  // columns kHW*wh..; a k step reads the A fragment with ldmatrix and splits
  // it (mma_tf32.cuh's warp_tile_mma), B's four fragments with one 128-bit
  // load each (the 256 instance: warp_tile_mma over its two 32-column
  // groups, B's parts read from the split buffer)
  auto product = [&](int lb, int sb) {
    const int wq = warp & 3, wh = warp >> 2, lr = lane & 7, lq = lane >> 3;
    float p2[kC][1][4][4];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) p2[cc][0][nb][q] = 0.f;
    if constexpr (kWide) {
      const float* l1_t = smem + kFOffL1 + lb * kPairs * kE;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        warp_tile_mma<1, 4, kE, false, false, false, false, kW2Lo>(p2[cc], l1_t, kE, 16 * wq,
                                                                   w2s, kH, kHW * wh + 32 * cc);
    } else {
      const float* A = smem + kFOffL1 + lb * kPairs * kE +
                       (16 * wq + lr + 8 * (lq & 1)) * kE + 4 * ((lq >> 1) ^ (lr >> 2));
      const float4* B = reinterpret_cast<const float4*>(smem + kFOffW2) + wh * 16 * 128 + lane;
#pragma unroll 2
      for (int ks = 0; ks < kE / 8; ++ks) {
        const int k0 = 8 * ks;
        uint32_t v[4], ah[1][4], al[1][4], bh[4][2], bl[4][2];
        ldsm_x4(A + (k0 & ~31) + 8 * (((k0 >> 3) & 3) ^ (lr & 3)), v);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(v[q], ah[0][q], al[0][q]);  // the plain split
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float4 f = B[ks * 128 + nb * 32];
          bh[nb][0] = __float_as_uint(f.x), bh[nb][1] = __float_as_uint(f.y);
          bl[nb][0] = __float_as_uint(f.z), bl[nb][1] = __float_as_uint(f.w);
        }
        mma_passes<1, 4>(p2[0], ah, al, bh, bl);
      }
    }
    const float* b2_s = vec + 5 * kE;
    const float* w3_s = b2_s + kH;
    float sr[2] = {0.f, 0.f};
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = kHW * wh + 32 * cc + 8 * nb + 2 * t + (q & 1);
          sr[q >> 1] = fmaf(fmaxf(p2[cc][0][nb][q] + b2_s[h], 0.f), w3_s[h], sr[q >> 1]);
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float s = quad_sum(sr[hh]);
      if (t == 0) smem[kFOffSr + (2 * sb + wh) * kPairs + 16 * wq + 8 * hh + g] = s;
    }
  };

  // warp 8: the loss of row il = lane & 7 over the segment, and the last
  // product's tile's sigma, noise and sel of pairs lane and lane + 32
  float racc = 0.f, sig_p = 1.f, nz_p[2] = {0.f, 0.f}, sel_p[2] = {0.f, 0.f};
  auto keep_pairs = [&](int gb) {
    const float* nz_t = smem + kFOffGrid + (3 * gb + 1) * kPairs;  // [il][jl]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h, at = (p & 7) * kTile + (p >> 3);
      nz_p[h] = nz_t[at];
      sel_p[h] = nz_t[kPairs + at];
    }
    sig_p = smem[kFOffSig + gb];
  };
  auto add_loss = [&](int sb) {
    const float wsig = expf(anneal * logf(sig_p));
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const float sr = smem[kFOffSr + 2 * sb * kPairs + p] + smem[kFOffSr + (2 * sb + 1) * kPairs + p];
      const float r = (sr + b3) / sig_p + nz_p[h] / sig_p;
      s += 0.5f * r * r * wsig * sel_p[h];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    racc += s;
  };
  int cur = list[t_begin] / nt;  // the item racc sums
  auto flush = [&]() {
    if (warp == 8 && lane < kTile) rpart[(size_t)(cur + blockIdx.x) * kTile + lane] = racc;
    racc = 0.f;
  };

  // the list entries of tiles k .. k + 3, read a tile ahead of their use
  auto entry = [&](int k) { return k < t_end ? list[k] : 0; };
  int v0 = entry(t_begin), v1 = entry(t_begin + 1), v2 = entry(t_begin + 2);
  int v3 = entry(t_begin + 3);

  // prologue: the grids of the first three tiles and the rows of the first
  // two; then demb of the first two and l1 of the first
  load_grids(v0, 0);
  if (t_begin + 1 < t_end) load_grids(v1, 1);
  if (t_begin + 2 < t_end) load_grids(v2, 2);
  load_rows(v0, 0);
  if (t_begin + 1 < t_end) load_rows(v1, 1);
  cp_async_commit();
  stage_fwd_head(W, smem + kFOffW2, smem + kFOffVec);
  cp_async_wait<0>();
  __syncthreads();
  if (warp >= 8) {
    make_demb(0, 0);
    if (t_begin + 1 < t_end) make_demb(1, 1);
  }
  __syncthreads();
  if (warp >= 8) make_l1(0, 0, 0);

  for (int k = t_begin; k < t_end; ++k) {
    const int q = k - t_begin, item = v0 / nt, v4 = entry(k + 4);
    cp_async_wait<0>();
    __syncthreads();  // in place: tile k's l1, tile k + 1's demb and rows, tile
                      // k + 2's grids, tile k - 1's score sums; every warp is
                      // done with the buffers these loads overwrite
    if (k + 3 < t_end) load_grids(v3, (q + 3) % 4);
    if (k + 2 < t_end) load_rows(v2, (q + 2) & 1);
    cp_async_commit();
    if (warp == 8 && k > t_begin) add_loss((q - 1) & 1);
    if (item != cur) {  // block-uniform: the run moves to the next row tile
      flush();
      cur = item;
    }
    if (warp < 8) {
      product(q & 1, q & 1);
    } else {
      if (warp == 8) keep_pairs(q % 4);
      if (k + 1 < t_end) make_l1((q + 1) & 1, (q + 1) & 1, (q + 1) & 1);
      if (k + 2 < t_end) make_demb((q + 2) % 4, q & 1);
    }
    v0 = v1;
    v1 = v2;
    v2 = v3;
    v3 = v4;
  }
  __syncthreads();  // the last tile's score sums are complete
  if (warp == 8) add_loss((t_end - 1 - t_begin) & 1);
  flush();
}

// rows[b, i]: the segment partials of item (b, i / 8) in block order; zero
// for a row tile with no listed tile. `blocks` is ncsn_fwd_kernel's grid.
__global__ void __launch_bounds__(kThreads)
ncsn_rows_kernel(const float* __restrict__ rpart, const int* __restrict__ pre,
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

// shared memory of the backward, in floats
constexpr int kBOffW2 = 0;                          // [2][kE][kH] swizzled: W2 split, hi, lo
constexpr int kBOffL1 = kBOffW2 + kW2SmemFloats;    // [kPairs][kE] swizzled: l1
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
// the distance MLP's split over the block: threads per feature, pairs each
constexpr int kMlpSplit = kThreads / kE, kMlpPairs = kPairs / kMlpSplit;

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
                HeadWeights W, const float* __restrict__ w2s, const int* __restrict__ list,
                const int* __restrict__ total_p, float* __restrict__ dpart_j,
                float* __restrict__ dpart_i, float* __restrict__ part, int n,
                float anneal) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W2_s = smem + kBOffW2;
  // B of l1 W2: W2's parts in shared memory, or (kWide) the split buffer
  const float* W2_b = kWide ? w2s : W2_s;
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
  if constexpr (!kWide) {
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
  float gw3[kC][4][2], gb2[kC][4][2];  // columns h = kHW*(warp>>2) + 32*cc + 8*nb + 2*t + c
  float gwod[kC][4][2], gbod[kC][4][2];  // columns e = 128*cc + 32*(warp>>1) + 8*nb + 2*t + c
  float racc[kC][4][2];  // du rows i (il = g) of the segment, the same columns
  // feature tid % kE: d w_d2, and d w_d1 and d b_d1 over w_d2
  float gwd1 = 0.f, gbd1 = 0.f, gwd2 = 0.f;
  float gb3 = 0.f, gbd2 = 0.f;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        gw3[cc][nb][c] = gb2[cc][nb][c] = gwod[cc][nb][c] = gbod[cc][nb][c] = racc[cc][nb][c] = 0.f;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int q = 0; q < 4; ++q) gw2[mb][nb][q] = 0.f;
  }
  // the 256 instance's dW2 over the run: this block's row of the partials,
  // warp (wq, wh) owning rows 64*wq.. and columns 64*wh.. in four 32x32
  // blocks (rb, cb), each element added to by its one thread, tile by tile
  float* gw2_d = part + (size_t)blockIdx.x * kWgrad + kOffW2;
  auto gw2_at = [&](int rb, int cb, int mb, int nb, int q) {
    const int e = 64 * (warp & 3) + 32 * rb + 16 * mb + 8 * (q >> 1) + g;
    return e * kH + 64 * (warp >> 2) + 32 * cb + 8 * nb + 2 * t + (q & 1);
  };
  if constexpr (kWide) {
#pragma unroll 1
    for (int rc = 0; rc < 4; ++rc)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) gw2_d[gw2_at(rc >> 1, rc & 1, mb, nb, q)] = 0.f;
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
    for (int cc = 0; cc < kC; ++cc)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        *reinterpret_cast<float2*>(dst + 128 * cc + 32 * (warp >> 1) + 8 * nb + 2 * t) =
            make_float2(racc[cc][nb][0], racc[cc][nb][1]);
        racc[cc][nb][0] = racc[cc][nb][1] = 0.f;
      }
  };

  // 5. the distance MLP of the tile in buffer pb: feature tid % kE over
  // pairs kMlpPairs*(tid / kE)..
  // (d b_d1 and d w_d1 are w_d2 times sum_p [t1 > 0] ddemb (dp); the sums
  // are scaled once, at the end)
  auto dist_mlp = [&](int pb) {
    const int e = tid & (kE - 1), p0 = kMlpPairs * (tid / kE);
    const float w1e = wd1_s[e], b1e = bd1_s[e];
    const float4* dd_t = reinterpret_cast<const float4*>(dde_s) + pb * kPairs;
    const float* dp_t = dp_s + pb * kPairs;
#pragma unroll 8
    for (int p = p0; p < p0 + kMlpPairs; ++p) {
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
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {  // warp w: pairs p = jl*8 + w (il = w), lane: features 4*lane..
      const int e = 128 * cc + 4 * lane;
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
    float p2[kC][1][4][4];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) p2[cc][0][nb][q] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      warp_tile_mma<1, 4, kE, false, false, false, true, kW2Lo>(p2[cc], l1_s, kE, 16 * wq, W2_b,
                                                                kH, kHW * wh + 32 * cc);
    {
      float sr[2] = {0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = kHW * wh + 32 * cc + 8 * nb + 2 * t + (q & 1);
            p2[cc][0][nb][q] += b2_s[h];
            sr[q >> 1] = fmaf(fmaxf(p2[cc][0][nb][q], 0.f), w3_s[h], sr[q >> 1]);
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
      for (int cc = 0; cc < kC; ++cc)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int h = kHW * wh + 32 * cc + 8 * nb + 2 * t;
          float dx[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pre = p2[cc][0][nb][2 * hh + c];
            gw3[cc][nb][c] = fmaf(fmaxf(pre, 0.f), ds, gw3[cc][nb][c]);
            dx[c] = pre > 0.f ? ds * w3_s[h + c] : 0.f;
            gb2[cc][nb][c] += dx[c];
          }
          store2(dx2_s, kH, p, h, dx[0], dx[1]);
        }
    }
    __syncthreads();

    // 3. dW2 += l1^T dx2: the tile's product, added to the run's sum in f32
    // (the tensor core's truncating accumulator would drift over a run),
    // then dl1 = dx2 W2^T
    if constexpr (kWide) {  // four 32x32 blocks, each added to the row in device memory
#pragma unroll 1
      for (int rc = 0; rc < 4; ++rc) {
        float t3[2][4][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) t3[mb][nb][q] = 0.f;
        warp_tile_mma<2, 4, kPairs, true, false>(t3, l1_s, kE, 64 * wq + 32 * (rc >> 1), dx2_s,
                                                 kH, 64 * wh + 32 * (rc & 1));
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) gw2_d[gw2_at(rc >> 1, rc & 1, mb, nb, q)] += t3[mb][nb][q];
      }
    } else {
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
    // ddemb's partial sums over this warp's columns, per (mb, hh)
    float sde[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      float dl[2][4][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) dl[mb][nb][q] = 0.f;
      if constexpr (kWide)  // B = W2^T from the split buffer, scalar loads
        warp_tile_mma<2, 4, kH, false, false, false, false, kW2Lo>(
            dl, dx2_s, kH, 32 * wm, w2s + 2 * kW2Lo, kE, 128 * cc + 32 * wn);
      else
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
            const int e = 128 * cc + 32 * wn + 8 * nb + 2 * t;
            const float2 l1 = load2(l1_s, kE, p, e);
            const float v0 = l1.x > 0.f ? dl[mb][nb][2 * hh] : 0.f;
            const float v1 = l1.y > 0.f ? dl[mb][nb][2 * hh + 1] : 0.f;
            racc[cc][nb][0] += v0;
            racc[cc][nb][1] += v1;
            gwod[cc][nb][0] = fmaf(v0, de, gwod[cc][nb][0]);
            gwod[cc][nb][1] = fmaf(v1, de, gwod[cc][nb][1]);
            gbod[cc][nb][0] += v0;
            gbod[cc][nb][1] += v1;
            s = fmaf(v0, wod_s[e], fmaf(v1, wod_s[e + 1], s));
            vj[16 * mb + 8 * hh + 2 * nb] = v0;
            vj[16 * mb + 8 * hh + 2 * nb + 1] = v1;
          }
          if constexpr (kC == 1) {
            s = quad_sum(s);
            if (t == 0) dde_s[(buf * kPairs + p) * 4 + wn] = s;
          } else {
            sde[mb][hh] = cc == 0 ? s : sde[mb][hh] + s;
          }
        }
      rs_lanes<2>(vj);  // summed over the tile's 8 rows i
      {
        float* dst = dpart_j + (size_t)k * kTileRows + 128 * cc;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * g + q, jl = 4 * wm + (e >> 3);
          __stcg(dst + jl * kE + 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1), vj[q]);
        }
      }
    }
    if constexpr (kC > 1) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float s = quad_sum(sde[mb][hh]);
          if (t == 0) dde_s[(buf * kPairs + 32 * wm + 16 * mb + 8 * hh + g) * 4 + wn] = s;
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
  if constexpr (!kWide) {  // (the 256 instance's dW2 is in `out` already)
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
                        // [kMlpSplit][kE] (2 kE apart) wd1, bd1, wd2; [4] b3;
                        // [kMlpSplit] bd2
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
  for (int cc = 0; cc < kC; ++cc)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float a[4] = {gw3[cc][nb][c], gb2[cc][nb][c], gwod[cc][nb][c], gbod[cc][nb][c]};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) a[q] += __shfl_xor_sync(0xffffffffu, a[q], off);
        if (g == 0) {
          const int h = kHW * (warp >> 2) + 32 * cc + 8 * nb + 2 * t + c;
          const int e = 128 * cc + 32 * (warp >> 1) + 8 * nb + 2 * t + c;
          r_w3[(warp & 3) * kH + h] = a[0];
          r_b2[(warp & 3) * kH + h] = a[1];
          r_wod[(warp & 1) * kE + e] = a[2];
          r_bod[(warp & 1) * kE + e] = a[3];
        }
      }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) gb3 += __shfl_xor_sync(0xffffffffu, gb3, off);
  if (lane == 0 && warp < 4) r_b3[warp] = gb3;
  r_wd1[tid] = gwd1 * wd2_s[tid & (kE - 1)];  // [tid / kE][tid % kE]
  r_bd1[tid] = gbd1 * wd2_s[tid & (kE - 1)];
  r_wd2[tid] = gwd2;
  if ((tid & (kE - 1)) == 0) r_bd2[tid / kE] = gbd2;
  __syncthreads();
  if (tid < kH) {
    out[kOffW3 + tid] = r_w3[tid] + r_w3[kH + tid] + r_w3[2 * kH + tid] + r_w3[3 * kH + tid];
    out[kOffB2 + tid] = r_b2[tid] + r_b2[kH + tid] + r_b2[2 * kH + tid] + r_b2[3 * kH + tid];
  }
  if (tid < kE) {
    out[kOffWod + tid] = r_wod[tid] + r_wod[kE + tid];
    out[kOffBod + tid] = r_bod[tid] + r_bod[kE + tid];
    if constexpr (kMlpSplit == 2) {
      out[kOffWd1 + tid] = r_wd1[tid] + r_wd1[kE + tid];
      out[kOffBd1 + tid] = r_bd1[tid] + r_bd1[kE + tid];
      out[kOffWd2 + tid] = r_wd2[tid] + r_wd2[kE + tid];
    } else {
      out[kOffWd1 + tid] = r_wd1[tid];
      out[kOffBd1 + tid] = r_bd1[tid];
      out[kOffWd2 + tid] = r_wd2[tid];
    }
  }
  if (tid == 0) {
    out[kOffB3] = r_b3[0] + r_b3[1] + r_b3[2] + r_b3[3];
    out[kOffBd2] = kMlpSplit == 2 ? r_bd2[0] + r_bd2[1] : r_bd2[0];
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
  const int r = threadIdx.x >> 5, f = (threadIdx.x & 31) * 4;  // (+ 128 per column group)
  const long long total = pre[gridDim.y * nt];
  float4 s[kC];
#pragma unroll
  for (int cc = 0; cc < kC; ++cc) s[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float* src) {
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + r * kE + 128 * cc + f));
      s[cc].x += v.x;
      s[cc].y += v.y;
      s[cc].z += v.z;
      s[cc].w += v.w;
    }
  };
  const int t0 = pre[item], t1 = pre[item + 1];
  if (t1 > t0) {
    // the blocks whose runs hold tiles t0 .. t1 - 1 (blocks with empty runs
    // wrote nothing)
    for (int k = first_run_block(t0, total, blocks);
         k < blocks && run_begin(total, blocks, k) < t1; ++k) {
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
  if (i < n) {
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      *reinterpret_cast<float4*>(du + ((size_t)b * n + i) * kE + 128 * cc + f) = s[cc];
  }
}

static HeadWeights head(const float* wd1, const float* bd1, const float* wd2,
                        const float* bd2, const float* wod, const float* bod,
                        const float* w2, const float* b2, const float* w3,
                        const float* b3) {
  return HeadWeights{wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3};
}

}  // namespace geossl

// Shared memory of the larger of the two kernels' blocks.
extern "C" size_t ncsn_smem_bytes() {
  using namespace geossl;
  return sizeof(float) * (size_t)(kFwdFloats > kBwdFloats ? kFwdFloats : kBwdFloats);
}
// The forward's and the backward's own shares of it (fwd 1, bwd 0).
extern "C" size_t ncsn_dir_smem_bytes(int fwd) {
  return sizeof(float) * (size_t)(fwd ? geossl::kFwdFloats : geossl::kBwdFloats);
}
extern "C" int ncsn_wgrad_size() { return geossl::kWgrad; }
// Floats of the split-W2 buffer either direction takes (0: the 128
// instance keeps W2 in shared memory and takes none).
extern "C" size_t ncsn_w2_floats() { return geossl::kW2SplitFloats; }
// Blocks of either kernel's persistent grid, i.e. rows of the backward's
// partials buffer.
extern "C" int ncsn_blocks(int B, int n) {
  return geossl::persistent_blocks(B * ((n + geossl::kTile - 1) / geossl::kTile));
}

// Ints of either direction's workspace: the tile list over sel (worklist.cuh).
extern "C" size_t ncsn_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::tile_list_ints((size_t)B * nt, nt);
}

// Floats of the forward's row partials: 8 rows for every possible (block,
// item) segment.
extern "C" size_t ncsn_fwd_rpart_floats(int B, int n) {
  const size_t items = (size_t)B * ((n + geossl::kTile - 1) / geossl::kTile);
  return (items + (size_t)ncsn_blocks(B, n)) * geossl::kTile;
}

// Floats of the backward's du partials: the j side of every tile that could
// be listed, then the i side of every possible (block, item) segment.
extern "C" size_t ncsn_bwd_dpart_floats(int B, int n) {
  const size_t nt = (n + geossl::kTile - 1) / geossl::kTile, items = (size_t)B * nt;
  return (items * nt + 2 * (items + (size_t)ncsn_blocks(B, n))) * geossl::kTileRows;
}

namespace geossl {
// The 256 instance's W2 split into w2s (ncsn_w2_floats() floats); nothing
// for the 128 instance.
static cudaError_t split_w2(const float* w2, float* w2s, cudaStream_t s) {
  if (!kWide) return cudaSuccess;
  ncsn_split_w2_kernel<<<(kE * kH + kThreads - 1) / kThreads, kThreads, 0, s>>>(w2, w2s);
  return cudaGetLastError();
}
}  // namespace geossl

// Row sums of the annealed loss, rows [B, n]. `ws` holds ncsn_ws_ints(B, n)
// ints, `rpart` ncsn_fwd_rpart_floats(B, n) floats (written only where a
// segment is listed), `w2s` ncsn_w2_floats() floats (null when 0). Returns
// the cudaError_t of the launches (0 on success). E must be the head width
// this library was built for (NCSN_E). No atomics: the result is the same
// from run to run on one card.
extern "C" int ncsn_score_fwd(const float* dist, const float* noise, const float* sel,
                              const float* sigma, const float* u, const float* wd1,
                              const float* bd1, const float* wd2, const float* bd2,
                              const float* wod, const float* bod, const float* w2,
                              const float* b2, const float* w3, const float* b3,
                              float* rows, float* rpart, int* ws, float* w2s, int B, int n,
                              int E, float anneal, void* stream) {
  using namespace geossl;
  if (E != kE) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kFwdFloats;
  const int blocks = ncsn_blocks(B, n), nt = (n + kTile - 1) / kTile, items = B * nt;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = make_tile_list<false>(sel, ws, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  err = split_w2(w2, w2s, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  err = cudaFuncSetAttribute(ncsn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ncsn_fwd_kernel<<<blocks, kFwdThreads, smem, s>>>(
      dist, noise, sel, sigma, u, head(wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3), w2s,
      list, pre + items, rpart, n, anneal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ncsn_rows_kernel<<<(B * n + kThreads - 1) / kThreads, kThreads, 0, s>>>(rpart, pre, rows, B, n,
                                                                           blocks);
  return (int)cudaGetLastError();
}

// Backward: du [B, n, E], and the ten weight gradients into `wgrad`
// (ncsn_wgrad_size() floats, in the order of the offsets above). `ws` holds
// ncsn_ws_ints(B, n) ints, `dpart` ncsn_bwd_dpart_floats(B, n) floats
// (written only where a tile or segment is listed), `part`
// ncsn_blocks(B, n) rows of ncsn_wgrad_size() floats, `w2s`
// ncsn_w2_floats() floats (null when 0). Returns the cudaError_t of the
// launches. No atomics: the result is the same from run to run on one card.
extern "C" int ncsn_score_bwd(const float* dist, const float* noise, const float* sel,
                              const float* sigma, const float* u, const float* grows,
                              const float* wd1, const float* bd1, const float* wd2,
                              const float* bd2, const float* wod, const float* bod,
                              const float* w2, const float* b2, const float* w3,
                              const float* b3, float* du, float* dpart, float* part,
                              float* wgrad, int* ws, float* w2s, int B, int n, int E,
                              float anneal, void* stream) {
  using namespace geossl;
  if (E != kE) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kBwdFloats;
  const int blocks = ncsn_blocks(B, n), nt = (n + kTile - 1) / kTile, items = B * nt;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = make_tile_list<false>(sel, ws, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  const int* pos = list + (size_t)items * nt;
  float* dpart_j = dpart;
  float* dpart_i = dpart + (size_t)items * nt * kTileRows;
  err = split_w2(w2, w2s, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ncsn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ncsn_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, noise, sel, sigma, u, grows, head(wd1, bd1, wd2, bd2, wod, bod, w2, b2, w3, b3),
      w2s, list, pre + items, dpart_j, dpart_i, part, n, anneal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ncsn_du_kernel<<<dim3(nt, B), kThreads, 0, s>>>(dpart_j, dpart_i, pre, pos, du, n, blocks);
  sum_partials(part, blocks, kWgrad, wgrad, s);
  return (int)cudaGetLastError();
}
