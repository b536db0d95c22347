// cfconv_fwd: SchNet's continuous-filter convolution, forward.
//
//   m[b,i,f] = sum_j env[b,i,j] * (ssp(rbf(dist[b,i,j]) W1 + b1) W2 + b2)[f] * x[b,j,f]
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _fwd_kernel (cfconv_fused), as
// cfconv_fwd_kernel, and _fwd_sym_kernel (cfconv_fused_sym), as
// cfconv_fwd_sym_kernel. As there, the [B,N,N,F] filter tensor never leaves
// the chip: they read dist/env [B,N,N] and x [B,N,F] and write m [B,N,F].
//
// Bound on the H100: operations. The filter MLP costs 2*G*F + 2*F*F FLOP of
// products per pair (~46k at G=51, F=128) against 8 bytes of dist/env per
// pair, far above the card's ridge. Both kernels skip work: tiles whose
// envelope is all zero (out of cutoff, padding, empty graph slots) when
// `sparse` is set, and the symmetric kernel the tiles below the diagonal.
//
// Plain mode (cfconv_fwd_kernel, a max_neighbors graph: dist/env need not
// be symmetric, and the grid may be a rectangular stripe ni != nj): the
// symmetric mode's machinery below without the mirror.
// - work list: the occupancy pass and scan make the list of computed tiles
//   on the device (worklist.cuh's make_tile_list, items (graph, 8-row i
//   tile) listing their j tiles), and a persistent grid (one 8-warp block
//   per SM) takes equal runs of it (run_begin). Runs of whole items
//   (first_item) would leave a small batch to its longest item: serving's
//   N=256 batch (11 complexes in 128 slots, 2,358 tiles) has items of up
//   to 17 tiles, and the longest run of whole items held 31 tiles against
//   a mean of 18 (measured: 0.30 against 0.20 ms there, and slower at
//   every full batch timed; PERF.md). A block sums the rows of each item in registers over its
//   run's tiles of it; an item that lies whole in the run is written to
//   `out` there, an item that a run boundary splits is written as 8-row
//   partials (at most two per block, its run's first and last item), which
//   a second launch (cfconv_fwd_join_kernel) adds up in block order. So
//   each output row is written once, with no atomics, and the output is
//   bitwise the same from run to run on one card. The rows of an item with
//   no listed tile (padding, empty graph slots, all-zero env under
//   `sparse`) are written as zeros, spread over the grid;
// - products: both filter products of each tile on the tensor cores in the
//   plain 3xTF32 split (filter_mma.cuh, as the symmetric mode), W1 and W2
//   staged once per block; any G: the first product runs in k steps of 32
//   above G = 64 (its padded rows zero), and above G = 64 the hidden layer
//   reuses the RBF's shared memory (one barrier more per tile);
// - loads: the next tile's dist/env and x rows with cp.async (double
//   buffer) while the current tile's products run;
// - rows: lane (g, t) of warp (wm, wn) sums row il = g over the warp's four
//   jl of each tile; the two warps wm add their halves once per item (or
//   item part), through shared memory, in a fixed order.
//
// Symmetric mode (cfconv_fwd_sym_kernel; dist/env symmetric, the caller's
// guarantee): one filter per unordered pair. With square 8x8 tiles only
// tiles pi <= pj are computed; a tile with pi < pj adds w x_j to its rows i
// and w x_i to its rows j (every cell's mirror lies in a skipped tile). It
// is the message phase of schnet_stack.cu as a launch of its own:
// - work list: an occupancy pass and a scan make the list of computed tiles
//   on the device (worklist.cuh, no host sync), and a persistent grid (one
//   8-warp block per SM) gives each block an equal run of it, whatever the
//   mix of graph sizes and however few graphs are real;
// - products: rbf[64 x G->56] W1 and ssp(.) W2 per tile on the tensor cores
//   with mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh; the tile's filter
//   and messages are filter_mma.cuh's, shared with schnet_stack.cu), in the
//   plain split: one layer's two products stay within half the tolerance,
//   and the precise mode costs 16% (PERF.md). W1 and W2 are staged once
//   per block in the swizzled layout; the RBF exp, ssp and the messages
//   stay on the CUDA cores with the fast exp/log intrinsics;
// - loads: the next tile's dist/env and x rows (j and i tiles) load with
//   cp.async (double buffer) while the current tile's products run, issued
//   after the barrier that ends the previous tile;
// - messages: a block sums its rows i over the consecutive tiles of one row
//   tile in registers and adds them once per row tile; the mirrored rows j
//   are summed over the tile's 8 rows i in registers and added per tile.
//   Both go to `out` by global atomicAdd, so `out` must be zero on entry and
//   the summation order varies from run to run (f32 rounding; chip_smoke.py
//   checks that two launches agree within the kernel's tolerance).
#include "filter_mma.cuh"
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

// both modes' filter products in mma_tf32.cuh's plain 3xTF32 split (the
// header says why)
constexpr bool kPrecise = false;

// shared memory of the plain-mode kernel, in floats; then W1 [gp][kF], the
// RBF [kPairs][gp] and the hidden layer [kPairs][kF] (at G > 64 the hidden
// layer takes the RBF's place), all swizzled
constexpr int kPOffW2 = 0;                          // [kF][kF] swizzled
constexpr int kPOffX = kPOffW2 + kF * kF;           // [2][8][kSRS] x rows of the j tile
constexpr int kPOffDE = kPOffX + 2 * kTile * kSRS;  // [2][2][64] dist, env, [il][jl]
constexpr int kPOffB = kPOffDE + 4 * kPairs;        // [2][kF] b1, b2
constexpr int kPOffRed = kPOffB + 2 * kF;           // [4][32][8] row sums of the warps wm = 1
constexpr int kPOffW1 = kPOffRed + 4 * 32 * 8;

// G padded: kSGP, or a multiple of 32 above it.
__host__ __device__ inline int padded_g(int G) { return G <= kSGP ? kSGP : (G + 31) / 32 * 32; }

// Block k runs listed tiles [run_begin(k), run_begin(k + 1)) of the tile
// list (worklist.cuh: items (graph, 8-row i tile), each listing its j
// tiles), in list order. One barrier per tile opens it (the tile's loads
// landed, every warp done with the previous one), then filter_tile_mma's
// two. An item that lies whole in the run goes to `out`; the run's first
// and last item, where a run boundary splits them, go to this block's
// partial slots 0 and 1 of `part` [blocks][2][8][kF].
__global__ void __launch_bounds__(kThreads, 1)
cfconv_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  float* __restrict__ part, const int* __restrict__ pre,
                  const int* __restrict__ list, int B, int ni, int nj, int G, float start,
                  float delta, float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int gp = padded_g(G);
  float* W2_s = smem + kPOffW2;
  float* b1_s = smem + kPOffB;
  float* b2_s = b1_s + kF;
  float* red_s = smem + kPOffRed;
  float* W1_s = smem + kPOffW1;
  float* rbf_s = W1_s + gp * kF;
  float* s_s = gp == kSGP ? rbf_s + kPairs * gp : rbf_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * nti;

  // every warp writes zero to the rows of its items with no listed tile
  // (any block may write them: no other block does), one item a warp at a
  // time
  for (int item = blockIdx.x + gridDim.x * warp; item < n_items;
       item += gridDim.x * (kThreads / 32)) {
    if (pre[item] != pre[item + 1]) continue;  // warp-uniform
    const int b = item / nti, i0 = (item - b * nti) * kTile;
    for (int idx = lane; idx < kTile * kF / 4; idx += 32) {
      const int r = idx / (kF / 4), f = (idx % (kF / 4)) * 4, i = i0 + r;
      if (i < ni)
        *reinterpret_cast<float4*>(out + ((size_t)b * ni + i) * kF + f) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const long long total = pre[n_items];
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  if (t_begin >= t_end) return;  // block-uniform: an empty run

  // the weights, once per block (W1's rows >= G zero; the RBF's padding
  // columns zero where the hidden layer does not take its place)
  for (int c = tid; c < gp * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W1_s + swz_at(kF, r, f), w1 + (r < G ? r * kF + f : 0), r < G);
  }
  for (int c = tid; c < kF * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W2_s + swz_at(kF, r, f), w2 + r * kF + f, true);
  }
  cp_async_commit();
  if (tid < kF) {
    b1_s[tid] = b1[tid];
    b2_s[tid] = b2[tid];
  }
  if (s_s != rbf_s)
    for (int idx = tid; idx < kPairs * gp; idx += kThreads) rbf_s[idx] = 0.f;

  // issues the cp.async loads of listed tile v into buffer buf: dist/env,
  // then the x rows of its j tile
  auto load_tile = [&](int v, int buf) {
    const int item = v / ntj, pj = v - item * ntj, b = item / nti;
    const int i0 = (item - b * nti) * kTile, j0 = pj * kTile;
    if (tid < 2 * kPairs) {
      const int p = tid & (kPairs - 1), i = i0 + (p >> 3), j = j0 + (p & 7);
      const bool in = i < ni && j < nj;
      cp_async4(smem + kPOffDE + (2 * buf + (tid >= kPairs)) * kPairs + p,
                (tid < kPairs ? dist : env) + (in ? ((size_t)b * ni + i) * nj + j : 0), in);
    }
    for (int c = tid; c < kTile * kF / 4; c += kThreads) {
      const int r = c / (kF / 4), f = (c % (kF / 4)) * 4, j = j0 + r;
      cp_async16(smem + kPOffX + buf * kTile * kSRS + r * kSRS + f,
                 x + (j < nj ? ((size_t)b * nj + j) * kF + f : 0), j < nj);
    }
    cp_async_commit();
  };

  // this lane's share of row il = g of the current item, columns 32*wn +
  // 8*nb + 2*t + c, summed over this warp's four jl of every tile of the item
  float racc[4][2];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) racc[nb][0] = racc[nb][1] = 0.f;
  const int first = list[t_begin] / ntj;  // the run's first item
  int cur = first;                         // the item whose rows racc holds
  // writes the rows of item `cur` (warps wm = 1 hand their sums to wm = 0
  // through red_s): to `out` if the item lies whole in the run, else to
  // partial slot 0 (the run's first item) or 1 (its last); zeroes the sums.
  // Every thread calls it.
  auto flush = [&]() {
    float* red = red_s + (wn * 32 + lane) * 8;
    __syncthreads();  // the warps wm = 0 are done reading red_s (the previous flush)
    if (wm == 1) {
      st4(red, racc[0][0], racc[0][1], racc[1][0], racc[1][1]);
      st4(red + 4, racc[2][0], racc[2][1], racc[3][0], racc[3][1]);
    }
    __syncthreads();
    const int b = cur / nti, i = (cur - b * nti) * kTile + g;
    const bool whole = pre[cur] >= t_begin && pre[cur + 1] <= t_end;
    if (wm == 0 && (i < ni || !whole)) {
      const float4 r0 = ld4(red), r1 = ld4(red + 4);
      const float r[4][2] = {{r0.x, r0.y}, {r0.z, r0.w}, {r1.x, r1.y}, {r1.z, r1.w}};
      float* dst = whole ? out + ((size_t)b * ni + i) * kF
                         : part + (((size_t)blockIdx.x * 2 + (cur != first)) * kTile + g) * kF;
      dst += 32 * wn + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        *reinterpret_cast<float2*>(dst + 8 * nb) =
            make_float2(racc[nb][0] + r[nb][0], racc[nb][1] + r[nb][1]);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) racc[nb][0] = racc[nb][1] = 0.f;
  };

  int v = list[t_begin];
  load_tile(v, 0);
  for (int k = t_begin; k < t_end; ++k) {
    const int v_next = k + 1 < t_end ? list[k + 1] : 0;
    const int item = v / ntj, j0 = (v - item * ntj) * kTile;
    const int buf = (k - t_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k's rows (and the weights) have landed; every
                      // warp is done with tile k - 1's buffer
    if (k + 1 < t_end) load_tile(v_next, buf ^ 1);
    if (item != cur) {  // block-uniform: the run moves to the next item
      flush();
      cur = item;
    }
    const float* d_t = smem + kPOffDE + 2 * buf * kPairs;
    const float* e_t = d_t + kPairs;
    const float* xj_t = smem + kPOffX + buf * kTile * kSRS;

    // the filter (filter_mma.cuh), then the messages of rows i
    float acc[2][4][4];
    if (gp == kSGP)
      filter_tile_mma<kPrecise>(d_t, rbf_s, s_s, W1_s, W2_s, b1_s, G, kSGP, start, delta, coeff,
                                acc);
    else  // the hidden layer in the RBF's place
      filter_tile_mma<kPrecise, true>(d_t, rbf_s, s_s, W1_s, W2_s, b1_s, G, gp, start, delta,
                                      coeff, acc);
    tile_messages<false>(acc, b2_s, e_t, xj_t, nullptr, racc, nullptr, j0, nj, false);
    v = v_next;
  }
  flush();
}

// The items that a run boundary splits: block k (k >= 1) takes the item
// holding listed tile run_begin(k) when the boundary lies inside it and is
// its first boundary, and writes its rows as the sum of the partials of the
// blocks whose runs hold its tiles, in block order (slot 0 where the item
// is the block's first, else slot 1).
__global__ void __launch_bounds__(kThreads)
cfconv_fwd_join_kernel(float* __restrict__ out, const float* __restrict__ part,
                       const int* __restrict__ pre, const int* __restrict__ list, int B,
                       int ni, int nj, int blocks) {
  const int k = blockIdx.x, ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const long long total = pre[B * nti];
  const int t = run_begin(total, blocks, k);
  if (k == 0 || t >= total) return;
  const int item = list[t] / ntj, t0 = pre[item], t1 = pre[item + 1];
  if (t == t0 || run_begin(total, blocks, k - 1) > t0) return;  // not split here first
  const int r = threadIdx.x / (kF / 4), f = (threadIdx.x % (kF / 4)) * 4;  // 8 rows x 32 float4
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = first_run_block(t0, total, blocks); j < blocks; ++j) {
    const int rb = run_begin(total, blocks, j);
    if (rb >= t1) break;
    if (run_begin(total, blocks, j + 1) == rb) continue;  // an empty run
    const int slot = list[rb] / ntj != item;
    const float4 v = *reinterpret_cast<const float4*>(
        part + (((size_t)j * 2 + slot) * kTile + r) * kF + f);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  const int b = item / nti, i = (item - b * nti) * kTile + r;
  if (i < ni) *reinterpret_cast<float4*>(out + ((size_t)b * ni + i) * kF + f) = s;
}

// -- symmetric mode ------------------------------------------------------------

// shared memory of the symmetric kernel, in floats
constexpr int kSOffW1 = 0;                           // [kSGP][kF] swizzled
constexpr int kSOffW2 = kSOffW1 + kSGP * kF;         // [kF][kF] swizzled
constexpr int kSOffRbf = kSOffW2 + kF * kF;          // [kPairs][kSGP] swizzled
constexpr int kSOffS = kSOffRbf + kPairs * kSGP;     // [kPairs][kF] swizzled
constexpr int kSOffX = kSOffS + kPairs * kF;         // [2][2][8][kSRS] x rows: j tile, i tile
constexpr int kSOffDE = kSOffX + 4 * kTile * kSRS;   // [2][2][64] dist, env, [il][jl]
constexpr int kSOffB = kSOffDE + 4 * kPairs;         // [2][kF] b1, b2
constexpr int kSymFloats = kSOffB + 2 * kF;

// Block k of the persistent grid computes listed tiles [run_begin(k),
// run_begin(k + 1)) of the device-made tile list (worklist.cuh), in list
// order: (graph, 8-row i tile) items, and within an item its tiles pj >= pi.
// Pair p = jl*8 + il of a tile is row p of its 64-row operands; warp (wm,
// wn) owns rows 32*wm.. and columns 32*wn.. of each 64 x F product, so lane
// (g, t) holds pairs (jl = 4*wm + 2*mb + h, il = g).
__global__ void __launch_bounds__(kThreads, 1)
cfconv_fwd_sym_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                      const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* out,
                      const int* __restrict__ list, const int* __restrict__ total_p,
                      int n, int G, float start, float delta, float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem + kSOffW1;
  float* W2_s = smem + kSOffW2;
  float* rbf_s = smem + kSOffRbf;
  float* s_s = smem + kSOffS;
  float* b1_s = smem + kSOffB;
  float* b2_s = b1_s + kF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wn = warp >> 1;
  const int nt = (n + kTile - 1) / kTile;
  const long long total = *total_p;
  const int t_begin = run_begin(total, gridDim.x, blockIdx.x);
  const int t_end = run_begin(total, gridDim.x, blockIdx.x + 1);
  if (t_begin >= t_end) return;  // block-uniform: an empty run

  // the weights, once per block (W1's rows >= G and rbf's columns >= G zero)
  for (int c = tid; c < kSGP * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W1_s + swz_at(kF, r, f), w1 + (r < G ? r * kF + f : 0), r < G);
  }
  for (int c = tid; c < kF * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W2_s + swz_at(kF, r, f), w2 + r * kF + f, true);
  }
  cp_async_commit();
  if (tid < kF) {
    b1_s[tid] = b1[tid];
    b2_s[tid] = b2[tid];
  }
  for (int idx = tid; idx < kPairs * kSGP; idx += kThreads) rbf_s[idx] = 0.f;

  // issues the cp.async loads of listed tile v into buffer buf: dist/env,
  // then the x rows of its j tile and of its i tile
  auto load_tile = [&](int v, int buf) {
    const int item = v / nt, pj = v - item * nt, b = item / nt;
    const int i0 = (item - b * nt) * kTile, j0 = pj * kTile;
    if (tid < 2 * kPairs) {
      const int p = tid & (kPairs - 1), i = i0 + (p >> 3), j = j0 + (p & 7);
      const bool in = i < n && j < n;
      cp_async4(smem + kSOffDE + (2 * buf + (tid >= kPairs)) * kPairs + p,
                (tid < kPairs ? dist : env) + (in ? ((size_t)b * n + i) * n + j : 0), in);
    }
    for (int c = tid; c < 2 * kTile * kF / 4; c += kThreads) {
      const int side = c / (kTile * kF / 4), r = (c / (kF / 4)) % kTile;
      const int f = (c % (kF / 4)) * 4, a = (side ? i0 : j0) + r;
      cp_async16(smem + kSOffX + ((2 * buf + side) * kTile + r) * kSRS + f,
                 x + (a < n ? ((size_t)b * n + a) * kF + f : 0), a < n);
    }
    cp_async_commit();
  };

  // this lane's share of rows i (il = g), columns 32*wn + 8*nb + 2*t + c,
  // summed over this warp's four jl of every tile of the run's current item
  float racc[4][2];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) racc[nb][0] = racc[nb][1] = 0.f;
  int cur = list[t_begin] / nt;  // the item whose rows racc holds
  // adds racc to the rows of item `cur` and zeroes it
  auto flush = [&]() {
    const int b = cur / nt, i = (cur - b * nt) * kTile + g;
    if (i < n) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        float* dst = out + ((size_t)b * n + i) * kF + 32 * wn + 8 * nb + 2 * t;
        atomicAdd(dst, racc[nb][0]);
        atomicAdd(dst + 1, racc[nb][1]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) racc[nb][0] = racc[nb][1] = 0.f;
  };

  int v = list[t_begin];
  load_tile(v, 0);
  for (int k = t_begin; k < t_end; ++k) {
    const int v_next = k + 1 < t_end ? list[k + 1] : 0;
    const int item = v / nt, pj = v - item * nt;
    const int b = item / nt, pi = item - b * nt, j0 = pj * kTile;
    const int buf = (k - t_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k's rows (and the weights) have landed; every
                      // warp is done with tile k - 1's buffer
    if (k + 1 < t_end) load_tile(v_next, buf ^ 1);
    if (item != cur) {  // block-uniform: the run moves to the next row tile
      flush();
      cur = item;
    }
    const float* d_t = smem + kSOffDE + 2 * buf * kPairs;
    const float* e_t = d_t + kPairs;
    const float* xj_t = smem + kSOffX + 2 * buf * kTile * kSRS;
    const float* xi_t = xj_t + kTile * kSRS;

    // the filter (filter_mma.cuh), then the messages
    float acc[2][4][4];
    filter_tile_mma<kPrecise>(d_t, rbf_s, s_s, W1_s, W2_s, b1_s, G, kSGP, start, delta, coeff, acc);
    tile_messages<true>(acc, b2_s, e_t, xj_t, xi_t, racc, out + (size_t)b * n * kF, j0, n,
                        pi != pj);
    v = v_next;
  }
  flush();
}

static size_t smem_bytes(int G, int symmetric) {
  if (symmetric) return sizeof(float) * (size_t)kSymFloats;
  const int gp = padded_g(G);
  const int hidden = gp == kSGP ? kPairs * (gp + kF) : kPairs * (gp > kF ? gp : kF);
  return sizeof(float) * ((size_t)kPOffW1 + (size_t)gp * kF + hidden);
}

extern "C" size_t cfconv_fwd_smem_bytes(int G, int symmetric) {
  return geossl::smem_bytes(G, symmetric);
}

// The tile list's ints, rounded up to whole 16-byte groups.
static size_t list_ints(int B, int ni, int nj) {
  const size_t n = tile_list_ints((size_t)B * ((ni + kTile - 1) / kTile), (nj + kTile - 1) / kTile);
  return (n + 3) / 4 * 4;
}

}  // namespace geossl

// Ints of the workspace: the tile list over env (worklist.cuh), items
// (graph, 8-row i tile), then in the plain mode its partials
// [blocks][2][8][F] (floats).
extern "C" size_t cfconv_fwd_ws_ints(int B, int ni, int nj, int symmetric) {
  using namespace geossl;
  if (symmetric) return list_ints(B, ni, nj);
  const int blocks =
      persistent_blocks(B * ((ni + kTile - 1) / kTile) * ((nj + kTile - 1) / kTile));
  return list_ints(B, ni, nj) + (size_t)blocks * 2 * kTile * kF;
}

// Returns the cudaError_t of the launches (0 on success). F must be 128;
// `ws` holds cfconv_fwd_ws_ints(B, ni, nj, symmetric) ints. With symmetric != 0:
// dist/env symmetric and square, G <= 64, `out` zero on entry; otherwise
// any G whose shared memory fits (cfconv_fwd_smem_bytes), every row of
// `out` written.
extern "C" int cfconv_fwd(const float* dist, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int* ws, int B, int ni, int nj,
                          int F, int G, float start, float delta, float coeff,
                          int symmetric, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || G < 1 || (symmetric && (ni != nj || G > kSGP)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, symmetric);
  cudaStream_t s = (cudaStream_t)stream;
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile, items = B * nti;
  cudaError_t err = symmetric ? make_tile_list<true>(env, ws, B, ni, nj, sparse, s)
                              : make_tile_list<false>(env, ws, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * ntj + items;
  const int* list = ws + worklist_ints(items, ntj);
  if (!symmetric) {
    err = cudaFuncSetAttribute(cfconv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = persistent_blocks(items * ntj);
    float* part = reinterpret_cast<float*>(ws + list_ints(B, ni, nj));
    cfconv_fwd_kernel<<<blocks, kThreads, smem, s>>>(dist, env, x, w1, b1, w2, b2, out, part,
                                                     pre, list, B, ni, nj, G, start, delta,
                                                     coeff);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cfconv_fwd_join_kernel<<<blocks, kThreads, 0, s>>>(out, part, pre, list, B, ni, nj, blocks);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(cfconv_fwd_sym_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cfconv_fwd_sym_kernel<<<persistent_blocks(items * ntj), kThreads, smem, s>>>(
      dist, env, x, w1, b1, w2, b2, out, list, pre + items, ni, G, start, delta, coeff);
  return (int)cudaGetLastError();
}
