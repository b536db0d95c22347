// A work list of occupied 8x8 pair tiles, made on the device with no host
// sync, shared by the persistent kernels (cfconv_bwd.cu, painn_bwd.cu,
// schnet_stack.cu, painn_stack.cu, both modes of cfconv_fwd.cu, painn_fwd.cu's
// plain mode, ncsn_score.cu's forward and backward), and the grid barrier of
// the cooperative ones.
//
// An occupancy pass (one block per graph and 8-row band; BY_ROW, one warp
// per item) flags the tiles to compute (with `sparse` those whose
// env is not all zero; with SYM only the tiles pi <= pj), writes zero on the
// other tiles of up to five pair grids (a backward's pair cotangents: the
// occupancy contract of geossl_tpu/ops/pallas_utils.py) and counts each
// item's tiles. An item is
// (graph, 8-column j tile) with its tiles listed over pi, or, BY_ROW,
// (graph, 8-row i tile) with its tiles listed over pj. A one-block scan turns
// the counts into prefix sums, by which a persistent grid splits the work
// into contiguous runs (first_item, or a kernel's own split by tile).
#pragma once

#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace geossl {

constexpr int kOccThreads = 256;

// Up to five [B, ni, nj] grids to zero on the tiles that are not computed.
struct ZeroGrids {
  float* g[5];
  int n;
};

// Block (pi, b) flags the computed tiles of its 8-row band: occ[item][tile]
// with item (b, pj) and tile pi.
template <bool SYM>
__global__ void __launch_bounds__(kOccThreads)
tile_occ_kernel(const float* __restrict__ env, int* __restrict__ occ,
                int* __restrict__ cnt, ZeroGrids zero, int ni, int nj, int sparse) {
  extern __shared__ int flag_s[];  // [ntj]
  const int tid = threadIdx.x, pi = blockIdx.x, b = blockIdx.y;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int i0 = pi * kTile, rows = min(kTile, ni - i0);
  const size_t base = ((size_t)b * ni + i0) * nj;
  for (int t = tid; t < ntj; t += kOccThreads) flag_s[t] = !sparse;
  __syncthreads();
  if (sparse) {
    const int js = SYM ? i0 : 0, w = nj - js;  // SYM: tiles left of the diagonal are skipped
    for (int idx = tid; idx < rows * w; idx += kOccThreads) {
      const int r = idx / w, j = js + idx - r * w;
      if (env[base + (size_t)r * nj + j] != 0.f) flag_s[j / kTile] = 1;
    }
    __syncthreads();
  }
  for (int pj = tid; pj < ntj; pj += kOccThreads) {
    const int on = (!SYM || pi <= pj) && flag_s[pj];
    occ[((size_t)b * ntj + pj) * nti + pi] = on;
    if (on) atomicAdd(&cnt[b * ntj + pj], 1);
    flag_s[pj] = on;
  }
  __syncthreads();
  if (zero.n == 0) return;
  for (int idx = tid; idx < rows * nj; idx += kOccThreads) {
    const int r = idx / nj, j = idx - r * nj;
    if (!flag_s[j / kTile]) {
      for (int k = 0; k < zero.n; ++k) zero.g[k][base + (size_t)r * nj + j] = 0.f;
    }
  }
}

// The same flags for BY_ROW items (b, pi), tiles pj, with no grids to zero:
// one warp per item, its lanes over the item's j tiles, the item's count
// written once (no atomics, no memset).
template <bool SYM>
__global__ void __launch_bounds__(kOccThreads)
row_occ_kernel(const float* __restrict__ env, int* __restrict__ occ, int* __restrict__ cnt,
               int items, int ni, int nj, int sparse) {
  const int item = blockIdx.x * (kOccThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (item >= items) return;
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile;
  const int b = item / nti, pi = item - b * nti, i0 = pi * kTile, rows = min(kTile, ni - i0);
  const float* base = env + ((size_t)b * ni + i0) * nj;
  int n = 0;
  for (int t0 = 0; t0 < ntj; t0 += 32) {
    const int pj = t0 + lane;
    bool on = pj < ntj && (!SYM || pi <= pj);
    if (on && sparse) {
      const int j0 = pj * kTile, cols = min(kTile, nj - j0);
      bool any = false;
      for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c) any |= base[(size_t)r * nj + j0 + c] != 0.f;
      on = any;
    }
    if (pj < ntj) occ[(size_t)item * ntj + pj] = on;
    n += __popc(__ballot_sync(0xffffffffu, on));
  }
  if (lane == 0) cnt[item] = n;
}

// Exclusive prefix sums of the n item counts: pre[0..n], pre[n] the total.
__global__ void __launch_bounds__(1024)
tile_scan_kernel(const int* __restrict__ cnt, int* __restrict__ pre, int n) {
  __shared__ int part_s[1024];
  const int tid = threadIdx.x, per = (n + 1023) / 1024;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += cnt[i];
  part_s[tid] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = tid >= off ? part_s[tid - off] : 0;
    __syncthreads();
    part_s[tid] += v;
    __syncthreads();
  }
  int run = part_s[tid] - s;
  for (int i = lo; i < hi; ++i) {
    pre[i] = run;
    run += cnt[i];
  }
  if (tid == 1023) pre[n] = part_s[1023];
}

// First item whose block, by work, is >= k: item i goes to block
// min(nb - 1, (pre[i] + pre[i+1]) * nb / (2 total)), the block holding the
// middle of its work. Items are never split between blocks.
__device__ inline int first_item(const int* __restrict__ pre, int n, int nb, int k) {
  const long long t2 = 2LL * max(pre[n], 1);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long key = min((long long)nb - 1,
                              (long long)(pre[mid] + pre[mid + 1]) * nb / t2);
    if (key >= k)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// A barrier across the whole (co-resident) grid of a cooperative launch
// (schnet_stack.cu, painn_stack.cu): bar[0] counts arrivals,
// bar[1] is the generation; both zero at launch.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = atomicAdd(bar + 1, 0u);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (atomicAdd(bar + 1, 0u) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Ints of a work list over `items` items of `tiles` tiles each: flags
// [items * tiles], counts [items], prefix sums [items + 1].
inline size_t worklist_ints(size_t items, size_t tiles) { return items * tiles + 2 * items + 1; }

// The occupancy pass and the scan on stream s; ws holds worklist_ints ints.
// BY_ROW lists zero no grids (zero.n must be 0).
template <bool SYM, bool BY_ROW>
inline cudaError_t make_worklist(const float* env, int* ws, ZeroGrids zero, int B, int ni,
                                 int nj, int sparse, cudaStream_t s) {
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int items = B * (BY_ROW ? nti : ntj);
  int* occ = ws;
  int* cnt = occ + (size_t)items * (BY_ROW ? ntj : nti);
  int* pre = cnt + items;
  if (BY_ROW) {
    if (zero.n != 0) return cudaErrorInvalidValue;
    const int per = kOccThreads / 32;
    row_occ_kernel<SYM><<<(items + per - 1) / per, kOccThreads, 0, s>>>(env, occ, cnt, items,
                                                                       ni, nj, sparse);
  } else {
    cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)items, s);
    if (err != cudaSuccess) return err;
    tile_occ_kernel<SYM><<<dim3(nti, B), kOccThreads, sizeof(int) * ntj, s>>>(
        env, occ, cnt, zero, ni, nj, sparse);
  }
  tile_scan_kernel<<<1, 1024, 0, s>>>(cnt, pre, items);
  return cudaGetLastError();
}

// The listed tiles one by one (BY_ROW lists: cfconv_fwd.cu's symmetric
// mode, painn_fwd.cu's plain mode, ncsn_score.cu): list[pre[item] + r] = item * n_t + the
// item's r-th computed tile, and pos[item * n_t + t] = the list position of
// tile t of the item, or -1 where it is not computed. One warp per item.
__global__ void __launch_bounds__(kOccThreads)
tile_list_kernel(const int* __restrict__ occ, const int* __restrict__ pre, int items,
                 int n_t, int* __restrict__ list, int* __restrict__ pos) {
  const int item = blockIdx.x * (kOccThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= items) return;
  const int* row = occ + (size_t)item * n_t;
  int at = pre[item];
  for (int base = 0; base < n_t; base += 32) {
    const int t = base + lane;
    const bool on = t < n_t && row[t];
    const unsigned m = __ballot_sync(0xffffffffu, on);
    const int p = at + __popc(m & ((1u << lane) - 1u));
    if (on) list[p] = item * n_t + t;
    if (t < n_t) pos[(size_t)item * n_t + t] = on ? p : -1;
    at += __popc(m);
  }
}

// Ints of a work list with its tile list (make_tile_list): the work list,
// then list [items * tiles] and pos [items * tiles].
inline size_t tile_list_ints(size_t items, size_t tiles) {
  return worklist_ints(items, tiles) + 2 * items * tiles;
}

// make_worklist<SYM, true> over a [B, ni, nj] grid, then the tile list.
// With nti, ntj its 8-row and 8-column tiles, ws holds tile_list_ints(B *
// nti, ntj) ints: flags, counts, prefix sums (pre[B * nti] is the number of
// listed tiles), list, pos.
template <bool SYM>
inline cudaError_t make_tile_list(const float* env, int* ws, int B, int ni, int nj, int sparse,
                                  cudaStream_t s) {
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile, items = B * nti;
  ZeroGrids none = {{nullptr}, 0};
  cudaError_t err = make_worklist<SYM, true>(env, ws, none, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return err;
  const int* occ = ws;
  const int* pre = ws + (size_t)items * ntj + items;
  const int per = kOccThreads / 32;
  int* list = ws + worklist_ints(items, ntj);
  int* pos = list + (size_t)items * ntj;
  tile_list_kernel<<<(items + per - 1) / per, kOccThreads, 0, s>>>(occ, pre, items, ntj, list,
                                                                   pos);
  return cudaGetLastError();
}

// The first tile of block k's run when `total` listed tiles are split into
// equal runs over `blocks` blocks (lengths differ by at most one).
__host__ __device__ inline int run_begin(long long total, int blocks, int k) {
  return (int)(total * k / blocks);
}

// The first block whose run (run_begin) may hold listed tile t0: the last
// block starting at or before it. Blocks from there on hold the tiles t0..
// while their runs start before the item's end (some runs may be empty).
__host__ __device__ inline int first_run_block(int t0, long long total, int blocks) {
  return (int)(((long long)(t0 + 1) * blocks + total - 1) / total) - 1;
}

// The item's computed tiles, in order, into tl_s (warp 0 only); returns
// their number on every lane of warp 0. row: the item's flags.
__device__ inline int item_tiles(const int* __restrict__ row, int n_t, int* tl_s) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < n_t; base += 32) {
    const bool on = base + lane < n_t && row[base + lane];
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (on) tl_s[n + __popc(m & ((1u << lane) - 1u))] = base + lane;
    n += __popc(m);
  }
  return n;
}

}  // namespace geossl
