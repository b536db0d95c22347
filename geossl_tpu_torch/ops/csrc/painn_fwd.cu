// painn_fwd: PaiNN's inter-atomic message pass, forward, in one kernel.
//
//   w        = (phi(d) Wk + bk) * gate            [B,Ni,Nj,3F], never stored
//   dq[i]    = sum_j wq xq_j
//   dmu_c[i] = sum_j wr xr_j dir_c[i,j] + sum_j wm xm_j mu_c[j]
//
// Replaces geossl_tpu/ops/painn_pallas.py: _fwd_kernel (painn_message_fused
// via _fwd_pallas), as painn_fwd_mma_kernel, and _fwd_sym_kernel
// (painn_message_fused_sym via _fwd_sym_pallas), as painn_fwd_sym_kernel. As
// there, the gated filter tensor stays on the chip: the kernels read dist,
// gate and the three direction grids [B,Ni,Nj], x and mu [B,Nj,3F] and write
// dq [B,Ni,F] and dmu [B,Ni,3F] (mu c-major).
//
// Bound on the H100: operations. The filter costs 2*R*3F FLOP per pair
// (15.4k at R=20, F=128) and the three message sums ~14F more, against 20
// bytes of pair grids per pair, far above the card's ridge. Both kernels
// skip work: with `sparse`, 8x8 tiles whose gate is all zero (out of cutoff,
// padding, empty graph slots).
//
// Plain mode (painn_fwd_mma_kernel), one block of 16 warps per SM; its tile
// body, painn_fwd_items, is painn_mma.cuh, which painn_stack.cu runs too:
// - work list: an occupancy pass and a scan make the list of computed tiles
//   on the device (worklist.cuh, no host sync), in (graph, 8-row i tile)
//   items, each with its j tiles. The persistent grid splits the items into
//   contiguous runs of equal work by the prefix sums (first_item);
//   items are never split, so each dq/dmu row is summed in registers by one
//   block and written once, with no atomics: the output is bitwise the same
//   from run to run on one card. The rows of an item with no listed tile
//   (padding, empty graph slots, an all-zero gate under `sparse`) are
//   written as zeros, spread over the grid;
// - products: the gated filter w = ([phi; 1] gate) [Wk; bk] of each tile, 64
//   pairs x 3F, on the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32
//   (mma_tf32.cuh) in the plain split: the filter feeds the messages
//   linearly (no relu, no chained product), and the errors stay at ~1.4% of
//   chip_smoke.py's tolerance (the precise mode: 1.2%, for 13% more time;
//   PERF.md). The operands are stored in mma fragment order, split into
//   their TF32 parts once: [Wk; bk] once per block, the A rows [phi; 1]
//   gate once per tile (the RBF's exp on the CUDA cores, folding the gate
//   in); a warp loads its A fragments once a tile for the three 128-wide
//   chunks and each B fragment with one 128-bit load;
// - messages: the three message sums on the CUDA cores, in the mma
//   fragments' layout. Pair p = jl*8 + il is row p, so lane (g, t) of warp
//   (wm, wn) holds row il = g for the warp's four jl: the sum over j of a
//   row stays in the lane's registers over all of an item's tiles, with no
//   shuffle per tile, and the two warps wm are added once per item, through
//   shared memory, in a fixed order. The warp's 16 filter columns are
//   permuted so that a lane holds four consecutive features (16-byte x/mu
//   loads and row stores). The k steps of chunk c + 1 are issued between the
//   message groups of chunk c;
// - loads: the pair grids two tiles ahead and the x/mu rows one tile ahead
//   (cp.async), the next tile's A fragments made while the current tile's
//   first products run, the list entries read a tile ahead: one barrier
//   per tile.
//
// Symmetric mode (painn_fwd_sym_kernel; symmetric dist/gate, antisymmetric
// directions, square grid), plain f32 FMAs on the CUDA cores, one block per
// (graph, 8-row i tile), the scheme of cfconv_bwd.cu's SYM mode: tile (pi,
// pj) is computed iff pi <= pj, so each filter is computed once per
// unordered pair of tiles. A computed tile with pi < pj also emits the
// messages of its mirror tile (pj, pi): the same filter, the direction terms
// negated (painn_tile.cuh, MIRROR). Those land on the tile's j rows: summed
// over the tile's 8 rows i in shared memory, then added to dq/dmu with
// global atomicAdd, as is each block's own row sum. So dq and dmu must be
// zero on entry and their summation order varies from run to run. The
// diagonal tile holds both orders of its pairs and emits no mirror. At the
// LBA shape (B=64, N=512, cutoff 5) the symmetric function's bound is bytes,
// not operations: the five pair grids' upper triangles outweigh the filters
// of the few in-cutoff pairs.
#include "painn_mma.cuh"
#include "reduce.cuh"

namespace geossl {

// -- plain mode: tensor-core filter (painn_mma.cuh) ---------------------------------

// Block k runs items [first_item(k), first_item(k + 1)) of the tile list
// (painn_fwd_items). KS k steps: K = 8 KS >= R + 1.
template <int KS>
__global__ void __launch_bounds__(kFwdThreads, 1)
painn_fwd_mma_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                     const float* __restrict__ dirx, const float* __restrict__ diry,
                     const float* __restrict__ dirz, const float* __restrict__ x,
                     const float* __restrict__ mu, const float* __restrict__ wk,
                     const float* __restrict__ bk, float* __restrict__ dq,
                     float* __restrict__ dmu, const int* __restrict__ pre,
                     const int* __restrict__ list, int B, int ni, int nj, int R, float delta,
                     float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  painn_fwd_items<KS>(reinterpret_cast<float*>(smem_v4), dist, gate, dirx, diry, dirz, x, mu,
                      wk, bk, dq, dmu, pre, list, B, ni, nj, R, delta, coeff);
}


// -- symmetric mode: f32 FMAs on the CUDA cores --------------------------------------

__global__ void __launch_bounds__(kThreads)
painn_fwd_sym_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                     const float* __restrict__ dirx, const float* __restrict__ diry,
                     const float* __restrict__ dirz, const float* __restrict__ x,
                     const float* __restrict__ mu, const float* __restrict__ wk,
                     const float* __restrict__ bk, float* __restrict__ dq,
                     float* __restrict__ dmu, int ni, int nj, int R, float delta,
                     float coeff, int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem;                    // [R][kF3]
  float* phi_s = Wk_s + R * kF3;         // [R][kPhiS]
  float* xj_s = phi_s + R * kPhiS;       // [kTile][kF3]
  float* muj_s = xj_s + kTile * kF3;     // [kTile][kF3]
  float* pr_s = muj_s + kTile * kF3;     // [5][kPairs]
  float* xi_s = pr_s + 5 * kPairs;       // [kTile][kF3]  x rows of the block
  float* mui_s = xi_s + kTile * kF3;     // [kTile][kF3]  mu rows of the block
  float* mir_s = mui_s + kTile * kF3;    // [kTile][kF4]  mirrored messages
  int* occ_s = (int*)(mir_s + kTile * kF4);  // [ntj]

  const int tid = threadIdx.x;
  const int pi = blockIdx.x, b = blockIdx.y;
  const int i0 = pi * kTile;
  const size_t grid_off = (size_t)b * ni * nj;
  const float* gate_b = gate + grid_off;
  const float* x_b = x + (size_t)b * nj * kF3;
  const float* mu_b = mu + (size_t)b * nj * kF3;

  float aq[kFPT], am[3][kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    aq[k] = 0.f;
    am[0][k] = am[1][k] = am[2][k] = 0.f;
  }

  for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
    const int i = i0 + idx / kF3;
    const size_t src = (size_t)i * kF3 + idx % kF3;
    xi_s[idx] = i < ni ? x_b[src] : 0.f;
    mui_s[idx] = i < ni ? mu_b[src] : 0.f;
  }

  const int ntj = (nj + kTile - 1) / kTile;
  if (sparse) {
    for (int t = tid; t < ntj; t += kThreads) occ_s[t] = 0;
    __syncthreads();
    const int rows = min(kTile, ni - i0), cols = nj - i0;
    for (int idx = tid; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, j = i0 + idx - r * cols;
      if (gate_b[(size_t)(i0 + r) * nj + j] != 0.f) occ_s[j / kTile] = 1;
    }
    __syncthreads();
  }

  bool staged = false;
  for (int pj = pi; pj < ntj; ++pj) {
    if (sparse && !occ_s[pj]) continue;  // block-uniform
    const int j0 = pj * kTile;
    const bool mirror = pj != pi;  // block-uniform
    __syncthreads();  // the previous tile is done with pr_s, phi_s, xj_s, muj_s, mir_s
    if (tid < kPairs)
      painn_load_pairs(pr_s, dist + grid_off, gate_b, dirx + grid_off,
                       diry + grid_off, dirz + grid_off, i0 + tid / kTile,
                       j0 + tid % kTile, ni, nj, tid);
    if (!staged) {
      block_copy(Wk_s, wk, R * kF3);
      staged = true;
    }
    for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
      const int j = j0 + idx / kF3;
      const size_t src = (size_t)j * kF3 + idx % kF3;
      xj_s[idx] = j < nj ? x_b[src] : 0.f;
      muj_s[idx] = j < nj ? mu_b[src] : 0.f;
    }
    if (mirror)
      for (int idx = tid; idx < kTile * kF4; idx += kThreads) mir_s[idx] = 0.f;
    __syncthreads();
    painn_rbf(pr_s, phi_s, R, delta, coeff);
    __syncthreads();
    if (!mirror) {
      painn_tile_messages<kF3>(pr_s, phi_s, Wk_s, bk, R, xj_s, muj_s, aq, am);
      continue;
    }
    painn_tile_messages<kF3, true>(pr_s, phi_s, Wk_s, bk, R, xj_s, muj_s, aq, am, xi_s,
                                   mui_s, mir_s);
    __syncthreads();  // mir_s complete
    for (int idx = tid; idx < kTile * kF4; idx += kThreads) {
      const int j = j0 + idx / kF4, t = idx % kF4;
      if (j >= nj) continue;
      if (t < kF)
        atomicAdd(&dq[((size_t)b * ni + j) * kF + t], mir_s[idx]);
      else
        atomicAdd(&dmu[((size_t)b * ni + j) * kF3 + t - kF], mir_s[idx]);
    }
  }

  // the two half-warps of a warp hold columns 0-3 and 4-7 of one row
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    aq[k] += __shfl_xor_sync(0xffffffffu, aq[k], 16);
#pragma unroll
    for (int c = 0; c < 3; ++c) am[c][k] += __shfl_xor_sync(0xffffffffu, am[c][k], 16);
  }
  const int fg = thread_fg(), i = i0 + thread_il();
  if ((tid & 16) == 0 && i < ni) {
    float* dq_row = dq + ((size_t)b * ni + i) * kF;
    float* dmu_row = dmu + ((size_t)b * ni + i) * kF3;
#pragma unroll
    for (int k = 0; k < kFPT; ++k) {
      const int f = feat(fg, k);
      atomicAdd(&dq_row[f], aq[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&dmu_row[c * kF + f], am[c][k]);
    }
  }
}

static size_t smem_bytes(int R, int nj, int symmetric) {
  if (!symmetric) return sizeof(float) * (size_t)kFwdFloats;
  return sizeof(float) * ((size_t)R * kF3 + (size_t)R * kPhiS + 4 * kTile * kF3 + 5 * kPairs +
                          kTile * kF4) +
         sizeof(int) * (size_t)((nj + kTile - 1) / kTile);
}

}  // namespace geossl

extern "C" size_t painn_fwd_smem_bytes(int R, int nj, int symmetric) {
  return geossl::smem_bytes(R, nj, symmetric);
}

// Ints of the plain mode's workspace: the tile list over the gate
// (worklist.cuh), items (graph, 8-row i tile).
extern "C" size_t painn_fwd_ws_ints(int B, int ni, int nj) {
  using namespace geossl;
  return tile_list_ints((size_t)B * ((ni + kTile - 1) / kTile), (nj + kTile - 1) / kTile);
}

// Returns the cudaError_t of the launches (0 on success). F must be 128 and
// 2 <= R <= 31. Plain mode: `ws` holds painn_fwd_ws_ints(B, ni, nj) ints.
// With `symmetric` (square grid only) dq and dmu must be zero on entry and
// ws is not read.
extern "C" int painn_fwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk, float* dq,
                         float* dmu, int* ws, int B, int ni, int nj, int F, int R, float delta,
                         float coeff, int symmetric, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > kRP - 1 || (symmetric && ni != nj))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, nj, symmetric);
  cudaStream_t s = (cudaStream_t)stream;
  if (symmetric) {
    cudaError_t err = cudaFuncSetAttribute(
        painn_fwd_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    painn_fwd_sym_kernel<<<dim3((ni + kTile - 1) / kTile, B), kThreads, smem, s>>>(
        dist, gate, dirx, diry, dirz, x, mu, wk, bk, dq, dmu, ni, nj, R, delta, coeff, sparse);
    return (int)cudaGetLastError();
  }
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile;
  const int items = B * nti;
  cudaError_t err = make_tile_list<false>(gate, ws, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * ntj + items;
  const int* list = ws + worklist_ints(items, ntj);
  auto kernel = R < 24 ? painn_fwd_mma_kernel<3> : painn_fwd_mma_kernel<kKS>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<persistent_blocks(items), kFwdThreads, smem, s>>>(dist, gate, dirx, diry, dirz, x, mu,
                                                             wk, bk, dq, dmu, pre, list, B, ni,
                                                             nj, R, delta, coeff);
  return (int)cudaGetLastError();
}
