// painn_fwd: PaiNN's inter-atomic message pass, forward, in one kernel.
//
//   w        = (phi(d) Wk + bk) * gate            [B,Ni,Nj,3F], never stored
//   dq[i]    = sum_j wq xq_j
//   dmu_c[i] = sum_j wr xr_j dir_c[i,j] + sum_j wm xm_j mu_c[j]
//
// Replaces geossl_tpu/ops/painn_pallas.py: _fwd_kernel (painn_message_fused
// via _fwd_pallas), as painn_fwd_mma_kernel<KS, false>, and _fwd_sym_kernel
// (painn_message_fused_sym via _fwd_sym_pallas), as painn_fwd_mma_kernel<KS,
// true>. As there, the gated filter tensor stays on the chip: the kernels read dist,
// gate and the three direction grids [B,Ni,Nj], x and mu [B,Nj,3F] and write
// dq [B,Ni,F] and dmu [B,Ni,3F] (mu c-major).
//
// Bound on the H100: operations. The filter costs 2*R*3F FLOP per pair
// (15.4k at R=20, F=128) and the three message sums ~14F more, against 20
// bytes of pair grids per pair, far above the card's ridge. Both modes
// skip work: with `sparse`, 8x8 tiles whose gate is all zero (out of cutoff,
// padding, empty graph slots).
//
// Plain mode (painn_fwd_mma_kernel<KS, false>), one block of 16 warps per SM; its tile
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
// Symmetric mode (painn_fwd_mma_kernel<KS, true>; symmetric dist/gate,
// antisymmetric directions, square grid), the scheme of cfconv_bwd.cu's SYM
// mode on the same tile body (painn_mma.cuh, SYM): the tile list holds the
// tiles pi <= pj (make_tile_list<true>), so each gated filter is computed
// once per unordered pair of tiles, and a tile with pi < pj also emits the
// messages of its mirror tile (pj, pi): the same filter, the direction
// terms negated. Those are summed over the tile's 8 rows i in registers
// (the 8 lanes of one t) and added to the tile's j rows with float2
// atomics, once per tile; each item's own rows are added with float4
// atomics when its run ends. So dq and dmu must be zero on entry and their
// summation order varies from run to run. The diagonal tile holds both
// orders of its pairs and emits no mirror. The item's x and mu rows (the
// mirror's sending side) are staged once per item: ~221 KB of shared
// memory.
#include "painn_mma.cuh"
#include "reduce.cuh"

namespace geossl {

// Block k runs items [first_item(k), first_item(k + 1)) of the tile list
// (painn_fwd_items). KS k steps: K = 8 KS >= R + 1; SYM the symmetric mode.
template <int KS, bool SYM>
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
  painn_fwd_items<KS, SYM>(reinterpret_cast<float*>(smem_v4), dist, gate, dirx, diry, dirz, x,
                           mu, wk, bk, dq, dmu, pre, list, B, ni, nj, R, delta, coeff);
}

static size_t smem_bytes(int symmetric) {
  return sizeof(float) * (size_t)(symmetric ? kFwdSymFloats : kFwdFloats);
}

}  // namespace geossl

extern "C" size_t painn_fwd_smem_bytes(int symmetric) { return geossl::smem_bytes(symmetric); }

// Ints of the workspace (both modes): the tile list over the gate
// (worklist.cuh), items (graph, 8-row i tile).
extern "C" size_t painn_fwd_ws_ints(int B, int ni, int nj) {
  using namespace geossl;
  return tile_list_ints((size_t)B * ((ni + kTile - 1) / kTile), (nj + kTile - 1) / kTile);
}

// Returns the cudaError_t of the launches (0 on success). F must be 128 and
// 2 <= R <= 31; `ws` holds painn_fwd_ws_ints(B, ni, nj) ints. With
// `symmetric` (square grid only) dq and dmu must be zero on entry.
extern "C" int painn_fwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk, float* dq,
                         float* dmu, int* ws, int B, int ni, int nj, int F, int R, float delta,
                         float coeff, int symmetric, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > kRP - 1 || (symmetric && ni != nj))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(symmetric);
  cudaStream_t s = (cudaStream_t)stream;
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile;
  const int items = B * nti;
  cudaError_t err = symmetric ? make_tile_list<true>(gate, ws, B, ni, nj, sparse, s)
                              : make_tile_list<false>(gate, ws, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + (size_t)items * ntj + items;
  const int* list = ws + worklist_ints(items, ntj);
  auto kernel = symmetric
                    ? (R < 24 ? painn_fwd_mma_kernel<3, true> : painn_fwd_mma_kernel<kKS, true>)
                    : (R < 24 ? painn_fwd_mma_kernel<3, false> : painn_fwd_mma_kernel<kKS, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<persistent_blocks(items), kFwdThreads, smem, s>>>(dist, gate, dirx, diry, dirz, x, mu,
                                                             wk, bk, dq, dmu, pre, list, B, ni,
                                                             nj, R, delta, coeff);
  return (int)cudaGetLastError();
}
