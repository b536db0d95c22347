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
//
// R above kOnePassR (pair_tile.cuh): the streamed instances
// (painn_fwd_mma_kernel<KS, SYM, true>) run the filter product in passes
// over chunks of at most 32 of its K rows (rbf_chunk), one launch a chunk
// over the one work list. Each pass stages its chunk's rows of Wk (and, in
// the last, bk) in WkF, reads its offsets from the plain version's offset
// table (an ulp of an offset weighs more as the RBF narrows with R), and
// adds its messages to the previous passes' (the messages are linear in the
// filter): the plain mode's rows are read back and rewritten by the thread
// that wrote them, the symmetric mode's added with atomics as always. Each
// pass repeats the message sums, so R = 64 (three passes) costs about three
// R = 20 launches. Up to R = 31 the instances are the one-pass code.
#include "painn_mma.cuh"
#include "reduce.cuh"

namespace geossl {

// Block k runs items [first_item(k), first_item(k + 1)) of the tile list
// (painn_fwd_items). KS k steps: K = 8 KS >= R + 1; SYM the symmetric mode;
// STREAM a pass of a streamed filter product (painn_fwd_items: R the
// chunk's rows, offs their offsets, bias, accum).
template <int KS, bool SYM, bool STREAM = false>
__global__ void __launch_bounds__(kFwdThreads, 1)
painn_fwd_mma_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                     const float* __restrict__ dirx, const float* __restrict__ diry,
                     const float* __restrict__ dirz, const float* __restrict__ x,
                     const float* __restrict__ mu, const float* __restrict__ wk,
                     const float* __restrict__ bk, float* __restrict__ dq,
                     float* __restrict__ dmu, const int* __restrict__ pre,
                     const int* __restrict__ list, int B, int ni, int nj, int R, float delta,
                     float coeff, const float* __restrict__ offs, bool bias, bool accum) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  painn_fwd_items<KS, SYM, STREAM>(reinterpret_cast<float*>(smem_v4), dist, gate, dirx, diry,
                                   dirz, x, mu, wk, bk, dq, dmu, pre, list, B, ni, nj, R, delta,
                                   coeff, offs, bias, accum);
}

// One launch of `kernel` (its dynamic shared memory set first).
template <typename Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, cudaStream_t s, int items,
                          const float* dist, const float* gate, const float* dirx,
                          const float* diry, const float* dirz, const float* x, const float* mu,
                          const float* wk, const float* bk, float* dq, float* dmu, const int* pre,
                          const int* list, int B, int ni, int nj, int R, float delta, float coeff,
                          const float* offs, bool bias, bool accum) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<persistent_blocks(items), kFwdThreads, smem, s>>>(dist, gate, dirx, diry, dirz, x, mu,
                                                             wk, bk, dq, dmu, pre, list, B, ni,
                                                             nj, R, delta, coeff, offs, bias,
                                                             accum);
  return cudaGetLastError();
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

// The chunks of an R-row filter product that every PaiNN kernel runs
// (pair_tile.cuh's rbf_chunk): writes (first RBF row, RBF rows, 1 if the
// bias row follows) for each into `out` (3 ints a chunk; null: nothing is
// written) and returns their count.
extern "C" int painn_rbf_chunks(int R, int* out) {
  using namespace geossl;
  if (R < 1) return 0;
  const int n = rbf_chunks(R);
  for (int c = 0; out && c < n; ++c) {
    const RbfChunk ch = rbf_chunk(R, c);
    out[3 * c] = ch.r0;
    out[3 * c + 1] = ch.rows;
    out[3 * c + 2] = ch.bias ? 1 : 0;
  }
  return n;
}

// K steps (KS: K = 8 KS) of the painn_fwd_mma_kernel instance that a launch
// at R RBF rows runs.
extern "C" int painn_fwd_ks(int R) {
  using namespace geossl;
  return (R > kOnePassR ? rbf_chunk_size(R) <= 24 : R < 24) ? 3 : kKS;
}

// Returns the cudaError_t of the launches (0 on success) and adds to
// `*launches` one for each kernel launch it made (one a filter pass: one up
// to R = kOnePassR, painn_rbf_chunks(R) above). F must be 128 and R >= 2;
// above R = kOnePassR `offs` holds the R RBF offsets (else it is not read
// and may be null). `ws` holds painn_fwd_ws_ints(B, ni, nj) ints. With
// `symmetric` (square grid only) dq and dmu must be zero on entry.
extern "C" int painn_fwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk, const float* offs,
                         float* dq, float* dmu, int* ws, int B, int ni, int nj, int F, int R,
                         float delta, float coeff, int symmetric, int sparse, void* stream,
                         int* launches) {
  using namespace geossl;
  const bool streamed = R > kOnePassR;
  if (F != kF || R < 2 || (streamed && !offs) || (symmetric && ni != nj) || !launches)
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
  // K = 24 when the product's rows (a streamed pass's chunk) fit it
  const bool ks3 = painn_fwd_ks(R) == 3;
  if (!streamed) {
    auto kernel =
        symmetric ? (ks3 ? painn_fwd_mma_kernel<3, true> : painn_fwd_mma_kernel<kKS, true>)
                  : (ks3 ? painn_fwd_mma_kernel<3, false> : painn_fwd_mma_kernel<kKS, false>);
    err = launch(kernel, smem, s, items, dist, gate, dirx, diry, dirz, x, mu, wk, bk, dq, dmu,
                 pre, list, B, ni, nj, R, delta, coeff, nullptr, true, false);
    if (err == cudaSuccess) ++*launches;
    return (int)err;
  }
  auto kernel = symmetric ? (ks3 ? painn_fwd_mma_kernel<3, true, true>
                                 : painn_fwd_mma_kernel<kKS, true, true>)
                          : (ks3 ? painn_fwd_mma_kernel<3, false, true>
                                 : painn_fwd_mma_kernel<kKS, false, true>);
  for (int c = 0; c < rbf_chunks(R); ++c) {
    const RbfChunk ch = rbf_chunk(R, c);
    err = launch(kernel, smem, s, items, dist, gate, dirx, diry, dirz, x, mu,
                 wk + (size_t)ch.r0 * kF3, bk, dq, dmu, pre, list, B, ni, nj, ch.rows, delta,
                 coeff, offs + ch.r0, ch.bias, c > 0);
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}
