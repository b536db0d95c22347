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
// Plain mode (cfconv_fwd_kernel, a max_neighbors graph): plain f32 FMA on
// the CUDA cores from shared memory with a 4x8 register tile per thread
// (pair_tile.cuh), one block per (graph, 8-row i tile). The block loops
// over the 8-column j tiles, which takes the place of the TPU's sequential
// j grid axis, and keeps its rows' sums in registers. W1 and W2 are staged
// in shared memory once per block, at its first computed tile. Each block
// finds its own occupied tiles in one pass over its env rows before the
// loop (the TPU kernels got flags from a separate occupancy pass by scalar
// prefetch).
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

__global__ void __launch_bounds__(kThreads)
cfconv_fwd_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int ni,
                  int nj, int G, float start, float delta, float coeff,
                  int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem;                   // [G][kF]
  float* W2_s = W1_s + G * kF;          // [kF][kF]
  float* rbf_s = W2_s + kF * kF;        // [kPairs][G]
  float* s_s = rbf_s + kPairs * G;      // [kPairs][kF]
  float* xj_s = s_s + kPairs * kF;      // [kTile][kF]
  float* d_s = xj_s + kTile * kF;       // [kPairs]
  float* e_s = d_s + kPairs;            // [kPairs]
  int* occ_s = (int*)(e_s + kPairs);    // [ntj] tile occupancy of this row block

  const int tid = threadIdx.x;
  const int pi = blockIdx.x, b = blockIdx.y;
  const int i0 = pi * kTile;
  const float* dist_b = dist + (size_t)b * ni * nj;
  const float* env_b = env + (size_t)b * ni * nj;
  const float* x_b = x + (size_t)b * nj * kF;
  float* out_b = out + (size_t)b * ni * kF;

  const int fg = thread_fg(), il = thread_il();
  float macc[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) macc[k] = 0.f;

  // occupancy: one coalesced pass over this block's env rows flags the
  // tiles with a nonzero entry, so an empty tile costs no further read
  const int ntj = (nj + kTile - 1) / kTile;
  if (sparse) {
    for (int t = tid; t < ntj; t += kThreads) occ_s[t] = 0;
    __syncthreads();
    const int rows = min(kTile, ni - i0), cols = nj;
    for (int idx = tid; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, j = idx - r * cols;
      if (env_b[(size_t)(i0 + r) * nj + j] != 0.f) occ_s[j / kTile] = 1;
    }
    __syncthreads();
  }

  // the weights are staged at the first tile computed: a block whose rows
  // are all padding (an empty graph slot) reads nothing but its envelope
  bool staged = false;
  for (int pj = 0; pj < ntj; ++pj) {
    if (sparse && !occ_s[pj]) continue;  // block-uniform
    const int j0 = pj * kTile;
    __syncthreads();  // the previous tile is done with d_s/e_s/xj_s
    if (tid < kPairs) {
      const int i = i0 + tid / kTile, j = j0 + tid % kTile;
      const bool in = i < ni && j < nj;
      d_s[tid] = in ? dist_b[(size_t)i * nj + j] : 0.f;
      e_s[tid] = in ? env_b[(size_t)i * nj + j] : 0.f;
    }
    if (!staged) {
      block_copy(W1_s, w1, G * kF);
      block_copy(W2_s, w2, kF * kF);
      staged = true;
    }
    for (int idx = tid; idx < kTile * kF; idx += kThreads) {
      const int j = j0 + idx / kF;
      xj_s[idx] = j < nj ? x_b[(size_t)j * kF + idx % kF] : 0.f;
    }
    __syncthreads();

    float w[kPPT][kFPT], c[kFPT];
    filter_tile(d_s, rbf_s, s_s, W1_s, b1, W2_s, b2, G, start, delta, coeff, w);
    tile_message(e_s, xj_s, w, c);
#pragma unroll
    for (int k = 0; k < kFPT; ++k) macc[k] += c[k];
  }

  // lanes 0-15 of each warp hold their row's sums (lanes 16-31 the same)
  const int i = i0 + il;
  if ((tid & 16) == 0 && i < ni) {
#pragma unroll
    for (int k = 0; k < kFPT; ++k) out_b[(size_t)i * kF + feat(fg, k)] = macc[k];
  }
}

// -- symmetric mode ------------------------------------------------------------

// the two filter products in mma_tf32.cuh's plain 3xTF32 split (the header
// says why)
constexpr bool kSymPrecise = false;
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
    filter_tile_mma<kSymPrecise>(d_t, rbf_s, s_s, W1_s, W2_s, b1_s, G, start, delta, coeff, acc);
    tile_messages<true>(acc, b2_s, e_t, xj_t, xi_t, racc, out + (size_t)b * n * kF, j0, n,
                        pi != pj);
    v = v_next;
  }
  flush();
}

static size_t smem_bytes(int G, int nj, int symmetric) {
  if (symmetric) return sizeof(float) * (size_t)kSymFloats;
  return sizeof(float) * ((size_t)G * kF + kF * kF + kPairs * G + kPairs * kF +
                          kTile * kF + 2 * kPairs) +
         sizeof(int) * (size_t)((nj + kTile - 1) / kTile);
}

}  // namespace geossl

extern "C" size_t cfconv_fwd_smem_bytes(int G, int nj, int symmetric) {
  return geossl::smem_bytes(G, nj, symmetric);
}

// Ints of the symmetric mode's workspace: the tile list (worklist.cuh).
extern "C" size_t cfconv_fwd_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::tile_list_ints((size_t)B * nt, nt);
}

// Returns the cudaError_t of the launches (0 on success). F must be 128.
// With symmetric != 0: dist/env symmetric and square, G <= 64, `out` zero
// on entry, `ws` holding cfconv_fwd_ws_ints(B, ni) ints; otherwise ws is
// not read.
extern "C" int cfconv_fwd(const float* dist, const float* env, const float* x,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, float* out, int* ws, int B, int ni, int nj,
                          int F, int G, float start, float delta, float coeff,
                          int symmetric, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || (symmetric && (ni != nj || G < 1 || G > kSGP)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, nj, symmetric);
  cudaStream_t s = (cudaStream_t)stream;
  if (!symmetric) {
    cudaError_t err = cudaFuncSetAttribute(
        cfconv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((ni + kTile - 1) / kTile, B);
    cfconv_fwd_kernel<<<grid, kThreads, smem, s>>>(dist, env, x, w1, b1, w2, b2, out, ni,
                                                   nj, G, start, delta, coeff, sparse);
    return (int)cudaGetLastError();
  }
  const int nt = (ni + kTile - 1) / kTile, items = B * nt;
  cudaError_t err = make_tile_list<true>(env, ws, B, ni, ni, sparse, s);
  if (err != cudaSuccess) return (int)err;
  const int* total = ws + (size_t)items * nt + 2 * items;  // pre[items]
  const int* list = ws + worklist_ints(items, nt);
  err = cudaFuncSetAttribute(cfconv_fwd_sym_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cfconv_fwd_sym_kernel<<<persistent_blocks(items * nt), kThreads, smem, s>>>(
      dist, env, x, w1, b1, w2, b2, out, list, total, ni, G, start, delta, coeff);
  return (int)cudaGetLastError();
}
