// schnet_stack: all L SchNet interaction blocks in one persistent launch
// (inference), after an occupancy pass and a scan that make its work list.
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _stack_kernel (schnet_stack_infer).
// Per block k, with h carried across blocks:
//   x = h Wl1[k]                                   (lin1, no bias)
//   w = ssp(rbf(dist) W1[k] + b1[k]) W2[k] + b2[k]  (filter network)
//   m[i] = sum_j env[i,j] w[i,j] x[j]
//   h = h + ssp(m Wa[k] + ba[k]) Wb[k] + bb[k]      (lin2, act, lin)
// env is computed once by the caller, as models/schnet.fused_stack_apply does.
//
// Bound on the H100: operations. Per occupied pair and block the filter
// network is ~46k FLOP (G = 51, F = 128) of tile products, against 8 bytes
// of dist/env; the dense layers add 6*F*F per atom and block. Every product
// runs on the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32, in
// mma_tf32.cuh's precise mode (both TF32 parts rounded, each k step added
// in f32 on the CUDA cores): the stack chains 5 L products, and the plain
// split with the tensor core's truncating accumulation ends up to 9x
// beyond the plain version's tolerance at the serving batch (PERF.md). Per
// 8x8 pair tile (pair p = jl*8 + il as row p) rbf[64 x G->56] W1 and
// ssp(.) W2 (filter_mma.cuh, shared with cfconv_fwd.cu's symmetric mode),
// and per 64 atom rows h Wl1, m Wa and ssp(.) Wb. The
// elementwise terms (RBF exp, ssp, the messages) stay on the CUDA cores
// with the fast exp/log intrinsics. The filter tensor never leaves the
// chip; h, x and m ([B,N,F] each, a few MB) live in L2 between phases.
//
// SYM (symmetric dist/env, the caller's guarantee, as cfconv_fwd_sym): one
// filter per unordered pair. Only tiles pi <= pj are computed; a tile with
// pi < pj adds w x_j to row i and w x_i to row j (every cell's mirror lies
// in a skipped tile). Without SYM (a max_neighbors graph) every occupied
// tile is computed and adds to its rows i only. Tiles whose env is all zero
// (padding atoms, empty graph slots of a partial batch, out of cutoff) are
// skipped: that drops only exact zeros.
//
// Work split. The pair tiles of the whole batch form one list, ordered by
// (graph, 8-row i tile) and then j tile, made on the device (worklist.cuh);
// a persistent grid of one 8-warp block per SM (cooperative launch: all
// blocks resident) gives each block an equal run of tiles, whatever the mix
// of graph sizes and however few graphs are real. The phases of each
// interaction block are separated by grid barriers:
//   dense:    over 64-row chunks of [B*N, F] (round-robin): h += ssp(m Wa +
//             ba) Wb + bb (from the second block on), x = h Wl1, m = 0;
//   messages: over the block's run of tiles: the filter, then m += the
//             tile's messages, by global atomicAdd. A block sums its rows i
//             over the consecutive tiles of one row tile in registers and
//             adds them once per row tile; the mirrored rows j (SYM) are
//             summed over the tile's 8 rows i in registers and added per
//             tile. So m, and through it h, is summed in an order that
//             changes from run to run (f32 rounding; chip_smoke.py checks
//             that two launches agree within the kernel's tolerance).
// A last dense phase applies the last block's update. Between phases the
// data other blocks wrote is read through L2 (cp.async.cg, ld.global.cg).
// Per tile, the next tile's dist/env and x rows load with cp.async (double
// buffer) while the current tile's products run.
#include "filter_mma.cuh"
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "worklist.cuh"

namespace geossl {

constexpr int kRows = 64;       // atom rows per dense chunk
// every product in mma_tf32.cuh's precise mode (the header says why)
constexpr bool kPrecise = true;
// shared memory, in floats; the dense phase reuses W2_s as W_s and s_s as A_s
constexpr int kOffW1 = 0;                          // [kSGP][kF] swizzled
constexpr int kOffW2 = kOffW1 + kSGP * kF;         // [kF][kF] swizzled
constexpr int kOffRbf = kOffW2 + kF * kF;          // [kPairs][kSGP] swizzled
constexpr int kOffS = kOffRbf + kPairs * kSGP;     // [kPairs][kF] swizzled
constexpr int kOffXj = kOffS + kPairs * kF;        // [2][8][kSRS] x rows of the j tile
constexpr int kOffXi = kOffXj + 2 * kTile * kSRS;  // [8][kSRS] SYM: x rows of the i tile
constexpr int kOffDE = kOffXi + kTile * kSRS;      // [2][2][64] dist, env, [il][jl]
constexpr int kOffB = kOffDE + 4 * kPairs;         // [2][kF] b1, b2
constexpr int kStackFloats = kOffB + 2 * kF;       // then ints: misc[4], tile list [nt]

// 64 rows x F floats from global (rows >= rows_end zero) into a swizzled
// [64][kF] shared matrix, 16 bytes per cp.async (the swizzle moves aligned
// groups of 4 floats).
__device__ __forceinline__ void load_rows(float* A_s, const float* src, int r0, int rows_end) {
  for (int c = threadIdx.x; c < kRows * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    const bool in = r0 + r < rows_end;
    cp_async16(A_s + swz_at(kF, r, f), src + (in ? (size_t)(r0 + r) * kF + f : 0), in);
  }
}

// W [kF][kF] from global into a swizzled shared matrix.
__device__ __forceinline__ void load_weight(float* W_s, const float* __restrict__ w) {
  for (int c = threadIdx.x; c < kF * kF / 4; c += kThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W_s + swz_at(kF, r, f), w + r * kF + f, true);
  }
}

__device__ __forceinline__ void zero_acc(float acc[2][4][4]) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
}

template <bool SYM>
__global__ void __launch_bounds__(kThreads, 1)
schnet_stack_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                    const float* __restrict__ h0, const float* __restrict__ wl1,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ wa, const float* __restrict__ ba,
                    const float* __restrict__ wb, const float* __restrict__ bb,
                    float* h, float* xb, float* mb_, const int* __restrict__ occ,
                    const int* __restrict__ pre, unsigned* bar, int B, int n, int G,
                    int L, float start, float delta, float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem + kOffW1;
  float* W2_s = smem + kOffW2;
  float* rbf_s = smem + kOffRbf;
  float* s_s = smem + kOffS;
  float* xi_s = smem + kOffXi;
  float* b1_s = smem + kOffB;
  float* b2_s = b1_s + kF;
  int* misc = reinterpret_cast<int*>(smem + kStackFloats);  // [0] first item [1] tiles
  int* tl_s = misc + 4;                                     // the item's computed j tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp (wm, wn) owns rows 32*wm.. and columns 32*wn.. of every 64 x F product
  const int wm = warp & 1, wn = warp >> 1;
  const int nt = (n + kTile - 1) / kTile, n_items = B * nt, rows = B * n;
  const int n_chunks = (rows + kRows - 1) / kRows;

  for (int idx = tid; idx < kPairs * kSGP; idx += kThreads) rbf_s[idx] = 0.f;  // columns >= G stay 0
  // this block's run of tiles, and the item holding its first tile
  const long long total = pre[n_items];
  const int t_begin = (int)(total * blockIdx.x / gridDim.x);
  const int t_end = (int)(total * (blockIdx.x + 1) / gridDim.x);
  if (tid == 0) {
    int lo = 0, hi = n_items - 1;  // the last item with pre[item] <= t_begin
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= t_begin)
        lo = mid;
      else
        hi = mid - 1;
    }
    misc[0] = lo;
  }
  __syncthreads();
  const int item0 = misc[0];

  for (int l = 0; l <= L; ++l) {
    // -- dense phase: the update of block l - 1, then x = h Wl1[l], m = 0 ----
    float* A_s = s_s;
    float* W_s = W2_s;
    for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
      const int r0 = ch * kRows;
      float acc[2][4][4];
      __syncthreads();  // A_s and W_s are free
      load_rows(A_s, l == 0 ? h0 : mb_, r0, rows);
      if (l > 0) load_weight(W_s, wa + (size_t)(l - 1) * kF * kF);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (l > 0) {
        // t = ssp(m Wa + ba), then h += t Wb + bb
        const float* Ba = ba + (size_t)(l - 1) * kF;
        const float* Bb = bb + (size_t)(l - 1) * kF;
        zero_acc(acc);
        warp_tile_mma<2, 4, kF, false, false, false, kPrecise>(acc, A_s, kF, 32 * wm, W_s, kF, 32 * wn);
        __syncthreads();  // every warp is done with A_s and W_s
        load_weight(W_s, wb + (size_t)(l - 1) * kF * kF);
        cp_async_commit();
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c0 = 32 * wn + 8 * nb + 2 * t;
              store2(A_s, kF, 32 * wm + 16 * mb + 8 * hh + g, c0,
                     ssp_fast(acc[mb][nb][2 * hh] + Ba[c0]),
                     ssp_fast(acc[mb][nb][2 * hh + 1] + Ba[c0 + 1]));
            }
        cp_async_wait<0>();
        __syncthreads();
        zero_acc(acc);
        warp_tile_mma<2, 4, kF, false, false, false, kPrecise>(acc, A_s, kF, 32 * wm, W_s, kF, 32 * wn);
        __syncthreads();  // every warp is done with A_s and W_s
        if (l < L) {
          load_weight(W_s, wl1 + (size_t)l * kF * kF);
          cp_async_commit();
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 32 * wm + 16 * mb + 8 * hh + g, c0 = 32 * wn + 8 * nb + 2 * t;
              if (r0 + r < rows) {
                float2* hp = reinterpret_cast<float2*>(h + (size_t)(r0 + r) * kF + c0);
                const float2 ho = __ldcg(hp);
                const float2 hn = make_float2(ho.x + acc[mb][nb][2 * hh] + Bb[c0],
                                              ho.y + acc[mb][nb][2 * hh + 1] + Bb[c0 + 1]);
                *hp = hn;
                store2(A_s, kF, r, c0, hn.x, hn.y);
              } else {
                store2(A_s, kF, r, c0, 0.f, 0.f);
              }
            }
      } else {
        // the first block's h is h0
        for (int c = tid; c < kRows * kF / 4; c += kThreads) {
          const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
          if (r0 + r < rows)
            *reinterpret_cast<float4*>(h + (size_t)(r0 + r) * kF + f) =
                *reinterpret_cast<const float4*>(A_s + swz_at(kF, r, f));
        }
        load_weight(W_s, wl1);
        cp_async_commit();
      }
      if (l == L) continue;
      cp_async_wait<0>();
      __syncthreads();  // Wl1 and the new h rows in shared memory
      zero_acc(acc);
      warp_tile_mma<2, 4, kF, false, false, false, kPrecise>(acc, A_s, kF, 32 * wm, W_s, kF, 32 * wn);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 32 * wm + 16 * mb + 8 * hh + g, c0 = 32 * wn + 8 * nb + 2 * t;
            if (r0 + r < rows) {
              const size_t o = (size_t)(r0 + r) * kF + c0;
              *reinterpret_cast<float2*>(xb + o) = make_float2(acc[mb][nb][2 * hh],
                                                               acc[mb][nb][2 * hh + 1]);
              *reinterpret_cast<float2*>(mb_ + o) = make_float2(0.f, 0.f);
            }
          }
    }
    if (l == L) break;
    grid_sync(bar);  // x and the zeroed m of every row are written

    // -- message phase of block l over this block's run of tiles ------------
    {
      const float* W1 = w1 + (size_t)l * G * kF;
      for (int c = tid; c < kSGP * kF / 4; c += kThreads) {
        const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
        cp_async16(W1_s + swz_at(kF, r, f), W1 + (r < G ? r * kF + f : 0), r < G);
      }
      load_weight(W2_s, w2 + (size_t)l * kF * kF);
      cp_async_commit();
      if (tid < kF) {
        b1_s[tid] = b1[(size_t)l * kF + tid];
        b2_s[tid] = b2[(size_t)l * kF + tid];
      }
    }
    int tile = t_begin;
    for (int item = item0; tile < t_end; ++item) {
      const int k0 = tile - pre[item];
      const int k1 = min(pre[item + 1] - pre[item], k0 + (t_end - tile));
      tile += k1 - k0;
      if (k1 <= k0) continue;
      const int b = item / nt, pi = item - b * nt, i0 = pi * kTile;
      __syncthreads();  // the previous item is done with tl_s and xi_s
      if (warp == 0) item_tiles(occ + (size_t)item * nt, nt, tl_s);
      if (SYM) {  // the x rows of the i tile
        for (int c = tid; c < kTile * kF / 4; c += kThreads) {
          const int r = c / (kF / 4), f = (c % (kF / 4)) * 4, i = i0 + r;
          cp_async16(xi_s + r * kSRS + f, xb + (i < n ? ((size_t)b * n + i) * kF + f : 0), i < n);
        }
        cp_async_commit();
      }
      __syncthreads();  // tl_s complete

      // issues the cp.async loads of tile pj into buffer buf: dist/env, then
      // the x rows of the j tile
      auto load_tile = [&](int pj, int buf) {
        const int j0 = pj * kTile;
        if (tid < 2 * kPairs) {
          const int p = tid & (kPairs - 1), i = i0 + (p >> 3), j = j0 + (p & 7);
          const bool in = i < n && j < n;
          cp_async4(smem + kOffDE + (2 * buf + (tid >= kPairs)) * kPairs + p,
                    (tid < kPairs ? dist : env) + (in ? ((size_t)b * n + i) * n + j : 0), in);
        }
        for (int c = tid; c < kTile * kF / 4; c += kThreads) {
          const int r = c / (kF / 4), f = (c % (kF / 4)) * 4, j = j0 + r;
          cp_async16(smem + kOffXj + buf * kTile * kSRS + r * kSRS + f,
                     xb + (j < n ? ((size_t)b * n + j) * kF + f : 0), j < n);
        }
        cp_async_commit();
      };

      // this lane's share of rows i (il = g), columns 32*wn + 8*nb + 2*t + c,
      // summed over this warp's four jl of every tile of the run
      float racc[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) racc[nb][0] = racc[nb][1] = 0.f;

      load_tile(tl_s[k0], 0);
      for (int k = k0; k < k1; ++k) {
        const int pj = tl_s[k], buf = (k - k0) & 1, j0 = pj * kTile;
        cp_async_wait<0>();
        __syncthreads();  // tile k's rows (and the weights, the x_i rows) have
                          // landed; every warp is done with tile k - 1's buffer
        if (k + 1 < k1) load_tile(tl_s[k + 1], buf ^ 1);
        const float* d_t = smem + kOffDE + 2 * buf * kPairs;
        const float* e_t = d_t + kPairs;
        const float* xj_t = smem + kOffXj + buf * kTile * kSRS;

        // the filter (filter_mma.cuh), then the messages
        float acc[2][4][4];
        filter_tile_mma<kPrecise>(d_t, rbf_s, s_s, W1_s, W2_s, b1_s, G, kSGP, start, delta, coeff, acc);
        tile_messages<SYM>(acc, b2_s, e_t, xj_t, xi_s, racc, mb_ + (size_t)b * n * kF, j0, n,
                           pi != pj);
      }
      // this warp's part of rows i over the run's tiles
      const int i = i0 + g;
      if (i < n) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          float* dst = mb_ + ((size_t)b * n + i) * kF + 32 * wn + 8 * nb + 2 * t;
          atomicAdd(dst, racc[nb][0]);
          atomicAdd(dst + 1, racc[nb][1]);
        }
      }
    }
    cp_async_wait<0>();  // a block with no tiles still staged the weights
    grid_sync(bar);      // m of every row is complete
  }
}

static size_t smem_bytes(int n) {
  return sizeof(float) * (size_t)kStackFloats + sizeof(int) * (4 + (size_t)((n + kTile - 1) / kTile));
}

template <bool SYM>
static cudaError_t launch(void** args, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(schnet_stack_kernel<SYM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)schnet_stack_kernel<SYM>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  // every block must be resident for the grid barriers: a cooperative launch
  // refuses a grid that would not be
  return cudaLaunchCooperativeKernel((const void*)schnet_stack_kernel<SYM>, dim3(sms * per_sm),
                                     dim3(kThreads), args, smem, s);
}

}  // namespace geossl

extern "C" size_t schnet_stack_smem_bytes(int n) { return geossl::smem_bytes(n); }

// Ints of the workspace: the work list over (graph, i tile) items
// (worklist.cuh), then the grid barrier's two counters.
extern "C" size_t schnet_stack_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::worklist_ints((size_t)B * nt, nt) + 2;
}

// Returns the cudaError_t of the launches (0 on success). F must be 128 and
// G at most 64. `xbuf` and `mbuf` are [B, n, F] scratch, `ws` holds
// schnet_stack_ws_ints(B, n) ints. With `symmetric` dist and env must be
// symmetric (the header says why).
extern "C" int schnet_stack(const float* dist, const float* env, const float* h0,
                            const float* wl1, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* wa,
                            const float* ba, const float* wb, const float* bb,
                            float* out, float* xbuf, float* mbuf, int* ws, int B, int n,
                            int F, int G, int L, float start, float delta, float coeff,
                            int symmetric, void* stream) {
  using namespace geossl;
  if (F != kF || G < 1 || G > kSGP || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (n + kTile - 1) / kTile;
  const size_t items = (size_t)B * nt;
  int* occ = ws;
  int* pre = occ + items * nt + items;
  unsigned* bar = reinterpret_cast<unsigned*>(ws + worklist_ints(items, nt));
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  ZeroGrids none = {{nullptr}, 0};
  err = symmetric ? make_worklist<true, true>(env, ws, none, B, n, n, 1, s)
                  : make_worklist<false, true>(env, ws, none, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&dist, &env, &h0,  &wl1, &w1,  &b1,  &w2,  &b2, &wa,    &ba,    &wb,
                  &bb,   &out, &xbuf, &mbuf, &occ, &pre, &bar, &B, &n,    &G,     &L,
                  &start, &delta, &coeff};
  const size_t smem = smem_bytes(n);
  err = symmetric ? launch<true>(args, smem, s) : launch<false>(args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
