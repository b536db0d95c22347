// painn_stack: all L PaiNN interaction and mixing blocks in one persistent
// launch, after an occupancy pass and a scan that make its work list.
//
// Replaces geossl_tpu/ops/painn_pallas.py: _stack_kernel in inference mode
// (painn_stack_infer via _stack_pallas) and, with RES, in save_residuals
// mode (painn_stack_train's forward). Per block k, with q and mu carried
// across blocks (mu starts at zero):
//   x      = silu(q Wd1 + bd1) Wd2 + bd2                      (x-MLP, 3F)
//   q, mu += the message pass of painn_fwd.cu with Wk[k], bk[k]
//   v, w   = split(mu_c Wmix)  per channel c                  (no bias)
//   vn     = sqrt(sum_c v_c^2 + eps)
//   a,g,s  = split(silu([q, vn] W1 + b1) W2 + b2)
//   q     += a + s * sum_c v_c w_c;   mu_c += g * w_c
// The gate and directions are computed once by the caller, as
// models/painn.fused_stack_apply does.
//
// Bound on the H100: operations. Per block ~17k FLOP per occupied pair (the
// filter, 2*R*3F, and the message sums, as painn_fwd) and 30 F^2 per atom
// for the dense layers (x-MLP 8F^2, mixing 12F^2, context MLP 10F^2).
// Every product runs on the tensor cores with mma.sync.m16n8k8 TF32 in
// 3xTF32 (mma_tf32.cuh): the elementwise terms (RBF, silu, vn, the message
// sums, the gated updates) stay on the CUDA cores.
//
// Work split, after schnet_stack.cu: one cooperative launch of one 16-warp
// block per SM (every block resident), its phases separated by grid
// barriers (worklist.cuh's grid_sync):
//   dense 0:  q = q0, mu = 0, x = the x-MLP of block 0;
//   messages k (k < L): over this block's run of the tile list;
//   dense k+1: the mixing of block k, then, on the same rows (q just
//             written), the x-MLP of block k + 1 (fusing the two saves a
//             grid barrier per block); dense L is the last mixing only.
// - Work list: the occupancy pass and scan over the gate (worklist.cuh's
//   make_tile_list, items (graph, 8-row i tile) listing their j tiles with
//   a nonzero gate), made once per launch: the gate is the same for every
//   block. The grid splits it into runs of whole items (first_item).
// - Messages: painn_mma.cuh's painn_fwd_items, the tile body of painn_fwd's
//   plain mode as it is (16 warps at 128 registers: the stack keeps its
//   block size and budget): the gated filter ([phi; 1] gate) [Wk; bk] on
//   the tensor cores in the plain split (it feeds the message sums
//   linearly; tests/test_torch_port_cfconv_tc.py emulates the stack's
//   splits through L = 3 blocks), operands in mma fragment order, grids
//   and rows loaded ahead with cp.async, each row summed in registers over
//   its item and written once (no atomics: the stack's output is bitwise
//   the same from run to run on one card). A message pass reads x and the
//   OLD mu of every column, while other blocks' runs finish at other
//   times, so its dq and dmu go to workspaces that the next dense phase
//   adds (the JAX kernel computes the whole dmu before adding it).
// - Dense phases: over chunks of 64 rows of [B*N, .] (32 rows when a
//   batch is small, launch() says when; round-robin over the blocks), each
//   product [64 x 128] x [128 x 128] per warp 16 rows x 32 columns (32 rows:
//   16 x 16), in the precise mode (rounded split, each k step added in f32:
//   the stack chains six products a block, 18 in all, and the plain split's
//   truncating accumulation drifts beyond the tolerance; the test above
//   shows it). Weights are staged in shared memory as 128 x 128 pieces in
//   two slots (cp.async; Wmix as its v and w halves, W1 as its q and vn
//   halves, W2 and Wd2 as three column slices), the next piece loading
//   while the current one's product runs where a slot is free. The mixing
//   loads mu'_c = mu_c + dmu_c one channel at a time, keeps sum_c v_c^2 and
//   sum_c v_c w_c in registers and w_c in the chunk's rows of the x
//   workspace (block k's x is consumed by then; each thread reads back
//   what it wrote); the context MLP's hidden layer and the new q stay in
//   shared memory for the x-MLP of the next block.
// - Rows with no tile (padding atoms, the empty graph slots of a partial
//   batch) go through the dense layers as every other row: their messages
//   are zero, their x-MLP and mixing are not (the reference computes them).
// Data other blocks wrote in an earlier phase is read through L2
// (cp.async.cg, ld.global.cg).
//
// RES (save_residuals, the forward of the differentiable stack): the kernel
// also writes the block boundaries that the backward resumes from, each
// [B, L, N, F or 3F]: qs and mus (q and mu at block entry, mus[:, 0] = 0),
// where the dense phase writes the new q and mu, and qps and mups (q + dq
// and mu + dmu at mixing entry), where the mixing loads them.
#include "painn_mma.cuh"

namespace geossl {

constexpr int kDRows = 64;  // atom rows per dense chunk, at most
// the dense products in mma_tf32.cuh's precise mode (the header says why)
constexpr bool kDensePrecise = true;
// shared memory of the dense phases, in floats: two 128 x 128 weight slots
// and three 64 x 128 row buffers, all swizzled; the message phases use the
// same memory as painn_fwd_items lays it out
constexpr int kDW0 = 0;
constexpr int kDW1 = kDW0 + kF * kF;
constexpr int kDP = kDW1 + kF * kF;
constexpr int kDQ = kDP + kDRows * kF;
constexpr int kDS = kDQ + kDRows * kF;
constexpr int kDenseFloats = kDS + kDRows * kF;
constexpr int kStackFloats = kDenseFloats > kFwdFloats ? kDenseFloats : kFwdFloats;

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Row `row` of [B*n, .] as a row of a residual stack [B, L, n, .] at block l.
__device__ __forceinline__ size_t res_row(int row, int n, int L, int l) {
  return ((size_t)(row / n) * L + l) * n + row % n;
}

// The 128 x 128 piece (rows r0.., columns c0..) of a weight matrix with
// row length ld into a swizzled shared matrix (cp.async; the caller commits).
__device__ __forceinline__ void stage_piece(float* W_s, const float* __restrict__ w, int ld,
                                            int r0, int c0) {
  for (int c = threadIdx.x; c < kF * kF / 4; c += kFwdThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4;
    cp_async16(W_s + swz_at(kF, r, f), w + (size_t)(r0 + r) * ld + c0 + f, true);
  }
}

// A_s = ROWS rows r0.. of (a + b)[:, c0 .. c0 + 127] (b may be null) of
// [rows, ld] matrices read through L2, rows >= rows_end zero; with res, the
// values also go to the residual stack res [B, L, n, ld] at block l.
template <int ROWS>
__device__ __forceinline__ void load_chunk(float* A_s, const float* a, const float* b, int ld,
                                           int c0, int r0, int rows_end, float* res, int n,
                                           int L, int l) {
  for (int c = threadIdx.x; c < ROWS * kF / 4; c += kFwdThreads) {
    const int r = c / (kF / 4), f = (c % (kF / 4)) * 4, row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows_end) {
      const size_t o = (size_t)row * ld + c0 + f;
      v = __ldcg(reinterpret_cast<const float4*>(a + o));
      if (b) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(b + o));
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
      if (res) *reinterpret_cast<float4*>(res + res_row(row, n, L, l) * ld + c0 + f) = v;
    }
    *reinterpret_cast<float4*>(A_s + swz_at(kF, r, f)) = v;
  }
}

// A chunk of ROWS = 16 RG rows (RG = 4 or 2): warp w owns rows 16 (w % RG)
// and columns 8 RG (w / RG) of each ROWS x 128 product, RG blocks of 8.
template <int ROWS>
struct Dense {
  static constexpr int RG = ROWS / 16, NB = RG;
  // acc += A_s W_s (ROWS x 128 by 128 x 128) at this warp's rows dm + g (+ 8)
  // and columns dn + 8 nb + 2 t (+ 1), as acc[0][nb][0, 1] (and [2, 3])
  static __device__ __forceinline__ void mma(float acc[1][NB][4], const float* A_s,
                                             const float* W_s) {
    const int warp = threadIdx.x >> 5;
    warp_tile_mma<1, NB, kF, false, false, false, kDensePrecise>(
        acc, A_s, kF, 16 * (warp % RG), W_s, kF, 8 * NB * (warp / RG));
  }
  static __device__ __forceinline__ void zero(float acc[1][NB][4]) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[0][nb][q] = 0.f;
  }
};

template <bool RES, int KS, int ROWS>
__global__ void __launch_bounds__(kFwdThreads, 1)
painn_stack_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                   const float* __restrict__ dirx, const float* __restrict__ diry,
                   const float* __restrict__ dirz, const float* __restrict__ q0,
                   const float* __restrict__ wd1, const float* __restrict__ bd1,
                   const float* __restrict__ wd2, const float* __restrict__ bd2,
                   const float* __restrict__ wk, const float* __restrict__ bk,
                   const float* __restrict__ wmix, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* q, float* mu, float* work, float* qs,
                   float* mus, float* qps, float* mups, const int* __restrict__ pre,
                   const int* __restrict__ list, unsigned* bar, int B, int n, int R, int L,
                   float delta, float coeff, float eps) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W0 = smem + kDW0;
  float* W1 = smem + kDW1;
  float* P = smem + kDP;
  float* Q = smem + kDQ;
  float* S = smem + kDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  using D = Dense<ROWS>;
  constexpr int NB = D::NB;
  const int dm = 16 * (warp % D::RG), dn = 8 * NB * (warp / D::RG);  // this warp's part
  const int rows = B * n, n_chunks = (rows + ROWS - 1) / ROWS;
  // workspaces: x [rows][3F] (also the mixing's w_c), the messages dq
  // [rows][F] and dmu [rows][3F]
  float* xw = work;
  float* dqw = xw + (size_t)rows * kF3;
  float* dmuw = dqw + (size_t)rows * kF;

  for (int l = 0; l <= L; ++l) {
    for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
      const int r0 = ch * ROWS;
      if (l == 0) {
        // q = q0 (into S for the x-MLP), mu = 0
        __syncthreads();  // the previous chunk is done with S and the slots
        stage_piece(W1, wd1, kF, 0, 0);
        cp_async_commit();
        load_chunk<ROWS>(S, q0, nullptr, kF, 0, r0, rows, RES ? qs : nullptr, n, L, 0);
        for (int c = tid; c < ROWS * (kF + kF3) / 4; c += kFwdThreads) {
          const bool m = c >= ROWS * kF / 4;
          const int cc = m ? c - ROWS * kF / 4 : c;
          const int w4 = m ? kF3 / 4 : kF / 4, r = cc / w4, f = (cc % w4) * 4, row = r0 + r;
          if (row >= rows) continue;
          if (!m) {
            *reinterpret_cast<float4*>(q + (size_t)row * kF + f) =
                *reinterpret_cast<const float4*>(q0 + (size_t)row * kF + f);
          } else {
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(mu + (size_t)row * kF3 + f) = z;
            if (RES) *reinterpret_cast<float4*>(mus + res_row(row, n, L, 0) * kF3 + f) = z;
          }
        }
      } else {
        // -- the mixing of block lm ----------------------------------------
        const int lm = l - 1;
        const float* Wmix = wmix + (size_t)lm * kF * 2 * kF;  // [F][2F]
        const float* Wc1 = w1 + (size_t)lm * 2 * kF * kF;     // [2F][F]
        const float* Wc2 = w2 + (size_t)lm * kF * kF3;        // [F][3F]
        const float* Bc1 = b1 + (size_t)lm * kF;
        const float* Bc2 = b2 + (size_t)lm * kF3;
        float vn2[NB][4], vw[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) vn2[nb][q4] = vw[nb][q4] = 0.f;
        __syncthreads();  // the previous chunk is done with the slots and buffers
        stage_piece(W0, Wmix, 2 * kF, 0, 0);   // the v half
        stage_piece(W1, Wmix, 2 * kF, 0, kF);  // the w half
        cp_async_commit();
        // per channel (P, Q, P): mu'_c = mu_c + dmu_c, then v_c and w_c
        for (int c = 0; c < 3; ++c) {
          float* A = (c & 1) ? Q : P;  // every warp is done with channel c - 2's
          load_chunk<ROWS>(A, mu, dmuw, kF3, c * kF, r0, rows, RES ? mups : nullptr, n, L, lm);
          cp_async_wait<0>();
          __syncthreads();
          float v[1][NB][4], w[1][NB][4];
          D::zero(v);
          D::zero(w);
          D::mma(v, A, W0);
          D::mma(w, A, W1);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = r0 + dm + g + 8 * hh, col = dn + 8 * nb + 2 * t;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float vv = v[0][nb][2 * hh + e], ww = w[0][nb][2 * hh + e];
                vn2[nb][2 * hh + e] += vv * vv;
                vw[nb][2 * hh + e] += vv * ww;
              }
              if (row < rows)  // w_c into the chunk's x rows; read back below
                *reinterpret_cast<float2*>(xw + (size_t)row * kF3 + c * kF + col) =
                    make_float2(w[0][nb][2 * hh], w[0][nb][2 * hh + 1]);
            }
        }
        // context MLP: hidden = silu([q', vn] W1 + b1), q' = q + dq
        __syncthreads();  // channel 2's products are done with the slots and Q
        stage_piece(W0, Wc1, kF, 0, 0);   // the q' half
        stage_piece(W1, Wc1, kF, kF, 0);  // the vn half
        cp_async_commit();
        load_chunk<ROWS>(Q, q, dqw, kF, 0, r0, rows, RES ? qps : nullptr, n, L, lm);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            store2(S, kF, dm + g + 8 * hh, dn + 8 * nb + 2 * t, sqrtf(vn2[nb][2 * hh] + eps),
                   sqrtf(vn2[nb][2 * hh + 1] + eps));
        cp_async_wait<0>();
        __syncthreads();
        {
          float h[1][NB][4];
          D::zero(h);
          D::mma(h, Q, W0);
          D::mma(h, S, W1);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int col = dn + 8 * nb + 2 * t;
              store2(P, kF, dm + g + 8 * hh, col, silu(h[0][nb][2 * hh] + Bc1[col]),
                     silu(h[0][nb][2 * hh + 1] + Bc1[col + 1]));
            }
        }
        // q = q' + a + s * sum_c v_c w_c (the a and s slices of W2)
        __syncthreads();  // the hidden layer is complete; S and the slots are free
        stage_piece(W0, Wc2, kF3, 0, 0);       // a
        stage_piece(W1, Wc2, kF3, 0, 2 * kF);  // s
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        {
          float a[1][NB][4], qa[NB][4];
          D::zero(a);
          D::mma(a, P, W0);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int col = dn + 8 * nb + 2 * t;
              const float2 qp = load2(Q, kF, dm + g + 8 * hh, col);
              qa[nb][2 * hh] = qp.x + (a[0][nb][2 * hh] + Bc2[col]);
              qa[nb][2 * hh + 1] = qp.y + (a[0][nb][2 * hh + 1] + Bc2[col + 1]);
            }
          D::zero(a);
          D::mma(a, P, W1);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = dm + g + 8 * hh, row = r0 + r, col = dn + 8 * nb + 2 * t;
              const float q_x = qa[nb][2 * hh] + (a[0][nb][2 * hh] + Bc2[2 * kF + col]) *
                                                     vw[nb][2 * hh];
              const float q_y = qa[nb][2 * hh + 1] +
                                (a[0][nb][2 * hh + 1] + Bc2[2 * kF + col + 1]) * vw[nb][2 * hh + 1];
              store2(S, kF, r, col, q_x, q_y);  // the next x-MLP's input
              if (row < rows) {
                *reinterpret_cast<float2*>(q + (size_t)row * kF + col) = make_float2(q_x, q_y);
                if (RES && l < L)
                  *reinterpret_cast<float2*>(qs + res_row(row, n, L, l) * kF + col) =
                      make_float2(q_x, q_y);
              }
            }
        }
        // mu_c = mu'_c + g * w_c (the g slice of W2)
        __syncthreads();  // every warp is done with the slots
        stage_piece(W0, Wc2, kF3, 0, kF);  // g
        cp_async_commit();
        if (l < L) {
          stage_piece(W1, wd1 + (size_t)l * kF * kF, kF, 0, 0);  // the x-MLP's Wd1
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        {
          float a[1][NB][4];
          D::zero(a);
          D::mma(a, P, W0);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = r0 + dm + g + 8 * hh, col = dn + 8 * nb + 2 * t;
              if (row >= rows) continue;
              const float g_x = a[0][nb][2 * hh] + Bc2[kF + col];
              const float g_y = a[0][nb][2 * hh + 1] + Bc2[kF + col + 1];
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                const size_t o = (size_t)row * kF3 + c * kF + col;
                const float2 m = __ldcg(reinterpret_cast<const float2*>(mu + o));
                const float2 d = __ldcg(reinterpret_cast<const float2*>(dmuw + o));
                const float2 wc = *reinterpret_cast<const float2*>(xw + o);  // this thread's
                const float2 mn = make_float2((m.x + d.x) + g_x * wc.x, (m.y + d.y) + g_y * wc.y);
                *reinterpret_cast<float2*>(mu + o) = mn;
                if (RES && l < L)
                  *reinterpret_cast<float2*>(mus + res_row(row, n, L, l) * kF3 + c * kF + col) = mn;
              }
            }
        }
      }
      if (l == L) continue;
      // -- the x-MLP of block l: x = silu(q Wd1 + bd1) Wd2 + bd2, q in S ------
      const float* Wd2 = wd2 + (size_t)l * kF * kF3;
      const float* Bd1 = bd1 + (size_t)l * kF;
      const float* Bd2 = bd2 + (size_t)l * kF3;
      __syncthreads();  // S is complete; every warp is done with W0
      stage_piece(W0, Wd2, kF3, 0, 0);
      cp_async_commit();
      cp_async_wait<1>();  // Wd1 (in W1) has landed
      __syncthreads();
      {
        float h[1][NB][4];
        D::zero(h);
        D::mma(h, S, W1);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = dn + 8 * nb + 2 * t;
            store2(P, kF, dm + g + 8 * hh, col, silu(h[0][nb][2 * hh] + Bd1[col]),
                   silu(h[0][nb][2 * hh + 1] + Bd1[col + 1]));
          }
      }
      // Wd2's three column slices: W0, W1, W0
      for (int k = 0; k < 3; ++k) {
        __syncthreads();  // the hidden layer is complete; the slot for slice k + 1 is free
        if (k < 2) {
          stage_piece((k & 1) ? W0 : W1, Wd2, kF3, 0, (k + 1) * kF);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        float a[1][NB][4];
        D::zero(a);
        D::mma(a, P, (k & 1) ? W1 : W0);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + dm + g + 8 * hh, col = k * kF + dn + 8 * nb + 2 * t;
            if (row < rows)
              *reinterpret_cast<float2*>(xw + (size_t)row * kF3 + col) = make_float2(
                  a[0][nb][2 * hh] + Bd2[col], a[0][nb][2 * hh + 1] + Bd2[col + 1]);
          }
      }
    }
    if (l == L) break;
    grid_sync(bar);  // x and mu of every row are written
    painn_fwd_items<KS>(smem, dist, gate, dirx, diry, dirz, xw, mu, wk + (size_t)l * R * kF3,
                        bk + (size_t)l * kF3, dqw, dmuw, pre, list, B, n, n, R, delta, coeff);
    grid_sync(bar);  // dq and dmu of every row are written
  }
}

// Rows per dense chunk: 32 when all of a batch's chunks fit in one round
// over the grid (one block per SM), so that a small batch keeps every SM
// busy (serving's N=32 batch: 128 chunks of 32 rows against 64 of 64);
// above that 64, which stage each weight piece for twice the rows (a
// partial batch at N=128, 16,384 rows, ~5% faster than in 32-row chunks;
// PERF.md).
static int chunk_rows(int rows, int sms) { return (rows + 31) / 32 <= sms ? 32 : 64; }

static int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool RES, int KS>
static cudaError_t launch(void** args, int rows, cudaStream_t s) {
  const int sms = sm_count();
  int per_sm = 0;
  const auto kernel = chunk_rows(rows, sms) == 32 ? painn_stack_kernel<RES, KS, 32>
                                                  : painn_stack_kernel<RES, KS, 64>;
  const size_t smem = sizeof(float) * (size_t)kStackFloats;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, kFwdThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  // every block must be resident for the grid barriers: a cooperative launch
  // refuses a grid that would not be
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms * per_sm), dim3(kFwdThreads),
                                     args, smem, s);
}

}  // namespace geossl

extern "C" size_t painn_stack_smem_bytes() { return sizeof(float) * (size_t)geossl::kStackFloats; }

// Rows per dense chunk of a launch over B graphs of n atoms on the current
// device (32 or 64: the kernel instance that launch runs).
extern "C" int painn_stack_chunk_rows(int B, int n) {
  return geossl::chunk_rows(B * n, geossl::sm_count());
}

// Ints of the workspace: the tile list over the gate (worklist.cuh), then
// the grid barrier's two counters.
extern "C" size_t painn_stack_ws_ints(int B, int n) {
  const int nt = (n + geossl::kTile - 1) / geossl::kTile;
  return geossl::tile_list_ints((size_t)B * nt, nt) + 2;
}

// Returns the cudaError_t of the launches (0 on success). F must be 128,
// 2 <= R <= 31, n <= 128, L >= 1. `work` holds B*n*7F floats of scratch,
// `ws` painn_stack_ws_ints(B, n) ints. With `save_residuals`, qs/qps hold
// B*L*n*F floats and mus/mups B*L*n*3F each (else they are not read and
// may be null).
extern "C" int painn_stack(const float* dist, const float* gate, const float* dirx,
                           const float* diry, const float* dirz, const float* q0,
                           const float* wd1, const float* bd1, const float* wd2,
                           const float* bd2, const float* wk, const float* bk,
                           const float* wmix, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* q, float* mu,
                           float* work, float* qs, float* mus, float* qps, float* mups, int* ws,
                           int B, int n, int F, int R, int L, float delta, float coeff,
                           float eps, int save_residuals, void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > kRP - 1 || n < 1 || n > 128 || L < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (n + kTile - 1) / kTile;
  const size_t items = (size_t)B * nt;
  unsigned* bar = reinterpret_cast<unsigned*>(ws + tile_list_ints(items, nt));
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  err = make_tile_list<false>(gate, ws, B, n, n, 1, s);
  if (err != cudaSuccess) return (int)err;
  const int* pre = ws + items * nt + items;
  const int* list = ws + worklist_ints(items, nt);
  void* args[] = {&dist, &gate, &dirx, &diry, &dirz, &q0,  &wd1, &bd1,  &wd2,  &bd2,
                  &wk,   &bk,   &wmix, &w1,   &b1,   &w2,  &b2,  &q,    &mu,   &work,
                  &qs,   &mus,  &qps,  &mups, &pre,  &list, &bar, &B,   &n,    &R,
                  &L,    &delta, &coeff, &eps};
  const bool ks3 = R < 24;
  const int rows = B * n;
  if (save_residuals)
    err = ks3 ? launch<true, 3>(args, rows, s) : launch<true, kKS>(args, rows, s);
  else
    err = ks3 ? launch<false, 3>(args, rows, s) : launch<false, kKS>(args, rows, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
