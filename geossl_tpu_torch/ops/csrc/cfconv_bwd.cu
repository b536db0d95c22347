// cfconv_bwd: backward of SchNet's continuous-filter convolution on the
// tensor cores, in 3xTF32.
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _bwd_kernel (via _bwd_pallas)
// and, with SYM, _bwd_sym_kernel (via _bwd_sym_pallas, the VJP of
// cfconv_fused_sym).
// For m[b,i,f] = sum_j env W[b,i,j,f] x[b,j,f] with W = ssp(rbf(d) W1 + b1) W2 + b2
// and the cotangent g[b,i,f] it recomputes the filter of every pair tile and
// emits all seven cotangents, as the TPU kernel does:
//   denv[b,i,j] = sum_f W g[i,f] x[j,f]        ddist[b,i,j] via the RBF chain
//   dx[b,j,f]   = sum_i env W g[i,f]
//   dW2 = s^T qe, db2 = sum qe, dh = (qe W2^T) ssp'(pre1), dW1 = rbf^T dh,
//   db1 = sum dh, with qe[i,j,f] = env g[i,f] x[j,f]
// The [B,N,N,F] tensors never leave the chip.
//
// Bound on the H100: operations. An 8x8 pair tile is one 64-row operand and
// its six products are the filter (rbf[64xG] W1, ssp() W2), dh' = qe W2^T,
// drbf = dh W1^T, dW2 += s^T qe and dW1 += rbf^T dh: ~170k FLOP per pair
// (G = 51, F = 128) against 16 bytes of dist/env/ddist/denv. They run on
// the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh:
// each f32 operand split into TF32 hi + lo, lo*hi + hi*lo + hi*hi summed in
// f32), which keeps the result within f32 rounding of the plain version:
// chip_smoke.py holds it to rtol 1e-4 and atol 1e-5 x max|ref| for
// ddist/denv/dx and 1e-3 relative norm for the weight gradients, the
// tolerances of the f32 CUDA-core kernel it replaced. chip_smoke.py's bound
// counts the products once at the TF32 tensor-core peak (495 TFLOP/s), the
// elementwise terms at the f32 peak and the bytes at the HBM rate, and takes
// the largest (`bound_basis`). mma.sync reaches about 315 TFLOP/s on an
// H100 (PERF.md); wgmma would reach more, but its TF32 form
// reads both operands K-major from canonical shared-memory layouts, and four
// of the six products read an operand transposed, so this kernel loads
// mma.sync fragments from one swizzled copy of each matrix in either
// orientation. The elementwise parts (RBF exp, ssp, sigmoid, qe, the
// denv/ddist row sums, the dx sums) stay on the CUDA cores, with the fast
// exp/log intrinsics (errors at f32 rounding of the values they feed).
//
// Work split. Three small launches come first (worklist.cuh): an occupancy pass (one block
// per graph and 8-row band) marks the 8x8 tiles to compute (with `sparse`
// those whose env is not all zero; with SYM only tiles pi <= pj), writes
// ddist = denv = 0 on every other tile (the occupancy contract of
// geossl_tpu/ops/pallas_utils.py: exact downstream, since env has value and
// slope zero there) and counts each item's tiles; a one-block scan turns the
// counts into prefix sums. The items are (graph, 8-column j tile). A
// persistent grid (one block of 8 warps per SM: 255 registers a thread, and
// shared memory for one block) splits the items into contiguous runs of
// equal work by those prefix sums, on the device, with no host sync. A
// block walks its items; for each it stages the item's x (and, SYM, g) rows,
// then walks the item's computed i tiles with the next tile's dist/env/g/x
// rows in flight (cp.async, double buffer) while the current tile's products
// run. The item's dx rows are summed in shared memory; the weight gradients
// stay in the warps' mma accumulators over all the block's tiles. At the end
// each block writes its partial weight gradients and a last launch sums the
// partials in block order (reduce.cuh). Cross-warp sums (denv, ddist, db1,
// db2) are taken in a fixed order, so ddist, denv and the weight gradients
// are bitwise the same from run to run on one card; so is dx in plain mode
// (each item's rows are written by one block).
//
// SYM (symmetric dist/env only, square grid), the port's symmetric scheme of
// cfconv_fwd.cu: tile (pi, pj) is computed iff pi <= pj. On a computed tile
// with pi < pj every cell's mirror lies in a skipped tile, so the tile
// carries it:
//   q[i,j,f] = g[i,f] x[j,f] + x[i,f] g[j,f]   (the diagonal tile: first term)
// goes through the filter chain once, and ddist/denv are written PLACED: a
// cell of a tile pi < pj holds its own cotangent plus its mirror's, a
// diagonal tile its own, a tile pi > pj (and, with `sparse`, an unoccupied
// one) zero. That is exact for training, because dist and env are symmetric
// functions of the positions. dx gets a j-indexed part (summed per item as
// above) and an i-indexed part from the mirrors (dx[i] += sum_j env W g_j),
// which lands on rows that other items own: it is summed over the tile's
// rows in shared memory and added to dx with global atomicAdd, and so is
// each item's j-indexed part (dx must be zero on entry). So in SYM mode dx
// is summed in an order that changes from run to run.
//
// Layout. Pair p = jl*8 + il of the tile is row p of every 64-row operand.
// In the 64x128 products warp (wm, wn) owns rows 16*kMB*wm.. and columns
// 32*wn..: lane (g, t) holds pairs (jl = 2*(kMB*wm + mb) + h, il = g), so a
// sum over i is a sum over the 8 lanes of one t (rs_lanes) and a sum over f
// a sum over t and then over the four column warps.
#include "mma_tf32.cuh"
#include "pair_tile.cuh"
#include "reduce.cuh"
#include "worklist.cuh"

namespace geossl {

constexpr int kWarps = 8;  // warps of the main kernel (255 registers each)
constexpr int kBT = 32 * kWarps;
constexpr int kRB = kWarps / 4;      // warp rows over a 64-row product (4 column quarters)
constexpr int kMB = 4 / kRB;         // 16-row blocks of a warp in a 64-row product
constexpr int kGP = 64;              // G padded: rows of W1_s, columns of rbf_s
constexpr int kRS = kF + 8;          // row stride of the 8-row tiles (bank spread)
constexpr int kTR = kTile * kRS;     // floats of one 8-row tile

// shared memory of the main kernel, in floats
constexpr int kOffW1 = 0;                         // [kGP][kF] swizzled
constexpr int kOffW2 = kOffW1 + kGP * kF;         // [kF][kF] swizzled
constexpr int kOffRbf = kOffW2 + kF * kF;         // [kPairs][kGP] swizzled
constexpr int kOffS = kOffRbf + kPairs * kGP;     // [kPairs][kF] swizzled: s, then dh
constexpr int kOffQe = kOffS + kPairs * kF;       // [kPairs][kF] swizzled: qe
constexpr int kOffX = kOffQe + kPairs * kF;       // [8][kRS] x rows of the item
constexpr int kOffGj = kOffX + kTR;               // [8][kRS] SYM: g rows of the item
constexpr int kOffDx = kOffGj + kTR;              // [8][kRS] the item's dx rows
constexpr int kOffMir = kOffDx + kTR;             // [8][kRS] SYM: the tile's i-indexed dx
constexpr int kOffG = kOffMir + kTR;              // [2][8][kRS] g rows of the i tile
constexpr int kOffXi = kOffG + 2 * kTR;           // [2][8][kRS] SYM: x rows of the i tile
constexpr int kOffD = kOffXi + 2 * kTR;           // [2][64] dist, [il][jl]
constexpr int kOffE = kOffD + 2 * kPairs;         // [2][64] env, [il][jl]
constexpr int kOffB1 = kOffE + 2 * kPairs;        // [kF]
constexpr int kOffB2 = kOffB1 + kF;               // [kF]
constexpr int kOffDen = kOffB2 + kF;              // [4][64] denv partials
constexpr int kOffDd = kOffDen + 4 * kPairs;      // [4][64] ddist partials
constexpr int kSmemFloats = kOffDd + 4 * kPairs;  // then ints: misc[4], tile list [nti]

// Floats of one block's partial weight gradients: [dW1 G*F][db1 F][dW2 F*F][db2 F]
__host__ __device__ inline int wgrad_size(int G) { return G * kF + kF + kF * kF + kF; }

template <bool SYM>
__global__ void __launch_bounds__(kBT, 1)
cfconv_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ gr,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const int* __restrict__ occ, const int* __restrict__ pre,
                  float* __restrict__ ddist, float* __restrict__ denv,
                  float* __restrict__ dx, float* __restrict__ part, int B,
                  int ni, int nj, int G, float start, float delta, float coeff) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem + kOffW1;
  float* W2_s = smem + kOffW2;
  float* rbf_s = smem + kOffRbf;
  float* s_s = smem + kOffS;
  float* qe_s = smem + kOffQe;
  float* x_s = smem + kOffX;
  float* gj_s = smem + kOffGj;
  float* dx_s = smem + kOffDx;
  float* mir_s = smem + kOffMir;
  float* b1_s = smem + kOffB1;
  float* b2_s = smem + kOffB2;
  float* den_p = smem + kOffDen;
  float* dd_p = smem + kOffDd;
  int* misc = reinterpret_cast<int*>(smem + kSmemFloats);  // [0] it0 [1] it1 [2] tiles
  int* tl_s = misc + 4;                                    // the item's computed i tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp (wm, wn) owns rows 16*kMB*wm.. and columns 32*wn.. of the 64x128
  // products: lane (g, t) holds pairs jl = 2*kMB*wm + 2*mb + h, il = g
  const int wm = warp % kRB, wn = warp / kRB;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * ntj;

  for (int idx = tid; idx < kGP * kF; idx += kBT) {
    const int r = idx / kF, c = idx % kF;
    W1_s[swz_at(kF, r, c)] = r < G ? w1[idx] : 0.f;
  }
  for (int idx = tid; idx < kF * kF; idx += kBT)
    W2_s[swz_at(kF, idx / kF, idx % kF)] = w2[idx];
  for (int idx = tid; idx < kPairs * kGP; idx += kBT) rbf_s[idx] = 0.f;  // columns >= G stay 0
  for (int idx = tid; idx < kTR; idx += kBT) mir_s[idx] = 0.f;
  if (tid < kF) {
    b1_s[tid] = b1[tid];
    b2_s[tid] = b2[tid];
  }
  if (tid == 0) {
    misc[0] = first_item(pre, n_items, gridDim.x, blockIdx.x);
    misc[1] = first_item(pre, n_items, gridDim.x, blockIdx.x + 1);
  }
  __syncthreads();
  const int it0 = misc[0], it1 = misc[1];

  // this block's share of the weight gradients, over all its tiles:
  // dW2 rows 32*kMB*wm.., dW1 rows 16*kMB*wm..; columns 32*wn.. of both
  float aw2[2 * kMB][4][4], aw1[kMB][4][4];
  float db1a[2 * kMB], db2a[2 * kMB];
#pragma unroll
  for (int i = 0; i < 2 * kMB; ++i) {
    db1a[i] = db2a[i] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) aw2[i][nb][q] = 0.f;
  }
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) aw1[mb][nb][q] = 0.f;

  for (int item = it0; item < it1; ++item) {
    const int b = item / ntj, pj = item - b * ntj, j0 = pj * kTile;
    const int n_it = SYM ? pj + 1 : nti;
    __syncthreads();  // the previous item is done with tl_s, x_s, gj_s and dx_s
    if (warp == 0) {  // the item's computed i tiles, in order
      const int n = item_tiles(occ + (size_t)item * nti, n_it, tl_s);
      if (lane == 0) misc[2] = n;
    }
    for (int idx = tid; idx < kTile * kF; idx += kBT) {
      const int r = idx / kF, f = idx % kF, j = j0 + r;
      x_s[r * kRS + f] = j < nj ? x[((size_t)b * nj + j) * kF + f] : 0.f;
      if (SYM) gj_s[r * kRS + f] = j < nj ? gr[((size_t)b * ni + j) * kF + f] : 0.f;
      dx_s[r * kRS + f] = 0.f;
    }
    __syncthreads();
    const int n_t = misc[2];

    // issues the cp.async loads of tile pi into buffer buf: dist/env, then
    // the g rows and, SYM, the x rows of the i tile in 16-byte pieces
    auto load_tile = [&](int pi, int buf) {
      const int i0 = pi * kTile;
      if (tid < 2 * kPairs) {
        const int p = tid & (kPairs - 1), i = i0 + (p >> 3), j = j0 + (p & 7);
        const bool in = i < ni && j < nj;
        const float* src = tid < kPairs ? dist : env;
        cp_async4(smem + (tid < kPairs ? kOffD : kOffE) + buf * kPairs + p,
                  src + (in ? ((size_t)b * ni + i) * nj + j : 0), in);
      }
      for (int c = tid; c < (SYM ? 2 : 1) * kTile * kF / 4; c += kBT) {
        const bool xrow = c >= kTile * kF / 4;
        const int cc = c & (kTile * kF / 4 - 1), r = cc >> 5, f = (cc & 31) * 4, i = i0 + r;
        const float* src = xrow ? x + (i < ni ? ((size_t)b * nj + i) * kF + f : 0)
                                : gr + (i < ni ? ((size_t)b * ni + i) * kF + f : 0);
        cp_async16(smem + (xrow ? kOffXi : kOffG) + buf * kTR + r * kRS + f, src, i < ni);
      }
      cp_async_commit();
    };

    if (n_t > 0) load_tile(tl_s[0], 0);
    for (int k = 0; k < n_t; ++k) {
      const int pi = tl_s[k], buf = k & 1, i0 = pi * kTile;
      if (k + 1 < n_t) {
        load_tile(tl_s[k + 1], buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile k's rows have landed
      const float* d_t = smem + kOffD + buf * kPairs;
      const float* e_t = smem + kOffE + buf * kPairs;
      const float* g_t = smem + kOffG + buf * kTR;
      const float* xi_t = smem + kOffXi + buf * kTR;
      const bool mirror = SYM && pi != pj;  // block-uniform
      float* ddist_b = ddist + (size_t)b * ni * nj;
      float* denv_b = denv + (size_t)b * ni * nj;

      // RBF of the tile's 64 pairs (row p = jl*8 + il)
      for (int idx = tid; idx < kPairs * kGP; idx += kBT) {
        const int p = idx / kGP, gg = idx % kGP;
        if (gg < G) {
          const float diff = d_t[(p & 7) * kTile + (p >> 3)] - (start + delta * (float)gg);
          rbf_s[swz_at(kGP, p, gg)] = __expf(coeff * diff * diff);
        }
      }
      __syncthreads();

      // hidden s = ssp(rbf W1 + b1) into s_s
      float acc[kMB][4][4];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
      if (G <= 56)
        warp_tile_mma<kMB, 4, 56, false, false>(acc, rbf_s, kGP, 16 * kMB * wm, W1_s, kF, 32 * wn);
      else
        warp_tile_mma<kMB, 4, kGP, false, false>(acc, rbf_s, kGP, 16 * kMB * wm, W1_s, kF, 32 * wn);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* a = acc[mb][nb] + 2 * h;
            store2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, c0, ssp_fast(a[0] + b1_s[c0]),
                   ssp_fast(a[1] + b1_s[c0 + 1]));
            a[0] = a[1] = 0.f;
          }
        }
      __syncthreads();

      // the filter w = s W2 + b2, in registers
      warp_tile_mma<kMB, 4, kF, false, false>(acc, s_s, kF, 16 * kMB * wm, W2_s, kF, 32 * wn);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[mb][nb][2 * h] += b2_s[c0];
            acc[mb][nb][2 * h + 1] += b2_s[c0 + 1];
          }
        }

      // qe = env q into qe_s, denv partials, db2
      {
        float v[16 * kMB];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jl = 2 * (kMB * wm + mb) + h, row = 8 * jl + g;
            const float e = e_t[g * kTile + jl];
            float den = 0.f;
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              const int c0 = 32 * wn + 8 * nb + 2 * t;
              const float2 xj = *reinterpret_cast<const float2*>(x_s + jl * kRS + c0);
              const float2 gi = *reinterpret_cast<const float2*>(g_t + g * kRS + c0);
              float q0 = gi.x * xj.x, q1 = gi.y * xj.y;
              if (mirror) {  // the mirror cell (j, i): q += x_i g_j
                const float2 xi = *reinterpret_cast<const float2*>(xi_t + g * kRS + c0);
                const float2 gj = *reinterpret_cast<const float2*>(gj_s + jl * kRS + c0);
                q0 = fmaf(xi.x, gj.x, q0);
                q1 = fmaf(xi.y, gj.y, q1);
              }
              den = fmaf(acc[mb][nb][2 * h], q0, fmaf(acc[mb][nb][2 * h + 1], q1, den));
              v[16 * mb + 8 * h + 2 * nb] = e * q0;
              v[16 * mb + 8 * h + 2 * nb + 1] = e * q1;
              store2(qe_s, kF, row, c0, e * q0, e * q1);
            }
            den = quad_sum(den);
            if (t == 0) den_p[wn * kPairs + row] = den;
          }
        rs_lanes<kMB>(v);
#pragma unroll
        for (int i = 0; i < 2 * kMB; ++i) db2a[i] += v[i];
      }

      // dx: the j rows' part (sum over i) into dx_s, SYM the mirrors' into mir_s
      {
        float v[16 * kMB], mv[4][2];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jl = 2 * (kMB * wm + mb) + h;
            const float e = e_t[g * kTile + jl];
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              const int c0 = 32 * wn + 8 * nb + 2 * t;
              const float ew0 = e * acc[mb][nb][2 * h], ew1 = e * acc[mb][nb][2 * h + 1];
              const float2 gi = *reinterpret_cast<const float2*>(g_t + g * kRS + c0);
              v[16 * mb + 8 * h + 2 * nb] = ew0 * gi.x;
              v[16 * mb + 8 * h + 2 * nb + 1] = ew1 * gi.y;
              if (mirror) {
                const float2 gj = *reinterpret_cast<const float2*>(gj_s + jl * kRS + c0);
                const bool first = mb == 0 && h == 0;
                mv[nb][0] = first ? ew0 * gj.x : fmaf(ew0, gj.x, mv[nb][0]);
                mv[nb][1] = first ? ew1 * gj.y : fmaf(ew1, gj.y, mv[nb][1]);
              }
            }
          }
        rs_lanes<kMB>(v);
#pragma unroll
        for (int i = 0; i < 2 * kMB; i += 2) {  // entry g*2*kMB + i: c = 0, 1
          const int e = g * 2 * kMB + i, nb = (e >> 1) & 3;
          float2* d2 = reinterpret_cast<float2*>(
              dx_s + (2 * kMB * wm + (e >> 3)) * kRS + 32 * wn + 8 * nb + 2 * t);
          d2->x += v[i];
          d2->y += v[i + 1];
        }
        if (mirror) {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int c0 = 32 * wn + 8 * nb + 2 * t;
            atomicAdd(mir_s + g * kRS + c0, mv[nb][0]);
            atomicAdd(mir_s + g * kRS + c0 + 1, mv[nb][1]);
          }
        }
      }
      __syncthreads();  // qe_s, den_p and mir_s complete

      if (tid < kPairs) {  // denv of pair p = jl*8 + il, column warps summed in order
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        const float s = den_p[tid] + den_p[kPairs + tid] + den_p[2 * kPairs + tid] +
                        den_p[3 * kPairs + tid];
        if (i < ni && j < nj) denv_b[(size_t)i * nj + j] = s;
      }
      if (mirror) {  // the tile's i-indexed dx: rows owned by other items
        for (int idx = tid; idx < kTile * kF; idx += kBT) {
          const int r = idx / kF, f = idx % kF, i = i0 + r;
          if (i < ni) atomicAdd(&dx[((size_t)b * nj + i) * kF + f], mir_s[r * kRS + f]);
          mir_s[r * kRS + f] = 0.f;
        }
      }

      // dW2 += s^T qe
      warp_tile_mma<2 * kMB, 4, kPairs, true, false, true>(aw2, s_s, kF, 32 * kMB * wm, qe_s,
                                                           kF, 32 * wn);

      // dh = (qe W2^T) ssp'(pre1), db1; ssp'(pre1) = sigmoid(pre1) =
      // 1 - exp(-softplus(pre1)) = 1 - exp(-s) / 2 from s = softplus - log 2,
      // which this thread's own fragment positions of s_s still hold (its
      // absolute error is f32 rounding of s, ~6e-8)
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
      warp_tile_mma<kMB, 4, kF, false, true>(acc, qe_s, kF, 16 * kMB * wm, W2_s, kF, 32 * wn);
      {
        float v[16 * kMB];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 sv =
                  load2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, 32 * wn + 8 * nb + 2 * t);
              float* a = acc[mb][nb] + 2 * h;
              a[0] *= fmaf(-0.5f, __expf(-sv.x), 1.f);
              a[1] *= fmaf(-0.5f, __expf(-sv.y), 1.f);
              v[16 * mb + 8 * h + 2 * nb] = a[0];
              v[16 * mb + 8 * h + 2 * nb + 1] = a[1];
            }
        rs_lanes<kMB>(v);
#pragma unroll
        for (int i = 0; i < 2 * kMB; ++i) db1a[i] += v[i];
      }
      __syncthreads();  // dW2 is done with s_s
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(s_s, kF, 16 * (kMB * wm + mb) + g + 8 * h, 32 * wn + 8 * nb + 2 * t,
                   acc[mb][nb][2 * h], acc[mb][nb][2 * h + 1]);
      __syncthreads();  // dh complete in s_s

      // ddist = sum_g (dh W1^T)[g] rbf_g 2 coeff (d - off_g), columns 16*wn..
      {
        float ar[kMB][2][4];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int q = 0; q < 4; ++q) ar[mb][nb][q] = 0.f;
        warp_tile_mma<kMB, 2, kF, false, true>(ar, s_s, kF, 16 * kMB * wm, W1_s, kF, 16 * wn);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * (kMB * wm + mb) + g + 8 * h;
            const float d = d_t[(p & 7) * kTile + (p >> 3)];
            float s = 0.f;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int gg = 16 * wn + 8 * nb + 2 * t + c;
                if (gg < G) {
                  const float diff = d - (start + delta * (float)gg);
                  s = fmaf(ar[mb][nb][2 * h + c] * rbf_s[swz_at(kGP, p, gg)], 2.f * coeff * diff,
                           s);
                }
              }
            s = quad_sum(s);
            if (t == 0) dd_p[wn * kPairs + p] = s;
          }
      }

      // dW1 += rbf^T dh
      warp_tile_mma<kMB, 4, kPairs, true, false>(aw1, rbf_s, kGP, 16 * kMB * wm, s_s, kF, 32 * wn);
      __syncthreads();  // the tile's scratch is free; dd_p complete

      if (tid < kPairs) {
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        const float s = dd_p[tid] + dd_p[kPairs + tid] + dd_p[2 * kPairs + tid] +
                        dd_p[3 * kPairs + tid];
        if (i < ni && j < nj) ddist_b[(size_t)i * nj + j] = s;
      }
    }

    // the item's dx rows (j-indexed part); dx_s is complete after the last
    // tile's final barrier
    for (int idx = tid; idx < kTile * kF; idx += kBT) {
      const int r = idx / kF, f = idx % kF, j = j0 + r;
      if (j >= nj) continue;
      float* dst = dx + ((size_t)b * nj + j) * kF + f;
      if (!SYM)
        *dst = dx_s[r * kRS + f];
      else if (n_t > 0)
        atomicAdd(dst, dx_s[r * kRS + f]);
    }
  }

  // this block's partial weight gradients
  float* out = part + (size_t)blockIdx.x * wgrad_size(G);
  float* pw1 = out;
  float* pb1 = pw1 + G * kF;
  float* pw2 = pb1 + kF;
  float* pb2 = pw2 + kF * kF;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mb = 0; mb < 2 * kMB; ++mb) {
        const int r = 16 * (2 * kMB * wm + mb) + g + 8 * h;
        pw2[r * kF + c0] = aw2[mb][nb][2 * h];
        pw2[r * kF + c0 + 1] = aw2[mb][nb][2 * h + 1];
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int r = 16 * (kMB * wm + mb) + g + 8 * h;
        if (r < G) {
          pw1[r * kF + c0] = aw1[mb][nb][2 * h];
          pw1[r * kF + c0 + 1] = aw1[mb][nb][2 * h + 1];
        }
      }
    }
  }
  // db1 and db2: lane (g, t) holds entry g*2*kMB + i of its warp's rows,
  // summed over il; add the 8 jl rows in order
  __syncthreads();  // the tile scratch is free
  float* red_s = qe_s;  // [8 jl][2 kF]
#pragma unroll
  for (int i = 0; i < 2 * kMB; ++i) {
    const int e = g * 2 * kMB + i, c = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
    const int r = (2 * kMB * wm + (e >> 3)) * 2 * kF;
    red_s[r + c] = db1a[i];
    red_s[r + kF + c] = db2a[i];
  }
  __syncthreads();
  for (int c = tid; c < 2 * kF; c += kBT) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += red_s[r * 2 * kF + c];
    if (c < kF)
      pb1[c] = s;
    else
      pb2[c - kF] = s;
  }
}

static size_t smem_bytes(int ni) {
  return sizeof(float) * (size_t)kSmemFloats + sizeof(int) * (4 + (size_t)((ni + kTile - 1) / kTile));
}

template <bool SYM>
static cudaError_t launch(const float* dist, const float* env, const float* x,
                          const float* g, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* ddist, float* denv,
                          float* dx, float* part, int* ws, int blocks, int B, int ni,
                          int nj, int G, float start, float delta, float coeff,
                          int sparse, cudaStream_t s) {
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;
  const int n_items = B * ntj;
  int* occ = ws;
  int* pre = occ + (size_t)n_items * nti + n_items;
  ZeroGrids zero = {{ddist, denv}, 2};
  cudaError_t err = make_worklist<SYM, false>(env, ws, zero, B, ni, nj, sparse, s);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(ni);
  cudaFuncSetAttribute(cfconv_bwd_kernel<SYM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cfconv_bwd_kernel<SYM><<<blocks, kBT, smem, s>>>(dist, env, x, g, w1, b1, w2, b2, occ, pre,
                                                   ddist, denv, dx, part, B, ni, nj, G, start,
                                                   delta, coeff);
  return cudaGetLastError();
}

}  // namespace geossl

extern "C" size_t cfconv_bwd_smem_bytes(int ni) { return geossl::smem_bytes(ni); }

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int cfconv_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Ints of the workspace: tile flags [B*ntj*nti], item counts [B*ntj] and
// their prefix sums [B*ntj + 1].
extern "C" size_t cfconv_bwd_ws_ints(int B, int ni, int nj) {
  return geossl::worklist_ints((size_t)B * ((nj + geossl::kTile - 1) / geossl::kTile),
                               (ni + geossl::kTile - 1) / geossl::kTile);
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// cfconv_bwd_blocks(B, nj) rows of G*F + F + F*F + F floats; `wgrad` (same
// row size) receives dW1 [G,F], db1 [F], dW2 [F,F], db2 [F]; `ws` holds
// cfconv_bwd_ws_ints(B, ni, nj) ints. F must be 128 and G at most 64. With
// `symmetric` (square grid only) ddist/denv are placed as the header says
// and `dx` must be zero on entry.
extern "C" int cfconv_bwd(const float* dist, const float* env, const float* x,
                          const float* g, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* ddist,
                          float* denv, float* dx, float* part, float* wgrad, int* ws,
                          int B, int ni, int nj, int F, int G, float start,
                          float delta, float coeff, int symmetric, int sparse,
                          void* stream) {
  using namespace geossl;
  if (F != kF || G > kGP || G < 1 || (symmetric && ni != nj))
    return (int)cudaErrorInvalidValue;
  const int blocks = cfconv_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      symmetric ? launch<true>(dist, env, x, g, w1, b1, w2, b2, ddist, denv, dx, part, ws,
                               blocks, B, ni, nj, G, start, delta, coeff, sparse, s)
                : launch<false>(dist, env, x, g, w1, b1, w2, b2, ddist, denv, dx, part, ws,
                                blocks, B, ni, nj, G, start, delta, coeff, sparse, s);
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, wgrad_size(G), wgrad, s);
  return (int)cudaGetLastError();
}
