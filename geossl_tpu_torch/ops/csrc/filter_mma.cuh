// The filter network and the messages of one 8x8 pair tile on the tensor
// cores, shared by the kernels that walk a list of pair tiles with a block of
// 8 warps (schnet_stack.cu's message phase, both modes of cfconv_fwd.cu),
// and the streamed W1 of a G > 64 filter (also cfconv_bwd.cu's). Each
// product runs in 3xTF32 (mma_tf32.cuh), or with kBF16 on bf16 operands
// (mma_bf16.cuh: the bf16 instances of the CFConv kernels, mxu='bf16').
//
// Pair p = jl*8 + il of the tile is row p of its 64-row operands. Warp
// (wm, wn) = (warp & 1, warp >> 1) owns rows 32*wm.. and columns 32*wn.. of
// each 64 x F product, so lane (g, t) holds pairs (jl = 4*wm + 2*mb + h,
// il = g) and columns 32*wn + 8*nb + 2*t + c.
#pragma once

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "pair_tile.cuh"

namespace geossl {

constexpr int kSGP = 64;      // G padded (G <= 64): rows of W1_s, columns of rbf_s
constexpr int kSRS = kF + 8;  // row stride of the 8-row x tiles (bank spread)
// G > kSGP: W1 streams through two [kKC][kF] buffers (W1_s's kSGP x kF) and
// the RBF is computed kKC columns at a time into two [kPairs][kKC] buffers
// (rbf_s's kPairs x kSGP), so a kernel's shared memory does not grow with G
constexpr int kKC = 32;
static_assert(2 * kKC == kSGP, "two streamed chunks fill the G <= 64 buffers");

// W1 rows [kKC c, kKC c + kKC) of a [G][kF] W1 (rows >= G zero) into the
// swizzled [kKC][kF] buffer dst by cp.async; commits one group. Every
// thread of the block (kThreads) calls it.
__device__ __forceinline__ void load_w1_chunk(float* dst, const float* __restrict__ w1, int c,
                                              int G) {
  for (int idx = threadIdx.x; idx < kKC * kF / 4; idx += kThreads) {
    const int r = idx / (kF / 4), f = (idx % (kF / 4)) * 4, gr = c * kKC + r;
    cp_async16(dst + swz_at(kF, r, f), w1 + (gr < G ? (size_t)gr * kF + f : 0), gr < G);
  }
  cp_async_commit();
}

// The RBF of the tile's 64 pairs for Gaussians [kKC c, kKC c + kKC) into
// the swizzled [kPairs][kKC] buffer dst (columns >= G zero), from the
// offsets `off` [G] and coefficient `coeff`. d_t: the tile's distances
// [il][jl]; pair p = jl*8 + il is row p.
__device__ __forceinline__ void rbf_chunk(float* dst, const float* d_t, int c, int G,
                                          const float* __restrict__ off, float coeff) {
  for (int idx = threadIdx.x; idx < kPairs * kKC; idx += kThreads) {
    const int p = idx / kKC, gl = idx % kKC, gg = c * kKC + gl;
    float v = 0.f;
    if (gg < G) {
      const float diff = d_t[(p & 7) * kTile + (p >> 3)] - __ldg(off + gg);
      v = __expf(coeff * diff * diff);
    }
    dst[swz_at(kKC, p, gl)] = v;
  }
}

// The W1 chunks of a G > kSGP filter as one block streams them: the k-th
// chunk it consumes lies in buffer k & 1 of buf (2 x [kKC][kF]), and while
// one chunk's product runs the next chunk is in flight into the other
// buffer (fetch). Every first product of the block (and the backward's
// drbf/dW1 pass) walks chunks 0 .. n - 1 in order; the last one fetches
// the next walk's chunk 0. With it go the RBF's offsets and coefficient:
// `tab` [G + 1] holds the plain version's own (ops/cfconv._rbf_table:
// linspace's f32 offsets, then -0.5 / step^2), since the RBF's sensitivity
// to an offset's last bit grows with G (an offset an ulp off moves a
// Gaussian's value by ~2 |coeff| |d - off| ulp(off), 6e-5 at G = 300 on a
// 10 A basis), and start + delta k in f32 lies an ulp or two from it.
struct W1Stream {
  float* buf;
  const float* w1;   // [G][kF], global
  const float* off;  // [G] the RBF's offsets, global
  float coeff;       // the RBF's -0.5 / step^2
  int G, n, k;       // n = ceil(G / kKC) chunks; k chunks consumed so far

  // tab: off [G] and coeff (null for G <= kSGP, whose kernels take
  // start + delta k)
  __device__ W1Stream(float* buf_, const float* w1_, int G_, const float* tab)
      : buf(buf_), w1(w1_), off(tab), coeff(tab ? __ldg(tab + G_) : 0.f), G(G_),
        n((G_ + kKC - 1) / kKC), k(0) {}
  __device__ float* cur() const { return buf + (k & 1) * kKC * kF; }
  // the RBF chunk buffer that goes with the current W1 chunk
  __device__ float* rbf(float* rbf_s) const { return rbf_s + (k & 1) * kPairs * kKC; }
  // chunk c into the buffer after the current one
  __device__ void fetch(int c) const { load_w1_chunk(buf + ((k + 1) & 1) * kKC * kF, w1, c, G); }
};

// acc (a warp's MB x 4 blocks at rows m0.., columns n0..) += rbf(d) W1 over
// the streamed chunks: each chunk's product (4 k steps of 8) into a zeroed
// fragment that is then added to acc in f32, so that the tensor core's
// truncating accumulation runs over one chunk and not over all of G (the
// rule for a sum over chunks, mma_tf32.cuh; in bf16 a chunk is two k
// steps of 16). On entry the stream's current chunk (chunk 0) has landed and
// a barrier has made it visible; each later chunk is waited for (all of the
// thread's cp.async groups) and made visible by the chunk's one barrier,
// after which the next chunk is fetched (after the last, chunk 0 again when
// `more`: the block's next walk). Every thread of the block calls it.
template <int MB, bool kPrecise, bool kBF16 = false>
__device__ __forceinline__ void rbf_w1_streamed(W1Stream& w, float* rbf_s, const float* d_t,
                                                int m0, int n0, bool more, float acc[MB][4][4]) {
  for (int c = 0; c < w.n; ++c) {
    if (c > 0) cp_async_wait<0>();
    float* rb = w.rbf(rbf_s);
    rbf_chunk(rb, d_t, c, w.G, w.off, w.coeff);
    __syncthreads();  // chunk c and its RBF visible; every warp done with chunk c - 1
    if (c + 1 < w.n)
      w.fetch(c + 1);
    else if (more)
      w.fetch(0);
    float part[MB][4][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mb][nb][q] = 0.f;
    tile_mma<kBF16, MB, 4, kKC, false, false, false, kPrecise>(part, rb, kKC, m0, w.cur(), kF, n0);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mb][nb][q] += part[mb][nb][q];
    ++w.k;
  }
}

__device__ __forceinline__ void zero_frag(float acc[2][4][4]) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] = 0.f;
}

// The hidden layer s = ssp(acc + b1) into s_s, then acc = s W2 (b2 not
// added): the rest of the filter once its first product is in acc.
template <bool kPrecise, bool kBF16 = false>
__device__ __forceinline__ void hidden_w2(float* s_s, const float* W2_s, const float* b1_s,
                                          float acc[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c0 = 32 * wn + 8 * nb + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store2(s_s, kF, 32 * wm + 16 * mb + 8 * hh + g, c0,
               ssp_fast(acc[mb][nb][2 * hh] + b1_s[c0]),
               ssp_fast(acc[mb][nb][2 * hh + 1] + b1_s[c0 + 1]));
    }
  __syncthreads();

  // the filter, s W2, in registers
  zero_frag(acc);
  tile_mma<kBF16, 2, 4, kF, false, false, false, kPrecise>(acc, s_s, kF, 32 * wm, W2_s, kF, 32 * wn);
}

// acc = ssp(rbf(d) W1 + b1) W2 of the tile (b2 not added), in 3xTF32
// (kPrecise: mma_tf32.cuh's precise mode) or with kBF16 on bf16 operands
// (the G <= 56 product's K padded to 64), with the RBF exp and ssp on the
// CUDA cores (fast intrinsics), for G <= kSGP. d_t: the tile's distances
// [il][jl]; rbf_s [kPairs][kSGP] scratch whose columns >= G are zero; s_s
// [kPairs][kF] scratch for the hidden layer; W1_s [kSGP][kF] (rows >= G
// zero) and W2_s [kF][kF]; all swizzled. Every thread of the block calls it
// (it holds two barriers; rbf_s and s_s are free on entry).
template <bool kPrecise, bool kBF16 = false>
__device__ __forceinline__ void filter_tile_mma(const float* d_t, float* rbf_s, float* s_s,
                                                const float* W1_s, const float* W2_s,
                                                const float* b1_s, int G, float start,
                                                float delta, float coeff, float acc[2][4][4]) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  for (int idx = tid; idx < kPairs * kSGP; idx += kThreads) {
    const int p = idx / kSGP, gg = idx % kSGP;
    if (gg < G) {
      const float diff = d_t[(p & 7) * kTile + (p >> 3)] - (start + delta * (float)gg);
      rbf_s[swz_at(kSGP, p, gg)] = __expf(coeff * diff * diff);
    }
  }
  __syncthreads();

  // hidden s = ssp(rbf W1 + b1) into s_s, then s W2
  zero_frag(acc);
  if (G <= 56)
    tile_mma<kBF16, 2, 4, 56, false, false, false, kPrecise>(acc, rbf_s, kSGP, 32 * wm, W1_s, kF,
                                                             32 * wn);
  else
    tile_mma<kBF16, 2, 4, kSGP, false, false, false, kPrecise>(acc, rbf_s, kSGP, 32 * wm, W1_s, kF,
                                                               32 * wn);
  hidden_w2<kPrecise, kBF16>(s_s, W2_s, b1_s, acc);
}

// filter_tile_mma for G > kSGP: the first product over W1's streamed
// chunks (rbf_w1_streamed; rbf_s holds the two RBF chunk buffers), `more`
// when the block computes another tile with the same W1 after this one.
// On entry the stream's chunk 0 has landed and is visible. One barrier per
// chunk, then hidden_w2's.
template <bool kPrecise, bool kBF16 = false>
__device__ __forceinline__ void filter_tile_mma_streamed(const float* d_t, float* rbf_s,
                                                         float* s_s, W1Stream& w1,
                                                         const float* W2_s, const float* b1_s,
                                                         bool more, float acc[2][4][4]) {
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  zero_frag(acc);
  rbf_w1_streamed<2, kPrecise, kBF16>(w1, rbf_s, d_t, 32 * wm, 32 * wn, more, acc);
  hidden_w2<kPrecise, kBF16>(s_s, W2_s, b1_s, acc);
}

// The tile's messages from its filter (acc + b2): this lane's rows i
// (il = g) get racc += env w x_j over the warp's four jl. With SYM and
// `mirror` (block-uniform: a tile above the diagonal) the mirrored messages
// env w x_i, summed over the tile's 8 rows i, are added to rows j0 + jl < n
// of m_b (the graph's rows, stride kF) with atomicAdd. e_t: the tile's env
// [il][jl]; xj_t, xi_t: the x rows of its j and i tiles (stride kSRS).
template <bool SYM>
__device__ __forceinline__ void tile_messages(const float acc[2][4][4], const float* b2_s,
                                              const float* e_t, const float* xj_t,
                                              const float* xi_t, float racc[4][2], float* m_b,
                                              int j0, int n, bool mirror) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  float v[32];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jl = 4 * wm + 2 * mb + hh;
      const float e = e_t[g * kTile + jl];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int c0 = 32 * wn + 8 * nb + 2 * t;
        const float ew0 = e * (acc[mb][nb][2 * hh] + b2_s[c0]);
        const float ew1 = e * (acc[mb][nb][2 * hh + 1] + b2_s[c0 + 1]);
        const float2 xj = *reinterpret_cast<const float2*>(xj_t + jl * kSRS + c0);
        racc[nb][0] = fmaf(ew0, xj.x, racc[nb][0]);
        racc[nb][1] = fmaf(ew1, xj.y, racc[nb][1]);
        if (SYM) {
          const float2 xi = *reinterpret_cast<const float2*>(xi_t + g * kSRS + c0);
          v[16 * mb + 8 * hh + 2 * nb] = ew0 * xi.x;
          v[16 * mb + 8 * hh + 2 * nb + 1] = ew1 * xi.y;
        }
      }
    }
  if (SYM && mirror) {
    rs_lanes<2>(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 4 * g + q, j = j0 + 4 * wm + (e >> 3);
      const int c = 32 * wn + 8 * ((e >> 1) & 3) + 2 * t + (e & 1);
      if (j < n) atomicAdd(m_b + (size_t)j * kF + c, v[q]);
    }
  }
}

}  // namespace geossl
