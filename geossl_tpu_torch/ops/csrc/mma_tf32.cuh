// Tensor-core tile products in 3xTF32 (cfconv_bwd.cu, painn_bwd.cu, schnet_stack.cu,
// painn_stack.cu, both modes of cfconv_fwd.cu, painn_fwd.cu's plain mode,
// ncsn_score.cu).
//
// A warp computes C[16*MB x 8*NB] += A[16*MB x K] B[K x 8*NB] with
// mma.sync.m16n8k8 (TF32 inputs, f32 accumulators). Each f32 operand x is
// split into a TF32 high part hi (x cut to its top 19 bits) and the
// remainder lo = x - hi, which is exact in f32 (|lo| < 2^-10 |x|); the mma
// reads the top 19 bits of lo. The product is summed as lo*hi + hi*lo +
// hi*hi ("3xTF32", CUTLASS's fast f32): the dropped lo*lo term and the TF32
// cut of lo leave a relative error of about 2^-19 per product, against
// 2^-10 for one TF32 pass, so the result stays within f32 rounding of a
// plain f32 product (tests/test_torch_port_cfconv_tc.py holds an emulation
// of it to 2e-6 of the f64 product at these tile shapes). The split is one
// integer and-mask and one f32 subtraction: cvt.rna.tf32.f32 runs on the
// conversion pipe, at 16 results per clock per SM on the H100.
//
// Operands live in shared memory as swizzled row-major f32 matrices: element
// (r, c) of a matrix with row length ld (a multiple of 32) is stored at
//   r * ld + (c ^ swz(r)),  swz(r) = 8 * (r & 3) + 4 * ((r >> 2) & 1).
// The swizzle moves aligned groups of 4 floats, so ldmatrix reads an 8x4
// block of one orientation (8 rows, 4 consecutive columns) in one
// conflict-free access, and the other orientation (4 rows x 8 columns, one
// float per lane) is conflict-free too. So one stored matrix serves as A,
// A^T, B or B^T: an operand whose K index runs along the stored rows is read
// with ldmatrix, one whose K runs down the stored columns with scalar loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace geossl {

__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (((r >> 2) & 1) << 2); }

// Offset of element (r, c) of a swizzled matrix with row length ld.
__device__ __forceinline__ int swz_at(int ld, int r, int c) { return r * ld + (c ^ swz(r)); }

// x = hi + lo with hi TF32 (x's top 19 bits) and lo exact in f32; the mma
// uses the top 19 bits of lo. kRound rounds both parts to nearest instead
// (hi = x rounded to TF32, |lo| <= 2^-11 |x|; lo's bits are offset so that
// the mma's cut of them rounds): two integer additions more, ~4x less
// error per operand.
template <bool kRound = false>
__device__ __forceinline__ void split_tf32(uint32_t xb, uint32_t& hi, uint32_t& lo) {
  hi = (kRound ? xb + 0x1000u : xb) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(xb) - __uint_as_float(hi));
  if (kRound) lo += 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x4 f32 blocks (ldmatrix's 8x8 b16): lane l gives the address of
// row l % 8 of block l / 8 and receives (row l / 4, column l % 4) of each.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The three passes lo*hi, hi*lo, hi*hi of one k step over MB x NB blocks,
// each pass over all blocks before the next, so that the mma of one block
// do not wait on each other.
template <int MB, int NB>
__device__ __forceinline__ void mma_passes(float c[MB][NB][4], const uint32_t ah[MB][4],
                                           const uint32_t al[MB][4], const uint32_t bh[NB][2],
                                           const uint32_t bl[NB][2]) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], al[mb], bh[nb]);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], ah[mb], bl[nb]);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], ah[mb], bh[nb]);
}

// The tile product of this warp: c[mb][nb] (16x8 blocks at rows m0 + 16 mb,
// columns n0 + 8 nb) += A B over k in [0, K), with
//   A[m][k] = MA(m, k) (kTA = false, ldmatrix) or MA(k, m) (kTA = true),
//   B[k][n] = MB_(k, n) (kTB = false) or MB_(n, k) (kTB = true, ldmatrix),
// both swizzled shared-memory matrices; K, m0 and n0 multiples of 8, m0 a
// multiple of 32 when kTA, and when !kTB the columns n0 .. n0 + 8 NB within
// one aligned group of 32 (NB <= 4). NB must be even when kTB. A k step splits all its fragments and then issues the three
// passes over all MB x NB blocks; with kBOuter it splits the A fragments
// one 16-row block at a time (fewer live registers when MB is large).
//
// Addresses: with k0 % 8 == 0 the swizzle of a scalar load's row k0+t+4u is
// 8t + 4u, so element (k0 + t + 4u, c0 + 8v + g) (c0 % 32 == 0, v < 4) lies
// at (k0 + t + 4u) ld + c0 + 8 (v ^ t) + (g ^ 4u); an ldmatrix row r0 + lr
// (r0 % 8 == 0) has the swizzle of lr. Both are lane constants plus a
// k-step term.
//
// kPrecise: the operands are split with rounding (split_tf32<true>), and
// each k step's three passes go into a zeroed fragment that is then added
// to c on the CUDA cores (IEEE f32, round to nearest). The tensor core adds
// to its accumulator with truncation, so a long chain of mma into one
// accumulator drifts toward zero by up to an ulp of the running sum per
// mma; this keeps that drift to the small per-step sum. Costs MB x NB x 4
// registers and 4 additions per block and k step; schnet_stack.cu, whose
// 5 L chained products compound every error, needs it (PERF.md), and so do
// painn_stack.cu's dense layers.
//
// kBLo > 0: B is stored split (split_b below, once for a matrix that many
// products read): its TF32 high parts at B and the low parts kBLo floats
// further, in the same layout, so that a k step loads B's fragments and
// does not split them.
template <int MB, int NB, int K, bool kTA, bool kTB, bool kBOuter = false, bool kPrecise = false,
          int kBLo = 0>
__device__ __forceinline__ void warp_tile_mma(float c[MB][NB][4], const float* A, int lda, int m0,
                                              const float* B, int ldb, int n0) {
  static_assert(K % 8 == 0, "K is a multiple of 8");
  static_assert(!kTB || NB % 2 == 0, "ldmatrix B needs pairs of n blocks");
  static_assert(kTB || NB <= 4, "scalar B loads cover 32 columns");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, t8 = 8 * t;
  const int lr = lane & 7, lq = lane >> 3;  // ldmatrix: row in block, block
  // lane parts of the addresses (see above)
  const int a_l = kTA ? t * lda + g + m0
                      : (m0 + lr + 8 * (lq & 1)) * lda + 4 * ((lq >> 1) ^ (lr >> 2));
  const int a_u = kTA ? 4 * lda + ((g ^ 4) - g) : 0;  // row + 4 (t-on-rows loads)
  const int b_l = kTB ? (n0 + lr + 8 * (lq >> 1)) * ldb + 4 * ((lq & 1) ^ (lr >> 2))
                      : t * ldb + g + (n0 & ~31);
  // !kTB: n0's 8-column block within its group of 32 (zero when NB = 4)
  const int nbo = kTB || NB == 4 ? 0 : (n0 >> 3) & 3;
  const int b_u = kTB ? 0 : 4 * ldb + ((g ^ 4) - g);
  auto load_a = [&](int mb, int k0, uint32_t ah[4], uint32_t al[4]) {
    uint32_t v[4];
    if (!kTA) {
      ldsm_x4(A + a_l + 16 * mb * lda + (k0 & ~31) + 8 * (((k0 >> 3) & 3) ^ (lr & 3)), v);
    } else {
      const float* p = A + k0 * lda + a_l + 32 * (mb >> 1);
      const int c0 = (16 * (mb & 1)) ^ t8, c1 = (16 * (mb & 1) + 8) ^ t8;
      v[0] = __float_as_uint(p[c0]);
      v[1] = __float_as_uint(p[c1]);
      v[2] = __float_as_uint(p[a_u + c0]);
      v[3] = __float_as_uint(p[a_u + c1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32<kPrecise>(v[q], ah[q], al[q]);
  };
  auto load_b = [&](int nb, int k0, uint32_t bh[2], uint32_t bl[2]) {
    const float* p = B + k0 * ldb + b_l + ((8 * (nb + nbo)) ^ t8);
    if (kBLo) {
      bh[0] = __float_as_uint(p[0]);
      bh[1] = __float_as_uint(p[b_u]);
      bl[0] = __float_as_uint(p[kBLo]);
      bl[1] = __float_as_uint(p[kBLo + b_u]);
      return;
    }
    split_tf32<kPrecise>(__float_as_uint(p[0]), bh[0], bl[0]);
    split_tf32<kPrecise>(__float_as_uint(p[b_u]), bh[1], bl[1]);
  };
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    // a k step: every fragment split first, then the three passes over all
    // MB x NB blocks, so that the mma of one block do not wait on each other
    uint32_t bh[NB][2], bl[NB][2];
    if (kTB) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        // blocks: (rows n, cols k0), (n, k0 + 4), (n + 8, k0), (n + 8, k0 + 4)
        uint32_t w[4];
        const float* p = B + b_l + 8 * nb * ldb + (k0 & ~31) + 8 * (((k0 >> 3) & 3) ^ (lr & 3));
        ldsm_x4(p, w);
        if (kBLo) {
          uint32_t wl[4];
          ldsm_x4(p + kBLo, wl);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            bh[nb + q / 2][q % 2] = w[q];
            bl[nb + q / 2][q % 2] = wl[q];
          }
          continue;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32<kPrecise>(w[q], bh[nb + q / 2][q % 2], bl[nb + q / 2][q % 2]);
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) load_b(nb, k0, bh[nb], bl[nb]);
    }
    if (kBOuter) {  // one A fragment live at a time
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        uint32_t ah[4], al[4];
        load_a(mb, k0, ah, al);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], al, bh[nb]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], ah, bl[nb]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_tf32(c[mb][nb], ah, bh[nb]);
      }
      continue;
    }
    uint32_t ah[MB][4], al[MB][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) load_a(mb, k0, ah[mb], al[mb]);
    if (kPrecise) {  // this k step's passes summed apart, then added in f32
      float d[MB][NB][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[mb][nb][q] = 0.f;
      mma_passes<MB, NB>(d, ah, al, bh, bl);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) c[mb][nb][q] += d[mb][nb][q];
    } else {
      mma_passes<MB, NB>(c, ah, al, bh, bl);
    }
  }
}

// An f32 value as warp_tile_mma's kBLo operands hold it: the high and the
// low part of split_tf32<true> (rounded; what the precise mode passes).
__device__ __forceinline__ void split_b(float x, float& hi, float& lo) {
  uint32_t h, l;
  split_tf32<true>(__float_as_uint(x), h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// A C fragment pair (row r, columns c, c + 1; c even) of a swizzled matrix.
__device__ __forceinline__ void store2(float* M, int ld, int r, int c, float v0, float v1) {
  *reinterpret_cast<float2*>(M + swz_at(ld, r, c)) = make_float2(v0, v1);
}
__device__ __forceinline__ float2 load2(const float* M, int ld, int r, int c) {
  return *reinterpret_cast<const float2*>(M + swz_at(ld, r, c));
}

// cp.async: 4 or 16 bytes from global to shared memory, zero-filled when !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sum over the 8 lanes of equal t (lane bits 2-4) of v[16*mb + 8*h + 2*nb + c]
// (mb < MB, h < 2, nb < 4, c < 2), left in v[0 .. 2*MB) of lane (g, t):
// v[i] is the sum of entry g * 2*MB + i.
template <int HALF, int M>
__device__ __forceinline__ void rs_step(float* v) {
  const bool up = threadIdx.x & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF], keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}
template <int MB>
__device__ __forceinline__ void rs_lanes(float v[16 * MB]) {
  rs_step<8 * MB, 16>(v);
  rs_step<4 * MB, 8>(v);
  rs_step<2 * MB, 4>(v);
}

// Sum over the 4 lanes of equal g (t = lane bits 0-1); every lane gets it.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace geossl
