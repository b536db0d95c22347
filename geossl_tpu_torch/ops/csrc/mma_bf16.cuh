// Tensor-core tile products with bf16 operands and f32 accumulation: the
// bf16 instances of the CFConv kernels (cfconv_fwd.cu, cfconv_bwd.cu), the
// counterpart of geossl_tpu/ops/cfconv_pallas.py's _dot with mxu='bf16':
// both operands rounded to bf16 (round to nearest even), their products
// exact in f32, the sums in f32. One pass, no split.
//
// warp_tile_mma_bf16 has warp_tile_mma's signature and transposition flags
// (mma_tf32.cuh) and reads the same swizzled f32 shared-memory matrices, so
// the kernels' shared layout and cp.async pipelines do not change: it rounds
// each pair of operand values to one bf16x2 register (cvt.rn.bf16x2.f32) as
// it loads them and issues one mma.sync.m16n8k16 per 16x8 block and k step
// of 16. Fragments (PTX ISA, m16n8k16 with .bf16): lane (g, t) holds A rows
// g and g + 8 at k = 2t, 2t + 1 and 2t + 8, 2t + 9, and B column g at the
// same k, the lower k in the lower half of each register; C is m16n8k8's.
// The two k of one register lie side by side in one stored row where K runs
// along the stored rows (A not transposed, B transposed): one 8-byte load,
// since the swizzle moves aligned groups of 4 floats. Where K runs down the
// stored columns (kTA, and B not transposed) they are two scalar loads.
//
// K steps are 16: tile_mma pads a K of 56 (the G <= 56 RBF product) to 64,
// which the callers' operands hold with zeros in both (rows >= G of W1 and
// columns >= G of the RBF).
#pragma once

#include "mma_tf32.cuh"

namespace geossl {

// lo in the low half, hi in the high half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Elements (r, c) and (r, c + 1) of a swizzled matrix (c even) as bf16x2.
__device__ __forceinline__ uint32_t bf16_pair_in_row(const float* M, int ld, int r, int c) {
  const float2 v = *reinterpret_cast<const float2*>(M + swz_at(ld, r, c));
  return pack_bf16x2(v.x, v.y);
}
// Elements (r, c) and (r + 1, c) as bf16x2.
__device__ __forceinline__ uint32_t bf16_pair_in_col(const float* M, int ld, int r, int c) {
  return pack_bf16x2(M[swz_at(ld, r, c)], M[swz_at(ld, r + 1, c)]);
}

// c[mb][nb] (16x8 blocks at rows m0 + 16 mb, columns n0 + 8 nb) += A B over
// k in [0, K), A and B as warp_tile_mma's (A[m][k] = MA(m, k), with kTA
// MA(k, m); B[k][n] = MB_(k, n), with kTB MB_(n, k)), with bf16 operands.
// One A fragment is live at a time (warp_tile_mma's kBOuter order).
template <int MB, int NB, int K, bool kTA, bool kTB>
__device__ __forceinline__ void warp_tile_mma_bf16(float c[MB][NB][4], const float* A, int lda,
                                                   int m0, const float* B, int ldb, int n0) {
  static_assert(K % 16 == 0, "K is a multiple of 16");
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  // A's pair (m, k), (m, k + 1); B's pair (k, n), (k + 1, n)
  auto a_pair = [&](int m, int k) {
    return kTA ? bf16_pair_in_col(A, lda, k, m) : bf16_pair_in_row(A, lda, m, k);
  };
  auto b_pair = [&](int k, int n) {
    return kTB ? bf16_pair_in_row(B, ldb, n, k) : bf16_pair_in_col(B, ldb, k, n);
  };
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = n0 + 8 * nb + g;
      b[nb][0] = b_pair(k0 + t2, n);
      b[nb][1] = b_pair(k0 + t2 + 8, n);
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int m = m0 + 16 * mb + g;
      const uint32_t a[4] = {a_pair(m, k0 + t2), a_pair(m + 8, k0 + t2), a_pair(m, k0 + t2 + 8),
                             a_pair(m + 8, k0 + t2 + 8)};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_bf16(c[mb][nb], a, b[nb]);
    }
  }
}

// The tile product in the precision of a kernel instance: kBF16 rounds the
// operands to bf16 (warp_tile_mma_bf16, K rounded up to a multiple of 16),
// else 3xTF32 (warp_tile_mma, whose kBOuter and kPrecise it passes on; the
// bf16 instances take no precise mode: their products are exact in f32 and
// the CFConv kernels run the plain split).
template <bool kBF16, int MB, int NB, int K, bool kTA, bool kTB, bool kBOuter = false,
          bool kPrecise = false>
__device__ __forceinline__ void tile_mma(float c[MB][NB][4], const float* A, int lda, int m0,
                                         const float* B, int ldb, int n0) {
  static_assert(!(kBF16 && kPrecise), "no precise mode in bf16");
  if constexpr (kBF16)
    warp_tile_mma_bf16<MB, NB, (K + 15) / 16 * 16, kTA, kTB>(c, A, lda, m0, B, ldb, n0);
  else
    warp_tile_mma<MB, NB, K, kTA, kTB, kBOuter, kPrecise>(c, A, lda, m0, B, ldb, n0);
}

}  // namespace geossl
