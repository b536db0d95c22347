// cfconv_bwd: backward of SchNet's continuous-filter convolution in one
// kernel (plus a small reduction launch for the weight gradients).
//
// Replaces geossl_tpu/ops/cfconv_pallas.py: _bwd_kernel (via _bwd_pallas).
// For m[b,i,f] = sum_j env W[b,i,j,f] x[b,j,f] with W = ssp(rbf(d) W1 + b1) W2 + b2
// and the cotangent g[b,i,f] it recomputes the filter of every pair tile and
// emits all seven cotangents, as the TPU kernel does:
//   denv[b,i,j] = sum_f W g[i,f] x[j,f]        ddist[b,i,j] via the RBF chain
//   dx[b,j,f]   = sum_i env W g[i,f]
//   dW2 = s^T qe, db2 = sum qe, dh = (qe W2^T) ssp'(pre1), dW1 = rbf^T dh,
//   db1 = sum dh, with qe[i,j,f] = env g[i,f] x[j,f]
// The [B,N,N,F] tensors never leave the chip.
//
// Bound on the H100: operations. Per occupied pair it does the forward
// filter (2GF + 2F^2) and four more products (dW2, dh: 2F^2 each; dW1,
// drbf: 2GF each), ~137k FLOP at G=51, F=128, against 16 bytes of
// dist/env/ddist/denv. As in the forward, the design removes work rather
// than speeding the arithmetic: with `sparse`, 8x8 tiles whose envelope is
// all zero are skipped (their ddist and denv are written as zero, the
// occupancy contract of geossl_tpu/ops/pallas_utils.py: exact downstream,
// since env has value and slope zero there). Plain f32 FMAs, no tensor cores.
//
// Work split. The TPU kernel accumulates dx over an inner sequential i axis
// and the weight gradients over its whole grid. Here a persistent grid (one
// block per SM, 1 block/SM by shared memory) walks the (graph, 8-column j
// tile) items; a block loops over the i tiles of its item and keeps its dx
// rows in registers, and keeps its share of dW1/db1/dW2/db2 in registers over
// all its items. At the end each block writes its partial weight gradients,
// and a second launch sums the partials in block order (reduce.cuh): no
// atomics, so the result is bitwise the same from run to run on one card.
//
// Pair tile layout: pair p = jl*8 + il (row = local j, column = local i), so
// the 4 pairs a thread owns in filter_tile (pair_tile.cuh) share one j (its
// warp) and the dx sum over i is a register sum plus one __shfl_xor(16).
// W1 and W2 sit in shared memory with a padded row stride (kWS = 132), so
// that the products reading them by column (dh = qe W2^T, drbf = dh W1^T)
// spread over the banks.
#include "pair_tile.cuh"
#include "reduce.cuh"

namespace geossl {

constexpr int kWS = kF + 4;  // padded row stride of W1_s / W2_s

// Floats of one block's partial weight gradients: [dW1 G*F][db1 F][dW2 F*F][db2 F]
__host__ __device__ inline int wgrad_size(int G) { return G * kF + kF + kF * kF + kF; }

__global__ void __launch_bounds__(kThreads, 1)
cfconv_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ env,
                  const float* __restrict__ x, const float* __restrict__ gr,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ ddist, float* __restrict__ denv,
                  float* __restrict__ dx, float* __restrict__ part, int B,
                  int ni, int nj, int G, float start, float delta, float coeff,
                  int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* W1_s = smem;                   // [G][kWS]
  float* W2_s = W1_s + G * kWS;         // [kF][kWS]
  float* rbf_s = W2_s + kF * kWS;       // [G][kPairs]
  float* s_s = rbf_s + G * kPairs;      // [kPairs][kF] hidden ssp(pre1)
  float* sd_s = s_s + kPairs * kF;      // [kPairs][kF] ssp'(pre1), then dh
  float* qe_s = sd_s + kPairs * kF;     // [kPairs][kF] env g_i x_j
  float* g_s = qe_s + kPairs * kF;      // [kTile][kF]  g rows of the i tile
  float* x_s = g_s + kTile * kF;        // [kTile][kF]  x rows of the j tile
  float* d_s = x_s + kTile * kF;        // [kPairs]
  float* e_s = d_s + kPairs;            // [kPairs]
  int* occ_s = (int*)(e_s + kPairs);    // [nti] occupancy of the item's tiles

  const int tid = threadIdx.x;
  const int fg = tid & (kFG - 1), hw = tid >> 4;
  const int jl = tid >> 5, il0 = (hw & 1) * kPPT;  // this thread's j and first i
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;

  for (int idx = tid; idx < G * kF; idx += kThreads)
    W1_s[(idx / kF) * kWS + idx % kF] = w1[idx];
  for (int idx = tid; idx < kF * kF; idx += kThreads)
    W2_s[(idx / kF) * kWS + idx % kF] = w2[idx];

  // this block's share of the weight gradients, over all its items
  float gw2[kFPT][kFPT];  // dW2[feat(hw, a)][feat(fg, k)]
  float gw1[4][kFPT];     // dW1[hw + 16 m][feat(fg, k)]   (G <= 64)
  float gb1[kFPT];        // db1[fg + 16 k], summed over hw below
  float gb2[kFPT];        // db2[feat(fg, k)], summed over hw below
#pragma unroll
  for (int a = 0; a < kFPT; ++a) {
    gb1[a] = 0.f;
    gb2[a] = 0.f;
#pragma unroll
    for (int k = 0; k < kFPT; ++k) gw2[a][k] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < kFPT; ++k) gw1[m][k] = 0.f;

  for (int item = blockIdx.x; item < B * ntj; item += gridDim.x) {
    const int b = item / ntj, j0 = (item % ntj) * kTile;
    const float* dist_b = dist + (size_t)b * ni * nj;
    const float* env_b = env + (size_t)b * ni * nj;
    const float* g_b = gr + (size_t)b * ni * kF;
    float* ddist_b = ddist + (size_t)b * ni * nj;
    float* denv_b = denv + (size_t)b * ni * nj;

    __syncthreads();  // the previous item is done with x_s and occ_s
    for (int idx = tid; idx < kTile * kF; idx += kThreads) {
      const int j = j0 + idx / kF;
      x_s[idx] = j < nj ? x[((size_t)b * nj + j) * kF + idx % kF] : 0.f;
    }
    if (sparse) {
      for (int t = tid; t < nti; t += kThreads) occ_s[t] = 0;
      __syncthreads();
      for (int idx = tid; idx < ni * kTile; idx += kThreads) {
        const int i = idx / kTile, j = j0 + idx % kTile;
        if (j < nj && env_b[(size_t)i * nj + j] != 0.f) occ_s[i / kTile] = 1;
      }
      __syncthreads();
    }

    float dxa[kFPT];
#pragma unroll
    for (int k = 0; k < kFPT; ++k) dxa[k] = 0.f;

    for (int pi = 0; pi < nti; ++pi) {
      const int i0 = pi * kTile;
      if (sparse && !occ_s[pi]) {  // block-uniform
        if (tid < kPairs) {
          const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
          if (i < ni && j < nj) {
            ddist_b[(size_t)i * nj + j] = 0.f;
            denv_b[(size_t)i * nj + j] = 0.f;
          }
        }
        continue;
      }
      __syncthreads();  // the previous tile is done with the tile scratch
      if (tid < kPairs) {
        const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
        const bool in = i < ni && j < nj;
        d_s[tid] = in ? dist_b[(size_t)i * nj + j] : 0.f;
        e_s[tid] = in ? env_b[(size_t)i * nj + j] : 0.f;
      }
      for (int idx = tid; idx < kTile * kF; idx += kThreads) {
        const int i = i0 + idx / kF;
        g_s[idx] = i < ni ? g_b[(size_t)i * kF + idx % kF] : 0.f;
      }
      __syncthreads();

      // forward filter of the tile: w in registers, s and ssp' in shared memory
      float w[kPPT][kFPT];
      filter_tile<kWS, true>(d_s, rbf_s, s_s, W1_s, b1, W2_s, b2, G, start,
                             delta, coeff, w, sd_s);

      // denv, dx, qe, db2 (pairs jl*8 + il0 + q, features feat(fg, k))
      {
        float xv[kFPT];
        load_feats(x_s + jl * kF, fg, xv);
        float den[kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const int p = jl * kTile + il0 + q;
          const float e = e_s[p];
          float gv[kFPT], qe[kFPT];
          load_feats(g_s + (il0 + q) * kF, fg, gv);
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < kFPT; ++k) {
            const float qv = gv[k] * xv[k];
            s = fmaf(w[q][k], qv, s);
            qe[k] = e * qv;
            dxa[k] = fmaf(e * w[q][k], gv[k], dxa[k]);
            gb2[k] += qe[k];
          }
          st4(qe_s + p * kF + fg * 4, qe[0], qe[1], qe[2], qe[3]);
          st4(qe_s + p * kF + kF / 2 + fg * 4, qe[4], qe[5], qe[6], qe[7]);
          den[q] = half_warp_sum(s);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) denv_b[(size_t)i * nj + j] = den[q];
          }
        }
      }
      __syncthreads();  // qe_s and s_s complete

      // dW2 += s^T qe over the tile's 64 pairs
      for (int p = 0; p < kPairs; ++p) {
        float sv[kFPT], qv[kFPT];
        load_feats(s_s + p * kF, hw, sv);
        load_feats(qe_s + p * kF, fg, qv);
#pragma unroll
        for (int a = 0; a < kFPT; ++a)
#pragma unroll
          for (int k = 0; k < kFPT; ++k) gw2[a][k] = fmaf(sv[a], qv[k], gw2[a][k]);
      }

      // dh = (qe W2^T) ssp'(pre1), features c = fg + 16k, written over sd_s
      {
        float dh[kPPT][kFPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q)
#pragma unroll
          for (int k = 0; k < kFPT; ++k) dh[q][k] = 0.f;
        for (int f0 = 0; f0 < kF; f0 += 4) {
          float a[kPPT][4];
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float4 v = ld4(qe_s + (jl * kTile + il0 + q) * kF + f0);
            a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < kFPT; ++k) {
            const float4 wv = ld4(W2_s + (fg + 16 * k) * kWS + f0);
#pragma unroll
            for (int q = 0; q < kPPT; ++q)
              dh[q][k] = fmaf(a[q][0], wv.x, fmaf(a[q][1], wv.y,
                         fmaf(a[q][2], wv.z, fmaf(a[q][3], wv.w, dh[q][k]))));
          }
        }
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          float* row = sd_s + (jl * kTile + il0 + q) * kF;
#pragma unroll
          for (int k = 0; k < kFPT; ++k) {
            const float v = dh[q][k] * row[fg + 16 * k];
            row[fg + 16 * k] = v;  // each element is read and written by one thread
            gb1[k] += v;
          }
        }
      }
      __syncthreads();  // dh complete

      // ddist = sum_g (dh W1^T)[g] rbf_g 2 coeff (d - off_g), g = fg + 16m
      {
        float dr[kPPT][4];
#pragma unroll
        for (int q = 0; q < kPPT; ++q)
#pragma unroll
          for (int m = 0; m < 4; ++m) dr[q][m] = 0.f;
        for (int c0 = 0; c0 < kF; c0 += 4) {
          float a[kPPT][4];
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float4 v = ld4(sd_s + (jl * kTile + il0 + q) * kF + c0);
            a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float4 wv = ld4(W1_s + min(fg + 16 * m, G - 1) * kWS + c0);
#pragma unroll
            for (int q = 0; q < kPPT; ++q)
              dr[q][m] = fmaf(a[q][0], wv.x, fmaf(a[q][1], wv.y,
                         fmaf(a[q][2], wv.z, fmaf(a[q][3], wv.w, dr[q][m]))));
          }
        }
        float dd[kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const float d = d_s[jl * kTile + il0 + q];
          float s = 0.f;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int g = fg + 16 * m;
            if (g < G) {
              const float diff = d - (start + delta * (float)g);
              s = fmaf(dr[q][m] * expf(coeff * diff * diff), 2.f * coeff * diff, s);
            }
          }
          dd[q] = half_warp_sum(s);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) ddist_b[(size_t)i * nj + j] = dd[q];
          }
        }
      }

      // dW1 += rbf^T dh, rows g = hw + 16m
      for (int p0 = 0; p0 < kPairs; p0 += 4) {
        float r[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 v = ld4(rbf_s + min(hw + 16 * m, G - 1) * kPairs + p0);
          r[m][0] = v.x; r[m][1] = v.y; r[m][2] = v.z; r[m][3] = v.w;
        }
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float hv[kFPT];
          load_feats(sd_s + (p0 + pp) * kF, fg, hv);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int k = 0; k < kFPT; ++k) gw1[m][k] = fmaf(r[m][pp], hv[k], gw1[m][k]);
        }
      }
    }

    // dx rows: the two half-warps hold i 0-3 and 4-7 of every tile
    const int j = j0 + jl;
#pragma unroll
    for (int k = 0; k < kFPT; ++k) dxa[k] += __shfl_xor_sync(0xffffffffu, dxa[k], 16);
    if ((tid & 16) == 0 && j < nj) {
#pragma unroll
      for (int k = 0; k < kFPT; ++k) dx[((size_t)b * nj + j) * kF + feat(fg, k)] = dxa[k];
    }
  }

  // this block's partial weight gradients
  float* out = part + (size_t)blockIdx.x * wgrad_size(G);
  float* pw1 = out;
  float* pb1 = pw1 + G * kF;
  float* pw2 = pb1 + kF;
  float* pb2 = pw2 + kF * kF;
#pragma unroll
  for (int a = 0; a < kFPT; ++a)
#pragma unroll
    for (int k = 0; k < kFPT; ++k) pw2[feat(hw, a) * kF + feat(fg, k)] = gw2[a][k];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int g = hw + 16 * m;
    if (g < G) {
#pragma unroll
      for (int k = 0; k < kFPT; ++k) pw1[g * kF + feat(fg, k)] = gw1[m][k];
    }
  }
  // db1 and db2: sum the 16 half-warps' copies in a fixed order
  __syncthreads();  // the tile scratch is free
  float* red_s = s_s;  // [16][2 kF]
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    red_s[hw * 2 * kF + fg + 16 * k] = gb1[k];
    red_s[hw * 2 * kF + kF + feat(fg, k)] = gb2[k];
  }
  __syncthreads();
  for (int c = tid; c < 2 * kF; c += kThreads) {
    float s = 0.f;
    for (int h = 0; h < 16; ++h) s += red_s[h * 2 * kF + c];
    if (c < kF)
      pb1[c] = s;
    else
      pb2[c - kF] = s;
  }
}

static size_t smem_bytes(int G, int ni) {
  return sizeof(float) * ((size_t)G * kWS + kF * kWS + G * kPairs + 3 * kPairs * kF +
                          2 * kTile * kF + 2 * kPairs) +
         sizeof(int) * (size_t)((ni + kTile - 1) / kTile);
}

}  // namespace geossl

extern "C" size_t cfconv_bwd_smem_bytes(int G, int ni) { return geossl::smem_bytes(G, ni); }

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int cfconv_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// cfconv_bwd_blocks(B, nj) rows of G*F + F + F*F + F floats; `wgrad` (same
// row size) receives dW1 [G,F], db1 [F], dW2 [F,F], db2 [F]. F must be 128
// and G at most 64.
extern "C" int cfconv_bwd(const float* dist, const float* env, const float* x,
                          const float* g, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* ddist,
                          float* denv, float* dx, float* part, float* wgrad,
                          int B, int ni, int nj, int F, int G, float start,
                          float delta, float coeff, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || G > 64 || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, ni);
  const int blocks = cfconv_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(cfconv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cfconv_bwd_kernel<<<blocks, kThreads, smem, s>>>(dist, env, x, g, w1, b1, w2, b2,
                                                   ddist, denv, dx, part, B, ni, nj, G,
                                                   start, delta, coeff, sparse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, wgrad_size(G), wgrad, s);
  return (int)cudaGetLastError();
}
