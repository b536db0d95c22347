// painn_bwd: backward of PaiNN's message pass in one kernel (plus a small
// reduction launch for the filter weights' gradients).
//
// Replaces geossl_tpu/ops/painn_pallas.py: _bwd_kernel (via _bwd_pallas and
// _painn_bwd). For the cotangents gq [B,Ni,F] and gmu [B,Ni,3F] it
// recomputes every pair tile's filter and emits the nine cotangents as the
// TPU kernel does, with D[f] = sum_c dir_c gmu_c[i,f] and
// M[f] = sum_c mu_c[j,f] gmu_c[i,f]:
//   dw       = [gq_i xq_j, D xr_j, M xm_j]  (cotangent of the gated filter)
//   dx[j]    = sum_i [wq gq_i, wr D, wm M]
//   dmu_c[j] = sum_i wm gmu_c[i] xm_j
//   ddir_c   = sum_f wr xr_j gmu_c[i]     dgate = sum_t w_raw dw
//   dwg = dw gate:  dWk += phi^T dwg,  dbk += sum dwg,
//   ddist = sum_r (dwg Wk^T)[r] phi_r 2 coeff (d - off_r)
// w_raw = phi Wk + bk is recomputed for dgate (the gate may be zero, so it
// is never divided out). The [B,N,N,3F] tensors never leave the chip.
//
// Bound on the H100: operations. Per occupied pair: the filter recomputed
// (2*R*3F), dWk and dbk (2*(R+1)*3F), dphi (2*R*3F) and ~40F elementwise:
// ~52k FLOP at R=20, F=128, against ~40 bytes of pair grids read and
// written. With `sparse`, 8x8 tiles whose gate is all zero are skipped and
// their five pair cotangents written as zero (the occupancy contract of
// geossl_tpu/ops/pallas_utils.py: exact downstream, since the gate has value
// and slope zero there and every other pair cotangent carries a gate
// factor). Plain f32 FMAs, no tensor cores.
//
// Work split. The TPU grid is transposed ((b, j, i), i innermost) so that the
// j-indexed dx and dmu accumulate over i. Here a persistent grid (one block
// per SM: the block's shared memory is ~178 KB) walks the (graph, 8-column
// j tile) items; a block loops over the i tiles of its item, keeps dx and
// dmu of its j rows in registers, and keeps its share of dWk and dbk in
// registers over all its items: dbk is row R of the same product, with a
// row of ones under the RBF rows. At the end each block writes one partial
// row of (R+1)*3F floats and a second launch sums them in block order
// (reduce.cuh): no atomics, bitwise the same from run to run on one card.
//
// Pair tile layout: p = jl*8 + il (j-major), so a thread's 4 pairs share one
// j (its warp) and the dx sum over i is a register sum plus one
// __shfl_xor(16). Wk and the staged dwg tile have a padded row stride
// (kWS3 = 388), so the products that read them by column spread over the
// banks.
#include "painn_tile.cuh"
#include "reduce.cuh"

namespace geossl {

constexpr int kWS3 = kF3 + 4;

__global__ void __launch_bounds__(kThreads, 1)
painn_bwd_kernel(const float* __restrict__ dist, const float* __restrict__ gate,
                 const float* __restrict__ dirx, const float* __restrict__ diry,
                 const float* __restrict__ dirz, const float* __restrict__ x,
                 const float* __restrict__ mu, const float* __restrict__ wk,
                 const float* __restrict__ bk, const float* __restrict__ gq,
                 const float* __restrict__ gmu, float* __restrict__ dx,
                 float* __restrict__ dmu_in, float* __restrict__ ddist,
                 float* __restrict__ dgate, float* __restrict__ ddx,
                 float* __restrict__ ddy, float* __restrict__ ddz,
                 float* __restrict__ part, int B, int ni, int nj, int R, float delta,
                 float coeff, int sparse) {
  extern __shared__ float4 smem_v4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v4);
  float* Wk_s = smem;                      // [R][kWS3]
  float* phi_s = Wk_s + R * kWS3;          // [R+1][kPhiS], row R = 1
  float* dwg_s = phi_s + (R + 1) * kPhiS;  // [kPairs][kWS3]
  float* xj_s = dwg_s + kPairs * kWS3;     // [kTile][kF3]  x rows of the j tile
  float* muj_s = xj_s + kTile * kF3;       // [kTile][kF3]  mu rows of the j tile
  float* gq_s = muj_s + kTile * kF3;       // [kTile][kF]   gq rows of the i tile
  float* gmu_s = gq_s + kTile * kF;        // [kTile][kF3]  gmu rows of the i tile
  float* pr_s = gmu_s + kTile * kF3;       // [5][kPairs]
  int* occ_s = (int*)(pr_s + 5 * kPairs);  // [nti]

  const int tid = threadIdx.x;
  const int fg = tid & (kFG - 1), hw = tid >> 4;
  const int jl = tid >> 5, il0 = (hw & 1) * kPPT;  // this thread's j and first i
  const int p0 = jl * kTile + il0;
  const int ntj = (nj + kTile - 1) / kTile, nti = (ni + kTile - 1) / kTile;

  for (int idx = tid; idx < R * kF3; idx += kThreads)
    Wk_s[(idx / kF3) * kWS3 + idx % kF3] = wk[idx];
  for (int idx = tid; idx < kPairs; idx += kThreads) phi_s[R * kPhiS + idx] = 1.f;

  // this block's share of [dWk; dbk]: rows r = hw + 16m, chunk c, feat(fg, k)
  float gw[2][3][kFPT];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) gw[m][c][k] = 0.f;

  for (int item = blockIdx.x; item < B * ntj; item += gridDim.x) {
    const int b = item / ntj, j0 = (item % ntj) * kTile;
    const size_t grid_off = (size_t)b * ni * nj;
    const float* gate_b = gate + grid_off;
    const float* gq_b = gq + (size_t)b * ni * kF;
    const float* gmu_b = gmu + (size_t)b * ni * kF3;

    __syncthreads();  // the previous item is done with xj_s, muj_s, occ_s
    for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
      const int j = j0 + idx / kF3;
      const size_t src = ((size_t)b * nj + j) * kF3 + idx % kF3;
      xj_s[idx] = j < nj ? x[src] : 0.f;
      muj_s[idx] = j < nj ? mu[src] : 0.f;
    }
    if (sparse) {
      for (int t = tid; t < nti; t += kThreads) occ_s[t] = 0;
      __syncthreads();
      for (int idx = tid; idx < ni * kTile; idx += kThreads) {
        const int i = idx / kTile, j = j0 + idx % kTile;
        if (j < nj && gate_b[(size_t)i * nj + j] != 0.f) occ_s[i / kTile] = 1;
      }
      __syncthreads();
    }

    float dxa[3][kFPT], dma[3][kFPT];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) dxa[c][k] = dma[c][k] = 0.f;

    for (int pi = 0; pi < nti; ++pi) {
      const int i0 = pi * kTile;
      if (sparse && !occ_s[pi]) {  // block-uniform
        if (tid < kPairs) {
          const int i = i0 + (tid & 7), j = j0 + (tid >> 3);
          if (i < ni && j < nj) {
            const size_t off = grid_off + (size_t)i * nj + j;
            ddist[off] = dgate[off] = ddx[off] = ddy[off] = ddz[off] = 0.f;
          }
        }
        continue;
      }
      __syncthreads();  // the previous tile is done with the tile scratch
      if (tid < kPairs)
        painn_load_pairs(pr_s, dist + grid_off, gate_b, dirx + grid_off,
                         diry + grid_off, dirz + grid_off, i0 + (tid & 7),
                         j0 + (tid >> 3), ni, nj, tid);
      for (int idx = tid; idx < kTile * kF3; idx += kThreads) {
        const int i = i0 + idx / kF3;
        gmu_s[idx] = i < ni ? gmu_b[(size_t)i * kF3 + idx % kF3] : 0.f;
        if (idx < kTile * kF) {
          const int ii = i0 + idx / kF;
          gq_s[idx] = ii < ni ? gq_b[(size_t)ii * kF + idx % kF] : 0.f;
        }
      }
      __syncthreads();
      painn_rbf(pr_s, phi_s, R, delta, coeff);
      __syncthreads();

      // per pair: dgate and ddir partial sums over this thread's features
      float pg[kPPT], pd[3][kPPT];
#pragma unroll
      for (int q = 0; q < kPPT; ++q) pg[q] = pd[0][q] = pd[1][q] = pd[2][q] = 0.f;

#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float w[kPPT][kFPT];
        painn_filter_chunk<kWS3>(phi_s, Wk_s, bk, R, p0, fg, c, w);  // raw
        float xv[kFPT];
        load_feats(xj_s + jl * kF3 + c * kF, fg, xv);
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const int p = p0 + q, il = il0 + q;
          const float g = pr_s[kPairs + p];
          float dw[kFPT];
          if (c == 0) {
            float gv[kFPT];
            load_feats(gq_s + il * kF, fg, gv);
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              dw[k] = gv[k] * xv[k];
              dxa[0][k] = fmaf(g * w[q][k], gv[k], dxa[0][k]);
            }
          } else {
            // s = D (c == 1: sum_c dir_c gmu_c) or M (c == 2: sum_c mu_c[j] gmu_c)
            float s[kFPT], wx[kFPT];
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              s[k] = 0.f;
              wx[k] = g * w[q][k] * xv[k];
            }
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              float gm[kFPT], by[kFPT];
              load_feats(gmu_s + il * kF3 + cc * kF, fg, gm);
              if (c == 1) {
                const float dc = pr_s[(2 + cc) * kPairs + p];
#pragma unroll
                for (int k = 0; k < kFPT; ++k) {
                  s[k] = fmaf(dc, gm[k], s[k]);
                  pd[cc][q] = fmaf(wx[k], gm[k], pd[cc][q]);
                }
              } else {
                load_feats(muj_s + jl * kF3 + cc * kF, fg, by);
#pragma unroll
                for (int k = 0; k < kFPT; ++k) {
                  s[k] = fmaf(by[k], gm[k], s[k]);
                  dma[cc][k] = fmaf(wx[k], gm[k], dma[cc][k]);
                }
              }
            }
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              dw[k] = s[k] * xv[k];
              dxa[c][k] = fmaf(g * w[q][k], s[k], dxa[c][k]);
            }
          }
#pragma unroll
          for (int k = 0; k < kFPT; ++k) pg[q] = fmaf(w[q][k], dw[k], pg[q]);
          float* row = dwg_s + p * kWS3 + c * kF + fg * 4;
          st4(row, dw[0] * g, dw[1] * g, dw[2] * g, dw[3] * g);
          st4(row + kF / 2, dw[4] * g, dw[5] * g, dw[6] * g, dw[7] * g);
        }
      }
      {
        float sg[kPPT], sd[3][kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          sg[q] = half_warp_sum(pg[q]);
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) sd[cc][q] = half_warp_sum(pd[cc][q]);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) {
              const size_t off = grid_off + (size_t)i * nj + j;
              dgate[off] = sg[q];
              ddx[off] = sd[0][q];
              ddy[off] = sd[1][q];
              ddz[off] = sd[2][q];
            }
          }
        }
      }
      __syncthreads();  // dwg_s complete

      // ddist = sum_r (dwg Wk^T)[r] phi_r 2 coeff (d - delta r), r = fg + 16m
      {
        float dr[kPPT][2];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) dr[q][0] = dr[q][1] = 0.f;
        const int r0 = min(fg, R - 1), r1 = min(fg + 16, R - 1);
        for (int t0 = 0; t0 < kF3; t0 += 4) {
          const float4 w0 = ld4(Wk_s + r0 * kWS3 + t0), w1 = ld4(Wk_s + r1 * kWS3 + t0);
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const float4 a = ld4(dwg_s + (p0 + q) * kWS3 + t0);
            dr[q][0] = fmaf(a.x, w0.x, fmaf(a.y, w0.y, fmaf(a.z, w0.z, fmaf(a.w, w0.w, dr[q][0]))));
            dr[q][1] = fmaf(a.x, w1.x, fmaf(a.y, w1.y, fmaf(a.z, w1.z, fmaf(a.w, w1.w, dr[q][1]))));
          }
        }
        float dd[kPPT];
#pragma unroll
        for (int q = 0; q < kPPT; ++q) {
          const int p = p0 + q;
          const float d = pr_s[p];
          float s = 0.f;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int r = fg + 16 * m;
            if (r < R) {
              const float diff = d - delta * (float)r;
              s = fmaf(dr[q][m] * phi_s[r * kPhiS + p], 2.f * coeff * diff, s);
            }
          }
          dd[q] = half_warp_sum(s);
        }
        if (fg == 0) {
#pragma unroll
          for (int q = 0; q < kPPT; ++q) {
            const int i = i0 + il0 + q, j = j0 + jl;
            if (i < ni && j < nj) ddist[grid_off + (size_t)i * nj + j] = dd[q];
          }
        }
      }

      // [dWk; dbk] += [phi; 1]^T dwg over the tile's 64 pairs, rows hw + 16m
      {
        const int r0 = min(hw, R), r1 = min(hw + 16, R);
        for (int p = 0; p < kPairs; ++p) {
          const float a0 = phi_s[r0 * kPhiS + p], a1 = phi_s[r1 * kPhiS + p];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float dv[kFPT];
            load_feats(dwg_s + p * kWS3 + c * kF, fg, dv);
#pragma unroll
            for (int k = 0; k < kFPT; ++k) {
              gw[0][c][k] = fmaf(a0, dv[k], gw[0][c][k]);
              gw[1][c][k] = fmaf(a1, dv[k], gw[1][c][k]);
            }
          }
        }
      }
    }

    // dx and dmu rows: the two half-warps hold i 0-3 and 4-7 of every tile
    const int j = j0 + jl;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        dxa[c][k] += __shfl_xor_sync(0xffffffffu, dxa[c][k], 16);
        dma[c][k] += __shfl_xor_sync(0xffffffffu, dma[c][k], 16);
      }
    if ((tid & 16) == 0 && j < nj) {
      const size_t row = ((size_t)b * nj + j) * kF3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) {
          dx[row + c * kF + feat(fg, k)] = dxa[c][k];
          dmu_in[row + c * kF + feat(fg, k)] = dma[c][k];
        }
    }
  }

  // this block's partial [dWk; dbk], rows 0..R
  float* out = part + (size_t)blockIdx.x * (R + 1) * kF3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = hw + 16 * m;
    if (r <= R) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < kFPT; ++k) out[r * kF3 + c * kF + feat(fg, k)] = gw[m][c][k];
    }
  }
}

static size_t smem_bytes(int R, int ni) {
  return sizeof(float) * ((size_t)R * kWS3 + (size_t)(R + 1) * kPhiS + kPairs * kWS3 +
                          2 * kTile * kF3 + kTile * kF + kTile * kF3 + 5 * kPairs) +
         sizeof(int) * (size_t)((ni + kTile - 1) / kTile);
}

}  // namespace geossl

extern "C" size_t painn_bwd_smem_bytes(int R, int ni) { return geossl::smem_bytes(R, ni); }

// Blocks of the persistent grid, i.e. rows of the partials buffer.
extern "C" int painn_bwd_blocks(int B, int nj) {
  return geossl::persistent_blocks(B * ((nj + geossl::kTile - 1) / geossl::kTile));
}

// Returns the cudaError_t of the launches (0 on success). `part` holds
// painn_bwd_blocks(B, nj) rows of (R+1)*3F floats; `wgrad` (one such row)
// receives dWk [R,3F] and then dbk [3F]. F must be 128 and 2 <= R <= 31.
extern "C" int painn_bwd(const float* dist, const float* gate, const float* dirx,
                         const float* diry, const float* dirz, const float* x,
                         const float* mu, const float* wk, const float* bk,
                         const float* gq, const float* gmu, float* dx, float* dmu_in,
                         float* ddist, float* dgate, float* ddx, float* ddy, float* ddz,
                         float* part, float* wgrad, int B, int ni, int nj, int F, int R,
                         float delta, float coeff, int sparse, void* stream) {
  using namespace geossl;
  if (F != kF || R < 2 || R > 31) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, ni);
  const int blocks = painn_bwd_blocks(B, nj);
  cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(painn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  painn_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, dx, dmu_in, ddist, dgate,
      ddx, ddy, ddz, part, B, ni, nj, R, delta, coeff, sparse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials(part, blocks, (R + 1) * kF3, wgrad, s);
  return (int)cudaGetLastError();
}
