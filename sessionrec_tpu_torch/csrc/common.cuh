// Helpers shared by the catalog-loss kernels (xent.cu, xent_bwd.cu,
// xent_multi.cu): constants, type conversions and the shared-memory
// staging of operand rows and catalog tiles.  Everything here has internal
// linkage, so each source that includes it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // ops/masked.py:NEG_INF
constexpr float NORM_EPS = 1e-12f;  // layers.l2norm eps
constexpr int NT = 256;             // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_D = 256;          // D <= MAX_D (register tiles below)
constexpr unsigned FULL = 0xffffffffu;

// forward / dsr tiles: 32 rows x 64 catalog columns
constexpr int F_BM = 32;
constexpr int F_BN = 64;
// dtable tiles: 32 catalog rows x 64 batch rows
constexpr int T_BN = 32;
constexpr int T_BM = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// round to the operand type and back (identity for float32)
template <typename T> __device__ __forceinline__ float round_op(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// rows [row0, row0 + rows) of a row-major [n_rows, D] array into shared
// memory with row stride ld, as float; rows at or past n_rows read as 0
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           int row0, int n_rows, int rows,
                                           int D) {
  for (int r = 0; r < rows; ++r) {
    const int gr = row0 + r;
    for (int k = threadIdx.x; k < D; k += NT)
      dst[r * ld + k] = gr < n_rows ? to_f(src[(size_t)gr * D + k]) : 0.f;
  }
}

// nrm[c] = max(||tile row c||, eps), one warp per row
__device__ __forceinline__ void tile_norms(const float* tile, int ld,
                                           float* nrm, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < rows; c += NWARPS) {
    float acc = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = tile[c * ld + k];
      acc += v * v;
    }
    acc = warp_sum(acc);
    if (lane == 0) nrm[c] = fmaxf(sqrtf(acc), NORM_EPS);
  }
}

// stage a catalog tile as the backward pass's product operand: the
// (normalised) rows rounded to the operand type; nrm gets the norms
template <typename T>
__device__ __forceinline__ void stage_operand_tile(float* tile, int ld,
                                                   float* nrm, const T* tab,
                                                   int p0, int p_end, int rows,
                                                   int D, int normalize) {
  stage_rows(tile, ld, tab, p0, p_end, rows, D);
  __syncthreads();
  if (normalize) {
    tile_norms(tile, ld, nrm, rows, D);
    __syncthreads();
    for (int r = 0; r < rows; ++r)
      for (int k = threadIdx.x; k < D; k += NT)
        tile[r * ld + k] = round_op<T>(tile[r * ld + k] / nrm[r]);
  }
  __syncthreads();
}

// acc[i][j] += sum_k A_s[ty + 16 i][k] * B_s[tx + 16 j][k] for thread
// (ty, tx) = (tid / 16, tid % 16): a 32-row x 64-column tile of products,
// each thread owning rows ty, ty + 16 and columns tx + 16 j (j < 4)
__device__ __forceinline__ void product_32x64(float (&acc)[2][4],
                                              const float* A_s,
                                              const float* B_s, int ld,
                                              int D) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a0 = A_s + ty * ld;
  const float* a1 = A_s + (ty + 16) * ld;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = B_s[(tx + 16 * j) * ld + k];
      acc[0][j] = fmaf(x0, y, acc[0][j]);
      acc[1][j] = fmaf(x1, y, acc[1][j]);
    }
  }
}

// acc[i][j] += sum_k A_s[ty + 16 i][k] * B_s[tx + 16 j][k]: a 64-row x
// 32-column tile, each thread owning rows ty + 16 i (i < 4) and columns
// tx, tx + 16
__device__ __forceinline__ void product_64x32(float (&acc)[4][2],
                                              const float* A_s,
                                              const float* B_s, int ld,
                                              int D) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float y0 = B_s[tx * ld + k], y1 = B_s[(tx + 16) * ld + k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = A_s[(ty + 16 * i) * ld + k];
      acc[i][0] = fmaf(x, y0, acc[i][0]);
      acc[i][1] = fmaf(x, y1, acc[i][1]);
    }
  }
}

// G[i][q] += sum_b dz_s[b][4 w + i] * A_s[b][l + 32 q] over the T_BM
// batch rows of a chunk (warp w, lane l): d_table's dz^T @ sr
__device__ __forceinline__ void accumulate_dtable(float (&G)[4][MAX_D / 32],
                                                  const float* dz_s, int ldz,
                                                  const float* A_s, int ld,
                                                  int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = 0; b < T_BM; ++b) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = dz_s[b * ldz + warp * 4 + i];
#pragma unroll
    for (int q = 0; q < MAX_D / 32; ++q) {
      const int d = lane + 32 * q;
      if (d < D) {
        const float x = A_s[b * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) G[i][q] = fmaf(w[i], x, G[i][q]);
      }
    }
  }
}

// acc[i][q] += sum_c dz_s[4 w + i][c] * B_s[c][l + 32 q] over the first
// cols columns of a tile (warp w, lane l): d_sr's dz @ t
__device__ __forceinline__ void accumulate_dsr(float (&acc)[4][MAX_D / 32],
                                               const float* dz_s, int ldz,
                                               const float* B_s, int ld,
                                               int cols, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < cols; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = dz_s[(warp * 4 + i) * ldz + c];
#pragma unroll
    for (int q = 0; q < MAX_D / 32; ++q) {
      const int d = lane + 32 * q;
      if (d < D) {
        const float y = B_s[c * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(w[i], y, acc[i][q]);
      }
    }
  }
}

// rows row0 + 4 w + i (i < 4, below n_rows) of one split's partial d_sr
__device__ __forceinline__ void store_dsr_part(
    const float (&acc)[4][MAX_D / 32], float* part, int row0, int n_rows,
    int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp * 4 + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int q = 0; q < MAX_D / 32; ++q) {
      const int d = lane + 32 * q;
      if (d < D) part[(size_t)r * D + d] = acc[i][q];
    }
  }
}

// d_table rows p0 + 4 w + i (i < 4) of warp w from the register sums G of
// dz^T @ sr (lane l owns features l + 32 q), with the l2norm VJP
// (G - (G . t) t [n > eps]) / max(n, eps) folded in when the table is
// normalised; n_s holds the tile's clamped row norms
template <typename T>
__device__ __forceinline__ void store_dtable(const float (&G)[4][MAX_D / 32],
                                             const float* n_s, const T* tab,
                                             int p0, int P, int D,
                                             int normalize, T* dtab) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = warp * 4 + i, col = p0 + c;
    if (col >= P) continue;  // warp-uniform
    if (normalize) {
      const float n = n_s[c];
      const float live = n > NORM_EPS ? 1.f : 0.f;
      float t[MAX_D / 32];
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_D / 32; ++q) {
        const int d = lane + 32 * q;
        t[q] = d < D ? to_f(tab[(size_t)col * D + d]) / n : 0.f;
        dot += G[i][q] * t[q];
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int q = 0; q < MAX_D / 32; ++q) {
        const int d = lane + 32 * q;
        if (d < D)
          dtab[(size_t)col * D + d] =
              from_f<T>((G[i][q] - dot * t[q] * live) / n);
      }
    } else {
#pragma unroll
      for (int q = 0; q < MAX_D / 32; ++q) {
        const int d = lane + 32 * q;
        if (d < D) dtab[(size_t)col * D + d] = from_f<T>(G[i][q]);
      }
    }
  }
}

// d_sr = the sum of the catalog splits' partial sums, in a fixed order
__global__ void xent_bwd_dsr_reduce(const float* __restrict__ dsr_part,
                                    int n_split, int n,
                                    float* __restrict__ dsr) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) acc += dsr_part[(size_t)sp * n + e];
    dsr[e] = acc;
  }
}

}  // namespace
