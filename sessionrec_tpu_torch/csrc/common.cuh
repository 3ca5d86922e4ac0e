// Helpers shared by the catalog-loss kernels (xent.cu, xent_bwd.cu,
// xent_multi.cu): constants, type conversions, K1's shared-memory staging
// and product, and the fixed-order d_sr reduce.  Everything here has
// internal linkage, so each source that includes it gets its own copy.

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
constexpr int MAX_D = 256;          // D <= MAX_D (8 features a lane, tiles.cuh)
constexpr unsigned FULL = 0xffffffffu;

// K1's tiles: 32 rows x 64 catalog columns
constexpr int F_BM = 32;
constexpr int F_BN = 64;

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
