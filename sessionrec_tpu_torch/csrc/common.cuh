// Helpers shared by the catalog-loss kernels (xent.cu, xent_bwd.cu,
// xent_multi.cu): constants, type conversions, a warp sum and the
// fixed-order d_sr reduce; the tiles and the products are tiles.cuh's.
// Everything here has internal linkage, so each source that includes it
// gets its own copy.

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
constexpr int MAX_D = 256;          // one pass up to here (8 features a lane);
                                    // wider rows go by slabs (tiles.cuh)
constexpr unsigned FULL = 0xffffffffu;

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
