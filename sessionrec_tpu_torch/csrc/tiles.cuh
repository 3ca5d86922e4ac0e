// Tile helpers of K2 (xent_bwd.cu), K3 and K4 (xent_multi.cu):
// asynchronous staging of 64-row tiles into shared memory, register-tiled
// float32 products over them, and the kernels they share: the table
// normalised (or its norms taken) once, and the row splits' d_table
// partials reduced in a fixed order.
//
// A staged tile keeps the operand's own type (float32 or bfloat16) and its
// row-major layout, with a row stride of ld = round_up(D, 32) + 4
// elements.  A thread reads four consecutive elements of a row with one
// shared load (16 bytes in float32, 8 in bfloat16) and widens them to
// float32 in registers.  That stride puts the rows that the lanes of one
// load phase read on distinct banks (16 bytes apart modulo 128 in float32,
// 8 or 72 apart in bfloat16), and lets cp.async copy four elements of a
// row straight into place, with no transpose.  The products' unroll depths
// are the fastest of those timed on the H100 (PERF.md).

#pragma once

#include "common.cuh"

namespace {

constexpr int TILE = 64;        // catalog rows, and batch rows, of a tile
constexpr int LDZ = TILE + 4;   // row stride of the float32 dz tile

// row stride, in elements, of a staged [TILE, D] tile
__host__ __device__ __forceinline__ int tile_ld(int D) {
  return (D + 31) / 32 * 32 + 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four consecutive elements, global to shared, asynchronously
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four consecutive shared elements widened to float32
__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(float (&x)[4], const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

// rows [row0, row0 + TILE) of a row-major [n_rows, D] array into dst (row
// stride ld), columns [0, round_up(D, 4)).  With vec (D % 4 == 0 and the
// array aligned to four elements) every four elements of a live row go by
// one cp.async, to be waited for with the group that the caller commits;
// otherwise, and for rows at or past n_rows, by plain loads and stores.
// Rows at or past n_rows and columns at or past D read 0.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int row0, int n_rows, int D,
                                           bool vec) {
  const int q4 = (D + 3) >> 2;  // four-element pieces per row
  for (int e = threadIdx.x; e < TILE * q4; e += NT) {
    const int r = e / q4, k = (e - r * q4) * 4;
    const int gr = row0 + r;
    T* d = dst + r * ld + k;
    if (vec && gr < n_rows) {
      copy4_async(d, src + (size_t)gr * D + k);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        d[v] = (gr < n_rows && k + v < D) ? src[(size_t)gr * D + k + v]
                                          : from_f<T>(0.f);
    }
  }
}

// S[i][j] = sum_k A[ty + 16 i][k] * C[tx + 16 j][k] over k < D4 (D rounded
// up to 4) for thread (ty, tx) = (tid / 16, tid % 16): a 64 x 64 tile of
// logits, 4 x 4 per thread, 8 shared loads per 64 FMAs.  The A loads of a
// phase are one broadcast address, the C loads distinct banks.
template <typename T>
__device__ __forceinline__ void product_logits(float (&S)[4][4], const T* A,
                                               const T* C, int ld, int D4) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* a_p = A + ty * ld;
  const T* c_p = C + tx * ld;
#pragma unroll 4
  for (int k = 0; k < D4; k += 4) {
    float a[4][4], c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(a[i], a_p + 16 * i * ld + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(c[j], c_p + 16 * j * ld + k);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) S[i][j] = fmaf(a[i][v], c[j][v], S[i][j]);
  }
}

// the feature of accumulator column j (< 8) of lane l: d = 4 l + (j % 4)
// + 128 (j / 4), so a lane's four consecutive features are one shared load
// and the lanes of a phase read consecutive bytes
__device__ __forceinline__ int lane_feature(int j) {
  return 4 * (threadIdx.x & 31) + (j & 3) + 128 * (j >> 2);
}

// acc[i][j] += sum_{k < TILE} X[k][8 w + i] * Y[k][lane_feature(j)] for
// warp w: each warp owns 8 output rows, each lane 8 features (the upper
// four only when HI, D > 128), so a step of k is 4 shared loads (the two X
// loads a broadcast) for 64 FMAs.  X is a float32 [TILE][LDZ] tile, Y a
// staged tile.  A lane whose features pass the tile's row reads in-row
// columns instead; the caller stores no feature at or past D.
template <typename T, bool HI>
__device__ __forceinline__ void rank_update(float (&acc)[8][8],
                                            const float* X, const T* Y,
                                            int ld) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float* x_p = X + 8 * w;
  const T* y0_p = Y + min(4 * l, ld - 4);
  const T* y1_p = Y + min(4 * l + 128, ld - 4);
#pragma unroll 8
  for (int k = 0; k < TILE; ++k) {
    float x0[4], x1[4], y0[4], y1[4];
    load4(x0, x_p + k * LDZ);
    load4(x1, x_p + k * LDZ + 4);
    load4(y0, y0_p + k * ld);
    if (HI) load4(y1, y1_p + k * ld);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][v] = fmaf(x0[i], y0[v], acc[i][v]);
        acc[i + 4][v] = fmaf(x1[i], y0[v], acc[i + 4][v]);
        if (HI) {
          acc[i][v + 4] = fmaf(x0[i], y1[v], acc[i][v + 4]);
          acc[i + 4][v + 4] = fmaf(x1[i], y1[v], acc[i + 4][v + 4]);
        }
      }
    }
  }
}

// one row of 8 accumulators per lane (features lane_feature(j)) to a
// float32 row of D, four at a time where D % 4 == 0
__device__ __forceinline__ void store_row8(float* row, const float (&v)[8],
                                           int D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = lane_feature(4 * h);
    if ((D & 3) == 0) {
      if (d < D)
        *reinterpret_cast<float4*>(row + d) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) row[d + q] = v[4 * h + q];
    }
  }
}

// the three 64-row tiles and the dz tile of one block
template <typename T>
size_t bwd_smem(int D) {
  return (size_t)3 * TILE * tile_ld(D) * sizeof(T) +
         (size_t)TILE * LDZ * sizeof(float);
}

// max(||row||, eps) of a row of D elements, on every lane of a warp
template <typename T>
__device__ __forceinline__ float warp_row_norm(const T* src, int D) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float v = to_f(src[k]);
    acc = fmaf(v, v, acc);
  }
  return fmaxf(sqrtf(warp_sum(acc)), NORM_EPS);
}

// t = round_op(row / max(||row||, eps)) and n = max(||row||, eps), one warp
// per table row
template <typename T>
__global__ void __launch_bounds__(NT) xent_bwd_normalize(
    const T* __restrict__ tab, int P, int D, T* __restrict__ that,
    float* __restrict__ nrm) {
  const int row = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= P) return;  // warp-uniform
  const T* src = tab + (size_t)row * D;
  const float n = warp_row_norm(src, D);
  for (int k = lane; k < D; k += 32)
    that[(size_t)row * D + k] = from_f<T>(to_f(src[k]) / n);
  if (lane == 0) nrm[row] = n;
}

// n = max(||row||, eps) alone, one warp per table row
template <typename T>
__global__ void __launch_bounds__(NT) xent_table_norms(
    const T* __restrict__ tab, int P, int D, float* __restrict__ nrm) {
  const int row = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (row >= P) return;  // warp-uniform
  const float n = warp_row_norm(tab + (size_t)row * D, D);
  if ((threadIdx.x & 31) == 0) nrm[row] = n;
}

// d_table row col from its sum g = (dz^T sr)[col] (lane_feature(j) of
// each lane), with the l2norm VJP (G - (G . t) t [n > eps]) / n, t the
// unrounded table row / n, when the table is normalised
template <typename T>
__device__ __forceinline__ void finish_dtable_row(const float (&g)[8],
                                                  int col, const T* tab,
                                                  const float* nrm, int D,
                                                  int normalize, T* dtab) {
  const size_t base = (size_t)col * D;
  if (!normalize) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = lane_feature(j);
      if (d < D) dtab[base + d] = from_f<T>(g[j]);
    }
    return;
  }
  const float n = nrm[col];
  const float live = n > NORM_EPS ? 1.f : 0.f;
  float t[8];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // features at or past D hold whatever the tile's padding held
    const int d = lane_feature(j);
    t[j] = d < D ? to_f(tab[base + d]) / n : 0.f;
    if (d < D) dot = fmaf(g[j], t[j], dot);
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane_feature(j);
    if (d < D) dtab[base + d] = from_f<T>((g[j] - dot * t[j] * live) / n);
  }
}

// d_table from the row splits' partials, summed in split order, one warp
// per catalog row
template <typename T>
__global__ void __launch_bounds__(NT) xent_bwd_dtable_reduce(
    const float* __restrict__ part, int n_split, const T* __restrict__ tab,
    const float* __restrict__ nrm, int P, int D, int normalize,
    T* __restrict__ dtab) {
  const int col = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (col >= P) return;  // warp-uniform
  float gs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane_feature(j);
    float acc = 0.f;
    if (d < D)
      for (int sp = 0; sp < n_split; ++sp)
        acc += part[((size_t)sp * P + col) * D + d];
    gs[j] = acc;
  }
  finish_dtable_row<T>(gs, col, tab, nrm, D, normalize, dtab);
}

}  // namespace
