// Tile helpers of K1 (xent.cu), K2 (xent_bwd.cu), K3 and K4
// (xent_multi.cu): asynchronous staging of 64-row tiles into shared
// memory, register-tiled float32 products over them, the forward tile loop
// that K1 and K3 share, and the kernels they share: the table normalised
// (or its norms taken) once, the row splits' d_table partials reduced in a
// fixed order, and past 256 features the backward's two products over dz
// and their chunk loop (the slab path, below).
//
// float32 runs on the FMA pipes.  A staged tile keeps its row-major
// layout, with a row stride of ld = round_up(D, 32) + 4 elements.  A
// thread reads four consecutive elements of a row with one 16-byte shared
// load.  That stride puts the rows that the lanes of one load phase read
// on distinct banks (16 bytes apart modulo 128), and lets cp.async copy
// four elements of a row straight into place, with no transpose.  The
// products' unroll depths are the fastest of those timed on the H100
// (PERF.md).
//
// bfloat16 runs on the tensor cores at every width: K1's and K3's forward
// loops and K2's and K4's product kernels multiply with mma.sync m16n8k16
// (bf16 x bf16 products, exact in float32, summed in float32), fed from
// shared memory by ldmatrix, on tiles of their own stride (the
// tensor-core section below), up to MAX_D features in one pass and past
// it through the slab path's k-chunks and feature slabs.

#pragma once

#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive shared elements
__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
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

// acc[i][j] += sum_{k < KN} X[k][8 w + i] * Y[k][lane_feature(j)] for
// warp w: each warp owns 8 output rows, each lane 8 features (the upper
// four only when HI, D > 128), so a step of k is 4 shared loads (the two X
// loads a broadcast) for 64 FMAs.  X is a [KN][ldx] tile (float32, or the
// operand type), Y a staged tile.  A lane whose features pass the tile's
// row reads in-row columns instead; the caller stores no feature at or
// past D.  UNROLL steps of k are unrolled.
template <int KN, bool HI, int UNROLL, typename TX, typename T>
__device__ __forceinline__ void rank_update_rows(float (&acc)[8][8],
                                                 const TX* X, int ldx,
                                                 const T* Y, int ld) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const TX* x_p = X + 8 * w;
  const T* y0_p = Y + min(4 * l, ld - 4);
  const T* y1_p = Y + min(4 * l + 128, ld - 4);
#pragma unroll (UNROLL)
  for (int k = 0; k < KN; ++k) {
    float x0[4], x1[4], y0[4], y1[4];
    load4(x0, x_p + k * ldx);
    load4(x1, x_p + k * ldx + 4);
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

// rank_update_rows over a float32 [TILE][LDZ] dz tile
template <typename T, bool HI>
__device__ __forceinline__ void rank_update(float (&acc)[8][8],
                                            const float* X, const T* Y,
                                            int ld) {
  rank_update_rows<TILE, HI, 8>(acc, X, LDZ, Y, ld);
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

static_assert(NT == 4 * TILE, "row_masks: four threads per tile row");

// mask[i] bit c, for the TILE rows row0 + i: global column gc0 + c (c <
// 64) is one of the row's session items (row r takes iid list r % B).
// Four threads per row (tid = 4 i + part) scan the list and merge by
// shuffles.
__device__ __forceinline__ void row_masks(unsigned long long* mask,
                                          const int* __restrict__ iids,
                                          int row0, int R, int B, int Ns,
                                          int gc0) {
  const int i = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int r = row0 + i;
  unsigned long long m = 0ull;
  if (r < R) {
    const int* ids = iids + (size_t)(r % B) * Ns;
    for (int j = part; j < Ns; j += 4) {
      const unsigned c = (unsigned)(ids[j] - gc0);
      if (c < 64u) m |= 1ull << c;
    }
  }
  m |= __shfl_xor_sync(FULL, m, 1);
  m |= __shfl_xor_sync(FULL, m, 2);
  if (part == 0) mask[i] = m;
}

// (m, s) <- the log-sum-exp merge of (m, s) and (mo, so)
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  const float ms = fmaxf(mn, NEG_INF * 0.5f);
  s = s * expf(m - ms) + so * expf(mo - ms);
  m = mn;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.  A staged bfloat16
// tile has the row stride tc_ld(D) = round_up(D, 16) + 8 elements: rows
// start on 16 bytes, so a row goes by 16-byte cp.async copies and each
// 8 x 8 piece of an ldmatrix is eight 16-byte rows; the stride is an odd
// multiple of 16 bytes modulo 128, so those eight rows fall on eight
// distinct bank groups (conflict-free, also transposed); and features from
// D up to round_up(D, 16) read 0, so a k step of 16 never passes the row.
// Products run mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: both
// operands of the logits are K-contiguous (plain ldmatrix.x4), the
// accumulations' operands are read transposed where they are stored
// N-contiguous (ldmatrix.x4.trans).  A fragment's float32 accumulators:
// lane l holds rows l / 4 and l / 4 + 8 of its 16 x 8 piece, columns
// 2 (l % 4) + {0, 1}.
// ---------------------------------------------------------------------------

// bfloat16 runs on the tensor cores at every width (float32 on the FMA
// pipes)
template <typename T>
constexpr bool tc_type = std::is_same<T, __nv_bfloat16>::value;

// resident blocks per SM that a D <= MAX_D kernel's launch bounds ask for:
// two for the tensor-core kernels, one on the FMA pipes
template <typename T>
constexpr int tile_blocks() {
  return tc_type<T> ? 2 : 1;
}

// features a tensor-core k loop runs over: D rounded up to 16
__host__ __device__ __forceinline__ int tc_kp(int D) {
  return (D + 15) & ~15;
}

// row stride, in elements, of a staged bfloat16 [TILE, D] tensor-core tile
__host__ __device__ __forceinline__ int tc_ld(int D) { return tc_kp(D) + 8; }

constexpr int LDZB = TILE + 8;  // row stride of the bfloat16 dz tile

// whether 16-byte cp.async copies may stage bfloat16 rows of a and b: vec
// (D % 4 == 0, both aligned to four elements), D % 8 == 0 and both aligned
// to 16 bytes
inline int tc_vec(int vec, int D, const void* a, const void* b) {
  return vec && D % 8 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

// eight consecutive bfloat16 elements, global to shared, asynchronously
__device__ __forceinline__ void copy8_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// columns [k0, k0 + w) of rows [row0, row0 + NR) of a row-major bfloat16
// [n_rows, D] array into dst (row stride ld, a tc_ld), as columns [0,
// round_up(w, 16)), eight elements a piece.  With vec (tc_vec, and k0 % 8
// == 0) every piece of a live row within w goes by one 16-byte cp.async,
// to be waited for with the group that the caller commits; otherwise by
// plain loads.  Rows at or past n_rows and columns at or past w read 0.
template <int NR = TILE>
__device__ __forceinline__ void stage_slab_tc(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* __restrict__ src,
    int row0, int n_rows, int D, int k0, int w, bool vec) {
  const int q8 = tc_kp(w) >> 3;  // eight-element pieces per row
  for (int e = threadIdx.x; e < NR * q8; e += NT) {
    const int r = e / q8, k = (e - r * q8) * 8;
    const int gr = row0 + r;
    __nv_bfloat16* d = dst + r * ld + k;
    const __nv_bfloat16* s = src + (size_t)gr * D + k0 + k;
    if (gr >= n_rows || k >= w) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      copy8_async(d, s);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v)
        d[v] = k + v < w ? s[v] : from_f<__nv_bfloat16>(0.f);
    }
  }
}

// rows [row0, row0 + TILE) of a row-major bfloat16 [n_rows, D] array, all
// D columns (stage_slab_tc)
__device__ __forceinline__ void stage_tile_tc(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* __restrict__ src,
    int row0, int n_rows, int D, bool vec) {
  stage_slab_tc(dst, ld, src, row0, n_rows, D, 0, D, vec);
}

// four 8 x 8 pieces of 16-bit elements from shared memory, one a register
// (lane l reads its pieces' rows at p; lanes 8 i .. 8 i + 7 address piece
// i), as they are (ldsm_x4) or transposed (ldsm_x4_t)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for a 16 x 16 bfloat16 A fragment, a 16 x 8 B fragment (b0, b1)
// and a 16 x 8 float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S = A C^T, the 64 x 64 logits tile of staged bfloat16 rows A [TILE][ld]
// and C [TILE][ld] over k < kp (round_up(D, 16)), on the tensor cores.
// The 8 warps split the tile 4 (rows) x 2 (columns): warp w computes rows
// 16 (w >> 1) .. + 16 against columns 32 (w & 1) .. + 32, four n8
// fragments, so lane l holds S[f][e] at row 16 (w >> 1) + l / 4 + 8 (e / 2)
// and column 32 (w & 1) + 8 f + 2 (l % 4) + e % 2.  A k step is one
// ldmatrix.x4 of A, two of C and four mma.
__device__ __forceinline__ void product_logits_tc(float (&S)[4][4],
                                                  const __nv_bfloat16* A,
                                                  const __nv_bfloat16* C,
                                                  int ld, int kp) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int lr = l & 7, l8 = (l >> 3) & 1, l16 = l >> 4;
  // A's pieces: rows +0 / +8 (l8), k +0 / +8 (l16); C's: columns +0 / +8
  // (l16: the n8 fragment), k +0 / +8 (l8)
  const __nv_bfloat16* a_p = A + (16 * (w >> 1) + lr + 8 * l8) * ld + 8 * l16;
  const __nv_bfloat16* c_p = C + (32 * (w & 1) + lr + 8 * l16) * ld + 8 * l8;
#pragma unroll 4
  for (int k = 0; k < kp; k += 16) {
    unsigned a[4], b0[4], b1[4];
    ldsm_x4(a, a_p + k);
    ldsm_x4(b0, c_p + k);            // fragments 0, 1
    ldsm_x4(b1, c_p + 16 * ld + k);  // fragments 2, 3
    mma_bf16(S[0], a, b0[0], b0[1]);
    mma_bf16(S[1], a, b0[2], b0[3]);
    mma_bf16(S[2], a, b1[0], b1[1]);
    mma_bf16(S[3], a, b1[2], b1[3]);
  }
}

// acc[i][2 j + h] += the 64-deep sums of the products X Y for output rows
// 32 (w >> 2) + 16 i .. + 16 and features 16 p + 8 h .. + 8 of feature pair
// p = (w & 3) + 4 j, for the pairs p < np (round_up(D, 16) / 16): the 8
// warps split a 64 x round_up(D, 16) output 2 (rows) x 4 (interleaved
// feature pairs).  XT: the A operand is X^T, X stored [k][row] (d_table's
// dz^T), read by ldmatrix.x4.trans; otherwise X is stored [row][k] (d_sr's
// dz), read by ldmatrix.x4.  Y is stored [k][feature] (a staged tile), read
// by ldmatrix.x4.trans, one feature pair a load.  A k step is 2 + NPW
// loads for 4 NPW mma.
template <int NPW, bool XT>
__device__ __forceinline__ void rank_update_tc(float (&acc)[2][2 * NPW][4],
                                               const __nv_bfloat16* X,
                                               int ldx,
                                               const __nv_bfloat16* Y,
                                               int ldy, int np) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int m0 = 32 * (w >> 2), wn = w & 3;
  const int lr = l & 7, l8 = (l >> 3) & 1, l16 = l >> 4;
  // X's pieces: rows +0 / +8 (l8), k +0 / +8 (l16); Y's: k +0 / +8 (l8),
  // features +0 / +8 (l16: the n8 fragment)
  const __nv_bfloat16* x_p = XT ? X + (lr + 8 * l16) * ldx + m0 + 8 * l8
                                : X + (m0 + lr + 8 * l8) * ldx + 8 * l16;
  const __nv_bfloat16* y_p = Y + (lr + 8 * l8) * ldy + 16 * wn + 8 * l16;
#pragma unroll
  for (int k = 0; k < TILE; k += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (XT)
        ldsm_x4_t(a[i], x_p + k * ldx + 16 * i);
      else
        ldsm_x4(a[i], x_p + 16 * i * ldx + k);
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      if (wn + 4 * j < np) {  // warp-uniform
        unsigned b[4];
        ldsm_x4_t(b, y_p + k * ldy + 64 * j);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
}

// rank_update_tc's accumulators to a float32 [TILE][ldo] tile in shared
// memory (ldo even), features of the pairs p < np
template <int NPW>
__device__ __forceinline__ void store_acc_tc(float* out, int ldo,
                                             const float (&acc)[2][2 * NPW][4],
                                             int np) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int m = 32 * (w >> 2) + (l >> 2), wn = w & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      if (wn + 4 * j >= np) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float(&c)[4] = acc[i][2 * j + h];
        float* o = out + (m + 16 * i) * ldo + 16 * (wn + 4 * j) + 8 * h +
                   2 * (l & 3);
        *reinterpret_cast<float2*>(o) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(o + 8 * ldo) = make_float2(c[2], c[3]);
      }
    }
}

// a row of a float32 tile in shared memory in rank_update's lane layout:
// v[j] = row[lane_feature(j)] for the features below D, else 0
__device__ __forceinline__ void load_row8(float (&v)[8], const float* row,
                                          int D) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane_feature(j);
    v[j] = d < D ? row[d] : 0.f;
  }
}

// shared memory of a forward block: the rows, two catalog tiles and, with
// MEMBERS, the rows' masks (bfloat16 at the tensor cores' stride)
template <typename T, bool MEMBERS>
size_t fwd_smem(int D) {
  const int ld = tc_type<T> ? tc_ld(D) : tile_ld(D);
  return (size_t)3 * TILE * ld * sizeof(T) +
         (MEMBERS ? TILE * sizeof(unsigned long long) : 0);
}

// ---------------------------------------------------------------------------
// The forward tile loop of K1 (MEMBERS = false) and K3 (MEMBERS = true): a
// partial online log-sum-exp over one catalog split.  grid = (row tiles,
// catalog splits) over the R rows of sr, row r taking label r % B (and,
// with MEMBERS, iid list r % B).  A block stages its 64 rows once and
// streams the raw table tiles of its split (double-buffered), scales each
// logit by scale / n[col] in registers when the table is normalised, and
// keeps its own running stats per row.  float32 (fwd_tile_loop_fma):
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of
// each 64 x 64 logits tile, its stats merged over the row's 16 threads by
// shuffles at the end.  bfloat16 (fwd_tile_loop_tc): the tile from
// product_logits_tc, a thread's two rows and eight columns a tile; its
// stats merged over the quad by shuffles, then over the row's two column
// warps through shared memory, at the end.
//   MEMBERS: a row's session columns go to (m_in, s_in), the others to
//     (m_ex, s_ex); part holds [5][n_split][R] floats: m_in, s_in, m_ex,
//     s_ex, zl.  Columns are compared locally with n_valid and the labels.
//   otherwise: every column goes to (m_ex, s_ex), the "in" partition stays
//     empty and compiles away; part holds [3][n_split][R] floats: m, s, zl.
//     Columns are compared globally (col_offset + c, as K1's JAX kernel
//     does), so n_valid and the labels are shifted by col_offset.
// ---------------------------------------------------------------------------
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_tile_loop_fma(
    unsigned char* smem, const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  const int ld = tile_ld(D), D4 = (D + 3) & ~3;
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] table
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(C_s + 2 * TILE * ld);  // [TILE]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int shift = MEMBERS ? 0 : col_offset;
  n_valid -= shift;

  stage_tile(A_s, ld, sr, row0, R, D, vec);
  stage_tile(C_s, ld, tab, t_begin * TILE, P, D, vec);
  cp_async_commit();

  int lbl[4];
  float m_in[4], s_in[4], m_ex[4], s_ex[4], zl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    lbl[i] = r < R ? labels[r % B] - shift : -1;
    m_in[i] = m_ex[i] = NEG_INF;
    s_in[i] = s_ex[i] = zl[i] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    const int p0 = t * TILE;
    if (t + 1 < t_end)
      stage_tile(C_s + (buf ^ 1) * TILE * ld, ld, tab, (t + 1) * TILE, P, D,
                 vec);
    cp_async_commit();
    if constexpr (MEMBERS)
      row_masks(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits(S, A_s, C, ld, D4);
    float n[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx + 16 * j;
      n[j] = normalize && col < P ? nrm[col] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned long long bits = MEMBERS ? mask_s[ty + 16 * i] : 0ull;
      float z[4];
      bool mem[4];
      float t_in = NEG_INF, t_ex = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = p0 + c;
        float v = scale * S[i][j];
        if (normalize) v = v / n[j];
        const bool in_table = col < P;
        if (!in_table || col >= n_valid) v = NEG_INF;
        if (in_table && col == lbl[i]) zl[i] += v;
        mem[j] = MEMBERS && ((bits >> c) & 1ull);
        z[j] = v;
        if (mem[j]) t_in = fmaxf(t_in, v);
        else t_ex = fmaxf(t_ex, v);
      }
      const float mi = fmaxf(m_in[i], t_in), me = fmaxf(m_ex[i], t_ex);
      // guards: exp(NEG_INF - NEG_INF) on a partition still empty
      const float si = fmaxf(mi, NEG_INF * 0.5f);
      const float se = fmaxf(me, NEG_INF * 0.5f);
      float acc_in = s_in[i] * expf(m_in[i] - si);
      float acc_ex = s_ex[i] * expf(m_ex[i] - se);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mem[j]) acc_in += expf(z[j] - si);
        else acc_ex += expf(z[j] - se);
      }
      s_in[i] = acc_in;
      s_ex[i] = acc_ex;
      m_in[i] = mi;
      m_ex[i] = me;
    }
    __syncthreads();  // C and the masks are consumed
  }

  // merge the 16 per-thread partials of each row (lanes of one half-warp)
  const size_t plane = (size_t)gridDim.y * R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      float mio = 0.f, sio = 0.f;
      if constexpr (MEMBERS) {
        mio = __shfl_xor_sync(FULL, m_in[i], off);
        sio = __shfl_xor_sync(FULL, s_in[i], off);
      }
      const float meo = __shfl_xor_sync(FULL, m_ex[i], off);
      const float seo = __shfl_xor_sync(FULL, s_ex[i], off);
      zl[i] += __shfl_xor_sync(FULL, zl[i], off);
      if constexpr (MEMBERS) lse_merge(m_in[i], s_in[i], mio, sio);
      lse_merge(m_ex[i], s_ex[i], meo, seo);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      const size_t o = (size_t)blockIdx.y * R + r;
      if constexpr (MEMBERS) {
        part[o] = m_in[i];
        part[plane + o] = s_in[i];
        part[2 * plane + o] = m_ex[i];
        part[3 * plane + o] = s_ex[i];
        part[4 * plane + o] = zl[i];
      } else {
        part[o] = m_ex[i];
        part[plane + o] = s_ex[i];
        part[2 * plane + o] = zl[i];
      }
    }
  }
}

// The running stats of a thread's two rows in the tensor cores' fragment
// layout (K1's and K3's bfloat16 loops, fwd_tile_loop_tc and
// fwd_slab_loop_tc): lane l of warp w owns rows rb = 16 (w >> 1) + l / 4
// and rb + 8 of each tile and its columns cb + 8 f + {0, 1} (f < 4), cb =
// 32 (w & 1) + 2 (l % 4); the row's other columns lie with the quad's
// three other lanes and with warp w ^ 1.
struct TcRows {
  int lbl[2];
  float m_in[2], s_in[2], m_ex[2], s_ex[2], zl[2];
};

__device__ __forceinline__ int tc_row_base() {
  return 16 * (threadIdx.x >> 6) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int tc_col_base() {
  return 32 * ((threadIdx.x >> 5) & 1) + 2 * (threadIdx.x & 3);
}

// empty stats, and the labels (shifted by shift) of the rows below R
__device__ __forceinline__ void tc_rows_init(TcRows& st,
                                             const int* __restrict__ labels,
                                             int row0, int R, int B,
                                             int shift) {
  const int rb = tc_row_base();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rb + 8 * h;
    st.lbl[h] = r < R ? labels[r % B] - shift : -1;
    st.m_in[h] = st.m_ex[h] = NEG_INF;
    st.s_in[h] = st.s_ex[h] = st.zl[h] = 0.f;
  }
}

// the online log-sum-exp of one 64 x 64 logits tile S (product_logits_tc's
// layout) of catalog columns [p0, p0 + TILE) into st: each logit scaled
// (and divided by its column's norm when normalize), columns past P or at
// or past n_valid masked, with MEMBERS a row's session columns (mask_s)
// to the "in" partition
template <bool MEMBERS>
__device__ __forceinline__ void tc_tile_lse(
    TcRows& st, const float (&S)[4][4], const unsigned long long* mask_s,
    const float* __restrict__ nrm, int p0, int P, int n_valid, float scale,
    int normalize) {
  const int rb = tc_row_base(), cb = tc_col_base();
  float n[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int col = p0 + cb + 8 * (q >> 1) + (q & 1);
    n[q] = normalize && col < P ? nrm[col] : 1.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned long long bits = MEMBERS ? mask_s[rb + 8 * h] : 0ull;
    float z[8];
    bool mem[8];
    float t_in = NEG_INF, t_ex = NEG_INF;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = cb + 8 * (q >> 1) + (q & 1);
      const int col = p0 + c;
      float v = scale * S[q >> 1][2 * h + (q & 1)];
      if (normalize) v = v / n[q];
      const bool in_table = col < P;
      if (!in_table || col >= n_valid) v = NEG_INF;
      if (in_table && col == st.lbl[h]) st.zl[h] += v;
      mem[q] = MEMBERS && ((bits >> c) & 1ull);
      z[q] = v;
      if (mem[q]) t_in = fmaxf(t_in, v);
      else t_ex = fmaxf(t_ex, v);
    }
    const float mi = fmaxf(st.m_in[h], t_in), me = fmaxf(st.m_ex[h], t_ex);
    // guards: exp(NEG_INF - NEG_INF) on a partition still empty
    const float si = fmaxf(mi, NEG_INF * 0.5f);
    const float se = fmaxf(me, NEG_INF * 0.5f);
    float acc_in = st.s_in[h] * expf(st.m_in[h] - si);
    float acc_ex = st.s_ex[h] * expf(st.m_ex[h] - se);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (mem[q]) acc_in += expf(z[q] - si);
      else acc_ex += expf(z[q] - se);
    }
    st.s_in[h] = acc_in;
    st.s_ex[h] = acc_ex;
    st.m_in[h] = mi;
    st.m_ex[h] = me;
  }
}

// merge each row's stats over its quad (shuffles), then warp w ^ 1's into
// warp w's (w even) through shared memory at smem (which the caller has
// drained and every thread is done reading), and write the split's partial
// (fwd_tile_loop's part layout)
template <bool MEMBERS>
__device__ __forceinline__ void tc_rows_merge(TcRows& st, unsigned char* smem,
                                              int row0, int R,
                                              float* __restrict__ part) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rb = tc_row_base();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      float mio = 0.f, sio = 0.f;
      if constexpr (MEMBERS) {
        mio = __shfl_xor_sync(FULL, st.m_in[h], off);
        sio = __shfl_xor_sync(FULL, st.s_in[h], off);
      }
      const float meo = __shfl_xor_sync(FULL, st.m_ex[h], off);
      const float seo = __shfl_xor_sync(FULL, st.s_ex[h], off);
      st.zl[h] += __shfl_xor_sync(FULL, st.zl[h], off);
      if constexpr (MEMBERS) lse_merge(st.m_in[h], st.s_in[h], mio, sio);
      lse_merge(st.m_ex[h], st.s_ex[h], meo, seo);
    }
  }
  float* red = reinterpret_cast<float*>(smem);  // [5][TILE]
  const bool quad_head = (l & 3) == 0;
  if ((w & 1) && quad_head) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rb + 8 * h;
      red[i] = st.m_in[h];
      red[TILE + i] = st.s_in[h];
      red[2 * TILE + i] = st.m_ex[h];
      red[3 * TILE + i] = st.s_ex[h];
      red[4 * TILE + i] = st.zl[h];
    }
  }
  __syncthreads();
  if ((w & 1) || !quad_head) return;
  const size_t plane = (size_t)gridDim.y * R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = rb + 8 * h, r = row0 + i;
    if constexpr (MEMBERS)
      lse_merge(st.m_in[h], st.s_in[h], red[i], red[TILE + i]);
    lse_merge(st.m_ex[h], st.s_ex[h], red[2 * TILE + i], red[3 * TILE + i]);
    st.zl[h] += red[4 * TILE + i];
    if (r < R) {
      const size_t o = (size_t)blockIdx.y * R + r;
      if constexpr (MEMBERS) {
        part[o] = st.m_in[h];
        part[plane + o] = st.s_in[h];
        part[2 * plane + o] = st.m_ex[h];
        part[3 * plane + o] = st.s_ex[h];
        part[4 * plane + o] = st.zl[h];
      } else {
        part[o] = st.m_ex[h];
        part[plane + o] = st.s_ex[h];
        part[2 * plane + o] = st.zl[h];
      }
    }
  }
}

// fwd_tile_loop in bfloat16: the same partials, the logits on the tensor
// cores (product_logits_tc), the stats in the fragment layout (TcRows)
template <bool MEMBERS>
__device__ __forceinline__ void fwd_tile_loop_tc(
    unsigned char* smem, const __nv_bfloat16* __restrict__ sr,
    const __nv_bfloat16* __restrict__ tab, const float* __restrict__ nrm,
    const int* __restrict__ labels, const int* __restrict__ iids, int R,
    int B, int P, int D, int Ns, int n_valid, int col_offset, float scale,
    int normalize, int vec, int tiles_per_split, float* __restrict__ part) {
  typedef __nv_bfloat16 T;
  const int ld = tc_ld(D), kp = tc_kp(D);
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] table
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(C_s + 2 * TILE * ld);  // [TILE]
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int shift = MEMBERS ? 0 : col_offset;
  n_valid -= shift;

  stage_tile_tc(A_s, ld, sr, row0, R, D, vec);
  stage_tile_tc(C_s, ld, tab, t_begin * TILE, P, D, vec);
  cp_async_commit();

  TcRows st;
  tc_rows_init(st, labels, row0, R, B, shift);

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    const int p0 = t * TILE;
    if (t + 1 < t_end)
      stage_tile_tc(C_s + (buf ^ 1) * TILE * ld, ld, tab, (t + 1) * TILE, P,
                    D, vec);
    cp_async_commit();
    if constexpr (MEMBERS)
      row_masks(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits_tc(S, A_s, C, ld, kp);
    tc_tile_lse<MEMBERS>(st, S, mask_s, nrm, p0, P, n_valid, scale,
                         normalize);
    __syncthreads();  // C and the masks are consumed
  }

  cp_async_wait<0>();
  tc_rows_merge<MEMBERS>(st, smem, row0, R, part);
}

// K1's and K3's forward tile loop: bfloat16 on the tensor cores, float32
// on the FMA pipes
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_tile_loop(
    unsigned char* smem, const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  if constexpr (tc_type<T>)
    fwd_tile_loop_tc<MEMBERS>(smem, sr, tab, nrm, labels, iids, R, B, P, D,
                              Ns, n_valid, col_offset, scale, normalize, vec,
                              tiles_per_split, part);
  else
    fwd_tile_loop_fma<T, MEMBERS>(smem, sr, tab, nrm, labels, iids, R, B, P,
                                  D, Ns, n_valid, col_offset, scale,
                                  normalize, vec, tiles_per_split, part);
}

// the three 64-row tiles and the dz tile of one block
template <typename T>
size_t bwd_smem(int D) {
  return (size_t)3 * TILE * tile_ld(D) * sizeof(T) +
         (size_t)TILE * LDZ * sizeof(float);
}

// K2's on the tensor cores: three bfloat16 tiles at their stride and the
// bfloat16 dz tile (which, with the tiles, later holds the float32
// [TILE][tc_kp(D) + 8] output tile)
inline size_t bwd_tc_smem(int D) {
  return (size_t)(3 * TILE * tc_ld(D) + TILE * LDZB) * sizeof(__nv_bfloat16);
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

// ---------------------------------------------------------------------------
// The slab path, for D > MAX_D.  The backward's products cut a row of D
// features into slab_count(D) slabs of slab_width<T>(D) features (the last
// one narrower, none wider than MAX_D), so that a thread's accumulators
// (8 x 8 on the FMA pipes, a warp's 32 rows x four feature pairs on the
// tensor cores) cover one slab of an output row at any width; the logits
// go over all D features in k-chunks of KC.  float32 runs every product on
// the FMA pipes, bfloat16 on the tensor cores (mma.sync m16n8k16 from
// ldmatrix, float32 sums): a bfloat16 k-chunk is staged at the stride
// LDKB = KC + 8 (tc_ld), a slab at tc_ld of its width.
//
// K1's and K3's forward (fwd_slab_loop) walks its catalog split's (catalog
// tile, k-chunk of KC features) pairs as one stream through a ring of
// fwd_stages<T>() shared-memory stages: each chunk of the rows and of the
// tile is issued by cp.async fwd_stages - 1 chunks ahead of its product,
// also across catalog tiles, so a tile's epilogue (the online log-sum-exp)
// runs while the next tile's first chunks land.  The ring (104 KB of
// three stages in float32, 72 KB of four in bfloat16) leaves room for two
// resident blocks an SM.
//
// K2's and K4's backward computes dz once, then runs three products (a
// block per output slab that recomputed the full-width logits would run
// 2 (slabs + 1) products of 2 R P D operations where the bound counts 3).
// For each catalog chunk of at most the wrapper's scratch
// cap (ops/xent.py:DZ_SCRATCH_BYTES), slab_bwd_chunks launches
//   * the loss's dz kernel (xent_bwd_dz_slab, xent_multi_bwd_dz_slab): one
//     block per (64-row tile, 64-row catalog tile) computes the logits once
//     over all D features (dz_logits, dz_logits_tc: k-chunks of KC
//     features, two cp.async stages) and writes dz, rounded to the operand
//     type as the JAX kernel feeds its matrix unit, to a [rows, chunk]
//     scratch in that type: exact, and half the bytes in bfloat16 (whose
//     dz tile goes through shared memory to 16-byte stores);
//   * xent_slab_dtable (xent_slab_dtable_tc in bfloat16): dz^T sr, output
//     tiles of 64 catalog rows x one slab, the R rows reduced in stages of
//     KR rows (TILE on the tensor cores), split over the grid's z axis so
//     that the blocks fill the card; float32 partials [split][P][D];
//   * xent_slab_dsr (xent_slab_dsr_tc): dz t, output tiles of 64 rows x one
//     slab, the chunk's catalog reduced in stages of KR (TILE), split over
//     z; one float32 partial per split and chunk, summed in chunk and
//     split order by xent_bwd_dsr_reduce.
// Then the loss's finish kernel sums d_table's partials in split order and
// applies the l2norm VJP, whose dot product spans every slab
// (slab_dtable_finish).  Work: 3 * 2 R P D operations, as the bound counts; dz
// adds 3 R P operand-type elements to the bytes moved (written once, read by
// each product): about 8% of the bound at the north star.  Each product streams
// both of its operands through two cp.async stages (the next stage lands while
// the current one is used) and sizes its shared memory (93 KB in float32, 84
// KB in bfloat16 at slabs of 256) for two resident blocks per SM.  No
// atomics: the same inputs give the same bits.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int slab_count(int D) {
  return (D + MAX_D - 1) / MAX_D;
}

// features of every slab but the last: ceil(D / slabs) rounded up to 4 in
// float32, so each slab starts four-element aligned (16 bytes), and to 16
// in bfloat16, so each slab starts on a tensor-core k step and 16 bytes
// (its ldmatrix rows and cp.async copies stay aligned).  Past MAX_D no
// slab is wider than MAX_D, and none is empty (slab_bwd_chunks checks).
template <typename T>
__host__ __device__ __forceinline__ int slab_width(int D) {
  const int n = slab_count(D), a = tc_type<T> ? 16 : 4;
  return ((D + n - 1) / n + a - 1) & ~(a - 1);
}

// columns [k0, k0 + w) of rows [row0, row0 + NR) of a row-major
// [n_rows, D] array into dst (row stride ld), as columns [0, round_up(w,
// 4)); rows at or past n_rows and columns at or past w read 0.  With vec
// (D % 4 == 0 and the array aligned to four elements, so k0 + k is too)
// every four elements of a live row go by one cp.async, to be waited for
// with the group that the caller commits.
template <int NR = TILE, typename T>
__device__ __forceinline__ void stage_slab(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int row0, int n_rows, int D,
                                           int k0, int w, bool vec) {
  const int q4 = (w + 3) >> 2;
  for (int e = threadIdx.x; e < NR * q4; e += NT) {
    const int r = e / q4, k = (e - r * q4) * 4;
    const int gr = row0 + r;
    T* d = dst + r * ld + k;
    if (vec && gr < n_rows) {
      copy4_async(d, src + (size_t)gr * D + k0 + k);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        d[v] = (gr < n_rows && k + v < w) ? src[(size_t)gr * D + k0 + k + v]
                                          : from_f<T>(0.f);
    }
  }
}

// the slab of rank_update's accumulators of one row (features
// lane_feature(j) of a slab w wide) to row, which points at the slab's first
// feature in a float32 row of D; four at a time where D % 4 == 0 (then w and
// every slab's start are multiples of four as well)
__device__ __forceinline__ void store_slab8(float* row, const float (&v)[8],
                                            int w, int D) {
  if ((D & 3) == 0) {
    store_row8(row, v, w);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane_feature(j);
    if (d < w) row[d] = v[j];
  }
}

constexpr int KC = 64;              // features of a k-chunk
constexpr int LDK = KC + 4;         // row stride of a staged k-chunk
constexpr int CHUNK = 2 * TILE * LDK;  // elements of a chunk stage
static_assert(LDK == (KC + 31) / 32 * 32 + 4, "LDK: tile_ld(KC)");

// k-chunk kc (features [kc KC, kc KC + KC) of D) of rows [a0, a0 + TILE) of
// a [a_rows, D] into dst's first [TILE][LDK] and of rows [c0, c0 + TILE) of
// c [c_rows, D] into the second, by cp.async where vec (stage_slab)
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* __restrict__ a,
                                            int a0, int a_rows,
                                            const T* __restrict__ c, int c0,
                                            int c_rows, int D, int kc,
                                            bool vec) {
  const int k0 = kc * KC, w = min(KC, D - k0);
  stage_slab(dst, LDK, a, a0, a_rows, D, k0, w, vec);
  stage_slab(dst + TILE * LDK, LDK, c, c0, c_rows, D, k0, w, vec);
}

// product_logits over the staged k-chunk kc of D at stage A
template <typename T>
__device__ __forceinline__ void chunk_logits(float (&S)[4][4], const T* A,
                                             int D, int kc) {
  product_logits(S, A, A + TILE * LDK, LDK, (min(KC, D - kc * KC) + 3) & ~3);
}

// a bfloat16 k-chunk stage on the tensor cores: the two [TILE][LDKB] tiles
constexpr int LDKB = KC + 8;              // tc_ld(KC)
constexpr int CHUNK_TC = 2 * TILE * LDKB;  // elements of a chunk stage
static_assert(LDKB == (KC + 15) / 16 * 16 + 8, "LDKB: tc_ld(KC)");

// stage_chunk in bfloat16 for the tensor cores: the k-chunk at the stride
// LDKB, its features past D (in the last chunk, up to round_up(w, 16))
// read as 0, by 16-byte cp.async where vec (tc_vec; stage_slab_tc)
__device__ __forceinline__ void stage_chunk_tc(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ a, int a0,
    int a_rows, const __nv_bfloat16* __restrict__ c, int c0, int c_rows,
    int D, int kc, bool vec) {
  const int k0 = kc * KC, w = min(KC, D - k0);
  stage_slab_tc(dst, LDKB, a, a0, a_rows, D, k0, w, vec);
  stage_slab_tc(dst + TILE * LDKB, LDKB, c, c0, c_rows, D, k0, w, vec);
}

// product_logits_tc over the staged bfloat16 k-chunk kc of D at stage A:
// round_up(w, 16) features of a chunk w wide (the last chunk of D 1,000
// is 40 wide and runs 48)
__device__ __forceinline__ void chunk_logits_tc(float (&S)[4][4],
                                                const __nv_bfloat16* A, int D,
                                                int kc) {
  product_logits_tc(S, A, A + TILE * LDKB, LDKB, tc_kp(min(KC, D - kc * KC)));
}

// ring stages of the slab forward's chunk stream.  float32: three keep two
// chunks in flight behind the one in use, and 3 x 34,816 bytes let two
// blocks share an SM's 228 KB.  bfloat16: a chunk's product is a quarter
// of float32's time on the tensor cores, so four keep three in flight, 4 x
// 18,432 bytes, still two blocks an SM.
constexpr int FWD_STAGES = 3;
constexpr int FWD_STAGES_TC = 4;

template <typename T>
constexpr int fwd_stages() {
  return tc_type<T> ? FWD_STAGES_TC : FWD_STAGES;
}

// shared memory of a slab-path forward block: the chunk ring and, with
// MEMBERS, the rows' masks
template <typename T, bool MEMBERS>
constexpr size_t fwd_slab_smem() {
  return (tc_type<T> ? (size_t)FWD_STAGES_TC * CHUNK_TC * sizeof(T)
                     : (size_t)FWD_STAGES * CHUNK * sizeof(T)) +
         (MEMBERS ? TILE * sizeof(unsigned long long) : 0);
}

// ---------------------------------------------------------------------------
// fwd_tile_loop for D > MAX_D: the same partial online log-sum-exp over one
// catalog split and the same outputs.  The split's (catalog tile, k-chunk)
// pairs, chunk q = (tile t_begin + q / n_k, k-chunk q % n_k), form one
// stream through the ring: chunk q + stages - 1 is issued as soon as
// chunk q has landed and the stage it overwrites is consumed (one
// __syncthreads a chunk), before chunk q's product; each 64 x 64 logits
// tile sums its chunks in ascending k (product_logits, the same fmaf chain
// per logit as one pass over D), then its epilogue runs while the next
// tile's chunks land.  With MEMBERS the tile's masks are built during its
// first chunk and read after its last (n_k >= 2 past MAX_D, so a barrier
// lies between).  float32 (fwd_slab_loop_fma) holds fwd_tile_loop_fma's
// thread layout; bfloat16 (fwd_slab_loop_tc) fwd_tile_loop_tc's, in a ring
// of FWD_STAGES_TC stages at the tensor cores' stride.
// ---------------------------------------------------------------------------
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_slab_loop_fma(
    unsigned char* smem, const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  T* ring = reinterpret_cast<T*>(smem);            // [FWD_STAGES][CHUNK]
  unsigned long long* mask_s = reinterpret_cast<unsigned long long*>(
      ring + FWD_STAGES * CHUNK);                  // [TILE]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_k = (D + KC - 1) / KC;
  const int n_chunks = (t_end - t_begin) * n_k;
  const int shift = MEMBERS ? 0 : col_offset;
  n_valid -= shift;

  // chunk q into its stage, one commit group a chunk (empty past the end)
  auto issue = [&](int q) {
    if (q < n_chunks) {
      const int t = q / n_k;
      stage_chunk(ring + (q % FWD_STAGES) * CHUNK, sr, row0, R, tab,
                  (t_begin + t) * TILE, P, D, q - t * n_k, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < FWD_STAGES - 1; ++q) issue(q);

  int lbl[4];
  float m_in[4], s_in[4], m_ex[4], s_ex[4], zl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    lbl[i] = r < R ? labels[r % B] - shift : -1;
    m_in[i] = m_ex[i] = NEG_INF;
    s_in[i] = s_ex[i] = zl[i] = 0.f;
  }

  float S[4][4] = {};
  int kc = 0, p0 = t_begin * TILE;  // chunk q's k-chunk and catalog tile
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<FWD_STAGES - 2>();  // this thread's copies of chunk q
    __syncthreads();  // everyone's; and chunk q - 1's stage is consumed
    issue(q + FWD_STAGES - 1);
    if constexpr (MEMBERS) {
      if (kc == 0) row_masks(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    }
    chunk_logits(S, ring + (q % FWD_STAGES) * CHUNK, D, kc);
    if (++kc < n_k) continue;

    float n[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx + 16 * j;
      n[j] = normalize && col < P ? nrm[col] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned long long bits = MEMBERS ? mask_s[ty + 16 * i] : 0ull;
      float z[4];
      bool mem[4];
      float t_in = NEG_INF, t_ex = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = p0 + c;
        float v = scale * S[i][j];
        S[i][j] = 0.f;
        if (normalize) v = v / n[j];
        const bool in_table = col < P;
        if (!in_table || col >= n_valid) v = NEG_INF;
        if (in_table && col == lbl[i]) zl[i] += v;
        mem[j] = MEMBERS && ((bits >> c) & 1ull);
        z[j] = v;
        if (mem[j]) t_in = fmaxf(t_in, v);
        else t_ex = fmaxf(t_ex, v);
      }
      const float mi = fmaxf(m_in[i], t_in), me = fmaxf(m_ex[i], t_ex);
      const float si = fmaxf(mi, NEG_INF * 0.5f);
      const float se = fmaxf(me, NEG_INF * 0.5f);
      float acc_in = s_in[i] * expf(m_in[i] - si);
      float acc_ex = s_ex[i] * expf(m_ex[i] - se);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mem[j]) acc_in += expf(z[j] - si);
        else acc_ex += expf(z[j] - se);
      }
      s_in[i] = acc_in;
      s_ex[i] = acc_ex;
      m_in[i] = mi;
      m_ex[i] = me;
    }
    kc = 0;
    p0 += TILE;
  }

  const size_t plane = (size_t)gridDim.y * R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      float mio = 0.f, sio = 0.f;
      if constexpr (MEMBERS) {
        mio = __shfl_xor_sync(FULL, m_in[i], off);
        sio = __shfl_xor_sync(FULL, s_in[i], off);
      }
      const float meo = __shfl_xor_sync(FULL, m_ex[i], off);
      const float seo = __shfl_xor_sync(FULL, s_ex[i], off);
      zl[i] += __shfl_xor_sync(FULL, zl[i], off);
      if constexpr (MEMBERS) lse_merge(m_in[i], s_in[i], mio, sio);
      lse_merge(m_ex[i], s_ex[i], meo, seo);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      const size_t o = (size_t)blockIdx.y * R + r;
      if constexpr (MEMBERS) {
        part[o] = m_in[i];
        part[plane + o] = s_in[i];
        part[2 * plane + o] = m_ex[i];
        part[3 * plane + o] = s_ex[i];
        part[4 * plane + o] = zl[i];
      } else {
        part[o] = m_ex[i];
        part[plane + o] = s_ex[i];
        part[2 * plane + o] = zl[i];
      }
    }
  }
}

template <bool MEMBERS>
__device__ __forceinline__ void fwd_slab_loop_tc(
    unsigned char* smem, const __nv_bfloat16* __restrict__ sr,
    const __nv_bfloat16* __restrict__ tab, const float* __restrict__ nrm,
    const int* __restrict__ labels, const int* __restrict__ iids, int R,
    int B, int P, int D, int Ns, int n_valid, int col_offset, float scale,
    int normalize, int vec, int tiles_per_split, float* __restrict__ part) {
  typedef __nv_bfloat16 T;
  constexpr int STAGES = FWD_STAGES_TC;
  T* ring = reinterpret_cast<T*>(smem);            // [STAGES][CHUNK_TC]
  unsigned long long* mask_s = reinterpret_cast<unsigned long long*>(
      ring + STAGES * CHUNK_TC);                   // [TILE]
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_k = (D + KC - 1) / KC;
  const int n_chunks = (t_end - t_begin) * n_k;
  const int shift = MEMBERS ? 0 : col_offset;
  n_valid -= shift;

  // chunk q into its stage, one commit group a chunk (empty past the end)
  auto issue = [&](int q) {
    if (q < n_chunks) {
      const int t = q / n_k;
      stage_chunk_tc(ring + (q % STAGES) * CHUNK_TC, sr, row0, R, tab,
                     (t_begin + t) * TILE, P, D, q - t * n_k, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) issue(q);

  TcRows st;
  tc_rows_init(st, labels, row0, R, B, shift);

  float S[4][4] = {};
  int kc = 0, p0 = t_begin * TILE;  // chunk q's k-chunk and catalog tile
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk q
    __syncthreads();  // everyone's; and chunk q - 1's stage is consumed
    issue(q + STAGES - 1);
    if constexpr (MEMBERS) {
      if (kc == 0) row_masks(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    }
    chunk_logits_tc(S, ring + (q % STAGES) * CHUNK_TC, D, kc);
    if (++kc < n_k) continue;
    tc_tile_lse<MEMBERS>(st, S, mask_s, nrm, p0, P, n_valid, scale,
                         normalize);
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[f][e] = 0.f;
    kc = 0;
    p0 += TILE;
  }

  // the merge reuses the ring: drain it, and wait for the last product
  cp_async_wait<0>();
  __syncthreads();
  tc_rows_merge<MEMBERS>(st, smem, row0, R, part);
}

// K1's and K3's forward past MAX_D: bfloat16 on the tensor cores, float32
// on the FMA pipes
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_slab_loop(
    unsigned char* smem, const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  if constexpr (tc_type<T>)
    fwd_slab_loop_tc<MEMBERS>(smem, sr, tab, nrm, labels, iids, R, B, P, D,
                              Ns, n_valid, col_offset, scale, normalize, vec,
                              tiles_per_split, part);
  else
    fwd_slab_loop_fma<T, MEMBERS>(smem, sr, tab, nrm, labels, iids, R, B, P,
                                  D, Ns, n_valid, col_offset, scale,
                                  normalize, vec, tiles_per_split, part);
}

// ---------------------------------------------------------------------------
// The slab backward (see the slab path's note above).
// ---------------------------------------------------------------------------

constexpr int KR = 32;        // reduction rows of a product stage
constexpr int LDX = KR + 4;   // row stride of xent_slab_dsr's [TILE][KR] dz
// elements of a product stage's dz tile: [KR][LDZ] (d_table) or [TILE][LDX]
// (d_sr)
constexpr int STAGE_X = KR * LDZ > TILE * LDX ? KR * LDZ : TILE * LDX;

// shared memory of a dz block: two chunk stages (at the tensor cores'
// stride in bfloat16, where they later hold the [TILE][LDZB] dz tile)
template <typename T>
__host__ __device__ constexpr size_t dz_smem() {
  return (size_t)2 * (tc_type<T> ? CHUNK_TC : CHUNK) * sizeof(T);
}

// elements of a tensor-core product stage: the [TILE][LDZB] dz tile and
// TILE rows of a slab sw wide at tc_ld(sw)
__host__ __device__ __forceinline__ int stage_tc_elems(int sw) {
  return TILE * LDZB + TILE * tc_ld(sw);
}

// shared memory of a product block: two stages of its dz tile and of KR
// (bfloat16: TILE) rows of its slab; in bfloat16 they later hold the
// float32 [TILE][round_up(sw, 16) + 8] output tile, which is smaller
template <typename T>
size_t slab_product_smem(int D) {
  const int sw = slab_width<T>(D);
  if constexpr (tc_type<T>)
    return std::max((size_t)2 * stage_tc_elems(sw) * sizeof(T),
                    (size_t)TILE * (tc_kp(sw) + 8) * sizeof(float));
  return (size_t)2 * (STAGE_X + KR * tile_ld(sw)) * sizeof(T);
}

// S = the 64 x 64 logits tile of rows [a0, a0 + TILE) of a [a_rows, D]
// against rows [c0, c0 + TILE) of c [c_rows, D] over all D features, in
// k-chunks through two stages of smem (dz_smem), the next chunk arriving
// by cp.async while the current one is used (product_logits's thread
// layout).  On return every thread is done reading smem.
template <typename T>
__device__ __forceinline__ void dz_logits(float (&S)[4][4], T* smem,
                                          const T* __restrict__ a, int a0,
                                          int a_rows, const T* __restrict__ c,
                                          int c0, int c_rows, int D,
                                          bool vec) {
  const int n_k = (D + KC - 1) / KC;
  stage_chunk(smem, a, a0, a_rows, c, c0, c_rows, D, 0, vec);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    if (kc + 1 < n_k)
      stage_chunk(smem + ((kc + 1) & 1) * CHUNK, a, a0, a_rows, c, c0,
                  c_rows, D, kc + 1, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk has landed
    __syncthreads();
    chunk_logits(S, smem + (kc & 1) * CHUNK, D, kc);
    __syncthreads();  // the chunk is consumed
  }
}

// dz_logits in bfloat16 on the tensor cores: the same logits tile over all
// D features in k-chunks at the stride LDKB through two stages of smem
// (dz_smem), in product_logits_tc's layout.  On return every thread is
// done reading smem.
__device__ __forceinline__ void dz_logits_tc(
    float (&S)[4][4], __nv_bfloat16* smem,
    const __nv_bfloat16* __restrict__ a, int a0, int a_rows,
    const __nv_bfloat16* __restrict__ c, int c0, int c_rows, int D,
    bool vec) {
  const int n_k = (D + KC - 1) / KC;
  stage_chunk_tc(smem, a, a0, a_rows, c, c0, c_rows, D, 0, vec);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    if (kc + 1 < n_k)
      stage_chunk_tc(smem + ((kc + 1) & 1) * CHUNK_TC, a, a0, a_rows, c, c0,
                     c_rows, D, kc + 1, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk has landed
    __syncthreads();
    chunk_logits_tc(S, smem + (kc & 1) * CHUNK_TC, D, kc);
    __syncthreads();  // the chunk is consumed
  }
}

// a block's bfloat16 dz tile, dz_s [TILE][LDZB] in shared memory, to rows
// [r0, r0 + TILE) x columns [q0, q0 + TILE) of the dz scratch (row stride
// ldz, a multiple of TILE; q0 too), eight elements a 16-byte store
__device__ __forceinline__ void store_dz_tc(__nv_bfloat16* __restrict__ dz,
                                            int ldz, int r0, int q0,
                                            const __nv_bfloat16* dz_s) {
  for (int e = threadIdx.x; e < TILE * (TILE / 8); e += NT) {
    const int r = e / (TILE / 8), k = (e % (TILE / 8)) * 8;
    *reinterpret_cast<uint4*>(dz + (size_t)(r0 + r) * ldz + q0 + k) =
        *reinterpret_cast<const uint4*>(dz_s + r * LDZB + k);
  }
}

// rows [r0, r0 + TILE) x columns [q0, q0 + TILE) of the bfloat16 dz
// scratch into dst [TILE][LDZB], by 16-byte cp.async
__device__ __forceinline__ void stage_dz_tc(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ dz,
                                            int ldz, int r0, int q0) {
  for (int e = threadIdx.x; e < TILE * (TILE / 8); e += NT) {
    const int r = e / (TILE / 8), k = (e % (TILE / 8)) * 8;
    copy8_async(dst + r * LDZB + k, dz + (size_t)(r0 + r) * ldz + q0 + k);
  }
}

// rows [r0, r0 + NR) x columns [q0, q0 + NC) of the dz scratch (row stride
// ldz; every element written, every four aligned) into dst (row stride
// lds), by cp.async
template <int NR, int NC, typename T>
__device__ __forceinline__ void stage_dz(T* dst, int lds,
                                         const T* __restrict__ dz, int ldz,
                                         int r0, int q0) {
  constexpr int Q = NC / 4;
  for (int e = threadIdx.x; e < NR * Q; e += NT) {
    const int r = e / Q, k = (e - r * Q) * 4;
    copy4_async(dst + r * lds + k, dz + (size_t)(r0 + r) * ldz + q0 + k);
  }
}

// two consecutive shared elements
__device__ __forceinline__ void load2(float (&x)[2], const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}

// acc[i][j] += sum_{k < KN} X[8 w + i][k] * Y[k][lane_feature(j)]: as
// rank_update_rows with X stored [output row][k] (row stride ldx, even),
// read two k at a time (8 broadcast loads for 2 steps of k), so a step of
// k is 6 shared loads for 64 FMAs
template <int KN, typename TX, typename T>
__device__ __forceinline__ void rank_update_cols(float (&acc)[8][8],
                                                 const TX* X, int ldx,
                                                 const T* Y, int ld) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const TX* x_p = X + 8 * w * ldx;
  const T* y0_p = Y + min(4 * l, ld - 4);
  const T* y1_p = Y + min(4 * l + 128, ld - 4);
#pragma unroll 1
  for (int k = 0; k < KN; k += 2) {
    float x[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) load2(x[i], x_p + i * ldx + k);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float y0[4], y1[4];
      load4(y0, y0_p + (k + kk) * ld);
      load4(y1, y1_p + (k + kk) * ld);
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][v] = fmaf(x[i][kk], y0[v], acc[i][v]);
          acc[i][v + 4] = fmaf(x[i][kk], y1[v], acc[i][v + 4]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// d_table's partial: grid = (catalog tiles of the chunk, slabs, row
// splits).  Block (x, y, z) owns catalog rows c0 + 64 x .. of the chunk that
// starts at table row c0 and features slab y, and reduces the 64-row tiles
// [z tiles_per_split, (z + 1) tiles_per_split) of the R rows in stages of KR:
// dz [KR][64] from the scratch and sr's [KR] rows of the slab, double-
// buffered; G = dz^T sr in registers (warp w owns catalog rows 8 w ..
// 8 w + 7), written as split z's float32 partial [P][D].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_slab_dtable(
    const T* __restrict__ dz, int ldz, const T* __restrict__ sr, int R, int P,
    int D, int vec, int c0, int tiles_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = slab_width<T>(D), ldy = tile_ld(sw);
  const int stage_elems = STAGE_X + KR * ldy;
  T* buf = reinterpret_cast<T*>(smem);
  const int q0 = blockIdx.x * TILE;
  const int k0 = blockIdx.y * sw, w = min(sw, D - k0);
  const int n_rows = (R + TILE - 1) / TILE;
  const int r_begin = blockIdx.z * tiles_per_split * TILE;
  const int r_end =
      min(n_rows, (int)(blockIdx.z + 1) * tiles_per_split) * TILE;
  const int n_steps = (r_end - r_begin) / KR;
  auto stage = [&](int s) {
    T* X = buf + (s & 1) * stage_elems;
    const int r = r_begin + s * KR;
    stage_dz<KR, TILE>(X, LDZ, dz, ldz, r, q0);
    stage_slab<KR>(X + STAGE_X, ldy, sr, r, R, D, k0, w, vec);
  };
  stage(0);
  cp_async_commit();
  float G[8][8] = {};
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const T* X = buf + (s & 1) * stage_elems;
    rank_update_rows<KR, true, 4>(G, X, LDZ, X + STAGE_X, ldy);
    __syncthreads();  // the stage is consumed
  }
  const int wp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = c0 + q0 + 8 * wp + i;
    if (col < P)
      store_slab8(part + ((size_t)blockIdx.z * P + col) * D + k0, G[i], w, D);
  }
}

// ---------------------------------------------------------------------------
// d_sr's partial: grid = (64-row tiles of the R rows, slabs, catalog
// splits).  Block (x, y, z) owns rows 64 x .. and features slab y, and
// reduces the chunk's catalog tiles [z tiles_per_split, (z + 1)
// tiles_per_split) (of n_tiles; the chunk starts at table row c0) in stages
// of KR: dz [64][KR] from the scratch and t's [KR] rows of the slab,
// double-buffered; dz t in registers (warp w owns rows 8 w .. 8 w + 7),
// written to out [z][R][D].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_slab_dsr(
    const T* __restrict__ dz, int ldz, const T* __restrict__ op, int R, int P,
    int D, int vec, int c0, int n_tiles, int tiles_per_split,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = slab_width<T>(D), ldy = tile_ld(sw);
  const int stage_elems = STAGE_X + KR * ldy;
  T* buf = reinterpret_cast<T*>(smem);
  const int r0 = blockIdx.x * TILE;
  const int k0 = blockIdx.y * sw, w = min(sw, D - k0);
  const int q_begin = blockIdx.z * tiles_per_split * TILE;
  const int q_end =
      min(n_tiles, (int)(blockIdx.z + 1) * tiles_per_split) * TILE;
  const int n_steps = (q_end - q_begin) / KR;
  auto stage = [&](int s) {
    T* X = buf + (s & 1) * stage_elems;
    const int q = q_begin + s * KR;
    stage_dz<TILE, KR>(X, LDX, dz, ldz, r0, q);
    stage_slab<KR>(X + STAGE_X, ldy, op, c0 + q, P, D, k0, w, vec);
  };
  stage(0);
  cp_async_commit();
  float acc[8][8] = {};
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const T* X = buf + (s & 1) * stage_elems;
    rank_update_cols<KR>(acc, X, LDX, X + STAGE_X, ldy);
    __syncthreads();  // the stage is consumed
  }
  const int wp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * wp + i;
    if (r < R)
      store_slab8(out + ((size_t)blockIdx.z * R + r) * D + k0, acc[i], w, D);
  }
}

// ---------------------------------------------------------------------------
// The two slab products in bfloat16, on the tensor cores: the grids,
// splits, chunk loop and float32 partials of xent_slab_dtable and
// xent_slab_dsr, each stage reducing TILE rows (rank_update_tc's fixed
// 64-deep k loop; the splits go in whole 64-row tiles and the dz scratch
// is padded to them, so every stage is whole): the dz tile [TILE][LDZB]
// from the scratch and TILE rows of the operand's slab at tc_ld(sw), both
// by 16-byte cp.async (the slab's by plain loads where vec is 0), double-
// buffered.  A warp's accumulators (32 rows x four feature pairs) go
// through shared memory, once the stages are consumed, to the slab's
// float32 stores in store_slab8's lane layout.
// ---------------------------------------------------------------------------

// d_table's partial (xent_slab_dtable's grid): G = dz^T sr for catalog rows
// q0 .. q0 + 63 of the chunk and the block's slab, dz read transposed
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_slab_dtable_tc(
    const T* __restrict__ dz, int ldz, const T* __restrict__ sr, int R, int P,
    int D, int vec, int c0, int tiles_per_split, float* __restrict__ part) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = slab_width<T>(D), ldy = tc_ld(sw);
  const int stage_elems = stage_tc_elems(sw);
  T* buf = reinterpret_cast<T*>(smem);
  const int q0 = blockIdx.x * TILE;
  const int k0 = blockIdx.y * sw, w = min(sw, D - k0);
  const int kp = tc_kp(w), np = kp / 16;
  const int n_rows = (R + TILE - 1) / TILE;
  const int r_begin = blockIdx.z * tiles_per_split * TILE;
  const int r_end =
      min(n_rows, (int)(blockIdx.z + 1) * tiles_per_split) * TILE;
  const int n_steps = (r_end - r_begin) / TILE;
  auto stage = [&](int s) {
    T* X = buf + (s & 1) * stage_elems;
    const int r = r_begin + s * TILE;
    stage_dz_tc(X, dz, ldz, r, q0);
    stage_slab_tc(X + TILE * LDZB, ldy, sr, r, R, D, k0, w, vec);
  };
  stage(0);
  cp_async_commit();
  float G[2][8][4] = {};
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const T* X = buf + (s & 1) * stage_elems;
    rank_update_tc<4, true>(G, X, LDZB, X + TILE * LDZB, ldy, np);
    __syncthreads();  // the stage is consumed
  }
  cp_async_wait<0>();
  __syncthreads();
  float* G_s = reinterpret_cast<float*>(smem);  // [TILE][kp + 8]
  store_acc_tc<4>(G_s, kp + 8, G, np);
  __syncthreads();
  const int wp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int col = c0 + q0 + 8 * wp + i;
    if (col >= P) continue;  // warp-uniform
    float v[8];
    load_row8(v, G_s + (8 * wp + i) * (kp + 8), w);
    store_slab8(part + ((size_t)blockIdx.z * P + col) * D + k0, v, w, D);
  }
}

// d_sr's partial (xent_slab_dsr's grid): dz t for rows r0 .. r0 + 63 and
// the block's slab over the split's catalog tiles of the chunk
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_slab_dsr_tc(
    const T* __restrict__ dz, int ldz, const T* __restrict__ op, int R, int P,
    int D, int vec, int c0, int n_tiles, int tiles_per_split,
    float* __restrict__ out) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = slab_width<T>(D), ldy = tc_ld(sw);
  const int stage_elems = stage_tc_elems(sw);
  T* buf = reinterpret_cast<T*>(smem);
  const int r0 = blockIdx.x * TILE;
  const int k0 = blockIdx.y * sw, w = min(sw, D - k0);
  const int kp = tc_kp(w), np = kp / 16;
  const int q_begin = blockIdx.z * tiles_per_split * TILE;
  const int q_end =
      min(n_tiles, (int)(blockIdx.z + 1) * tiles_per_split) * TILE;
  const int n_steps = (q_end - q_begin) / TILE;
  auto stage = [&](int s) {
    T* X = buf + (s & 1) * stage_elems;
    const int q = q_begin + s * TILE;
    stage_dz_tc(X, dz, ldz, r0, q);
    stage_slab_tc(X + TILE * LDZB, ldy, op, c0 + q, P, D, k0, w, vec);
  };
  stage(0);
  cp_async_commit();
  float acc[2][8][4] = {};
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const T* X = buf + (s & 1) * stage_elems;
    rank_update_tc<4, false>(acc, X, LDZB, X + TILE * LDZB, ldy, np);
    __syncthreads();  // the stage is consumed
  }
  cp_async_wait<0>();
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);  // [TILE][kp + 8]
  store_acc_tc<4>(acc_s, kp + 8, acc, np);
  __syncthreads();
  const int wp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * wp + i;
    if (r >= R) continue;  // warp-uniform
    float v[8];
    load_row8(v, acc_s + (8 * wp + i) * (kp + 8), w);
    store_slab8(out + ((size_t)blockIdx.z * R + r) * D + k0, v, w, D);
  }
}

// the slab products of type T: on the tensor cores in bfloat16, on the FMA
// pipes in float32
template <typename T>
auto slab_dtable_kernel() {
  if constexpr (tc_type<T>) return xent_slab_dtable_tc<T>;
  else return xent_slab_dtable<T>;
}
template <typename T>
auto slab_dsr_kernel() {
  if constexpr (tc_type<T>) return xent_slab_dsr_tc<T>;
  else return xent_slab_dsr<T>;
}

// resident blocks per SM, registers and local memory bytes per thread of
// kernel fn with smem bytes of dynamic shared memory (set as its maximum)
inline void kernel_attrs(const void* fn, int smem, int* blocks, int* regs,
                         int* local) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NT, smem);
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, fn);
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
}

template <typename T>
int set_product_smem(int D) {
  const int smem = (int)slab_product_smem<T>(D);
  cudaFuncSetAttribute(slab_dtable_kernel<T>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(slab_dsr_kernel<T>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return smem;
}

// the two product kernels' numbers at width D: blocks[k], regs[k], local[k]
// of d_table's (k = 0) and d_sr's (k = 1), xent_slab_dtable and
// xent_slab_dsr (their _tc kernels in bfloat16)
template <typename T>
int slab_product_attrs(int D, int* blocks, int* regs, int* local) {
  const int smem = (int)slab_product_smem<T>(D);
  kernel_attrs((const void*)slab_dtable_kernel<T>(), smem, &blocks[0],
               &regs[0], &local[0]);
  kernel_attrs((const void*)slab_dsr_kernel<T>(), smem, &blocks[1], &regs[1],
               &local[1]);
  return (int)cudaGetLastError();
}

// The chunk loop of the slab backward.  The catalog's n_tiles 64-row tiles
// go in chunks of chunk_tiles; for each chunk, launch_dz(c0, tiles, ldz)
// writes its dz into dz [rows * 64][ldz = chunk_tiles * 64], then
// d_table's product (slab_dtable_kernel) writes the chunk's catalog rows of
// dtab_part [t_split][P][D] (row splits of t_per tiles) and d_sr's
// (slab_dsr_kernel) its d_sr partials,
// ceil(tiles / s_per) of them, after the earlier chunks' in dsr_part
// [parts][R][D] (into dsr itself when the whole catalog makes one).  Last,
// xent_bwd_dsr_reduce sums the partials in chunk and split order.
// ops/xent.py:slab_bwd_plan chooses the numbers and the scratch.
template <typename T, typename LaunchDz>
int slab_bwd_chunks(LaunchDz launch_dz, const T* sr, const T* op, int R,
                    int P, int D, int vec, int chunk_tiles, int t_split,
                    int t_per, int s_per, T* dz, float* dtab_part,
                    float* dsr_part, float* dsr, cudaStream_t stream) {
  const int n_tiles = (P + TILE - 1) / TILE, n_rows = (R + TILE - 1) / TILE;
  const int slabs = slab_count(D), ldz = chunk_tiles * TILE;
  // every slab within MAX_D and none empty
  if (slab_width<T>(D) > MAX_D || (slabs - 1) * slab_width<T>(D) >= D)
    return (int)cudaErrorInvalidValue;
  const int smem = set_product_smem<T>(D);
  const auto dtable = slab_dtable_kernel<T>();
  const auto dsr_product = slab_dsr_kernel<T>();
  int parts = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += chunk_tiles)
    parts += (std::min(chunk_tiles, n_tiles - t0) + s_per - 1) / s_per;
  float* out = parts > 1 ? dsr_part : dsr;
  cudaError_t err;
  int part = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += chunk_tiles) {
    const int tiles = std::min(chunk_tiles, n_tiles - t0), c0 = t0 * TILE;
    const int e = launch_dz(c0, tiles, ldz);
    if (e) return e;
    dtable<<<dim3(tiles, slabs, t_split), NT, smem, stream>>>(
        dz, ldz, sr, R, P, D, vec, c0, t_per, dtab_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int splits = (tiles + s_per - 1) / s_per;
    dsr_product<<<dim3(n_rows, slabs, splits), NT, smem, stream>>>(
        dz, ldz, op, R, P, D, vec, c0, tiles, s_per,
        out + (size_t)part * R * D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    part += splits;
  }
  if (parts > 1) {
    const int n = R * D;
    xent_bwd_dsr_reduce<<<(n + NT - 1) / NT, NT, 0, stream>>>(dsr_part,
                                                              parts, n, dsr);
  }
  return (int)cudaGetLastError();
}

// d_table for D > MAX_D from the row splits' float32 partials [n_split][P][D]
// (every slab's columns), summed in split order, with the l2norm VJP of
// finish_dtable_row when the table is normalised: its dot product over the
// whole row, then the row.  One warp per catalog row, two passes over D;
// each loss's finish kernel (xent_bwd_finish_slab, xent_multi_bwd_finish_slab)
// runs it once a call.
template <typename T>
__device__ __forceinline__ void slab_dtable_finish(
    const float* __restrict__ part, int n_split, const T* __restrict__ tab,
    const float* __restrict__ nrm, int P, int D, int normalize,
    T* __restrict__ dtab) {
  const int col = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= P) return;  // warp-uniform
  const size_t base = (size_t)col * D, plane = (size_t)P * D;
  auto gsum = [&](int k) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) acc += part[sp * plane + base + k];
    return acc;
  };
  if (!normalize) {
    for (int k = lane; k < D; k += 32) dtab[base + k] = from_f<T>(gsum(k));
    return;
  }
  const float n = nrm[col];
  const float live = n > NORM_EPS ? 1.f : 0.f;
  float dot = 0.f;
  for (int k = lane; k < D; k += 32)
    dot = fmaf(gsum(k), to_f(tab[base + k]) / n, dot);
  dot = warp_sum(dot);
  for (int k = lane; k < D; k += 32) {
    const float t = to_f(tab[base + k]) / n;
    dtab[base + k] = from_f<T>((gsum(k) - dot * t * live) / n);
  }
}

}  // namespace
