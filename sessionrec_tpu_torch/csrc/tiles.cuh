// Tile helpers of K1 (xent.cu), K2 (xent_bwd.cu), K3 and K4
// (xent_multi.cu): asynchronous staging of 64-row tiles into shared
// memory, register-tiled float32 products over them, the forward tile loop
// that K1 and K3 share, and the kernels they share: the table normalised
// (or its norms taken) once, and the row splits' d_table partials reduced
// in a fixed order.
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

// shared memory of a forward block: the rows, two catalog tiles and, with
// MEMBERS, the rows' masks
template <typename T, bool MEMBERS>
size_t fwd_smem(int D) {
  return (size_t)3 * TILE * tile_ld(D) * sizeof(T) +
         (MEMBERS ? TILE * sizeof(unsigned long long) : 0);
}

// ---------------------------------------------------------------------------
// The forward tile loop of K1 (MEMBERS = false) and K3 (MEMBERS = true): a
// partial online log-sum-exp over one catalog split.  grid = (row tiles,
// catalog splits) over the R rows of sr, row r taking label r % B (and,
// with MEMBERS, iid list r % B).  A block stages its 64 rows once and
// streams the raw table tiles of its split (double-buffered); thread (ty,
// tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of each 64 x 64
// logits tile, scales each logit by scale / n[col] in registers when the
// table is normalised, and keeps its own running stats per row, merged
// over the row's 16 threads by shuffles at the end.
//   MEMBERS: a row's session columns go to (m_in, s_in), the others to
//     (m_ex, s_ex); part holds [5][n_split][R] floats: m_in, s_in, m_ex,
//     s_ex, zl.  Columns are compared locally with n_valid and the labels.
//   otherwise: every column goes to (m_ex, s_ex), the "in" partition stays
//     empty and compiles away; part holds [3][n_split][R] floats: m, s, zl.
//     Columns are compared globally (col_offset + c, as K1's JAX kernel
//     does), so n_valid and the labels are shifted by col_offset.
// ---------------------------------------------------------------------------
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_tile_loop(
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
    cp_async_wait_prev();  // this tile (and the rows) have landed
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

// ---------------------------------------------------------------------------
// The slab path, for D > MAX_D.  A row of D features is cut into
// slab_count(D) slabs of slab_width(D) features (the last one narrower, none
// wider than MAX_D).  A block stages one slab of each operand tile at a time
// into a [TILE][tile_ld(slab_width(D))] buffer, so its shared memory does not
// grow with D, and a logits tile sums the products of all its slabs before
// anything reads it (slab_logits).  The backward kernels take the slab of
// their output features from the grid's z axis and recompute the full-width
// dz tile in every slab's block; the l2norm VJP, which couples a table row's
// features, is applied once every slab's partial is in
// (xent_slab_dtable_reduce).  One buffer per operand, waited for whole: a
// simple design, not yet a tuned one.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int slab_count(int D) {
  return (D + MAX_D - 1) / MAX_D;
}

// features of every slab but the last: ceil(D / slabs) rounded up to 4, so
// each slab starts four-element aligned
__host__ __device__ __forceinline__ int slab_width(int D) {
  const int n = slab_count(D);
  return ((D + n - 1) / n + 3) & ~3;
}

// wait until every committed group of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// columns [k0, k0 + w) of rows [row0, row0 + TILE) of a row-major
// [n_rows, D] array into dst (row stride ld), as columns [0, round_up(w,
// 4)); rows at or past n_rows and columns at or past w read 0.  With vec
// (D % 4 == 0 and the array aligned to four elements, so k0 + k is too)
// every four elements of a live row go by one cp.async, to be waited for
// with the group that the caller commits.
template <typename T>
__device__ __forceinline__ void stage_slab(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int row0, int n_rows, int D,
                                           int k0, int w, bool vec) {
  const int q4 = (w + 3) >> 2;
  for (int e = threadIdx.x; e < TILE * q4; e += NT) {
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

// S += the 64 x 64 logits tile of rows [a0, a0 + TILE) of a [a_rows, D]
// against rows [c0, c0 + TILE) of c [c_rows, D] over all D features, one
// slab at a time through A_s and C_s (product_logits's thread layout).  On
// return every thread is done reading A_s and C_s.
template <typename T>
__device__ __forceinline__ void slab_logits(float (&S)[4][4], T* A_s, T* C_s,
                                            int ld, const T* __restrict__ a,
                                            int a0, int a_rows,
                                            const T* __restrict__ c, int c0,
                                            int c_rows, int D, int sw,
                                            bool vec) {
  for (int k0 = 0; k0 < D; k0 += sw) {
    const int w = min(sw, D - k0);
    stage_slab(A_s, ld, a, a0, a_rows, D, k0, w, vec);
    stage_slab(C_s, ld, c, c0, c_rows, D, k0, w, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    product_logits(S, A_s, C_s, ld, (w + 3) & ~3);
    __syncthreads();
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

// shared memory of a slab-path forward block: a slab of the rows and one
// of a catalog tile and, with MEMBERS, the rows' masks
template <typename T, bool MEMBERS>
size_t fwd_slab_smem(int D) {
  return (size_t)2 * TILE * tile_ld(slab_width(D)) * sizeof(T) +
         (MEMBERS ? TILE * sizeof(unsigned long long) : 0);
}

// shared memory of a slab-path backward block: two slab tiles and the dz
// tile
template <typename T>
size_t bwd_slab_smem(int D) {
  return (size_t)2 * TILE * tile_ld(slab_width(D)) * sizeof(T) +
         (size_t)TILE * LDZ * sizeof(float);
}

// ---------------------------------------------------------------------------
// fwd_tile_loop for D > MAX_D: the same partial online log-sum-exp over one
// catalog split and the same outputs, with each 64 x 64 logits tile summed
// over the slabs (the rows' slab is staged again for every catalog tile).
// ---------------------------------------------------------------------------
template <typename T, bool MEMBERS>
__device__ __forceinline__ void fwd_slab_loop(
    unsigned char* smem, const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  const int sw = slab_width(D), ld = tile_ld(sw);
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] rows
  T* C_s = A_s + TILE * ld;                            // [TILE][ld] table
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(C_s + TILE * ld);  // [TILE]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int shift = MEMBERS ? 0 : col_offset;
  n_valid -= shift;

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
    const int p0 = t * TILE;
    if constexpr (MEMBERS)
      row_masks(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    float S[4][4] = {};
    slab_logits(S, A_s, C_s, ld, sr, row0, R, tab, p0, P, D, sw, vec);
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
    if constexpr (MEMBERS) __syncthreads();  // the masks are consumed
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

// d_table for D > MAX_D from the row splits' float32 partials [n_split][P][D]
// (every slab's columns), summed in split order, with the l2norm VJP of
// finish_dtable_row when the table is normalised: its dot product over the
// whole row, then the row.  One warp per catalog row, two passes over D.
template <typename T>
__global__ void __launch_bounds__(NT) xent_slab_dtable_reduce(
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
