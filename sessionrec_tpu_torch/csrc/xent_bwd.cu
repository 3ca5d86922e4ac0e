// K2: the backward pass of the fused full-catalog softmax cross-entropy,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sessionrec_tpu/ops/xent.py:164
// _bwd_kernel (pallas_call at :221).  For the per-row loss cotangent g it
// computes
//   dz      = round_op((softmax(scale * sr t^T) - onehot) * scale * g)
//   d_sr    = dz @ t                             [B, D] float32
//   d_table = l2norm-VJP(dz^T @ sr)              [P, D] the table's type
// with t = round_op(table / max(||table_row||, 1e-12)) when the table is
// normalised (the table itself otherwise), columns at or past n_valid
// masked, labels localised to the table (-1 matches nothing) and padding
// rows exactly 0.  round_op rounds to the operand type (identity in
// float32), where the JAX kernel feeds its matrix unit.
//
// What bounds it.  3 * 2*B*P*D operations are counted (the logits, d_sr,
// d_table) on (B + 2 P) * D elements: at B = 512, D = 256 about 770
// operations a float32 byte, far above the card's 20 (67 TFLOP/s over
// 3.35 TB/s), and 1,540 a bfloat16 byte, far above its 295 (989 TFLOP/s
// on the tensor cores), so it is bound by operations: float32 on the FP32
// FMA pipes (TF32 would change the numerics), bfloat16 on the tensor cores
// at every width.  Four products are performed: the logits
// are recomputed once for each output.  One pass for both outputs would
// need either a cross-block sum of a [B, D] partial per catalog tile
// (310 MB at the north-star catalog of 37,888 rows) or atomics, which give
// up determinism; so the kernel's ceiling is 75% of its bound.
//
// What the design does about it:
//   * The table is normalised once.  xent_bwd_normalize writes t and the
//     clamped norms n to scratch; the product kernels stream t and never
//     normalise a tile again (the first design re-normalised every tile in
//     every block that staged it).  It, finish_dtable_row and
//     xent_bwd_dtable_reduce live in tiles.cuh, shared with K4.
//   * float32: register-tiled products (tiles.cuh).  A 64 x 64 logits tile
//     is 4 x 4 outputs a thread, 8 shared loads of four elements per 64
//     FMAs; the accumulations d_table += dz^T sr and d_sr += dz t are 8 x 8
//     outputs a thread (a warp's 8 rows, a lane's 8 features), 4 loads per
//     64 FMAs.  Tiles stay row-major with a padded stride, so every read is
//     four consecutive elements and the lanes of a phase hit distinct
//     banks; dz goes to shared memory as [row][col] for d_table and as
//     [col][row] for d_sr, so each accumulation reads it along its own
//     reduction axis.
//   * bfloat16 up to MAX_D: all three products on the tensor cores
//     (xent_bwd_dtable_tc, xent_bwd_dsr_tc; mma.sync m16n8k16, float32
//     sums).  The logits tile comes from product_logits_tc (a warp's 16 x
//     32 of it); dz, rounded to bfloat16 as the JAX kernel feeds its matrix
//     unit (exact), goes to shared memory as bfloat16 [row][col], half the
//     float32 tile; d_table += dz^T sr reads both operands by
//     ldmatrix.x4.trans, d_sr += dz t reads dz by ldmatrix.x4 and t by
//     ldmatrix.x4.trans (rank_update_tc: a warp's 32 rows x four feature
//     pairs, 64 float32 accumulators a lane).  The accumulators go through
//     shared memory to the float32 partials' and d_table's stores.  Their
//     tiles (tc_ld stride, 16-byte cp.async) and their dz tile take 108 KB
//     at D = 256, so two blocks share an SM.
//   * Asynchronous, double-buffered staging.  Tiles arrive by cp.async
//     (float32 four elements, bfloat16 eight, 16 bytes a copy), and the
//     next tile of the streamed operand loads while the current one is
//     used.
//   * A grid that fills the card.  xent_bwd_dtable is parallel over
//     64-row catalog tiles and over row splits, with tiles x splits at
//     most the resident block slots (the wrapper reads them from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor); with several splits
//     each writes a float32 partial of dz^T sr and xent_bwd_dtable_reduce
//     sums them in a fixed order and applies the l2norm VJP
//     (G - (G . t) t [n > eps]) / n once, after the sum (the VJP is linear
//     in G); with one split the product kernel writes d_table itself.
//     xent_bwd_dsr is parallel over 64-row batch tiles and catalog splits,
//     and xent_bwd_dsr_reduce sums its partials in a fixed order.  The
//     bfloat16 kernels size the same grids from their own slots.
//   * Deterministic: no atomics; two calls on the same inputs give the
//     same bits.
//
// Interface.  srt_xent_bwd takes the grid the wrapper chose
// (ops/xent.py:_bwd_grid) and its scratch; srt_xent_bwd_slots reports the
// resident block slots of the two product kernels, their registers and
// their local memory (spills).  Any B >= 1, P >= 1, D >= 1: with
// D % 4 == 0 and aligned arrays the tiles are staged by cp.async (bfloat16,
// at every width: D % 8 == 0 and 16-byte aligned arrays), otherwise by
// plain loads.
//
// Past D = MAX_D (256) features srt_xent_bwd_slab runs the slab path of
// tiles.cuh.  A thread's 8 x 8 accumulators cover one slab of at most 256
// features of an output row, and a block per output slab that recomputed
// the full-width logits would run 2 (slabs + 1) products of 2 B P D
// operations where the bound counts 3.  It is bound by operations as
// above: at D = 512, B = 512 and the north-star catalog (37,888 rows)
// 3 * 2 B P D = 59.6 GFLOP, 0.88 ms at the FP32 peak (0.06 ms at the
// tensor cores' bf16 peak).  The design computes dz once and runs three
// products, 3 * 2 B P D operations in all:
//   * xent_bwd_dz_slab: one block per (64-row batch tile, 64-row catalog
//     tile) computes its logits tile once over all D features, staged in
//     k-chunks of 64 features through two cp.async stages, and writes dz,
//     rounded to the operand type by dlogit, to a [B, P] scratch in that
//     type (exact).  bfloat16: the chunks at the tensor cores' stride and
//     product (dz_logits_tc), the tile through shared memory (dz_tile_tc)
//     to 16-byte stores.  The scratch is capped
//     (ops/xent.py:DZ_SCRATCH_BYTES); a larger catalog goes in chunks,
//     each chunk's dz, then its products.
//   * d_table's product (dz^T sr) and d_sr's (dz t), tiles.cuh's products
//     shared with K4: in float32 xent_slab_dtable and xent_slab_dsr,
//     register-tiled on the FMA pipes (8 x 8 accumulators a thread), in
//     bfloat16 xent_slab_dtable_tc and xent_slab_dsr_tc on the tensor cores
//     (rank_update_tc over 64-row stages, slabs that start on a k step of
//     16); the reduction axis streamed through two cp.async stages, shared
//     memory sized for two resident blocks per SM, their grids split over
//     the reduction axis to fill the card.
//   * xent_bwd_dsr_reduce sums d_sr's partials in chunk and split order;
//     xent_bwd_finish_slab sums d_table's row splits in order and applies
//     the l2norm VJP over the whole row.
// dz adds only bytes: written once and read by each product, 3 B P
// elements, 233 MB in float32 at the north star (0.07 ms at 3.35 TB/s, 8%
// of the bound; in bfloat16 116 MB, 0.035 ms, above the operations'
// bound).  Still no atomics.  Each entry point launches on the given
// stream, does not synchronise and returns cudaGetLastError().

#include "tiles.cuh"

namespace {

// dz = (p - onehot) * scale * g for one logits value (0 for padding rows)
template <typename T>
__device__ __forceinline__ float dlogit(float z, int col, int p_end,
                                        int col_offset, int n_valid, int lbl,
                                        float lse_r, float g_r, bool row_ok,
                                        float scale) {
  const int gcol = col_offset + col;
  const bool in_table = col < p_end;
  if (!row_ok || !in_table) return 0.f;
  const float p = gcol < n_valid ? expf(z - lse_r) : 0.f;
  const float oh = gcol == lbl ? 1.f : 0.f;
  return round_op<T>((p - oh) * (scale * g_r));
}

// ---------------------------------------------------------------------------
// d_table: grid = (catalog tiles, row splits).  A block stages its 64-row
// tile of t once and streams the batch rows of its split in 64-row chunks
// (double-buffered), recomputes each 64 x 64 dz tile and accumulates
// G = dz^T sr in registers (warp w owns catalog rows 8 w .. 8 w + 7).  With
// part, it writes G as the split's float32 partial; otherwise d_table.
// ---------------------------------------------------------------------------
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, 1) xent_bwd_dtable(
    const float* __restrict__ g, const T* __restrict__ sr,
    const T* __restrict__ op, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const float* __restrict__ lse, int B, int P, int D, int n_valid,
    int col_offset, float scale, int normalize, int vec,
    int chunks_per_split, float* __restrict__ part, T* __restrict__ dtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld(D), D4 = (D + 3) & ~3;
  T* C_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] t rows
  T* A_s = C_s + TILE * ld;                            // [2][TILE][ld] sr
  float* dz_s = reinterpret_cast<float*>(A_s + 2 * TILE * ld);  // [row][col]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.x * TILE;
  const int n_chunks = (B + TILE - 1) / TILE;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  stage_tile(C_s, ld, op, p0, P, D, vec);
  stage_tile(A_s, ld, sr, c_begin * TILE, B, D, vec);
  cp_async_commit();

  float G[8][8] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const T* A = A_s + buf * TILE * ld;
    if (c + 1 < c_end)
      stage_tile(A_s + (buf ^ 1) * TILE * ld, ld, sr, (c + 1) * TILE, B, D,
                 vec);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk (and the tile) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits(S, A, C_s, ld, D4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, r = c * TILE + rl;
      const bool row_ok = r < B;
      const int lbl = row_ok ? labels[r] : -1;
      const float lse_r = row_ok ? lse[r] : 0.f;
      const float g_r = row_ok ? g[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        dz_s[rl * LDZ + cl] =
            dlogit<T>(scale * S[i][j], p0 + cl, P, col_offset, n_valid, lbl,
                      lse_r, g_r, row_ok, scale);
      }
    }
    __syncthreads();
    rank_update<T, HI>(G, dz_s, A, ld);
    __syncthreads();  // A and dz_s are consumed
  }

  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = p0 + 8 * w + i;
    if (col >= P) continue;  // warp-uniform
    if (part)
      store_row8(part + ((size_t)blockIdx.y * P + col) * D, G[i], D);
    else
      finish_dtable_row<T>(G[i], col, tab, nrm, D, normalize, dtab);
  }
}

// ---------------------------------------------------------------------------
// d_sr: grid = (batch tiles, catalog splits).  A block stages its 64 batch
// rows once and streams the catalog tiles of its split (double-buffered),
// recomputes each 64 x 64 dz tile and accumulates dz t in registers (warp
// w owns batch rows 8 w .. 8 w + 7); it writes its split's partial to out
// (d_sr itself when there is one split).
// ---------------------------------------------------------------------------
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, 1) xent_bwd_dsr(
    const float* __restrict__ g, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const float* __restrict__ lse, int B, int P, int D, int n_valid,
    int col_offset, float scale, int vec, int tiles_per_split,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld(D), D4 = (D + 3) & ~3;
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] t
  float* dz_s = reinterpret_cast<float*>(C_s + 2 * TILE * ld);  // [col][row]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  stage_tile(A_s, ld, sr, row0, B, D, vec);
  stage_tile(C_s, ld, op, t_begin * TILE, P, D, vec);
  cp_async_commit();

  int lbl[4];
  float lse_r[4], g_r[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    row_ok[i] = r < B;
    lbl[i] = row_ok[i] ? labels[r] : -1;
    lse_r[i] = row_ok[i] ? lse[r] : 0.f;
    g_r[i] = row_ok[i] ? g[r] : 0.f;
  }

  float acc[8][8] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    if (t + 1 < t_end)
      stage_tile(C_s + (buf ^ 1) * TILE * ld, ld, op, (t + 1) * TILE, P, D,
                 vec);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits(S, A_s, C, ld, D4);
    const int p0 = t * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        dz_s[cl * LDZ + ty + 16 * i] =
            dlogit<T>(scale * S[i][j], p0 + cl, P, col_offset, n_valid,
                      lbl[i], lse_r[i], g_r[i], row_ok[i], scale);
      }
    __syncthreads();
    rank_update<T, HI>(acc, dz_s, C, ld);
    __syncthreads();  // C and dz_s are consumed
  }

  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * w + i;
    if (r < B) store_row8(out + ((size_t)blockIdx.y * B + r) * D, acc[i], D);
  }
}

// ---------------------------------------------------------------------------
// The two product kernels in bfloat16 up to MAX_D, on the tensor cores: the
// grids, staging order and outputs of xent_bwd_dtable and xent_bwd_dsr.
// Each logits tile's dz goes to dz_s [row][col] as bfloat16 (dz_tile_tc);
// rank_update_tc's accumulators go through shared memory (the tiles', once
// consumed) to the rows' stores, a warp's 8 rows in the FMA kernels' lane
// layout.  NPW: feature pairs a warp (4 past 128 features, else 2).
// ---------------------------------------------------------------------------

// dz of the logits tile S (product_logits_tc's layout) of batch rows
// [r0, r0 + TILE) and catalog columns [p0, p0 + TILE), by dlogit, into
// dz_s [TILE][LDZB] as bfloat16 pairs: lane l of warp w takes rows rb =
// 16 (w >> 1) + l / 4 and rb + 8, columns cb + 8 f + {0, 1} (f < 4), cb =
// 32 (w & 1) + 2 (l % 4).  The rows' inputs are read again each tile (L1
// hits), not held across it: with 64 accumulators a lane, two blocks an SM
// leave no registers for them.
__device__ __forceinline__ void dz_tile_tc(
    __nv_bfloat16* dz_s, const float (&S)[4][4], const float* __restrict__ g,
    const int* __restrict__ labels, const float* __restrict__ lse, int r0,
    int B, int p0, int P, int n_valid, int col_offset, float scale) {
  typedef __nv_bfloat16 T;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rb = 16 * (w >> 1) + (l >> 2), cb = 32 * (w & 1) + 2 * (l & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = rb + 8 * h, r = r0 + rl;
    const bool row_ok = r < B;
    const int lbl = row_ok ? labels[r] : -1;
    const float lse_r = row_ok ? lse[r] : 0.f;
    const float g_r = row_ok ? g[r] : 0.f;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int cl = cb + 8 * f;
      const float d0 = dlogit<T>(scale * S[f][2 * h], p0 + cl, P, col_offset,
                                 n_valid, lbl, lse_r, g_r, row_ok, scale);
      const float d1 = dlogit<T>(scale * S[f][2 * h + 1], p0 + cl + 1, P,
                                 col_offset, n_valid, lbl, lse_r, g_r, row_ok,
                                 scale);
      *reinterpret_cast<__nv_bfloat162*>(dz_s + rl * LDZB + cl) =
          __floats2bfloat162_rn(d0, d1);
    }
  }
}
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, tile_blocks<T>()) xent_bwd_dtable_tc(
    const float* __restrict__ g, const T* __restrict__ sr,
    const T* __restrict__ op, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const float* __restrict__ lse, int B, int P, int D, int n_valid,
    int col_offset, float scale, int normalize, int vec,
    int chunks_per_split, float* __restrict__ part, T* __restrict__ dtab) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  constexpr int NPW = HI ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_ld(D), kp = tc_kp(D), np = kp / 16;
  T* C_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] t rows
  T* A_s = C_s + TILE * ld;                            // [2][TILE][ld] sr
  T* dz_s = A_s + 2 * TILE * ld;                       // [TILE][LDZB]
  const int w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * TILE;
  const int n_chunks = (B + TILE - 1) / TILE;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  stage_tile_tc(C_s, ld, op, p0, P, D, vec);
  stage_tile_tc(A_s, ld, sr, c_begin * TILE, B, D, vec);
  cp_async_commit();

  float G[2][2 * NPW][4] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const T* A = A_s + buf * TILE * ld;
    if (c + 1 < c_end)
      stage_tile_tc(A_s + (buf ^ 1) * TILE * ld, ld, sr, (c + 1) * TILE, B,
                    D, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk (and the tile) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits_tc(S, A, C_s, ld, kp);
    dz_tile_tc(dz_s, S, g, labels, lse, c * TILE, B, p0, P, n_valid,
               col_offset, scale);
    __syncthreads();
    rank_update_tc<NPW, true>(G, dz_s, LDZB, A, ld, np);
    __syncthreads();  // A and dz_s are consumed
  }

  cp_async_wait<0>();
  float* G_s = reinterpret_cast<float*>(smem);         // [TILE][kp + 8]
  store_acc_tc<NPW>(G_s, kp + 8, G, np);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int col = p0 + 8 * w + i;
    if (col >= P) continue;  // warp-uniform
    float gs[8];
    load_row8(gs, G_s + (8 * w + i) * (kp + 8), D);
    if (part)
      store_row8(part + ((size_t)blockIdx.y * P + col) * D, gs, D);
    else
      finish_dtable_row<T>(gs, col, tab, nrm, D, normalize, dtab);
  }
}

template <typename T, bool HI>
__global__ void __launch_bounds__(NT, tile_blocks<T>()) xent_bwd_dsr_tc(
    const float* __restrict__ g, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const float* __restrict__ lse, int B, int P, int D, int n_valid,
    int col_offset, float scale, int vec, int tiles_per_split,
    float* __restrict__ out) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  constexpr int NPW = HI ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_ld(D), kp = tc_kp(D), np = kp / 16;
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] t
  T* dz_s = C_s + 2 * TILE * ld;                       // [TILE][LDZB]
  const int w = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  stage_tile_tc(A_s, ld, sr, row0, B, D, vec);
  stage_tile_tc(C_s, ld, op, t_begin * TILE, P, D, vec);
  cp_async_commit();

  float acc[2][2 * NPW][4] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    if (t + 1 < t_end)
      stage_tile_tc(C_s + (buf ^ 1) * TILE * ld, ld, op, (t + 1) * TILE, P,
                    D, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits_tc(S, A_s, C, ld, kp);
    dz_tile_tc(dz_s, S, g, labels, lse, row0, B, t * TILE, P, n_valid,
               col_offset, scale);
    __syncthreads();
    rank_update_tc<NPW, false>(acc, dz_s, LDZB, C, ld, np);
    __syncthreads();  // C and dz_s are consumed
  }

  cp_async_wait<0>();
  float* acc_s = reinterpret_cast<float*>(smem);       // [TILE][kp + 8]
  store_acc_tc<NPW>(acc_s, kp + 8, acc, np);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * w + i;
    if (r >= B) continue;  // warp-uniform
    float v[8];
    load_row8(v, acc_s + (8 * w + i) * (kp + 8), D);
    store_row8(out + ((size_t)blockIdx.y * B + r) * D, v, D);
  }
}

// K2's two product kernels at D <= MAX_D in type T: on the tensor cores in
// bfloat16, on the FMA pipes in float32
template <typename T, bool HI>
auto dtable_kernel() {
  if constexpr (tc_type<T>) return xent_bwd_dtable_tc<T, HI>;
  else return xent_bwd_dtable<T, HI>;
}
template <typename T, bool HI>
auto dsr_kernel() {
  if constexpr (tc_type<T>) return xent_bwd_dsr_tc<T, HI>;
  else return xent_bwd_dsr<T, HI>;
}

// ---------------------------------------------------------------------------
// dz for D > MAX_D: grid = (64-row batch tiles, 64-row catalog tiles of the
// chunk that starts at table row c0).  A block computes its logits tile once
// over all D features and writes its dz tile, rounded to the operand type,
// to dz [rows * 64][ldz] at the chunk's columns; rows past B and columns
// past P get 0.  float32: dz_logits on the FMA pipes, a thread's 4 x 4 dz
// stored where it lies.  bfloat16: dz_logits_tc on the tensor cores, the
// tile by dz_tile_tc into shared memory (the consumed stages), then out in
// 16-byte stores (store_dz_tc).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_bwd_dz_slab(
    const float* __restrict__ g, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const float* __restrict__ lse, int B, int P, int D, int n_valid,
    int col_offset, float scale, int vec, int c0, int ldz,
    T* __restrict__ dz) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * TILE, q0 = blockIdx.y * TILE;
  const int p0 = c0 + q0;
  float S[4][4] = {};
  if constexpr (tc_type<T>) {
    T* stages = reinterpret_cast<T*>(smem);
    dz_logits_tc(S, stages, sr, row0, B, op, p0, P, D, vec);
    dz_tile_tc(stages, S, g, labels, lse, row0, B, p0, P, n_valid,
               col_offset, scale);
    __syncthreads();
    store_dz_tc(dz, ldz, row0, q0, stages);
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    dz_logits(S, reinterpret_cast<T*>(smem), sr, row0, B, op, p0, P, D,
              vec);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      const bool row_ok = r < B;
      const int lbl = row_ok ? labels[r] : -1;
      const float lse_r = row_ok ? lse[r] : 0.f;
      const float g_r = row_ok ? g[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        dz[(size_t)r * ldz + q0 + cl] = from_f<T>(
            dlogit<T>(scale * S[i][j], p0 + cl, P, col_offset, n_valid, lbl,
                      lse_r, g_r, row_ok, scale));
      }
    }
  }
}

// d_table for D > MAX_D: the row splits' partials summed, the l2norm VJP
// (slab_dtable_finish); launched once a call
template <typename T>
__global__ void __launch_bounds__(NT) xent_bwd_finish_slab(
    const float* __restrict__ part, int n_split, const T* __restrict__ tab,
    const float* __restrict__ nrm, int P, int D, int normalize,
    T* __restrict__ dtab) {
  slab_dtable_finish<T>(part, n_split, tab, nrm, P, D, normalize, dtab);
}

// srt_xent_bwd_slots's numbers for the two product kernels of the slab path
template <typename T>
int slab_slots(int D, int* out) {
  int blocks[2], regs[2], local[2];
  const int err = slab_product_attrs<T>(D, blocks, regs, local);
  for (int k = 0; k < 2; ++k) {
    out[k] = blocks[k];
    out[3 + k] = regs[k];
    out[5 + k] = local[k];
  }
  return err;
}

// K2 for D > MAX_D: t normalised once, then per catalog chunk dz and the
// two products (slab_bwd_chunks), then d_table finished
template <typename T>
int bwd_slab(const float* g, const T* sr, const T* tab, const int* labels,
             const float* lse, int B, int P, int D, int n_valid,
             int col_offset, float scale, int normalize, int vec,
             int chunk_tiles, int t_split, int t_per, int s_per, T* that,
             float* nrm, T* dz, float* dtab_part, float* dsr_part,
             float* dsr, T* dtab, cudaStream_t stream) {
  const T* op = tab;
  cudaError_t err;
  if (normalize) {
    xent_bwd_normalize<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, that, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    op = that;
  }
  if constexpr (tc_type<T>) vec = tc_vec(vec, D, sr, op);
  const int smem = (int)dz_smem<T>();
  cudaFuncSetAttribute(xent_bwd_dz_slab<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int n_rows = (B + TILE - 1) / TILE;
  auto launch_dz = [&](int c0, int tiles, int ldz) {
    xent_bwd_dz_slab<T><<<dim3(n_rows, tiles), NT, smem, stream>>>(
        g, sr, op, labels, lse, B, P, D, n_valid, col_offset, scale, vec, c0,
        ldz, dz);
    return (int)cudaGetLastError();
  };
  const int e = slab_bwd_chunks<T>(launch_dz, sr, op, B, P, D, vec,
                                   chunk_tiles, t_split, t_per, s_per, dz,
                                   dtab_part, dsr_part, dsr, stream);
  if (e) return e;
  xent_bwd_finish_slab<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
      dtab_part, t_split, tab, nrm, P, D, normalize, dtab);
  return (int)cudaGetLastError();
}

template <typename T, bool HI>
int set_smem(int D) {
  const int smem = tc_type<T> ? (int)bwd_tc_smem(D) : (int)bwd_smem<T>(D);
  cudaFuncSetAttribute(dtable_kernel<T, HI>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(dsr_kernel<T, HI>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return smem;
}

// resident blocks per SM of the two product kernels (out[0], out[1]), their
// registers per thread (out[3], out[4]) and local memory per thread, where
// spills go (out[5], out[6])
template <typename T, bool HI>
int slots(int D, int* out) {
  const int smem = set_smem<T, HI>(D);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], dtable_kernel<T, HI>(), NT, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], dsr_kernel<T, HI>(),
                                                NT, smem);
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, dtable_kernel<T, HI>());
  out[3] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  cudaFuncGetAttributes(&a, dsr_kernel<T, HI>());
  out[4] = a.numRegs;
  out[6] = (int)a.localSizeBytes;
  return (int)cudaGetLastError();
}

template <typename T, bool HI>
int bwd(const float* g, const T* sr, const T* tab, const int* labels,
        const float* lse, int B, int P, int D, int n_valid, int col_offset,
        float scale, int normalize, int vec, int t_split,
        int chunks_per_split, int s_split, int tiles_per_split, T* that,
        float* nrm, float* dtab_part, float* dsr_part, float* dsr, T* dtab,
        cudaStream_t stream) {
  const int smem = set_smem<T, HI>(D);
  const T* op = tab;
  cudaError_t err;
  if (normalize) {
    xent_bwd_normalize<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, that, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    op = that;
  }
  if (tc_type<T>) vec = tc_vec(vec, D, sr, op);
  const int n_tiles = (P + TILE - 1) / TILE, n_rows = (B + TILE - 1) / TILE;
  float* part = t_split > 1 ? dtab_part : nullptr;
  const auto dtable = dtable_kernel<T, HI>();
  const auto dsr_product = dsr_kernel<T, HI>();
  dtable<<<dim3(n_tiles, t_split), NT, smem, stream>>>(
      g, sr, op, tab, nrm, labels, lse, B, P, D, n_valid, col_offset, scale,
      normalize, vec, chunks_per_split, part, dtab);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (part) {
    xent_bwd_dtable_reduce<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        part, t_split, tab, nrm, P, D, normalize, dtab);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  float* out = s_split > 1 ? dsr_part : dsr;
  dsr_product<<<dim3(n_rows, s_split), NT, smem, stream>>>(
      g, sr, op, labels, lse, B, P, D, n_valid, col_offset, scale, vec,
      tiles_per_split, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (s_split > 1) {
    const int n = B * D;
    xent_bwd_dsr_reduce<<<(n + NT - 1) / NT, NT, 0, stream>>>(dsr_part,
                                                              s_split, n, dsr);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* g, const void* sr, const void* tab,
              const void* labels, const void* lse, int B, int P, int D,
              int n_valid, int col_offset, float scale, int normalize,
              int vec, int t_split, int chunks_per_split, int s_split,
              int tiles_per_split, void* that, void* nrm, void* dtab_part,
              void* dsr_part, void* dsr, void* dtab, void* stream) {
  auto f = ((D + 3) & ~3) > 128 ? bwd<T, true> : bwd<T, false>;
  return f((const float*)g, (const T*)sr, (const T*)tab, (const int*)labels,
           (const float*)lse, B, P, D, n_valid, col_offset, scale, normalize,
           vec, t_split, chunks_per_split, s_split, tiles_per_split, (T*)that,
           (float*)nrm, (float*)dtab_part, (float*)dsr_part, (float*)dsr,
           (T*)dtab, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// rows of a K2 tile (catalog rows of d_table's blocks, batch rows of
// d_sr's), for the wrapper's grid
int srt_xent_bwd_tile() { return TILE; }

// out[0], out[1]: resident blocks per SM of the d_table and d_sr product
// kernels at width D on the current device; out[2]: its SM count; out[3],
// out[4]: the two kernels' registers per thread; out[5], out[6]: their
// local memory bytes per thread; out[7]: 1 where they run on the tensor
// cores (bfloat16, at every width), 0 on the FMA pipes
int srt_xent_bwd_slots(int D, int is_bf16, int* out) {
  out[7] = is_bf16 ? tc_type<__nv_bfloat16> : tc_type<float>;
  const bool hi = ((D + 3) & ~3) > 128;
  const int err = D > MAX_D ? (is_bf16 ? slab_slots<__nv_bfloat16>(D, out)
                                       : slab_slots<float>(D, out))
                  : is_bf16 ? (hi ? slots<__nv_bfloat16, true>(D, out)
                                  : slots<__nv_bfloat16, false>(D, out))
                            : (hi ? slots<float, true>(D, out)
                                  : slots<float, false>(D, out));
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  return (int)cudaGetLastError();
}

// K2 up to MAX_D features: d_sr [B, D] float32 and d_table [P, D] in the
// table's type.  Grid: d_table over t_split row splits of chunks_per_split
// 64-row chunks, d_sr over s_split catalog splits of tiles_per_split 64-row
// tiles.  Scratch: that [P, D] (table's type) and nrm [P] float32 when
// normalize; dtab_part [t_split, P, D] float32 when t_split > 1; dsr_part
// [s_split, B, D] float32 when s_split > 1.  vec: D % 4 == 0 and every
// array aligned to four elements.  Past MAX_D: srt_xent_bwd_slab.
int srt_xent_bwd(const void* g, const void* sr, const void* tab,
                 const void* labels, const void* lse, int B, int P, int D,
                 int n_valid, int col_offset, float scale, int normalize,
                 int is_bf16, int vec, int t_split, int chunks_per_split,
                 int s_split, int tiles_per_split, void* that, void* nrm,
                 void* dtab_part, void* dsr_part, void* dsr, void* dtab,
                 void* stream) {
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  auto f = is_bf16 ? bwd_typed<__nv_bfloat16> : bwd_typed<float>;
  return f(g, sr, tab, labels, lse, B, P, D, n_valid, col_offset, scale,
           normalize, vec, t_split, chunks_per_split, s_split,
           tiles_per_split, that, nrm, dtab_part, dsr_part, dsr, dtab,
           stream);
}

// K2 past MAX_D features: the same outputs through dz and three products
// (tiles.cuh's slab path).  The catalog goes in chunks of chunk_tiles 64-row
// tiles; d_table's product over t_split row splits of t_per 64-row tiles,
// d_sr's over catalog splits of s_per tiles of each chunk.  Scratch: that
// and nrm as srt_xent_bwd's; dz [round_up(B, 64), chunk_tiles * 64] in the
// table's type; dtab_part [t_split, P, D] float32; dsr_part [parts, B, D]
// float32 with parts the sum over chunks of ceil(tiles / s_per), when it
// is more than 1 (ops/xent.py:slab_bwd_plan).
int srt_xent_bwd_slab(const void* g, const void* sr, const void* tab,
                      const void* labels, const void* lse, int B, int P,
                      int D, int n_valid, int col_offset, float scale,
                      int normalize, int is_bf16, int vec, int chunk_tiles,
                      int t_split, int t_per, int s_per, void* that,
                      void* nrm, void* dz, void* dtab_part, void* dsr_part,
                      void* dsr, void* dtab, void* stream) {
  if (D <= MAX_D) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return bwd_slab((const float*)g, (const __nv_bfloat16*)sr,
                    (const __nv_bfloat16*)tab, (const int*)labels,
                    (const float*)lse, B, P, D, n_valid, col_offset, scale,
                    normalize, vec, chunk_tiles, t_split, t_per, s_per,
                    (__nv_bfloat16*)that, (float*)nrm, (__nv_bfloat16*)dz,
                    (float*)dtab_part, (float*)dsr_part, (float*)dsr,
                    (__nv_bfloat16*)dtab, (cudaStream_t)stream);
  return bwd_slab((const float*)g, (const float*)sr, (const float*)tab,
                  (const int*)labels, (const float*)lse, B, P, D, n_valid,
                  col_offset, scale, normalize, vec, chunk_tiles, t_split,
                  t_per, s_per, (float*)that, (float*)nrm, (float*)dz,
                  (float*)dtab_part, (float*)dsr_part, (float*)dsr,
                  (float*)dtab, (cudaStream_t)stream);
}

// out[0]: resident blocks per SM of K2's dz kernel past MAX_D features
// (xent_bwd_dz_slab) on the current device; out[1], out[2]: its registers
// and local memory bytes per thread
int srt_xent_bwd_dz_slots(int D, int is_bf16, int* out) {
  (void)D;
  if (is_bf16)
    kernel_attrs((const void*)xent_bwd_dz_slab<__nv_bfloat16>,
                 (int)dz_smem<__nv_bfloat16>(), &out[0], &out[1], &out[2]);
  else
    kernel_attrs((const void*)xent_bwd_dz_slab<float>, (int)dz_smem<float>(),
                 &out[0], &out[1], &out[2]);
  return (int)cudaGetLastError();
}

}  // extern "C"
