// K3 and K4: the fused multi-order REnorm / fusion catalog loss, for Hopper
// (sm_90a).
//
// Replaces the two Pallas TPU kernels of sessionrec_tpu/ops/xent_multi.py:
//   K3  _fwd_kernel (xent_multi.py:57)  -> xent_table_norms
//                                          + xent_multi_fwd_partial
//                                          + xent_multi_fwd_merge
//   K4  _bwd_kernel (xent_multi.py:157) -> xent_bwd_normalize
//                                          + xent_multi_bwd_dtable
//                                          (+ xent_bwd_dtable_reduce)
//                                          + xent_multi_bwd_dsr
//                                          (+ xent_bwd_dsr_reduce),
//                                          in bfloat16 the _tc kernels
// and past 256 features the slab path of tiles.cuh: K3 xent_multi_fwd_slab
// in place of the partial kernel; K4 xent_multi_bwd_dz_slab (dz once) +
// xent_slab_dtable + xent_slab_dsr (in bfloat16 their _tc kernels)
// (+ xent_bwd_dsr_reduce) + xent_multi_bwd_finish_slab in place of the
// product kernels.
//
// The WSDM'22 paper head scores the session vector of every order k
// against the whole catalog and splits the catalog, per example, into the
// session's own items and the rest (REnorm).  Its loss needs five numbers
// per (order, row): (m_in, s_in) and (m_ex, s_ex), the running max and
// sum-exp of z = scale * sr_k . t over the in-session and the other
// columns, and zl, the label's logit.  The backward pass turns their
// cotangents into
//   dz = round_op((gin * p_in + gex * p_ex + gz * onehot(label)) * scale),
// p_in = exp(z - lse_in) on in-session live columns, p_ex = exp(z - lse_ex)
// on the other live columns, and then d_sr_k = dz_k @ t (float32) and
// d_table = l2norm-VJP(sum_k dz_k^T @ sr_k) (the table's type).  As the JAX
// kernels do, K3 divides the raw table's logits by the clamped row norms n,
// and K4 scores against t = round_op(table / n), the operand K2 streams.
// None of the kernels stores the [K, B, P] logits or the [B, P] session
// mask.
//
// What bounds it.  K3 performs 2*R*P*D operations and K4 three times as
// many (R = K*B rows) on (R + P)*D elements: at the paper path's shapes
// (K = 3, B = 512, D = 256, P = 3,584 to 37,888) about 770 operations a
// float32 byte, far above the card's 20 (67 TFLOP/s over 3.35 TB/s), and
// 1,540 a bfloat16 byte, far above its 295 (989 TFLOP/s on the tensor
// cores), so both are bound by operations: float32 on the FP32 FMA pipes
// (TF32 would change the numerics), bfloat16 on the tensor cores at every
// width (K3 through K1's loops, K4 through K2's products, below).
// K4 performs four products where its bound counts three (the logits are
// recomputed for each output, as in K2, xent_bwd.cu), so its ceiling is
// 75% of its bound.
//
// What the design does about it (K2's tiles, tiles.cuh):
//   * K folds into the row axis.  sr3 [K, B, D] is read as R = K*B rows,
//     row r = k*B + b taking label b and iid list b, so every order shares
//     each staged catalog tile.
//   * The table is normalised once per call.  K3 takes the clamped norms
//     (xent_table_norms) and divides each logit by its column's; K4 streams
//     t from xent_bwd_normalize, as K2 does.  The first design normalised
//     every catalog tile again in every block that staged it.
//   * float32: register-tiled products.  A 64 x 64 logits tile is 4 x 4
//     outputs a thread (product_logits); K4's accumulations d_table +=
//     dz^T sr and d_sr += dz t are 8 x 8 a thread (rank_update), with dz
//     in shared memory as [row][col] for d_table and as [col][row] for
//     d_sr.
//   * bfloat16 up to MAX_D: every product on the tensor cores (mma.sync
//     m16n8k16 from ldmatrix, float32 sums, tiles of stride round_up(D,
//     16) + 8).  K3's loop is fwd_tile_loop (tiles.cuh), which K1 runs
//     without membership: its logits come from product_logits_tc and a
//     row's membership bits are read at its fragment's columns.  K4's
//     xent_multi_bwd_dtable_tc and xent_multi_bwd_dsr_tc are K2's tensor-
//     core products over the R rows: the logits tile from
//     product_logits_tc, its dz (dz_multi_tile_tc: each column of a lane's
//     pair with its own membership bit, the row's inputs read from shared
//     memory each tile) rounded to bfloat16 as the JAX kernel feeds its
//     matrix unit (exact) into a bfloat16 [row][col] tile, and
//     rank_update_tc's accumulations.  Their tiles, dz tile and rows'
//     inputs take 110 KB at D = 256: two blocks an SM, as K3's.
//   * Asynchronous, double-buffered staging: the streamed operand's next
//     64-row tile arrives by cp.async while the current one is used
//     (float32 four elements, bfloat16 eight, 16 bytes a copy).
//   * Membership as bits.  While a tile stages, four threads per row scan
//     the row's iid list (global ids, -1 padded, any length) and OR a
//     64-bit mask over the tile's 64 columns, so a column's test is a
//     shift.  K4's six per-row inputs (gz, gin, gex, lse_in, lse_ex,
//     label) sit in shared memory beside the masks, not in registers.
//   * A grid from the card's resident slots (ops/xent.py:_bwd_grid, at R
//     rows).  K3 and K4's d_sr run over 64-row tiles of the R rows and
//     catalog splits; K4's d_table over catalog tiles and row splits.  K3's
//     splits merge their five stats in xent_multi_fwd_merge (each (m, s)
//     pair as a log-sum-exp, zl summed), K4's in fixed-order reduces
//     (xent_bwd_dtable_reduce applies the l2norm VJP once, after the sum).
//     No atomics: two calls on the same inputs give the same bits.
//   * Empty partitions stay finite: a row with no session item, or a tile
//     with no in-session column, carries m = NEG_INF and s = 0; every
//     rescale uses m_safe = max(m, NEG_INF / 2), so exp(NEG_INF - m_safe)
//     is 0, never NaN.  K4 takes p_in only on member & live columns and
//     p_ex only on the others, each against max(lse, NEG_INF / 2).
//
// Interface.  As the JAX kernels take them for the catalog-sharded path:
// n_valid (local columns at or past it are masked), col_offset (the global
// id of the table's first row: membership compares col_offset + j with the
// global iids), and labels localised to the table (-1 matches no column).
// The wrapper chooses the grids (ops/xent_multi.py) from
// srt_xent_multi_slots.  Any K, B >= 1, P >= 1, D >= 1, Ns >= 1: with
// D % 4 == 0 and aligned arrays the tiles are staged by cp.async
// (bfloat16, at every width: D % 8 == 0 and 16-byte aligned arrays),
// otherwise by plain loads.  Past D = MAX_D (256) K3 runs
// xent_multi_fwd_slab (fwd_slab_loop with membership: the split's catalog
// tiles in k-chunks of 64 features through a ring of cp.async stages, two
// blocks an SM; in bfloat16 four stages on the tensor cores,
// fwd_slab_loop_tc), and K4
// srt_xent_multi_bwd_slab, the slab path of tiles.cuh as K2 runs it
// (xent_bwd.cu): dz once, where a block per output slab that recomputed
// the full-width logits would run 2 (slabs + 1) products of 2 R P D
// operations and the bound counts 3 (at D = 512, R = 1,536 and the north
// star, 3 * 2 R P D = 178.9 GFLOP, 2.64 ms at the FP32 peak).
// xent_multi_bwd_dz_slab builds a block's masks and row inputs while its
// first k-chunk stages, computes its logits tile once over all D features
// and writes dz (dlogits_multi, rounded to the operand type; in bfloat16
// the logits on the tensor cores, dz_logits_tc, and the tile through
// shared memory, dz_multi_tile_tc) to the chunk's [R, P] scratch; K2's two
// products (xent_slab_dtable, xent_slab_dsr; in bfloat16 their _tc
// kernels on the tensor cores) run over it, and xent_multi_bwd_finish_slab
// applies the l2norm VJP over the whole row.  3 * 2 R P D operations in all; dz adds
// 3 R P elements to the bytes moved (699 MB in float32 at the north star,
// 0.21 ms at 3.35 TB/s, 8% of the bound), in one chunk up to
// DZ_SCRATCH_BYTES (ops/xent.py).  Each entry point launches on the given
// stream, does not synchronise and returns cudaGetLastError().

#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3, forward: partial two-partition online log-sum-exp over one catalog
// split (fwd_tile_loop with membership, tiles.cuh).  grid = (row tiles,
// catalog splits); part holds [5][n_split][R] floats: m_in, s_in, m_ex,
// s_ex, zl.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, tile_blocks<T>())
    xent_multi_fwd_partial(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_tile_loop<T, true>(smem, sr, tab, nrm, labels, iids, R, B, P, D, Ns,
                         n_valid, col_offset, scale, normalize, vec,
                         tiles_per_split, part);
}

// K3 for D > MAX_D: the same partial, its (catalog tile, k-chunk) pairs
// one pipelined stream (fwd_slab_loop: on the tensor cores in bfloat16),
// two blocks an SM
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_multi_fwd_slab(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int tiles_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_slab_loop<T, true>(smem, sr, tab, nrm, labels, iids, R, B, P, D, Ns,
                         n_valid, col_offset, scale, normalize, vec,
                         tiles_per_split, part);
}

// K3, merge: out [5][R] = (m_in, s_in, m_ex, s_ex, zl) over the whole
// catalog from the splits' partials
__global__ void xent_multi_fwd_merge(const float* __restrict__ part,
                                     int n_split, int R,
                                     float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t plane = (size_t)n_split * R;
  for (int q = 0; q < 2; ++q) {
    const float* m_p = part + 2 * q * plane;
    const float* s_p = m_p + plane;
    float m = NEG_INF, s = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      lse_merge(m, s, m_p[(size_t)sp * R + r], s_p[(size_t)sp * R + r]);
    out[2 * q * R + r] = m;
    out[(2 * q + 1) * R + r] = s;
  }
  float zg = 0.f;
  for (int sp = 0; sp < n_split; ++sp) zg += part[4 * plane + (size_t)sp * R + r];
  out[4 * R + r] = zg;
}

// K4's per-row inputs of a block's TILE rows, in shared memory beside the
// masks: coef[q][i] = (gz, gin, gex, lse_in, lse_ex)[q] of row row0 + i,
// the log-partitions guarded by max(., NEG_INF / 2), and its label; g5 is
// [5][R] = (gz, gin, gex, lse_in, lse_ex)
struct RowShared {
  unsigned long long mask[TILE];
  float coef[5][TILE];
  int lbl[TILE];
};

__device__ __forceinline__ void row_coefs(RowShared* rs,
                                          const float* __restrict__ g5,
                                          const int* __restrict__ labels,
                                          int row0, int R, int B) {
  const int i = threadIdx.x;
  if (i >= TILE) return;
  const int r = row0 + i;
  const bool ok = r < R;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float v = ok ? g5[(size_t)q * R + r] : 0.f;
    rs->coef[q][i] = q >= 3 ? fmaxf(v, NEG_INF * 0.5f) : v;
  }
  rs->lbl[i] = ok ? labels[r % B] : -1;
}

// one row's inputs, read from RowShared where a tile's dz needs them
struct RowIn {
  float gz, gin, gex, lin, lex;
  int lbl;
  unsigned long long bits;
};

__device__ __forceinline__ RowIn row_in(const RowShared* rs, int i) {
  return {rs->coef[0][i], rs->coef[1][i], rs->coef[2][i], rs->coef[3][i],
          rs->coef[4][i], rs->lbl[i],     rs->mask[i]};
}

// dz of one logit S at tile column c (local column col) of a row with
// inputs in: p_in on member & live columns, p_ex on the other live ones,
// the label's one-hot; 0 on rows past R and columns past P
template <typename T>
__device__ __forceinline__ float dlogit_multi(float S, int c, int col,
                                              const RowIn& in, bool row_ok,
                                              int P, int n_valid,
                                              float scale) {
  float acc = 0.f;
  if (col < n_valid) {
    const bool member = (in.bits >> c) & 1ull;
    acc = (member ? in.gin : in.gex) *
          expf(scale * S - (member ? in.lin : in.lex));
  }
  if (col == in.lbl) acc += in.gz;
  return row_ok && col < P ? round_op<T>(acc * scale) : 0.f;
}

// dz of tile row i at its four columns tx + 16 j (j < 4) of a tile that
// starts at local column p0, from the logits S[j] of that row
template <typename T>
__device__ __forceinline__ void dlogits_multi(float (&dz)[4],
                                              const float (&S)[4],
                                              const RowShared* rs, int i,
                                              bool row_ok, int p0, int P,
                                              int n_valid, float scale) {
  const int tx = threadIdx.x & 15;
  const RowIn in = row_in(rs, i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    dz[j] = dlogit_multi<T>(S[j], c, p0 + c, in, row_ok, P, n_valid, scale);
  }
}

// dz of the logits tile S (product_logits_tc's layout) of rows [r0, r0 +
// TILE) of the R and catalog columns [p0, p0 + TILE), into dz_s
// [TILE][LDZB] as bfloat16 pairs, in K2's lane mapping (xent_bwd.cu,
// dz_tile_tc): lane l of warp w takes rows rb = 16 (w >> 1) + l / 4 and
// rb + 8, columns cb + 8 f + {0, 1} (f < 4), cb = 32 (w & 1) + 2 (l % 4).
// Each row's inputs come from RowShared each tile, not from registers, and
// each column of a pair takes its own membership bit.
__device__ __forceinline__ void dz_multi_tile_tc(__nv_bfloat16* dz_s,
                                                 const float (&S)[4][4],
                                                 const RowShared* rs, int r0,
                                                 int R, int p0, int P,
                                                 int n_valid, float scale) {
  typedef __nv_bfloat16 T;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int rb = 16 * (w >> 1) + (l >> 2), cb = 32 * (w & 1) + 2 * (l & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = rb + 8 * h;
    const bool row_ok = r0 + rl < R;
    const RowIn in = row_in(rs, rl);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int cl = cb + 8 * f;
      const float d0 = dlogit_multi<T>(S[f][2 * h], cl, p0 + cl, in, row_ok,
                                       P, n_valid, scale);
      const float d1 = dlogit_multi<T>(S[f][2 * h + 1], cl + 1, p0 + cl + 1,
                                       in, row_ok, P, n_valid, scale);
      *reinterpret_cast<__nv_bfloat162*>(dz_s + rl * LDZB + cl) =
          __floats2bfloat162_rn(d0, d1);
    }
  }
}

// shared memory of a K4 block: K2's three tiles and dz tile (at the tensor
// cores' stride in bfloat16), and the rows' masks and inputs
template <typename T>
size_t bwd_multi_smem(int D) {
  return (tc_type<T> ? bwd_tc_smem(D) : bwd_smem<T>(D)) + sizeof(RowShared);
}

// ---------------------------------------------------------------------------
// K4, d_table: grid = (catalog tiles, row splits).  A block stages its
// 64-row tile of t once and streams the R rows of its split in 64-row
// chunks (double-buffered), building each chunk's masks and inputs while
// it stages; it recomputes each 64 x 64 dz tile and accumulates
// G = dz^T sr in registers (warp w owns catalog rows 8 w .. 8 w + 7).  With
// part, it writes G as the split's float32 partial; otherwise d_table.
// ---------------------------------------------------------------------------
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, 1) xent_multi_bwd_dtable(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ op, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int chunks_per_split, float* __restrict__ part, T* __restrict__ dtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld(D), D4 = (D + 3) & ~3;
  T* C_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] t rows
  T* A_s = C_s + TILE * ld;                            // [2][TILE][ld] sr
  float* dz_s = reinterpret_cast<float*>(A_s + 2 * TILE * ld);  // [row][col]
  RowShared* rs = reinterpret_cast<RowShared*>(dz_s + TILE * LDZ);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.x * TILE;
  const int n_chunks = (R + TILE - 1) / TILE;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  stage_tile(C_s, ld, op, p0, P, D, vec);
  stage_tile(A_s, ld, sr, c_begin * TILE, R, D, vec);
  cp_async_commit();

  float G[8][8] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const T* A = A_s + buf * TILE * ld;
    const int row0 = c * TILE;
    if (c + 1 < c_end)
      stage_tile(A_s + (buf ^ 1) * TILE * ld, ld, sr, (c + 1) * TILE, R, D,
                 vec);
    cp_async_commit();
    row_masks(rs->mask, iids, row0, R, B, Ns, col_offset + p0);
    row_coefs(rs, g5, labels, row0, R, B);
    cp_async_wait<1>();  // this chunk (and the tile) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits(S, A, C_s, ld, D4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      float dz[4];
      dlogits_multi<T>(dz, S[i], rs, rl, row0 + rl < R, p0, P, n_valid,
                       scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) dz_s[rl * LDZ + tx + 16 * j] = dz[j];
    }
    __syncthreads();
    rank_update<T, HI>(G, dz_s, A, ld);
    __syncthreads();  // A, dz_s and the rows' inputs are consumed
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
// K4, d_sr: grid = (row tiles, catalog splits).  A block stages its 64
// rows and their inputs once and streams the catalog tiles of its split
// (double-buffered), building each tile's masks while it stages; it
// recomputes each 64 x 64 dz tile and accumulates dz t in registers (warp
// w owns rows 8 w .. 8 w + 7), and writes its split's partial to out
// (d_sr itself when there is one split).
// ---------------------------------------------------------------------------
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, 1) xent_multi_bwd_dsr(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int vec, int tiles_per_split,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld(D), D4 = (D + 3) & ~3;
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] t
  float* dz_s = reinterpret_cast<float*>(C_s + 2 * TILE * ld);  // [col][row]
  RowShared* rs = reinterpret_cast<RowShared*>(dz_s + TILE * LDZ);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  stage_tile(A_s, ld, sr, row0, R, D, vec);
  stage_tile(C_s, ld, op, t_begin * TILE, P, D, vec);
  cp_async_commit();
  row_coefs(rs, g5, labels, row0, R, B);

  float acc[8][8] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    const int p0 = t * TILE;
    if (t + 1 < t_end)
      stage_tile(C_s + (buf ^ 1) * TILE * ld, ld, op, (t + 1) * TILE, P, D,
                 vec);
    cp_async_commit();
    row_masks(rs->mask, iids, row0, R, B, Ns, col_offset + p0);
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits(S, A_s, C, ld, D4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      float dz[4];
      dlogits_multi<T>(dz, S[i], rs, rl, row0 + rl < R, p0, P, n_valid,
                       scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) dz_s[(tx + 16 * j) * LDZ + rl] = dz[j];
    }
    __syncthreads();
    rank_update<T, HI>(acc, dz_s, C, ld);
    __syncthreads();  // C, dz_s and the masks are consumed
  }

  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * w + i;
    if (r < R) store_row8(out + ((size_t)blockIdx.y * R + r) * D, acc[i], D);
  }
}

// ---------------------------------------------------------------------------
// K4's two product kernels in bfloat16 up to MAX_D, on the tensor cores:
// the grids, staging order and outputs of xent_multi_bwd_dtable and
// xent_multi_bwd_dsr, and K2's products (xent_bwd.cu, xent_bwd_dtable_tc
// and xent_bwd_dsr_tc).  Each logits tile comes from product_logits_tc,
// its dz (dz_multi_tile_tc, from the rows' masks and inputs in RowShared)
// goes to dz_s [row][col] as bfloat16, and rank_update_tc accumulates;
// the accumulators go through shared memory (the tiles', once consumed)
// to the rows' stores.  NPW: feature pairs a warp (4 past 128 features,
// else 2).
// ---------------------------------------------------------------------------
template <typename T, bool HI>
__global__ void __launch_bounds__(NT, tile_blocks<T>())
    xent_multi_bwd_dtable_tc(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ op, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize, int vec,
    int chunks_per_split, float* __restrict__ part, T* __restrict__ dtab) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  constexpr int NPW = HI ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_ld(D), kp = tc_kp(D), np = kp / 16;
  T* C_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] t rows
  T* A_s = C_s + TILE * ld;                            // [2][TILE][ld] sr
  T* dz_s = A_s + 2 * TILE * ld;                       // [TILE][LDZB]
  RowShared* rs = reinterpret_cast<RowShared*>(dz_s + TILE * LDZB);
  const int w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * TILE;
  const int n_chunks = (R + TILE - 1) / TILE;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  stage_tile_tc(C_s, ld, op, p0, P, D, vec);
  stage_tile_tc(A_s, ld, sr, c_begin * TILE, R, D, vec);
  cp_async_commit();

  float G[2][2 * NPW][4] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const T* A = A_s + buf * TILE * ld;
    const int row0 = c * TILE;
    if (c + 1 < c_end)
      stage_tile_tc(A_s + (buf ^ 1) * TILE * ld, ld, sr, (c + 1) * TILE, R,
                    D, vec);
    cp_async_commit();
    row_masks(rs->mask, iids, row0, R, B, Ns, col_offset + p0);
    row_coefs(rs, g5, labels, row0, R, B);
    cp_async_wait<1>();  // this chunk (and the tile) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits_tc(S, A, C_s, ld, kp);
    dz_multi_tile_tc(dz_s, S, rs, row0, R, p0, P, n_valid, scale);
    __syncthreads();
    rank_update_tc<NPW, true>(G, dz_s, LDZB, A, ld, np);
    __syncthreads();  // A, dz_s and the rows' inputs are consumed
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
__global__ void __launch_bounds__(NT, tile_blocks<T>()) xent_multi_bwd_dsr_tc(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int vec, int tiles_per_split,
    float* __restrict__ out) {
  static_assert(tc_type<T>, "the tensor-core kernels take bfloat16");
  constexpr int NPW = HI ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tc_ld(D), kp = tc_kp(D), np = kp / 16;
  T* A_s = reinterpret_cast<T*>(smem);                 // [TILE][ld] sr rows
  T* C_s = A_s + TILE * ld;                            // [2][TILE][ld] t
  T* dz_s = C_s + 2 * TILE * ld;                       // [TILE][LDZB]
  RowShared* rs = reinterpret_cast<RowShared*>(dz_s + TILE * LDZB);
  const int w = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TILE;
  const int n_tiles = (P + TILE - 1) / TILE;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  stage_tile_tc(A_s, ld, sr, row0, R, D, vec);
  stage_tile_tc(C_s, ld, op, t_begin * TILE, P, D, vec);
  cp_async_commit();
  row_coefs(rs, g5, labels, row0, R, B);

  float acc[2][2 * NPW][4] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const T* C = C_s + buf * TILE * ld;
    const int p0 = t * TILE;
    if (t + 1 < t_end)
      stage_tile_tc(C_s + (buf ^ 1) * TILE * ld, ld, op, (t + 1) * TILE, P,
                    D, vec);
    cp_async_commit();
    row_masks(rs->mask, iids, row0, R, B, Ns, col_offset + p0);
    cp_async_wait<1>();  // this tile (and the rows) have landed
    __syncthreads();
    float S[4][4] = {};
    product_logits_tc(S, A_s, C, ld, kp);
    dz_multi_tile_tc(dz_s, S, rs, row0, R, p0, P, n_valid, scale);
    __syncthreads();
    rank_update_tc<NPW, false>(acc, dz_s, LDZB, C, ld, np);
    __syncthreads();  // C, dz_s and the masks are consumed
  }

  cp_async_wait<0>();
  float* acc_s = reinterpret_cast<float*>(smem);       // [TILE][kp + 8]
  store_acc_tc<NPW>(acc_s, kp + 8, acc, np);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * w + i;
    if (r >= R) continue;  // warp-uniform
    float v[8];
    load_row8(v, acc_s + (8 * w + i) * (kp + 8), D);
    store_row8(out + ((size_t)blockIdx.y * R + r) * D, v, D);
  }
}

// K4's two product kernels at D <= MAX_D in type T: on the tensor cores in
// bfloat16, on the FMA pipes in float32
template <typename T, bool HI>
auto dtable_kernel() {
  if constexpr (tc_type<T>) return xent_multi_bwd_dtable_tc<T, HI>;
  else return xent_multi_bwd_dtable<T, HI>;
}
template <typename T, bool HI>
auto dsr_kernel() {
  if constexpr (tc_type<T>) return xent_multi_bwd_dsr_tc<T, HI>;
  else return xent_multi_bwd_dsr<T, HI>;
}

// ---------------------------------------------------------------------------
// K4, dz for D > MAX_D: grid = (64-row tiles of the R rows, 64-row catalog
// tiles of the chunk that starts at table row c0).  A block builds its rows'
// masks and inputs (RowShared, after the chunk stages) while the first
// k-chunk stages, computes its logits tile once over all D features and
// writes its dz tile, rounded to the operand type, to dz [rows * 64][ldz]
// at the chunk's columns; rows past R and columns past P get 0.  float32:
// dz_logits on the FMA pipes, a thread's 4 x 4 dz stored where it lies.
// bfloat16: dz_logits_tc on the tensor cores, the tile by dz_multi_tile_tc
// into shared memory (the consumed stages), then out in 16-byte stores
// (store_dz_tc).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_multi_bwd_dz_slab(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ op, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int vec, int c0, int ldz,
    T* __restrict__ dz) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowShared* rs = reinterpret_cast<RowShared*>(smem + dz_smem<T>());
  const int row0 = blockIdx.x * TILE, q0 = blockIdx.y * TILE;
  const int p0 = c0 + q0;
  row_coefs(rs, g5, labels, row0, R, B);
  row_masks(rs->mask, iids, row0, R, B, Ns, col_offset + p0);
  float S[4][4] = {};
  // its first barrier publishes the masks and inputs
  if constexpr (tc_type<T>) {
    T* stages = reinterpret_cast<T*>(smem);
    dz_logits_tc(S, stages, sr, row0, R, op, p0, P, D, vec);
    dz_multi_tile_tc(stages, S, rs, row0, R, p0, P, n_valid, scale);
    __syncthreads();
    store_dz_tc(dz, ldz, row0, q0, stages);
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    dz_logits(S, reinterpret_cast<T*>(smem), sr, row0, R, op, p0, P, D,
              vec);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      float d[4];
      dlogits_multi<T>(d, S[i], rs, rl, row0 + rl < R, p0, P, n_valid,
                       scale);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dz[(size_t)(row0 + rl) * ldz + q0 + tx + 16 * j] = from_f<T>(d[j]);
    }
  }
}

// K4's d_table for D > MAX_D: the row splits' partials summed, the l2norm
// VJP (slab_dtable_finish); launched once a call
template <typename T>
__global__ void __launch_bounds__(NT) xent_multi_bwd_finish_slab(
    const float* __restrict__ part, int n_split, const T* __restrict__ tab,
    const float* __restrict__ nrm, int P, int D, int normalize,
    T* __restrict__ dtab) {
  slab_dtable_finish<T>(part, n_split, tab, nrm, P, D, normalize, dtab);
}

template <typename T>
constexpr size_t dz_multi_smem() {
  return dz_smem<T>() + sizeof(RowShared);
}

// K3's partial kernel at width D (the slab kernel past MAX_D)
template <typename T>
const void* fwd_kernel(int D) {
  return D > MAX_D ? (const void*)xent_multi_fwd_slab<T>
                   : (const void*)xent_multi_fwd_partial<T>;
}

template <typename T>
int set_fwd_smem(int D) {
  const int smem = D > MAX_D ? (int)fwd_slab_smem<T, true>()
                             : (int)fwd_smem<T, true>(D);
  cudaFuncSetAttribute(fwd_kernel<T>(D),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return smem;
}

template <typename T, bool HI>
int set_bwd_smem(int D) {
  const int smem = (int)bwd_multi_smem<T>(D);
  cudaFuncSetAttribute(dtable_kernel<T, HI>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(dsr_kernel<T, HI>(),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return smem;
}

// resident blocks per SM of the three product kernels (K3's partial, K4's
// d_table and d_sr, past MAX_D its two slab products: out[0..2]), their
// registers per thread (out[4..6]) and their local memory bytes per thread,
// where spills go (out[7..9]); K3's dynamic shared memory bytes (out[10]),
// the stages its staging pipelines (out[11]: the table tiles' two buffers
// up to MAX_D, the chunk ring's three or four past it), and whether K3's
// product (out[12]) and K4's (out[13]) run on the tensor cores (bfloat16,
// at every width)
template <typename T, bool HI>
int slots(int D, int* out) {
  const int fwd = set_fwd_smem<T>(D);
  kernel_attrs(fwd_kernel<T>(D), fwd, &out[0], &out[4], &out[7]);
  out[10] = fwd;
  out[11] = D > MAX_D ? fwd_stages<T>() : 2;
  out[12] = out[13] = tc_type<T>;
  if (D > MAX_D) {
    int blocks[2], regs[2], local[2];
    slab_product_attrs<T>(D, blocks, regs, local);
    for (int k = 0; k < 2; ++k) {
      out[1 + k] = blocks[k];
      out[5 + k] = regs[k];
      out[8 + k] = local[k];
    }
    return (int)cudaGetLastError();
  }
  const int bwd = set_bwd_smem<T, HI>(D);
  const void* fns[2] = {(const void*)dtable_kernel<T, HI>(),
                        (const void*)dsr_kernel<T, HI>()};
  for (int k = 0; k < 2; ++k)
    kernel_attrs(fns[k], bwd, &out[1 + k], &out[5 + k], &out[8 + k]);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* sr, const T* tab, const int* labels, const int* iids, int K,
        int B, int P, int D, int Ns, int n_valid, int col_offset, float scale,
        int normalize, int vec, int n_split, int tiles_per_split, float* nrm,
        float* part, float* out, cudaStream_t stream) {
  const int R = K * B;
  const int smem = set_fwd_smem<T>(D);
  cudaError_t err;
  if (normalize) {
    xent_table_norms<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (tc_type<T>) vec = tc_vec(vec, D, sr, tab);
  dim3 grid((R + TILE - 1) / TILE, n_split);
  if (D > MAX_D)
    xent_multi_fwd_slab<T><<<grid, NT, smem, stream>>>(
        sr, tab, nrm, labels, iids, R, B, P, D, Ns, n_valid, col_offset,
        scale, normalize, vec, tiles_per_split, part);
  else
    xent_multi_fwd_partial<T><<<grid, NT, smem, stream>>>(
        sr, tab, nrm, labels, iids, R, B, P, D, Ns, n_valid, col_offset,
        scale, normalize, vec, tiles_per_split, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  xent_multi_fwd_merge<<<(R + NT - 1) / NT, NT, 0, stream>>>(part, n_split,
                                                             R, out);
  return (int)cudaGetLastError();
}

template <typename T, bool HI>
int bwd(const float* g5, const T* sr, const T* tab, const int* labels,
        const int* iids, int K, int B, int P, int D, int Ns, int n_valid,
        int col_offset, float scale, int normalize, int vec, int t_split,
        int chunks_per_split, int s_split, int tiles_per_split, T* that,
        float* nrm, float* dtab_part, float* dsr_part, float* dsr, T* dtab,
        cudaStream_t stream) {
  const int R = K * B;
  const int smem = set_bwd_smem<T, HI>(D);
  const T* op = tab;
  cudaError_t err;
  if (normalize) {
    xent_bwd_normalize<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, that, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    op = that;
  }
  if (tc_type<T>) vec = tc_vec(vec, D, sr, op);
  const int n_tiles = (P + TILE - 1) / TILE, n_rows = (R + TILE - 1) / TILE;
  float* part = t_split > 1 ? dtab_part : nullptr;
  const auto dtable = dtable_kernel<T, HI>();
  const auto dsr_product = dsr_kernel<T, HI>();
  dtable<<<dim3(n_tiles, t_split), NT, smem, stream>>>(
      g5, sr, op, tab, nrm, labels, iids, R, B, P, D, Ns, n_valid,
      col_offset, scale, normalize, vec, chunks_per_split, part, dtab);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (part) {
    xent_bwd_dtable_reduce<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        part, t_split, tab, nrm, P, D, normalize, dtab);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  float* out = s_split > 1 ? dsr_part : dsr;
  dsr_product<<<dim3(n_rows, s_split), NT, smem, stream>>>(
      g5, sr, op, labels, iids, R, B, P, D, Ns, n_valid, col_offset, scale,
      vec, tiles_per_split, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (s_split > 1) {
    const int n = R * D;
    xent_bwd_dsr_reduce<<<(n + NT - 1) / NT, NT, 0, stream>>>(dsr_part,
                                                              s_split, n, dsr);
  }
  return (int)cudaGetLastError();
}

// K4 for D > MAX_D: t normalised once, then per catalog chunk dz and the
// two products (slab_bwd_chunks), then d_table finished
template <typename T>
int bwd_slab(const float* g5, const T* sr, const T* tab, const int* labels,
             const int* iids, int K, int B, int P, int D, int Ns, int n_valid,
             int col_offset, float scale, int normalize, int vec,
             int chunk_tiles, int t_split, int t_per, int s_per, T* that,
             float* nrm, T* dz, float* dtab_part, float* dsr_part,
             float* dsr, T* dtab, cudaStream_t stream) {
  const int R = K * B;
  const T* op = tab;
  cudaError_t err;
  if (normalize) {
    xent_bwd_normalize<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, that, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    op = that;
  }
  if constexpr (tc_type<T>) vec = tc_vec(vec, D, sr, op);
  const int smem = (int)dz_multi_smem<T>();
  cudaFuncSetAttribute(xent_multi_bwd_dz_slab<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int n_rows = (R + TILE - 1) / TILE;
  auto launch_dz = [&](int c0, int tiles, int ldz) {
    xent_multi_bwd_dz_slab<T><<<dim3(n_rows, tiles), NT, smem, stream>>>(
        g5, sr, op, labels, iids, R, B, P, D, Ns, n_valid, col_offset, scale,
        vec, c0, ldz, dz);
    return (int)cudaGetLastError();
  };
  const int e = slab_bwd_chunks<T>(launch_dz, sr, op, R, P, D, vec,
                                   chunk_tiles, t_split, t_per, s_per, dz,
                                   dtab_part, dsr_part, dsr, stream);
  if (e) return e;
  xent_multi_bwd_finish_slab<T>
      <<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
          dtab_part, t_split, tab, nrm, P, D, normalize, dtab);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_typed(const void* g5, const void* sr, const void* tab,
              const void* labels, const void* iids, int K, int B, int P,
              int D, int Ns, int n_valid, int col_offset, float scale,
              int normalize, int vec, int t_split, int chunks_per_split,
              int s_split, int tiles_per_split, void* that, void* nrm,
              void* dtab_part, void* dsr_part, void* dsr, void* dtab,
              void* stream) {
  auto f = ((D + 3) & ~3) > 128 ? bwd<T, true> : bwd<T, false>;
  return f((const float*)g5, (const T*)sr, (const T*)tab, (const int*)labels,
           (const int*)iids, K, B, P, D, Ns, n_valid, col_offset, scale,
           normalize, vec, t_split, chunks_per_split, s_split,
           tiles_per_split, (T*)that, (float*)nrm, (float*)dtab_part,
           (float*)dsr_part, (float*)dsr, (T*)dtab, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// out[0..2]: resident blocks per SM of K3's partial kernel and K4's d_table
// and d_sr kernels (past MAX_D the slab products) at width D on the current
// device; out[3]: its SM count;
// out[4..6]: the three kernels' registers per thread; out[7..9]: their
// local memory bytes per thread; out[10], out[11]: K3's dynamic shared
// memory bytes and staging stages; out[12], out[13]: 1 where K3's and
// K4's products run on the tensor cores (bfloat16, at every width), 0 on
// the FMA pipes
int srt_xent_multi_slots(int D, int is_bf16, int* out) {
  const bool hi = ((D + 3) & ~3) > 128;
  const int err = is_bf16 ? (hi ? slots<__nv_bfloat16, true>(D, out)
                                : slots<__nv_bfloat16, false>(D, out))
                          : (hi ? slots<float, true>(D, out)
                                : slots<float, false>(D, out));
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  return (int)cudaGetLastError();
}

// K3: out [5][K*B] floats = (m_in, s_in, m_ex, s_ex, zl).  Grid: 64-row
// tiles of the K*B rows times n_split catalog splits of tiles_per_split
// 64-row tiles.  Scratch: nrm [P] float32 when normalize; part
// [5][n_split][K*B] float32.  vec: D % 4 == 0 and every array aligned to
// four elements.
int srt_xent_multi_fwd(const void* sr, const void* tab, const void* labels,
                       const void* iids, int K, int B, int P, int D, int Ns,
                       int n_valid, int col_offset, float scale,
                       int normalize, int is_bf16, int vec, int n_split,
                       int tiles_per_split, void* nrm, void* part, void* out,
                       void* stream) {
  if (is_bf16)
    return fwd((const __nv_bfloat16*)sr, (const __nv_bfloat16*)tab,
               (const int*)labels, (const int*)iids, K, B, P, D, Ns, n_valid,
               col_offset, scale, normalize, vec, n_split, tiles_per_split,
               (float*)nrm, (float*)part, (float*)out, (cudaStream_t)stream);
  return fwd((const float*)sr, (const float*)tab, (const int*)labels,
             (const int*)iids, K, B, P, D, Ns, n_valid, col_offset, scale,
             normalize, vec, n_split, tiles_per_split, (float*)nrm,
             (float*)part, (float*)out, (cudaStream_t)stream);
}

// K4 up to MAX_D features: d_sr [K*B, D] float32 and d_table [P, D] in the
// table's type from g5 [5][K*B] = (gz, gin, gex, lse_in, lse_ex).  Grid:
// d_table over t_split row splits of chunks_per_split 64-row chunks, d_sr
// over s_split catalog splits of tiles_per_split 64-row tiles.  Scratch:
// that [P, D] (table's type) and nrm [P] float32 when normalize; dtab_part
// [t_split, P, D] float32 when t_split > 1; dsr_part [s_split, K*B, D]
// float32 when s_split > 1.  Past MAX_D: srt_xent_multi_bwd_slab.
int srt_xent_multi_bwd(const void* g5, const void* sr, const void* tab,
                       const void* labels, const void* iids, int K, int B,
                       int P, int D, int Ns, int n_valid, int col_offset,
                       float scale, int normalize, int is_bf16, int vec,
                       int t_split, int chunks_per_split, int s_split,
                       int tiles_per_split, void* that, void* nrm,
                       void* dtab_part, void* dsr_part, void* dsr,
                       void* dtab, void* stream) {
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  auto f = is_bf16 ? bwd_typed<__nv_bfloat16> : bwd_typed<float>;
  return f(g5, sr, tab, labels, iids, K, B, P, D, Ns, n_valid, col_offset,
           scale, normalize, vec, t_split, chunks_per_split, s_split,
           tiles_per_split, that, nrm, dtab_part, dsr_part, dsr, dtab,
           stream);
}

// K4 past MAX_D features: the same outputs through dz and three products
// over the K*B rows (tiles.cuh's slab path), with srt_xent_bwd_slab's plan
// and scratch (dz [round_up(K*B, 64), chunk_tiles * 64], dsr_part [parts,
// K*B, D]).
int srt_xent_multi_bwd_slab(const void* g5, const void* sr, const void* tab,
                            const void* labels, const void* iids, int K,
                            int B, int P, int D, int Ns, int n_valid,
                            int col_offset, float scale, int normalize,
                            int is_bf16, int vec, int chunk_tiles,
                            int t_split, int t_per, int s_per, void* that,
                            void* nrm, void* dz, void* dtab_part,
                            void* dsr_part, void* dsr, void* dtab,
                            void* stream) {
  if (D <= MAX_D) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return bwd_slab((const float*)g5, (const __nv_bfloat16*)sr,
                    (const __nv_bfloat16*)tab, (const int*)labels,
                    (const int*)iids, K, B, P, D, Ns, n_valid, col_offset,
                    scale, normalize, vec, chunk_tiles, t_split, t_per, s_per,
                    (__nv_bfloat16*)that, (float*)nrm, (__nv_bfloat16*)dz,
                    (float*)dtab_part, (float*)dsr_part, (float*)dsr,
                    (__nv_bfloat16*)dtab, (cudaStream_t)stream);
  return bwd_slab((const float*)g5, (const float*)sr, (const float*)tab,
                  (const int*)labels, (const int*)iids, K, B, P, D, Ns,
                  n_valid, col_offset, scale, normalize, vec, chunk_tiles,
                  t_split, t_per, s_per, (float*)that, (float*)nrm,
                  (float*)dz, (float*)dtab_part, (float*)dsr_part,
                  (float*)dsr, (float*)dtab, (cudaStream_t)stream);
}

// out[0]: resident blocks per SM of K4's dz kernel past MAX_D features
// (xent_multi_bwd_dz_slab) on the current device; out[1], out[2]: its
// registers and local memory bytes per thread
int srt_xent_multi_dz_slots(int D, int is_bf16, int* out) {
  (void)D;
  if (is_bf16)
    kernel_attrs((const void*)xent_multi_bwd_dz_slab<__nv_bfloat16>,
                 (int)dz_multi_smem<__nv_bfloat16>(), &out[0], &out[1],
                 &out[2]);
  else
    kernel_attrs((const void*)xent_multi_bwd_dz_slab<float>,
                 (int)dz_multi_smem<float>(), &out[0], &out[1], &out[2]);
  return (int)cudaGetLastError();
}

}  // extern "C"
