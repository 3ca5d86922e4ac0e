// Fused multi-order REnorm / fusion catalog loss for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of sessionrec_tpu/ops/xent_multi.py:
//   K3  _fwd_kernel (xent_multi.py:57)  -> xent_multi_fwd_partial
//                                          + xent_multi_fwd_merge
//   K4  _bwd_kernel (xent_multi.py:157) -> xent_multi_bwd_dtable
//                                          + xent_multi_bwd_dsr
//                                          (+ xent_bwd_dsr_reduce)
//
// The WSDM'22 paper head scores the session vector of every order k
// against the whole catalog and splits the catalog, per example, into the
// session's own items and the rest (REnorm).  Its loss needs five numbers
// per (order, row): (m_in, s_in) and (m_ex, s_ex), the running max and
// sum-exp of z = scale * sr_k . t over the in-session and the other
// columns, and zl, the label's logit.  The backward pass turns their
// cotangents into
//   dz = (gin * p_in + gex * p_ex + gz * onehot(label)) * scale,
// p_in = exp(z - lse_in) on in-session live columns, p_ex = exp(z - lse_ex)
// on the other live columns, and then d_sr_k = dz_k @ t and
// d_table = sum_k dz_k^T @ sr_k with the l2norm VJP folded in.  None of the
// kernels stores the [K, B, P] logits or the [B, P] session mask.
//
// What bounds it.  K3 performs 2*K*B*P*D operations and K4 three times as
// many on (K*B + P)*D elements.  At the paper path's shapes (K = 3,
// B = 512, D = 256, P = 3,584 to 37,888) that is some 2*K*B/(bytes per
// element) operations per byte, about 770 in float32: far above the card's
// ratio of float32 operations to bytes (67 TFLOP/s over 3.35 TB/s = 20),
// so every kernel is bound by operations, and the products run on the
// FP32 FMA pipes (TF32 would change the numerics), as K1 and K2 do.
//
// What the design does about it (a first, simple design; K1/K2's tiles):
//   * K folds into the row axis.  The TPU kernel loops over k inside each
//     table tile so that the tile is read once for all orders.  Here sr3
//     [K, B, D] is read as K*B rows, row r = k*B + b taking label b and
//     iid list b, and a block computes a 32-row x 64-column tile of logits
//     from its staged rows and one staged catalog tile, as
//     xent_fwd_partial does.  Each operand element read from memory feeds
//     32 to 64 FMAs.
//   * Membership is a bit mask per row and tile.  While a catalog tile is
//     staged, the block turns each of its rows' iid lists (global item ids,
//     -1 padded, at most MAX_NS) into a mask over the tile's columns, eight
//     threads a row merged by shuffles, so testing a column costs a shift.
//   * K3 splits the catalog over blockIdx.y; each split writes the five
//     partial stats per row, and xent_multi_fwd_merge combines each
//     (m, s) pair as a log-sum-exp and sums zl (only the split that holds
//     the label adds to it).
//   * Empty partitions stay finite: a row with no session item, or a tile
//     with no in-session column, carries m = NEG_INF and s = 0; every
//     rescale uses m_safe = max(m, NEG_INF / 2), so exp(NEG_INF - m_safe)
//     is 0, never NaN.  K4 takes p_in only on member & live columns and
//     p_ex only on the others, each against max(lse, NEG_INF / 2).
//   * K4 is K2's pair of kernels, without atomics and so deterministic:
//     xent_multi_bwd_dtable is parallel over catalog tiles and loops over
//     all K*B rows; xent_multi_bwd_dsr is parallel over row tiles and
//     catalog splits, and xent_bwd_dsr_reduce sums the splits in a fixed
//     order.
//   * bfloat16 inputs: as K2, the normalised table and dz are rounded to
//     bfloat16 where the JAX kernel feeds its matrix unit, and every
//     product accumulates in float32.
//
// Interface.  As the JAX kernels take them for the catalog-sharded path:
// n_valid (local columns at or past it are masked), col_offset (the global
// id of the table's first row: membership compares col_offset + j with the
// global iids), and labels localised to the table (-1 matches no column).
// Each C entry point launches on the given stream, does not synchronise
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int MAX_NS = 256;  // longest iid list (session items) per row

// mask[i] bit c, for the F_BM rows row0 + i of the block: global column
// gc0 + c (c < 64) is one of the row's session items.  Eight threads per
// row (tid = 8 i + part) scan the list and merge by shuffles.
__device__ __forceinline__ void row_masks64(unsigned long long* mask,
                                            const int* __restrict__ iids,
                                            int row0, int R, int B, int Ns,
                                            int gc0) {
  const int i = threadIdx.x >> 3, part = threadIdx.x & 7;
  const int r = row0 + i;
  unsigned long long m = 0ull;
  if (r < R) {
    const int* ids = iids + (size_t)(r % B) * Ns;
    for (int j = part; j < Ns; j += 8) {
      const unsigned c = (unsigned)(ids[j] - gc0);
      if (c < 64u) m |= 1ull << c;
    }
  }
  m |= __shfl_xor_sync(FULL, m, 1);
  m |= __shfl_xor_sync(FULL, m, 2);
  m |= __shfl_xor_sync(FULL, m, 4);
  if (part == 0) mask[i] = m;
}

// the same for the T_BM rows of a d_table chunk and 32 columns; four
// threads per row (tid = 4 i + part)
__device__ __forceinline__ void row_masks32(unsigned* mask,
                                            const int* __restrict__ iids,
                                            int row0, int R, int B, int Ns,
                                            int gc0) {
  const int i = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int r = row0 + i;
  unsigned m = 0u;
  if (r < R) {
    const int* ids = iids + (size_t)(r % B) * Ns;
    for (int j = part; j < Ns; j += 4) {
      const unsigned c = (unsigned)(ids[j] - gc0);
      if (c < 32u) m |= 1u << c;
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
// K3, forward: partial two-partition online log-sum-exp over one catalog
// split.  grid = (ceil(K*B / F_BM), n_split); thread (ty, tx) owns rows
// ty, ty + 16 and columns tx + 16 j (j < 4) of each 32 x 64 logits tile.
// part holds [5][n_split][K*B] floats: m_in, s_in, m_ex, s_ex, zl.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) xent_multi_fwd_partial(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const int* __restrict__ labels, const int* __restrict__ iids, int R,
    int B, int P, int D, int Ns, int n_valid, int col_offset, float scale,
    int normalize, int cols_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(smem);  // [F_BM]
  float* A_s = smem + 2 * F_BM;     // [F_BM][ld] sr rows
  float* B_s = A_s + F_BM * ld;     // [F_BN][ld] table rows
  float* n_s = B_s + F_BN * ld;     // [F_BN] row norms
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * F_BM;
  const int split = blockIdx.y;
  const int p_begin = split * cols_per_split;
  const int p_end = min(P, p_begin + cols_per_split);

  stage_rows(A_s, ld, sr, row0, R, F_BM, D);
  int lbl[2];
  float m_in[2], s_in[2], m_ex[2], s_ex[2], zl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty + 16 * i;
    lbl[i] = r < R ? labels[r % B] : -1;
    m_in[i] = m_ex[i] = NEG_INF;
    s_in[i] = s_ex[i] = zl[i] = 0.f;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += F_BN) {
    __syncthreads();  // the previous tile and its masks are consumed
    stage_rows(B_s, ld, tab, p0, p_end, F_BN, D);
    row_masks64(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    __syncthreads();
    if (normalize) {
      tile_norms(B_s, ld, n_s, F_BN, D);
      __syncthreads();
    }
    float acc[2][4] = {};
    product_32x64(acc, A_s, B_s, ld, D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned long long bits = mask_s[ty + 16 * i];
      float z[4];
      bool mem[4];
      float t_in = NEG_INF, t_ex = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = p0 + c;
        float v = scale * acc[i][j];
        if (normalize) v = v / n_s[c];
        const bool in_table = col < p_end;
        if (!in_table || col >= n_valid) v = NEG_INF;
        if (in_table && col == lbl[i]) zl[i] += v;
        mem[j] = (bits >> c) & 1ull;
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
  }

  // merge the 16 per-thread partials of each row (lanes of one half-warp)
  const size_t plane = (size_t)gridDim.y * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const float mio = __shfl_xor_sync(FULL, m_in[i], off);
      const float sio = __shfl_xor_sync(FULL, s_in[i], off);
      const float meo = __shfl_xor_sync(FULL, m_ex[i], off);
      const float seo = __shfl_xor_sync(FULL, s_ex[i], off);
      zl[i] += __shfl_xor_sync(FULL, zl[i], off);
      lse_merge(m_in[i], s_in[i], mio, sio);
      lse_merge(m_ex[i], s_ex[i], meo, seo);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      const size_t o = (size_t)split * R + r;
      part[o] = m_in[i];
      part[plane + o] = s_in[i];
      part[2 * plane + o] = m_ex[i];
      part[3 * plane + o] = s_ex[i];
      part[4 * plane + o] = zl[i];
    }
  }
}

// K3, merge: out [5][K*B] = (m_in, s_in, m_ex, s_ex, zl) over the whole
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

// K4's per-row inputs: the cotangents of zl, lse_in and lse_ex, the
// guarded log-partitions and the label; g5 is [5][K*B] = (gz, gin, gex,
// lse_in, lse_ex)
struct RowCoef {
  float gz, gin, gex, lin, lex;
  int lbl;
  bool ok;
};

__device__ __forceinline__ RowCoef row_coef(const float* __restrict__ g5,
                                            const int* __restrict__ labels,
                                            int r, int R, int B) {
  RowCoef c{0.f, 0.f, 0.f, 0.f, 0.f, -1, r < R};
  if (c.ok) {
    c.gz = g5[r];
    c.gin = g5[R + r];
    c.gex = g5[2 * R + r];
    c.lin = fmaxf(g5[3 * R + r], NEG_INF * 0.5f);
    c.lex = fmaxf(g5[4 * R + r], NEG_INF * 0.5f);
    c.lbl = labels[r % B];
  }
  return c;
}

// dz = (gin p_in + gex p_ex + gz onehot) * scale for one logits value,
// rounded to the operand type; 0 for padding rows and columns
template <typename T>
__device__ __forceinline__ float dlogit_multi(float z, int col, int p_end,
                                              int n_valid, bool member,
                                              const RowCoef& c, float scale) {
  if (!c.ok || col >= p_end) return 0.f;
  float acc = 0.f;
  if (col < n_valid)
    acc = member ? c.gin * expf(z - c.lin) : c.gex * expf(z - c.lex);
  if (col == c.lbl) acc += c.gz;
  return round_op<T>(acc * scale);
}

// ---------------------------------------------------------------------------
// K4, d_table: grid = ceil(P / T_BN).  A block owns 32 catalog rows, loops
// over the K*B rows in chunks of 64, recomputes the 64 x 32 dz tile and
// accumulates G = dz^T @ sr in registers, then writes d_table with the
// l2norm VJP (store_dtable).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) xent_multi_bwd_dtable(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ tab, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize,
    T* __restrict__ dtab) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  constexpr int LDZ = T_BN + 1;
  unsigned* mask_s = reinterpret_cast<unsigned*>(smem);  // [T_BM]
  float* B_s = smem + T_BM;       // [T_BN][ld] operand table rows
  float* A_s = B_s + T_BN * ld;   // [T_BM][ld] sr rows
  float* dz_s = A_s + T_BM * ld;  // [T_BM][LDZ]
  float* n_s = dz_s + T_BM * LDZ; // [T_BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int p0 = blockIdx.x * T_BN;

  stage_operand_tile(B_s, ld, n_s, tab, p0, P, T_BN, D, normalize);

  float G[4][MAX_D / 32] = {};
  for (int b0 = 0; b0 < R; b0 += T_BM) {
    __syncthreads();  // the previous chunk is consumed
    stage_rows(A_s, ld, sr, b0, R, T_BM, D);
    row_masks32(mask_s, iids, b0, R, B, Ns, col_offset + p0);
    __syncthreads();
    float acc[4][2] = {};
    product_64x32(acc, A_s, B_s, ld, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const RowCoef c = row_coef(g5, labels, b0 + rl, R, B);
      const unsigned bits = mask_s[rl];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cc = tx + 16 * j;
        dz_s[rl * LDZ + cc] = dlogit_multi<T>(
            scale * acc[i][j], p0 + cc, P, n_valid, (bits >> cc) & 1u, c,
            scale);
      }
    }
    __syncthreads();
    accumulate_dtable(G, dz_s, LDZ, A_s, ld, D);
  }

  store_dtable(G, n_s, tab, p0, P, D, normalize, dtab);
}

// ---------------------------------------------------------------------------
// K4, d_sr: grid = (ceil(K*B / F_BM), n_split).  A block owns 32 rows and
// one catalog split, recomputes each 32 x 64 dz tile and accumulates
// dz @ t in registers; each split writes its partial sum, reduced in a
// fixed order by xent_bwd_dsr_reduce.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) xent_multi_bwd_dsr(
    const float* __restrict__ g5, const T* __restrict__ sr,
    const T* __restrict__ tab, const int* __restrict__ labels,
    const int* __restrict__ iids, int R, int B, int P, int D, int Ns,
    int n_valid, int col_offset, float scale, int normalize,
    int cols_per_split, float* __restrict__ dsr_part) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  constexpr int LDZ = F_BN + 1;
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(smem);  // [F_BM]
  float* A_s = smem + 2 * F_BM;   // [F_BM][ld] sr rows
  float* B_s = A_s + F_BM * ld;   // [F_BN][ld] operand table rows
  float* dz_s = B_s + F_BN * ld;  // [F_BM][LDZ]
  float* n_s = dz_s + F_BM * LDZ; // [F_BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * F_BM;
  const int split = blockIdx.y;
  const int p_begin = split * cols_per_split;
  const int p_end = min(P, p_begin + cols_per_split);

  stage_rows(A_s, ld, sr, row0, R, F_BM, D);
  RowCoef coef[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    coef[i] = row_coef(g5, labels, row0 + ty + 16 * i, R, B);

  float acc_d[4][MAX_D / 32] = {};
  for (int p0 = p_begin; p0 < p_end; p0 += F_BN) {
    __syncthreads();  // the previous tile and its masks are consumed
    row_masks64(mask_s, iids, row0, R, B, Ns, col_offset + p0);
    stage_operand_tile(B_s, ld, n_s, tab, p0, p_end, F_BN, D, normalize);
    float acc[2][4] = {};
    product_32x64(acc, A_s, B_s, ld, D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned long long bits = mask_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        dz_s[(ty + 16 * i) * LDZ + c] = dlogit_multi<T>(
            scale * acc[i][j], p0 + c, p_end, n_valid, (bits >> c) & 1ull,
            coef[i], scale);
      }
    }
    __syncthreads();
    accumulate_dsr(acc_d, dz_s, LDZ, B_s, ld, min(F_BN, p_end - p0), D);
  }
  store_dsr_part(acc_d, dsr_part + (size_t)split * R * D, row0, R, D);
}

size_t fwd_smem(int D) {
  return (2 * F_BM + (size_t)(F_BM + F_BN) * (D + 1) + F_BN) * 4;
}
size_t dtable_smem(int D) {
  return (T_BM + (size_t)(T_BN + T_BM) * (D + 1) + T_BM * (T_BN + 1) + T_BN) *
         4;
}
size_t dsr_smem(int D) {
  return (2 * F_BM + (size_t)(F_BM + F_BN) * (D + 1) + F_BM * (F_BN + 1) +
          F_BN) * 4;
}

template <typename T>
int fwd(const void* sr, const void* tab, const int* labels, const int* iids,
        int K, int B, int P, int D, int Ns, int n_valid, int col_offset,
        float scale, int normalize, int n_split, int cols_per_split,
        float* part, float* out, cudaStream_t stream) {
  const int R = K * B;
  const size_t smem = fwd_smem(D);
  cudaFuncSetAttribute(xent_multi_fwd_partial<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((R + F_BM - 1) / F_BM, n_split);
  xent_multi_fwd_partial<T><<<grid, NT, smem, stream>>>(
      (const T*)sr, (const T*)tab, labels, iids, R, B, P, D, Ns, n_valid,
      col_offset, scale, normalize, cols_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_multi_fwd_merge<<<(R + 255) / 256, 256, 0, stream>>>(part, n_split, R,
                                                             out);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const float* g5, const void* sr, const void* tab, const int* labels,
        const int* iids, int K, int B, int P, int D, int Ns, int n_valid,
        int col_offset, float scale, int normalize, int n_split,
        int cols_per_split, float* dsr_part, float* dsr, void* dtab,
        cudaStream_t stream) {
  const int R = K * B;
  const size_t smem_t = dtable_smem(D), smem_s = dsr_smem(D);
  cudaFuncSetAttribute(xent_multi_bwd_dtable<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_t);
  cudaFuncSetAttribute(xent_multi_bwd_dsr<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_s);
  xent_multi_bwd_dtable<T><<<(P + T_BN - 1) / T_BN, NT, smem_t, stream>>>(
      g5, (const T*)sr, (const T*)tab, labels, iids, R, B, P, D, Ns, n_valid,
      col_offset, scale, normalize, (T*)dtab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + F_BM - 1) / F_BM, n_split);
  xent_multi_bwd_dsr<T><<<grid, NT, smem_s, stream>>>(
      g5, (const T*)sr, (const T*)tab, labels, iids, R, B, P, D, Ns, n_valid,
      col_offset, scale, normalize, cols_per_split, dsr_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = R * D;
  xent_bwd_dsr_reduce<<<(n + 255) / 256, 256, 0, stream>>>(dsr_part, n_split,
                                                           n, dsr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int srt_xent_multi_max_ns() { return MAX_NS; }

// K3: out [5][K*B] floats = (m_in, s_in, m_ex, s_ex, zl); part is scratch
// of 5 * n_split * K * B floats
int srt_xent_multi_fwd(const void* sr, const void* tab, const void* labels,
                       const void* iids, int K, int B, int P, int D, int Ns,
                       int n_valid, int col_offset, float scale,
                       int normalize, int is_bf16, int n_split,
                       int cols_per_split, void* part, void* out,
                       void* stream) {
  auto f = is_bf16 ? fwd<__nv_bfloat16> : fwd<float>;
  return f(sr, tab, (const int*)labels, (const int*)iids, K, B, P, D, Ns,
           n_valid, col_offset, scale, normalize, n_split, cols_per_split,
           (float*)part, (float*)out, (cudaStream_t)stream);
}

// K4: d_sr [K*B, D] float32 and d_table [P, D] in the table's type from
// g5 [5][K*B] = (gz, gin, gex, lse_in, lse_ex); dsr_part is scratch of
// n_split * K * B * D floats
int srt_xent_multi_bwd(const void* g5, const void* sr, const void* tab,
                       const void* labels, const void* iids, int K, int B,
                       int P, int D, int Ns, int n_valid, int col_offset,
                       float scale, int normalize, int is_bf16, int n_split,
                       int cols_per_split, void* dsr_part, void* dsr,
                       void* dtab, void* stream) {
  auto f = is_bf16 ? bwd<__nv_bfloat16> : bwd<float>;
  return f((const float*)g5, sr, tab, (const int*)labels, (const int*)iids,
           K, B, P, D, Ns, n_valid, col_offset, scale, normalize, n_split,
           cols_per_split, (float*)dsr_part, (float*)dsr, dtab,
           (cudaStream_t)stream);
}

}  // extern "C"
