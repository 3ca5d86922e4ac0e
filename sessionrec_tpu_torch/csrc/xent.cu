// Fused full-catalog softmax cross-entropy for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel of sessionrec_tpu/ops/xent.py:
//   K1  _fwd_kernel (xent.py:71)  -> xent_fwd_partial + xent_fwd_merge
// Its backward pass, K2 (_bwd_kernel, xent.py:164), is xent_bwd.cu.
//
// The loss of every training step is  -log softmax(scale * sr @ t^T)[label]
// over the whole catalog, with t = table / max(||table_row||, 1e-12) when
// the table is normalised.  None of the kernels stores the [B, P] logits:
// each recomputes its tile of them from sr and the table.
//
// What bounds it.  At the main path's shapes (B = 512, D = 256, P = 3,584
// to 37,888) a pass performs 2*B*P*D operations on B*D + P*D elements, some
// 2*B/(bytes per element) operations per byte: about 256 in float32 and 512
// in bfloat16.  Both are above the card's ratio of float32 operations to
// bytes (67 TFLOP/s over 3.35 TB/s = 20), so every kernel is bound by
// operations, not by bytes.  In float32 the tensor cores are out of reach
// (TF32 would change the numerics), so the products run on the FP32 FMA
// pipes.
//
// What the design does about it (a first, simple design):
//   * The TPU kernels hold all B rows and walk the catalog in order, so
//     they need one pass per row chunk and a row cap.  Hopper runs blocks
//     in parallel and in no order, so every kernel tiles over both B and
//     P, and no block depends on another.
//   * Each block stages its operand rows in shared memory once, in float32
//     (a row stride of D + 1 floats keeps the column reads free of bank
//     conflicts), and every thread computes a register tile of outputs, so
//     each operand element read from device memory feeds 32 to 64 FMAs.
//   * The forward pass splits the catalog over blockIdx.y so that the grid
//     fills the card; each split writes a partial (max, sum-exp, label
//     logit) per row, and xent_fwd_merge combines them the way the
//     catalog-sharded JAX path combines shards (xent.py:339-345).
//   * bfloat16 inputs: operands are rounded to bfloat16 where the JAX
//     kernel feeds bfloat16 to its matrix unit and products accumulate in
//     float32, so the numerics are those of a bfloat16 MMA with float32
//     accumulation.
//     The products themselves still run on the FMA pipes; mma / wgmma
//     tiles are later work.
//
// Interface.  Every kernel takes n_valid (columns at or past it are
// masked), a column offset (the global id of the table's first row; local
// column j is compared as col_offset + j) and labels already localised to
// the table (-1 matches no column), as the catalog-sharded JAX path does
// (xent.py:293-309).  Each C entry point launches on the given stream,
// does not synchronise and returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1, forward: partial online log-sum-exp over one catalog split.
// grid = (ceil(B / F_BM), n_split); thread (ty, tx) owns rows ty, ty + 16
// and columns tx + 16 j (j < 4) of each 32 x 64 logits tile, keeps its own
// running (max, sum-exp, label logit) per row over the columns it sees, and
// the 16 threads of a row merge them by shuffles at the end.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) xent_fwd_partial(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const int* __restrict__ labels, int B, int P, int D, int n_valid,
    int col_offset, float scale, int normalize, int cols_per_split,
    float* __restrict__ m_out, float* __restrict__ s_out,
    float* __restrict__ zl_out) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* A_s = smem;               // [F_BM][ld] sr rows
  float* B_s = A_s + F_BM * ld;    // [F_BN][ld] table rows
  float* n_s = B_s + F_BN * ld;    // [F_BN] row norms
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * F_BM;
  const int split = blockIdx.y;
  const int p_begin = split * cols_per_split;
  const int p_end = min(P, p_begin + cols_per_split);

  stage_rows(A_s, ld, sr, row0, B, F_BM, D);
  int lbl[2];
  float m[2], s[2], zl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty + 16 * i;
    lbl[i] = r < B ? labels[r] : -1;
    m[i] = NEG_INF;
    s[i] = 0.f;
    zl[i] = 0.f;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += F_BN) {
    __syncthreads();  // the previous tile is consumed
    stage_rows(B_s, ld, tab, p0, p_end, F_BN, D);
    __syncthreads();
    if (normalize) {
      tile_norms(B_s, ld, n_s, F_BN, D);
      __syncthreads();
    }
    float acc[2][4] = {};
    product_32x64(acc, A_s, B_s, ld, D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float z[4];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = p0 + c;
        const int gcol = col_offset + col;
        float v = scale * acc[i][j];
        if (normalize) v = v / n_s[c];
        const bool in_table = col < p_end;
        if (!in_table || gcol >= n_valid) v = NEG_INF;
        if (in_table && gcol == lbl[i]) zl[i] += v;
        z[j] = v;
        tmax = fmaxf(tmax, v);
      }
      const float m_new = fmaxf(m[i], tmax);
      // guard: exp(NEG_INF - NEG_INF) on an all-masked first tile
      const float m_safe = fmaxf(m_new, NEG_INF * 0.5f);
      float acc_s = s[i] * expf(m[i] - m_safe);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s += expf(z[j] - m_safe);
      s[i] = acc_s;
      m[i] = m_new;
    }
  }

  // merge the 16 per-thread partials of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const float mo = __shfl_xor_sync(FULL, m[i], off);
      const float so = __shfl_xor_sync(FULL, s[i], off);
      const float zo = __shfl_xor_sync(FULL, zl[i], off);
      const float mn = fmaxf(m[i], mo);
      const float ms = fmaxf(mn, NEG_INF * 0.5f);
      s[i] = s[i] * expf(m[i] - ms) + so * expf(mo - ms);
      zl[i] += zo;
      m[i] = mn;
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < B) {
      const size_t o = (size_t)split * B + r;
      m_out[o] = m[i];
      s_out[o] = s[i];
      zl_out[o] = zl[i];
    }
  }
}

// K1, merge: lse and per-row loss from the splits' partials (the combine of
// sharded_xent_fwd, xent.py:339-345, and the tiny guard of _finish_lse)
__global__ void xent_fwd_merge(const float* __restrict__ m_p,
                               const float* __restrict__ s_p,
                               const float* __restrict__ zl_p, int n_split,
                               int B, float* __restrict__ loss,
                               float* __restrict__ lse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float mg = NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) mg = fmaxf(mg, m_p[(size_t)sp * B + r]);
  const float ms = fmaxf(mg, NEG_INF * 0.5f);
  float sg = 0.f, zg = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const size_t o = (size_t)sp * B + r;
    sg += s_p[o] * expf(fmaxf(m_p[o], NEG_INF) - ms);
    zg += zl_p[o];
  }
  const float l = ms + logf(fmaxf(sg, FLT_MIN));
  lse[r] = l;
  loss[r] = l - zg;
}

size_t fwd_smem(int D) { return ((size_t)(F_BM + F_BN) * (D + 1) + F_BN) * 4; }

template <typename T>
int fwd(const void* sr, const void* tab, const int* labels, int B, int P,
        int D, int n_valid, int col_offset, float scale, int normalize,
        int n_split, int cols_per_split, float* part, float* loss, float* lse,
        cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaFuncSetAttribute(xent_fwd_partial<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  float* m_p = part;
  float* s_p = part + (size_t)n_split * B;
  float* zl_p = part + (size_t)2 * n_split * B;
  dim3 grid((B + F_BM - 1) / F_BM, n_split);
  xent_fwd_partial<T><<<grid, NT, smem, stream>>>(
      (const T*)sr, (const T*)tab, labels, B, P, D, n_valid, col_offset,
      scale, normalize, cols_per_split, m_p, s_p, zl_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_merge<<<(B + 255) / 256, 256, 0, stream>>>(m_p, s_p, zl_p, n_split,
                                                      B, loss, lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tile sizes the wrapper needs to size the catalog splits and the checks
int srt_xent_tile_cols() { return F_BN; }
int srt_xent_tile_rows() { return F_BM; }
int srt_xent_max_d() { return MAX_D; }

// K1: per-row loss and lse; part is scratch of 3 * n_split * B floats
int srt_xent_fwd(const void* sr, const void* tab, const void* labels, int B,
                 int P, int D, int n_valid, int col_offset, float scale,
                 int normalize, int is_bf16, int n_split, int cols_per_split,
                 void* part, void* loss, void* lse, void* stream) {
  auto f = is_bf16 ? fwd<__nv_bfloat16> : fwd<float>;
  return f(sr, tab, (const int*)labels, B, P, D, n_valid, col_offset, scale,
           normalize, n_split, cols_per_split, (float*)part, (float*)loss,
           (float*)lse, (cudaStream_t)stream);
}

}  // extern "C"
