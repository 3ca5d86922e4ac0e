// K1: the forward pass of the fused full-catalog softmax cross-entropy, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sessionrec_tpu/ops/xent.py:71 _fwd_kernel
// (pallas_call at :130), one catalog tile of the online log-sum-exp over
// z = scale * sr t^T (divided by the clamped row norms n when the table is
// normalised):
//   K1  _fwd_kernel  -> xent_table_norms + xent_fwd_partial + xent_fwd_merge
//                       (xent_fwd_slab in place of the partial past
//                       256 features)
// Its backward pass, K2 (_bwd_kernel, xent.py:164), is xent_bwd.cu.
//
// The loss of every training step is  lse - z[label]  per row over the whole
// catalog.  K1 returns it with lse, the only residual K2 needs; the [B, P]
// logits never reach device memory.  As the JAX kernel does, K1 scores the
// raw table and divides each logit by its column's unrounded norm.
//
// What bounds it.  2*B*P*D operations on (B + P)*D elements: at the main
// path's shapes (B = 512, D = 256, P = 3,584 to 37,888) about 256
// operations a float32 byte, far above the card's 20 (67 TFLOP/s over
// 3.35 TB/s), and 512 a bfloat16 byte, above its 295 (989 TFLOP/s on the
// tensor cores), so it is bound by operations: float32 on the FP32 FMA
// pipes (TF32 would change the numerics), bfloat16 on the tensor cores at
// every width (bf16 x bf16 products are exact in float32, so only the
// order of the float32 sums differs from the FMA loop's).
//
// What the design does about it (K3's tiles, tiles.cuh):
//   * One tile loop for K1 and K3: fwd_tile_loop without membership, so
//     every live column goes to the one (m, s) pair.
//   * The norms are taken once per call (xent_table_norms), not in every
//     block that stages a table tile (B / 64 times per table row).
//   * float32: register-tiled products, a 64 x 64 logits tile 4 x 4
//     outputs a thread, 8 vector shared loads per 64 FMAs (product_logits).
//   * bfloat16: the tile on the tensor cores (product_logits_tc:
//     mma.sync m16n8k16, float32 sums, operands by ldmatrix), a warp's 16
//     rows x 32 columns; the online log-sum-exp in the fragments' layout
//     (a lane's two rows and eight columns a tile), merged over the quad
//     and the two column warps once at the end; 99 KB of tiles at D = 256,
//     two blocks an SM.
//   * Asynchronous, double-buffered staging: the block's 64 rows once, the
//     next table tile by cp.async while the current one is used (float32
//     four elements a copy, bfloat16 eight at its own tile stride).
//   * A grid from K1's own resident slots (srt_xent_fwd_slots;
//     ops/xent.py:_fwd_grid): 64-row batch tiles times catalog splits,
//     each split writing a partial (m, s, zl) per row; xent_fwd_merge
//     combines them as the catalog-sharded JAX path combines shards
//     (xent.py:339-345).  No atomics: two calls give the same bits.
//
// Interface.  n_valid (columns at or past it are masked), col_offset (the
// global id of the table's first row: K1 compares col_offset + j with
// n_valid and the labels) and labels (-1 matches no column), as the
// catalog-sharded JAX path passes them (xent.py:293-309).  Any B >= 1,
// P >= 1, D >= 1: with D % 4 == 0 and aligned arrays the tiles are staged
// by cp.async, otherwise by plain loads.  Up to D = MAX_D (256) the kernel
// above runs; wider rows run xent_fwd_slab (fwd_slab_loop, tiles.cuh), which
// streams the split's catalog tiles in k-chunks of 64 features through a
// ring of cp.async stages, two blocks an SM: three stages on the FMA pipes
// in float32; four in bfloat16, each chunk multiplied on the tensor cores
// (fwd_slab_loop_tc: product_logits_tc accumulating over the tile's
// chunks, then fwd_tile_loop_tc's epilogue and merge).  Each entry point
// launches on the given stream, does not synchronise and returns
// cudaGetLastError().

#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1, forward: partial online log-sum-exp over one catalog split
// (fwd_tile_loop without membership).  grid = (row tiles, catalog splits);
// part holds [3][n_split][B] floats: m, s, zl.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT, tile_blocks<T>()) xent_fwd_partial(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels, int B,
    int P, int D, int n_valid, int col_offset, float scale, int normalize,
    int vec, int tiles_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_tile_loop<T, false>(smem, sr, tab, nrm, labels, nullptr, B, B, P, D,
                          0, n_valid, col_offset, scale, normalize, vec,
                          tiles_per_split, part);
}

// K1 for D > MAX_D: the same partial, its (catalog tile, k-chunk) pairs
// one pipelined stream (fwd_slab_loop: on the tensor cores in bfloat16),
// two blocks an SM
template <typename T>
__global__ void __launch_bounds__(NT, 2) xent_fwd_slab(
    const T* __restrict__ sr, const T* __restrict__ tab,
    const float* __restrict__ nrm, const int* __restrict__ labels, int B,
    int P, int D, int n_valid, int col_offset, float scale, int normalize,
    int vec, int tiles_per_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_slab_loop<T, false>(smem, sr, tab, nrm, labels, nullptr, B, B, P, D,
                          0, n_valid, col_offset, scale, normalize, vec,
                          tiles_per_split, part);
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

// the partial kernel at width D (the slab kernel past MAX_D)
template <typename T>
const void* fwd_kernel(int D) {
  return D > MAX_D ? (const void*)xent_fwd_slab<T>
                   : (const void*)xent_fwd_partial<T>;
}

template <typename T>
int set_fwd_smem(int D) {
  const int smem = D > MAX_D ? (int)fwd_slab_smem<T, false>()
                             : (int)fwd_smem<T, false>(D);
  cudaFuncSetAttribute(fwd_kernel<T>(D),
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return smem;
}

// resident blocks per SM of the partial kernel (out[0]), its registers per
// thread (out[2]), its local memory bytes per thread, where spills go
// (out[3]), its dynamic shared memory bytes (out[4]), the stages its
// staging pipelines (out[5]: the table tiles' two buffers up to MAX_D, the
// chunk ring's three or four stages past it) and whether its product runs
// on the tensor cores (out[6]: bfloat16, at every width)
template <typename T>
int slots(int D, int* out) {
  const int smem = set_fwd_smem<T>(D);
  kernel_attrs(fwd_kernel<T>(D), smem, &out[0], &out[2], &out[3]);
  out[4] = smem;
  out[5] = D > MAX_D ? fwd_stages<T>() : 2;
  out[6] = tc_type<T>;
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* sr, const T* tab, const int* labels, int B, int P, int D,
        int n_valid, int col_offset, float scale, int normalize, int vec,
        int n_split, int tiles_per_split, float* nrm, float* part,
        float* loss, float* lse, cudaStream_t stream) {
  const int smem = set_fwd_smem<T>(D);
  cudaError_t err;
  if (normalize) {
    xent_table_norms<T><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
        tab, P, D, nrm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (tc_type<T>) vec = tc_vec(vec, D, sr, tab);
  dim3 grid((B + TILE - 1) / TILE, n_split);
  if (D > MAX_D)
    xent_fwd_slab<T><<<grid, NT, smem, stream>>>(
        sr, tab, nrm, labels, B, P, D, n_valid, col_offset, scale, normalize,
        vec, tiles_per_split, part);
  else
    xent_fwd_partial<T><<<grid, NT, smem, stream>>>(
        sr, tab, nrm, labels, B, P, D, n_valid, col_offset, scale, normalize,
        vec, tiles_per_split, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t plane = (size_t)n_split * B;
  xent_fwd_merge<<<(B + NT - 1) / NT, NT, 0, stream>>>(
      part, part + plane, part + 2 * plane, n_split, B, loss, lse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feature slabs of K1-K4 at width D: 1 up to MAX_D, where the one-pass
// kernels run, ceil(D / MAX_D) past it (the slab kernels)
int srt_xent_slabs(int D) { return slab_count(D); }

// features of every slab but the last at width D past MAX_D, in bfloat16
// (is_bf16: a multiple of 16) or float32 (a multiple of 4)
int srt_xent_slab_width(int D, int is_bf16) {
  return is_bf16 ? slab_width<__nv_bfloat16>(D) : slab_width<float>(D);
}

// out[0]: resident blocks per SM of K1's partial kernel at width D on the
// current device; out[1]: its SM count; out[2]: the kernel's registers per
// thread; out[3]: its local memory bytes per thread; out[4]: its dynamic
// shared memory bytes; out[5]: its staging stages; out[6]: 1 where its
// product runs on the tensor cores (bfloat16, at every width), 0 on the
// FMA pipes
int srt_xent_fwd_slots(int D, int is_bf16, int* out) {
  const int err = is_bf16 ? slots<__nv_bfloat16>(D, out) : slots<float>(D, out);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  return (int)cudaGetLastError();
}

// K1: per-row loss and lse [B] float32.  Grid: 64-row tiles of the B rows
// times n_split catalog splits of tiles_per_split 64-row tiles.  Scratch:
// nrm [P] float32 when normalize; part [3][n_split][B] float32.  vec:
// D % 4 == 0 and sr and the table aligned to four elements.
int srt_xent_fwd(const void* sr, const void* tab, const void* labels, int B,
                 int P, int D, int n_valid, int col_offset, float scale,
                 int normalize, int is_bf16, int vec, int n_split,
                 int tiles_per_split, void* nrm, void* part, void* loss,
                 void* lse, void* stream) {
  if (is_bf16)
    return fwd((const __nv_bfloat16*)sr, (const __nv_bfloat16*)tab,
               (const int*)labels, B, P, D, n_valid, col_offset, scale,
               normalize, vec, n_split, tiles_per_split, (float*)nrm,
               (float*)part, (float*)loss, (float*)lse, (cudaStream_t)stream);
  return fwd((const float*)sr, (const float*)tab, (const int*)labels, B, P, D,
             n_valid, col_offset, scale, normalize, vec, n_split,
             tiles_per_split, (float*)nrm, (float*)part, (float*)loss,
             (float*)lse, (cudaStream_t)stream);
}

}  // extern "C"
