// The backward of the embedding gather (ops/embed.py), for Hopper
// (sm_90a): the table's dense gradient
//   d_table[r] = sum of the upstream gradient rows of every slot whose id
//                is r                               [P, D] the table's type
// for a step's gathers at once (every length tier and level), summed in a
// fixed order in float32 and rounded once, at the write.
//
// Replaces no Pallas kernel: the JAX package leaves the gather's backward
// to XLA's scatter-add.  It replaces torch's index backward
// (indexing_backward_kernel), which walks each id's duplicates serially,
// one dependent load each, and took one gather (one dense gradient) per
// tier and level.
//
// What bounds it.  Bytes: the n gathered rows' gradients read once and the
// P x D table gradient written once (every row, zeros included); at the
// paper cell's step (n = 24,320, P = 37,888, D = 256, float32) 63.7 MB, 19
// us at 3.35 TB/s.  No arithmetic worth counting.  What kept torch from
// that bound is the id of the padding slots: every tier is padded to its
// static caps with id 0, so two thirds of a step's slots share one row,
// and a serial walk of that run is a chain of ~16,000 dependent loads.
//
// What the design does about it:
//   * The slots are ordered by id with a stable sort (torch.sort on the
//     device, in the wrapper), so each id's slots form one run in slot
//     order.  The kernels read the gradient rows where autograd left them,
//     one tensor a gather (Pieces), through the sort's permutation;
//     embed_bwd_tiles writes each sorted slot's row pointer once (src), and
//     a warp's sums read them by broadcast loads.
//   * embed_bwd_tiles cuts the sorted slots into tiles of RUN_TILE, one
//     warp a tile.  It marks each run's first and last slot (head, tail;
//     zeroed first, so an id with no slots reads a run of 0) and sums, in
//     slot order, the tile's slots of its first run and of its last run
//     where that run crosses the tile's edge: the tile partials, float32.
//     The length of every sum is known before its loop, so the loads of
//     several slots are in flight at once.
//   * Every row of d_table is written exactly once.  embed_bwd_long, a
//     block a tile, takes the run longer than a tile that starts in its
//     tile, if any, and reduces its tile partials in a fixed tree: W ways
//     each sum every W-th partial in order, then the ways are added in
//     order.  The padding run of ~16,000 slots becomes ~500 partials
//     summed ~50 deep, in place of 16,000.  embed_bwd_rows, a warp a row,
//     sums every other run (at most RUN_TILE slots) in slot order, or
//     writes zeros.
//   * No atomics and no memset of d_table: the sums' order is a function
//     of the ids alone, so two runs, and a CUDA-graph replay against an
//     eager call, give the same bits.  Scratch is sized from n, P and D
//     (static shapes), so a captured graph takes it unchanged, and nothing
//     is read back to the host.
//   * Rows move as four elements a lane (float4, or four bfloat16 in 8
//     bytes) where D % 4 == 0 and every array is so aligned (vec), else
//     one.  bfloat16 gradients are summed in float32 and rounded once.
// Ids outside [0, P) land in no row (the forward gather refuses them).

#include "common.cuh"

namespace {

constexpr int RUN_TILE = 32;     // slots a tile; longer runs go by partials
constexpr int MAX_PIECES = 32;   // gradient tensors a launch takes
constexpr int LANE_GROUPS = 2;   // column groups a lane sums at once
constexpr int MAX_WAYS = 32;
constexpr int LONG_NT = 1024;    // threads of a long-run block
constexpr int RED_FLOATS = 4096; // the long-run tree's shared floats

// The gradient rows of a launch: piece k holds the slots from begin[k] up
// to begin[k + 1] (the next piece's begin, or n), row-major [rows, D].
struct Pieces {
  const void* ptr[MAX_PIECES];
  long long begin[MAX_PIECES];
  int count;
};

// ways of the long-run tree at width D: as many as the block's threads
// and the shared floats hold (ops/embed.py:ways, which the plain version
// follows)
__host__ __device__ inline int ways(int D) {
  const int w = RED_FLOATS / D;
  return w < 1 ? 1 : (w > MAX_WAYS ? MAX_WAYS : w);
}

// V elements of a row in type T, as floats (inlined, so the arrays stay in
// registers)
template <typename T, int V> struct Io;

template <> struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <> struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *p = x[0];
  }
};

// bfloat16 bits of x, rounded to nearest even
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// four bfloat16 as two words, element 0 in the low half (bit shifts, so
// nothing takes an address and leaves registers)
template <> struct Io<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    uint2 v;
    v.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
    v.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
    *reinterpret_cast<uint2*>(p) = v;
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    x[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *p = __float2bfloat16(x[0]);
  }
};

// the gradient row of the slot at position pos of the gathers' order
template <typename T>
__device__ __forceinline__ const T* source_row(const Pieces& pc,
                                               long long pos, int D) {
  const void* base = pc.ptr[0];
  long long first = 0;
#pragma unroll
  for (int k = 1; k < MAX_PIECES; ++k)
    if (k < pc.count && pos >= pc.begin[k]) {
      base = pc.ptr[k];
      first = pc.begin[k];
    }
  return static_cast<const T*>(base) + (pos - first) * D;
}

// A warp's sum, in order, of the gradient rows src[0 .. len - 1] (the
// same pointer for every lane: one broadcast load a row), written to out
// [D] in type O; zeros for len 0.  embed_bwd_tiles writes src and reads it
// back in the same kernel, so src is read by plain loads, never through
// the read-only path.
template <typename T, typename O, int V>
__device__ __forceinline__ void warp_sum_rows(const T* const* src, int len,
                                              int D, O* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int G = D / V;
  for (int c0 = 0; c0 < G; c0 += 32 * LANE_GROUPS) {
    float acc[LANE_GROUPS][V];
#pragma unroll
    for (int k = 0; k < LANE_GROUPS; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const T* r = src[j];
#pragma unroll
      for (int k = 0; k < LANE_GROUPS; ++k) {
        const int cg = c0 + lane + 32 * k;
        if (cg < G) {
          float x[V];
          Io<T, V>::load(r + (size_t)cg * V, x);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k][v] += x[v];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < LANE_GROUPS; ++k) {
      const int cg = c0 + lane + 32 * k;
      if (cg < G) Io<O, V>::store(out + (size_t)cg * V, acc[k]);
    }
  }
}

// Tile t = blockIdx.x * warps + warp: slots t * RUN_TILE on of the sorted
// order.  src [n]: each sorted slot's gradient row.  head / tail [P]:
// zeroed; each run's first slot and one past its last.  part [2 * tiles,
// D] float32: part[2t] the sum of the tile's slots of its first run, where
// that run continues from the tile before or (the tile holding one run)
// into the next; part[2t + 1] that of its last run, where it is another
// run and continues into the next tile.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
embed_bwd_tiles(const __grid_constant__ Pieces pc,
                const int* __restrict__ sorted,
                const long long* __restrict__ perm, int n, int P, int D,
                const T** src, int* __restrict__ head,
                int* __restrict__ tail, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int lo = t * RUN_TILE;
  if (lo >= n) return;
  const int cnt = min(RUN_TILE, n - lo);
  const bool in = lane < cnt;
  const int id = in ? sorted[lo + lane] : -1;
  if (in) src[lo + lane] = source_row<T>(pc, perm[lo + lane], D);
  int prev = __shfl_up_sync(FULL, id, 1);
  int next = __shfl_down_sync(FULL, id, 1);
  if (lane == 0) prev = lo > 0 ? sorted[lo - 1] : -1;
  if (lane == cnt - 1) next = lo + cnt < n ? sorted[lo + cnt] : -1;
  if (in && id >= 0 && id < P) {
    if (id != prev) head[id] = lo + lane;
    if (id != next) tail[id] = lo + lane + 1;
  }
  const int a = __shfl_sync(FULL, id, 0);
  const int b = __shfl_sync(FULL, id, cnt - 1);
  const bool a_left = lo > 0 && __shfl_sync(FULL, prev, 0) == a;
  const bool b_right = lo + cnt < n && __shfl_sync(FULL, next, cnt - 1) == b;
  const bool need_first = a_left || (a == b && b_right);
  const bool need_last = a != b && b_right;
  if (!need_first && !need_last) return;
  const int na = __popc(__ballot_sync(FULL, in && id == a));
  const int nb = __popc(__ballot_sync(FULL, in && id == b));
  __syncwarp();                     // the lanes' src entries, to the warp
  if (need_first)
    warp_sum_rows<T, float, V>(src + lo, na, D, part + (size_t)(2 * t) * D);
  if (need_last)
    warp_sum_rows<T, float, V>(src + lo + cnt - nb, nb, D,
                               part + (size_t)(2 * t + 1) * D);
}

// Block t: the run that starts in tile t, if it is longer than a tile,
// from its tile partials (first: the partial of its first tile; then
// part[2t'] of each later tile t' it reaches), into its row of d_table.
template <typename T, int V>
__global__ void __launch_bounds__(LONG_NT)
embed_bwd_long(const int* __restrict__ sorted, int n, int P, int D,
               const int* __restrict__ head, const int* __restrict__ tail,
               const float* __restrict__ part, T* __restrict__ dtab) {
  __shared__ float red[RED_FLOATS];
  const int t = blockIdx.x;
  const int lo = t * RUN_TILE;
  const int id = sorted[min(lo + RUN_TILE, n) - 1];
  if (id < 0 || id >= P) return;
  const int h = head[id], e = tail[id];
  if (h < lo || e - h <= RUN_TILE) return;
  const int m = (e - 1) / RUN_TILE - t + 1;        // partials
  const int first = 2 * t + (h == lo ? 0 : 1);
  const int G = D / V;
  const int W = ways(D);
  T* out = dtab + (size_t)id * D;
  for (int it = threadIdx.x; it < W * G; it += LONG_NT) {
    const int w = it / G, cg = it - w * G;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
    for (int i = w; i < m; i += W) {
      const int q = i == 0 ? first : 2 * (t + i);
      float x[V];
      Io<float, V>::load(part + (size_t)q * D + (size_t)cg * V, x);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += x[v];
    }
    if (W == 1) {
      Io<T, V>::store(out + (size_t)cg * V, acc);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) red[it * V + v] = acc[v];
    }
  }
  if (W == 1) return;
  __syncthreads();
  for (int cg = threadIdx.x; cg < G; cg += LONG_NT) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = red[cg * V + v];
    for (int w = 1; w < W; ++w)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += red[(w * G + cg) * V + v];
    Io<T, V>::store(out + (size_t)cg * V, acc);
  }
}

// A warp a row r of d_table: its run of at most RUN_TILE slots summed in
// slot order, or zeros; a longer run is embed_bwd_long's.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
embed_bwd_rows(const T* const* src, int P, int D,
               const int* __restrict__ head, const int* __restrict__ tail,
               T* __restrict__ dtab) {
  const int r = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (r >= P) return;
  const int h = head[r], len = tail[r] - h;
  if (len > RUN_TILE) return;
  warp_sum_rows<T, T, V>(src + h, len, D, dtab + (size_t)r * D);
}

template <typename T, int V>
int launch(const Pieces& pc, const int* sorted, const long long* perm,
           int n, int P, int D, const T** src, int* head, int* tail,
           float* part, T* dtab, cudaStream_t stream) {
  const int n_tiles = (n + RUN_TILE - 1) / RUN_TILE;
  if (n_tiles > 0) {
    embed_bwd_tiles<T, V><<<(n_tiles + NWARPS - 1) / NWARPS, NT, 0,
                            stream>>>(pc, sorted, perm, n, P, D, src, head,
                                      tail, part);
    embed_bwd_long<T, V><<<n_tiles, LONG_NT, 0, stream>>>(
        sorted, n, P, D, head, tail, part, dtab);
  }
  embed_bwd_rows<T, V><<<(P + NWARPS - 1) / NWARPS, NT, 0, stream>>>(
      src, P, D, head, tail, dtab);
  return (int)cudaGetLastError();
}

template <typename T>
void attrs(int vec, int* out) {
  const void* fns[3] = {
      (const void*)(vec ? embed_bwd_tiles<T, 4> : embed_bwd_tiles<T, 1>),
      (const void*)(vec ? embed_bwd_long<T, 4> : embed_bwd_long<T, 1>),
      (const void*)(vec ? embed_bwd_rows<T, 4> : embed_bwd_rows<T, 1>)};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, fns[k]);
    out[2 * k] = a.numRegs;
    out[2 * k + 1] = (int)a.localSizeBytes;
  }
}

}  // namespace

extern "C" {

// slots a tile, the pieces a launch takes, the ways of the long-run tree
// at width D (ops/embed.py reads them)
int srt_embed_tile() { return RUN_TILE; }
int srt_embed_max_pieces() { return MAX_PIECES; }
int srt_embed_ways(int D) { return ways(D); }

// out[0], out[1]: embed_bwd_tiles's registers and local memory bytes per
// thread; out[2], out[3]: embed_bwd_long's; out[4], out[5]: embed_bwd_rows's
int srt_embed_bwd_attrs(int is_bf16, int vec, int* out) {
  if (is_bf16)
    attrs<__nv_bfloat16>(vec, out);
  else
    attrs<float>(vec, out);
  return (int)cudaGetLastError();
}

// d_table [P, D] (the gradients' type) of n slots: the gradient rows of
// piece k (ptrs[k], row-major [rows, D]) are the slots from begins[k] on,
// in the gathers' order; sorted [n] int32 the slots' ids in a stable order
// by id, perm [n] int64 their positions.  Scratch: src [n] pointers,
// head_tail [2P] int32 (zeroed here), part [2 * ceil(n / RUN_TILE), D]
// float32.  vec: D % 4 == 0 and every row array aligned to four elements.
int srt_embed_bwd(const void* const* ptrs, const long long* begins,
                  int count, const void* sorted, const void* perm, int n,
                  int P, int D, int is_bf16, int vec, void* src,
                  void* head_tail, void* part, void* dtab, void* stream) {
  if (count < 1 || count > MAX_PIECES || P < 1 || D < 1 || n < 0 ||
      (vec && D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Pieces pc = {};
  for (int k = 0; k < count; ++k) {
    pc.ptr[k] = ptrs[k];
    pc.begin[k] = begins[k];
  }
  pc.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* head = static_cast<int*>(head_tail);
  const cudaError_t err =
      cudaMemsetAsync(head, 0, sizeof(int) * 2 * (size_t)P, s);
  if (err != cudaSuccess) return (int)err;
  const int* ids = static_cast<const int*>(sorted);
  const long long* pos = static_cast<const long long*>(perm);
  float* pt = static_cast<float*>(part);
  if (is_bf16) {
    using B = __nv_bfloat16;
    auto* out = static_cast<B*>(dtab);
    auto** rows = static_cast<const B**>(src);
    return vec ? launch<B, 4>(pc, ids, pos, n, P, D, rows, head, head + P,
                              pt, out, s)
               : launch<B, 1>(pc, ids, pos, n, P, D, rows, head, head + P,
                              pt, out, s);
  }
  auto* out = static_cast<float*>(dtab);
  auto** rows = static_cast<const float**>(src);
  return vec ? launch<float, 4>(pc, ids, pos, n, P, D, rows, head, head + P,
                                pt, out, s)
             : launch<float, 1>(pc, ids, pos, n, P, D, rows, head, head + P,
                                pt, out, s);
}

}  // extern "C"
