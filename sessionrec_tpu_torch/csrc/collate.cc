// Host C++ builders of the port's batches, the port's copy of
// native/collate.cc: the SRGNN/NISER session graph, LESSR's mailboxes and
// shortcut graph, and MSGIFSR's CCS heterograph.
//
// Same output, bit for bit, as graph/builders.py (tested in
// tests/test_torch_native_collate.py and tests/test_torch_families.py).
// The Python builders loop over every example under the interpreter lock;
// these run as one C call each through ctypes, which releases the lock,
// so the loader's prefetch thread does not compete with the training loop
// for it.
//
// Built with the host C++ compiler (no nvcc) at first use by
// data/native_collate.py into build/ at the repository root.
//
// Input: the batch's sequences flattened into one int32 array plus an
// offsets array (CSR-style).  Output arrays are allocated, zeroed, by the
// caller at their static padded shapes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Unique items in ascending order + per-position node ids.
// Matches np.unique(seq, return_inverse=True).
inline int unique_nodes(const int32_t* seq, int len, int32_t* items,
                        int32_t* seq_nid) {
  thread_local std::vector<int32_t> buf;
  buf.assign(seq, seq + len);
  int32_t* sorted = buf.data();
  std::sort(sorted, sorted + len);
  int n = 0;
  for (int i = 0; i < len; ++i)
    if (i == 0 || sorted[i] != sorted[i - 1]) items[n++] = sorted[i];
  for (int i = 0; i < len; ++i)
    seq_nid[i] = int(std::lower_bound(items, items + n, seq[i]) - items);
  return n;
}

}  // namespace

extern "C" {

// SRGNN/NISER weighted session graph (builders.build_session_batch).
void srt_build_session(const int32_t* flat, const int32_t* offsets, int B,
                       int N, int32_t* node_iid, float* node_mask, float* adj,
                       int32_t* last_idx) {
  std::vector<int32_t> items, nid;
  for (int b = 0; b < B; ++b) {
    const int32_t* seq = flat + offsets[b];
    const int len = offsets[b + 1] - offsets[b];
    if (len <= 0) continue;
    items.resize(len);
    nid.resize(len);
    const int n = unique_nodes(seq, len, items.data(), nid.data());
    int32_t* iid_b = node_iid + (size_t)b * N;
    float* mask_b = node_mask + (size_t)b * N;
    float* adj_b = adj + (size_t)b * N * N;
    for (int i = 0; i < n; ++i) {
      iid_b[i] = items[i];
      mask_b[i] = 1.0f;
    }
    if (len > 1) {
      for (int t = 1; t < len; ++t) adj_b[nid[t - 1] * N + nid[t]] += 1.0f;
    } else {
      adj_b[0] = 1.0f;  // self-loop 0 -> 0 of weight 1 (collate.py:74-76)
    }
    last_idx[b] = nid[len - 1];
  }
}

// LESSR EOP mailboxes + shortcut graph (builders.build_lessr_batch); M is
// the mailbox depth.
void srt_build_lessr(const int32_t* flat, const int32_t* offsets, int B,
                     int N, int M, int32_t* node_iid, float* node_mask,
                     int32_t* mail_idx, float* mail_mask, float* sc_adj,
                     int32_t* last_idx) {
  std::vector<int32_t> items, nid, deg;
  for (int b = 0; b < B; ++b) {
    const int32_t* seq = flat + offsets[b];
    const int len = offsets[b + 1] - offsets[b];
    if (len <= 0) continue;
    items.resize(len);
    nid.resize(len);
    deg.assign(len, 0);
    const int n = unique_nodes(seq, len, items.data(), nid.data());
    int32_t* iid_b = node_iid + (size_t)b * N;
    float* mask_b = node_mask + (size_t)b * N;
    int32_t* mi_b = mail_idx + (size_t)b * N * M;
    float* mm_b = mail_mask + (size_t)b * N * M;
    float* sc_b = sc_adj + (size_t)b * N * N;
    for (int i = 0; i < n; ++i) {
      iid_b[i] = items[i];
      mask_b[i] = 1.0f;
    }
    for (int t = 1; t < len; ++t) {
      const int v = nid[t], u = nid[t - 1];
      mi_b[v * M + deg[v]] = u;
      mm_b[v * M + deg[v]] = 1.0f;
      ++deg[v];
    }
    for (int i = 0; i < len; ++i)
      for (int j = i; j < len; ++j) sc_b[nid[i] * N + nid[j]] = 1.0f;
    last_idx[b] = nid[len - 1];
  }
}

// MSGIFSR CCS heterograph (builders.build_ccs_batch).
//
// Per-level output pointers are passed as arrays of pointers; caps[k]
// is level k+1's node capacity (max_len - k).  inter_in / inter_out
// exist for levels >= 2 (indexed by k-2).
void srt_build_ccs(const int32_t* flat, const int32_t* offsets, int B, int K,
                   int N, int32_t** iid_ptrs, float** mask_ptrs,
                   float** intra_ptrs, int32_t** last_ptrs,
                   float** inter_in_ptrs, float** inter_out_ptrs,
                   const int32_t* caps) {
  std::vector<int32_t> items, nid;
  // gram ids per position, per level (level index k-1)
  std::vector<std::vector<int32_t>> gram_of_pos(K + 1);
  for (int b = 0; b < B; ++b) {
    const int32_t* seq = flat + offsets[b];
    const int len = offsets[b + 1] - offsets[b];
    if (len <= 0) continue;
    items.resize(len);
    nid.resize(len);
    const int n = unique_nodes(seq, len, items.data(), nid.data());
    const int eff_order = std::min(K, len);

    // level 1
    {
      const int Nk = caps[0];
      int32_t* iid_b = iid_ptrs[0] + (size_t)b * Nk;  // [Nk, 1]
      float* mask_b = mask_ptrs[0] + (size_t)b * Nk;
      float* intra_b = intra_ptrs[0] + (size_t)b * Nk * Nk;
      for (int i = 0; i < n; ++i) {
        iid_b[i] = items[i];
        mask_b[i] = 1.0f;
      }
      for (int t = 1; t < len; ++t)
        intra_b[nid[t - 1] * Nk + nid[t]] = 1.0f;
      last_ptrs[0][b] = nid[len - 1];
    }

    for (int k = 2; k <= K; ++k) {
      const int Nk = caps[k - 1];
      int32_t* iid_b = iid_ptrs[k - 1] + (size_t)b * Nk * k;  // [Nk, k]
      float* mask_b = mask_ptrs[k - 1] + (size_t)b * Nk;
      float* intra_b = intra_ptrs[k - 1] + (size_t)b * Nk * Nk;
      if (k <= eff_order) {
        // distinct k-grams in first-occurrence order
        auto& gp = gram_of_pos[k];
        gp.assign(len - k + 1, 0);
        int m = 0;
        for (int j = 0; j + k <= len; ++j) {
          int found = -1;
          for (int g = 0; g < m; ++g) {
            if (std::memcmp(iid_b + (size_t)g * k, seq + j,
                            k * sizeof(int32_t)) == 0) {
              found = g;
              break;
            }
          }
          if (found < 0) {
            std::memcpy(iid_b + (size_t)m * k, seq + j, k * sizeof(int32_t));
            found = m++;
          }
          gp[j] = found;
        }
        for (int i = 0; i < m; ++i) mask_b[i] = 1.0f;
        const int P = len - k + 1;  // number of gram positions
        for (int i = 0; i + 1 < P; ++i)
          intra_b[gp[i] * Nk + gp[i + 1]] = 1.0f;
        last_ptrs[k - 1][b] = gp[P - 1];
        const int N1 = caps[0];
        float* ii_b = inter_in_ptrs[k - 2] + (size_t)b * N1 * Nk;
        float* io_b = inter_out_ptrs[k - 2] + (size_t)b * Nk * N1;
        for (int i = 0; i + k < len; ++i) {
          ii_b[nid[i] * Nk + gp[i + 1]] = 1.0f;
          io_b[gp[i] * N1 + nid[i + k]] = 1.0f;
        }
      } else {
        // pad level: one node, iid = smallest item repeated, no edges
        for (int j = 0; j < k; ++j) iid_b[j] = items[0];
        mask_b[0] = 1.0f;
        last_ptrs[k - 1][b] = 0;
      }
    }
  }
}

}  // extern "C"
