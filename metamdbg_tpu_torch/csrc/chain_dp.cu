// Kernel K4: the correction read mapper's chain DP, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA scan
// metamdbg_tpu/kernels/chain_jax.py:_chainer (chain_dp_device), and with it
// the host twins native/sketch.cpp:chain_corr_batch (the DP) and
// chain_mapper_batch (the DP, the backtrack and the match positions). Plain
// version: metamdbg_tpu_torch/kernels/chain_dp.py:chain_dp_reference.
//
// Input: flat anchor arrays (ref_pos, q_pos as int32 base-space pair
// centres in [0, 2^30), is_rev as u8, q_idx as int32 query pair indexes),
// one group per (query read, target read) pair, group g holding anchors
// [offsets[g], offsets[g+1]) sorted by (ref, query). For anchor i of a group,
// predecessor j (i-band <= j < i, j in the group) qualifies iff it is on the
// same strand, its ref and query positions both differ from i's,
// d_q <= max_dist and d_r <= max_dist, d_r > 0, |d_r - d_q| <= max_gap, and
// the query order agrees with i's strand; d_q takes its sign from i's strand
// (chain_jax.py:56-64). Its candidate is score_j + (w - (float)gap), in that
// order, in f32, with no contraction. The best candidate is the first
// strictly greater one scanning j from i-1 down; it is taken iff > 0, else
// the anchor starts a chain (score w, parent -1). Per group, best_index is
// the first anchor with the maximum score if > 0, else -1.
//
// Then, in the same thread, the backtrack (correction/mapper.py:78-99): the
// chain from best_index to its root has chain_len anchors; its score is
// nb_matches - diff_q = 2 * chain_len - 1 - |q_idx(best) - q_idx(root)|, or
// INT32_MIN below 3 anchors; its q_idx values go, ascending, into the first
// chain_len slots of the group's own slice of chain_pos, and -1 into the
// rest (a chain is a subset of its group, so the slice always holds it).
//
// What bounds it on this card: latency. The work is ~15 integer and 2 f32
// operations for each of <= band predecessors of each anchor and ~25 bytes
// of inputs and outputs per anchor, well under a millisecond at the
// correction mapper's ~10^7 anchors; but the DP is sequential along a group,
// so the kernel takes at least as long as its longest group takes one
// thread. The design is the simple one: one thread per group walks its
// anchors in order. The band is a run-time value (62 at the default
// density), too wide for K3's unrolled register shift register, so each
// predecessor is read back from the group's own anchors and from the scores
// this thread has just written: a group's few hundred bytes stay in L1. Any
// group length is taken, in one launch. No shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__device__ void sift_down(int32_t* a, int root, int end) {
  while (true) {
    int child = 2 * root + 1;
    if (child >= end) return;
    if (child + 1 < end && a[child + 1] > a[child]) ++child;
    if (a[root] >= a[child]) return;
    const int32_t t = a[root];
    a[root] = a[child];
    a[child] = t;
    root = child;
  }
}

// In-place heap sort of a[0, n), for a chain whose q_idx values are not
// monotone (they are on real anchors, whose centres rise with q_idx).
__device__ void heap_sort(int32_t* a, int n) {
  for (int r = n / 2 - 1; r >= 0; --r) sift_down(a, r, n);
  for (int end = n - 1; end > 0; --end) {
    const int32_t t = a[0];
    a[0] = a[end];
    a[end] = t;
    sift_down(a, 0, end);
  }
}

__global__ void chain_dp_kernel(const int32_t* __restrict__ ref_pos,
                                const int32_t* __restrict__ q_pos,
                                const uint8_t* __restrict__ is_rev,
                                const int32_t* __restrict__ q_idx,
                                const int64_t* __restrict__ offsets,
                                int64_t n_groups, int band, float w,
                                int max_dist, int max_gap, float* scores,
                                int32_t* parents,
                                int32_t* __restrict__ best_index,
                                int32_t* __restrict__ chain_len,
                                int32_t* __restrict__ chain_score,
                                int32_t* chain_pos) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int64_t lo = offsets[g];
  const int64_t hi = offsets[g + 1];
  const int n = (int)(hi - lo);
  const int32_t* rp = ref_pos + lo;
  const int32_t* qp = q_pos + lo;
  const uint8_t* rv = is_rev + lo;
  float* sc = scores + lo;
  int32_t* par = parents + lo;

  float best_score = 0.0f;
  int best_i = -1;
  for (int i = 0; i < n; ++i) {
    const int rp_i = rp[i];
    const int qp_i = qp[i];
    const int rv_i = rv[i];
    float best = -CUDART_INF_F;
    int best_j = -1;
    const int j_end = i - band > 0 ? i - band : 0;
    for (int j = i - 1; j >= j_end; --j) {
      const int rp_j = rp[j];
      const int qp_j = qp[j];
      const int d_r = rp_i - rp_j;
      const int d_q = rv_i ? qp_j - qp_i : qp_i - qp_j;
      const int gap = abs(d_r - d_q);
      const bool order = rv_i ? !(qp_i > qp_j) : !(qp_i < qp_j);
      const bool ok = rv[j] == rv_i && rp_j != rp_i && qp_j != qp_i &&
                      d_q <= max_dist && d_r <= max_dist && d_r > 0 &&
                      gap <= max_gap && order;
      if (ok) {
        const float cand = __fadd_rn(sc[j], __fsub_rn(w, (float)gap));
        if (cand > best) {
          best = cand;
          best_j = j;
        }
      }
    }
    float s = w;
    int parent = -1;
    if (best > 0.0f) {
      s = best;
      parent = best_j;
    }
    sc[i] = s;
    par[i] = parent;
    if (s > best_score) {
      best_score = s;
      best_i = i;
    }
  }
  best_index[g] = best_i;

  // the best chain, root first, into the group's slice of chain_pos
  int32_t* pos = chain_pos + lo;
  int len = 0;
  for (int a = best_i; a != -1; a = par[a]) ++len;
  int t = len;
  for (int a = best_i; a != -1; a = par[a]) pos[--t] = q_idx[lo + a];
  int score = INT_MIN;
  if (len >= 3) score = 2 * len - 1 - abs(q_idx[lo + best_i] - pos[0]);
  bool ascending = true, descending = true;
  for (int k = 1; k < len; ++k) {
    ascending = ascending && pos[k - 1] <= pos[k];
    descending = descending && pos[k - 1] >= pos[k];
  }
  if (!ascending && descending) {
    for (int k = 0; k < len / 2; ++k) {
      const int32_t x = pos[k];
      pos[k] = pos[len - 1 - k];
      pos[len - 1 - k] = x;
    }
  } else if (!ascending) {
    heap_sort(pos, len);
  }
  for (int k = len; k < n; ++k) pos[k] = -1;
  chain_len[g] = len;
  chain_score[g] = score;
}

}  // namespace

extern "C" int chain_dp_launch(const void* ref_pos, const void* q_pos,
                               const void* is_rev, const void* q_idx,
                               const void* offsets, long long n_groups,
                               int band, float w, int max_dist, int max_gap,
                               void* scores, void* parents, void* best_index,
                               void* chain_len, void* chain_score,
                               void* chain_pos, void* stream) {
  if (n_groups > 0) {
    const long long blocks = (n_groups + kThreads - 1) / kThreads;
    chain_dp_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ref_pos, (const int32_t*)q_pos,
        (const uint8_t*)is_rev, (const int32_t*)q_idx,
        (const int64_t*)offsets, (int64_t)n_groups, band, w, max_dist,
        max_gap, (float*)scores, (int32_t*)parents, (int32_t*)best_index,
        (int32_t*)chain_len, (int32_t*)chain_score, (int32_t*)chain_pos);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* chain_dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
