// Kernel K3: the read-vs-contig chain DP, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA scan
// metamdbg_tpu/kernels/chain_jax.py:_chainer_contig (chain_contig_device),
// and with it the host DP basespace/contig_mapper.py:_chain and
// native/sketch.cpp:chain_batch it is held against. Plain version:
// metamdbg_tpu_torch/kernels/chain.py:chain_contig_reference.
//
// Input: flat anchor arrays (ref_pos, q_pos, q_bp as int32, is_rev as u8),
// one group per candidate (read, contig) pair, group g holding anchors
// [offsets[g], offsets[g+1]) sorted by (ref, query). For anchor i of a group,
// predecessor j (i-10 <= j < i, j in the group) qualifies iff it is on the
// same strand, its ref and query positions both differ from i's,
// 0 < d_r <= d_r_max, |d_r - d_q| <= max_gap, the base-space spacing is
// <= bp_cap, and the query order agrees with the strand
// (ReadVsContigMapper.hpp:820-866). Its candidate is
// score_j + (w - (float)gap), in that order, in f32, with no contraction.
// The best candidate is the first strictly greater one scanning j from i-1
// down; it is taken iff > 0, else the anchor starts a chain (score w,
// parent -1). Outputs: scores (f32), parents (int32, group-local), and per
// group best_index, the first anchor with the maximum score if > 0, else -1.
//
// What bounds it on this card: latency. The work is ~15 integer and f32
// operations for each of <= 10 predecessors of each anchor and ~21 bytes
// of inputs and outputs per anchor, microseconds for the 4 Mb run's ~0.5 M
// anchors; but the DP is sequential along a group, so the kernel takes at
// least as long as its longest group takes one thread. The design is the
// simple one: one thread per group walks its anchors in order and keeps the
// 10-deep band (score, ref, query, query bp, strand) in registers as a shift
// register (fully unrolled, so no local memory). Any group length is taken,
// in one launch. No shared memory.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBand = 10;

__global__ void chain_contig_kernel(const int32_t* __restrict__ ref_pos,
                                    const int32_t* __restrict__ q_pos,
                                    const int32_t* __restrict__ q_bp,
                                    const uint8_t* __restrict__ is_rev,
                                    const int64_t* __restrict__ offsets,
                                    int64_t n_groups, int d_r_max, float w,
                                    int max_gap, int bp_cap,
                                    float* __restrict__ scores,
                                    int32_t* __restrict__ parents,
                                    int32_t* __restrict__ best_index) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int64_t lo = offsets[g];
  const int64_t hi = offsets[g + 1];

  // band slot t holds anchor i-1-t
  float b_sc[kBand];
  int b_rp[kBand], b_qp[kBand], b_qb[kBand], b_rv[kBand];
#pragma unroll
  for (int t = 0; t < kBand; ++t) {
    b_sc[t] = 0.0f;
    b_rp[t] = b_qp[t] = b_qb[t] = 0;
    b_rv[t] = 2;  // matches no strand: the slot is empty
  }

  float best_score = 0.0f;
  int best_i = -1;
  for (int64_t a = lo; a < hi; ++a) {
    const int i = (int)(a - lo);
    const int rp = ref_pos[a];
    const int qp = q_pos[a];
    const int qb = q_bp[a];
    const int rv = is_rev[a];

    float best = -CUDART_INF_F;
    int best_t = -1;
#pragma unroll
    for (int t = 0; t < kBand; ++t) {
      const int d_r = rp - b_rp[t];
      const int d_q = rv ? b_qp[t] - qp : qp - b_qp[t];
      const int gap = abs(d_r - d_q);
      const int d_bp = rv ? b_qb[t] - qb : qb - b_qb[t];
      const bool order = rv ? !(qp > b_qp[t]) : !(qp < b_qp[t]);
      const bool ok = b_rv[t] == rv && b_rp[t] != rp && b_qp[t] != qp &&
                      d_r > 0 && d_r <= d_r_max && gap <= max_gap &&
                      d_bp <= bp_cap && order;
      if (ok) {
        const float cand = __fadd_rn(b_sc[t], __fsub_rn(w, (float)gap));
        if (cand > best) {
          best = cand;
          best_t = t;
        }
      }
    }
    float sc = w;
    int parent = -1;
    if (best > 0.0f) {
      sc = best;
      parent = i - 1 - best_t;
    }
    scores[a] = sc;
    parents[a] = parent;
    if (sc > best_score) {
      best_score = sc;
      best_i = i;
    }

#pragma unroll
    for (int t = kBand - 1; t > 0; --t) {
      b_sc[t] = b_sc[t - 1];
      b_rp[t] = b_rp[t - 1];
      b_qp[t] = b_qp[t - 1];
      b_qb[t] = b_qb[t - 1];
      b_rv[t] = b_rv[t - 1];
    }
    b_sc[0] = sc;
    b_rp[0] = rp;
    b_qp[0] = qp;
    b_qb[0] = qb;
    b_rv[0] = rv;
  }
  best_index[g] = best_i;
}

}  // namespace

extern "C" int chain_contig_launch(const void* ref_pos, const void* q_pos,
                                   const void* q_bp, const void* is_rev,
                                   const void* offsets, long long n_groups,
                                   int d_r_max, float w, int max_gap,
                                   int bp_cap, void* scores, void* parents,
                                   void* best_index, void* stream) {
  if (n_groups > 0) {
    const long long blocks = (n_groups + kThreads - 1) / kThreads;
    chain_contig_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)ref_pos, (const int32_t*)q_pos, (const int32_t*)q_bp,
        (const uint8_t*)is_rev, (const int64_t*)offsets, (int64_t)n_groups,
        d_r_max, w, max_gap, bp_cap, (float*)scores, (int32_t*)parents,
        (int32_t*)best_index);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* chain_contig_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
