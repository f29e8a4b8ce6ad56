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
// Then the backtrack (correction/mapper.py:78-99): the chain from
// best_index to its root has chain_len anchors; its score is
// nb_matches - diff_q = 2 * chain_len - 1 - |q_idx(best) - q_idx(root)|, or
// INT32_MIN below 3 anchors; its q_idx values go, ascending, into the first
// chain_len slots of the group's own slice of chain_pos, and -1 into the
// rest (a chain is a subset of its group, so the slice always holds it).
//
// What bounds it on this card: bytes on the mapper's groups (~25 bytes in
// and out per anchor against ~15 integer operations per test, and a few
// tests per anchor in groups of 3-36), latency on long ones (the DP is
// sequential along a group). The design (chain_band.cuh): a block of one
// warp takes about kTile anchors of consecutive groups and stages them in
// shared memory with TMA bulk copies; one thread per group walks it, the
// run-time band over as many predecessors as reach back in the group, the
// score of i - 1 in a register. Small blocks keep many warps on an SM to
// hide each step's latency. Then one thread per group finds best_index,
// follows the parents back through shared memory and sorts the chain's
// q_idx there (a heap sort only when the chain is neither ascending nor
// descending), and the block writes scores, parents and chain_pos back with
// coalesced stores. A group too long for the span runs last as a 32-lane
// team from device memory, the band over the lanes and the scores of the
// last 64 anchors in registers (the backtrack through windows of the
// parents copied to shared memory).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chain_band.cuh"

namespace {

using chain_band::Tile;

constexpr int kThreads = 32;
constexpr int kTile = 256;
constexpr int kCap = 384;  // staged anchors: kTile plus room for longer groups

// An int32 with the order of the f32 `f` (finite or infinite, not NaN), and
// back.
__device__ __forceinline__ int f32_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_f32(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

struct Best {
  float score;  // -inf when no predecessor chains
  int j;        // -1 then
};

// Anchor i's best predecessor over the team's L lanes (lane t of mask), in
// the numbering of `src` (Src::anchor(j), Src::score(j, d) of j = i-1-d, and
// the rule Src::chains(i, j, &gap)); gs is the first anchor of i's group and
// prev_s the score of i - 1. Every lane of the team returns the same result.
template <int L, class Src>
__device__ __forceinline__ Best band_best(const Src& src, int i, int gs,
                                          int band, float prev_s, float w,
                                          int t, unsigned mask) {
  const typename Src::Anchor ai = src.anchor(i);
  const int reach = min(i - gs, band);
  float best = -CUDART_INF_F;
  int best_j = -1;
  for (int d = t; d < reach; d += L) {
    const int j = i - 1 - d;
    int gap;
    if (src.chains(ai, src.anchor(j), &gap)) {
      const float sj = d == 0 ? prev_s : src.score(j, d);
      const float cand = __fadd_rn(sj, __fsub_rn(w, (float)gap));
      if (cand > best) {
        best = cand;
        best_j = j;
      }
    }
  }
  if constexpr (L > 1) {
    const int key = f32_key(best);
    const int top = __reduce_max_sync(mask, key);
    best_j = __reduce_max_sync(mask, key == top ? best_j : -1);
    best = key_f32(top);
  }
  return {best, best_j};
}

// A whole warp's register window over the scores of the 64 anchors before
// i: lane t holds those of i-1-t (near) and i-33-t (far), the predecessors
// it tests in its first two slots, so a group run from device memory reads
// no recent score back through the memory system. push(s) moves the window
// on by one anchor, of score s.
struct ScoreWindow {
  float near = 0.0f, far = 0.0f;

  __device__ __forceinline__ void push(float s) {
    const float out = __shfl_sync(0xffffffffu, near, 31);
    far = __shfl_up_sync(0xffffffffu, far, 1);
    near = __shfl_up_sync(0xffffffffu, near, 1);
    if ((threadIdx.x & 31) == 0) {
      far = out;
      near = s;
    }
  }
};

// Src on a warp team whose lanes' first two slots read `win`.
template <class Src>
struct Windowed : Src {
  const ScoreWindow* win;

  __device__ __forceinline__ float score(int j, int d) const {
    return d < 32 ? win->near : d < 64 ? win->far : Src::score(j, d);
  }
};


// The mapper's rule for predecessor j of anchor i, over any anchor arrays
// (shared or device memory).
struct DpSrc {
  const int32_t* rp;
  const int32_t* qp;
  const uint8_t* rv;
  const float* sc;
  int max_dist, max_gap;

  struct Anchor {
    int rp, qp, rv;
  };

  __device__ __forceinline__ Anchor anchor(int j) const {
    return {rp[j], qp[j], rv[j] & 1};
  }

  __device__ __forceinline__ float score(int j, int) const { return sc[j]; }

  __device__ __forceinline__ bool chains(const Anchor& i, const Anchor& j,
                                         int* gap) const {
    const int d_r = i.rp - j.rp;
    const int d_q = i.rv ? j.qp - i.qp : i.qp - j.qp;
    *gap = abs(d_r - d_q);
    const bool order = i.rv ? !(i.qp > j.qp) : !(i.qp < j.qp);
    return j.rv == i.rv && j.rp != i.rp && j.qp != i.qp &&
           d_q <= max_dist && d_r <= max_dist && d_r > 0 &&
           *gap <= max_gap && order;
  }
};

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

// chain_pos of one group, by one thread: `pos` holds the chain's q_idx from
// the best anchor to the root; sorts them ascending and fills the group's
// other n - len slots with -1. Returns the chain's score.
__device__ int finish_chain(int32_t* pos, int len, int n) {
  int score = INT_MIN;
  if (len >= 3) score = 2 * len - 1 - abs(pos[0] - pos[len - 1]);
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
  return score;
}

struct Args {
  const int32_t* ref_pos;
  const int32_t* q_pos;
  const uint8_t* is_rev;
  const int32_t* q_idx;
  const int64_t* offsets;
  int64_t n_groups;
  int band;
  float w;
  int max_dist, max_gap;
  float* scores;
  int32_t* parents;
  int32_t* best_index;
  int32_t* chain_len;
  int32_t* chain_score;
  int32_t* chain_pos;
};

// Shared memory: the mbarrier, then ref_pos, q_pos, q_idx and is_rev as
// staged (q_pos's room holds chain_pos once the DP is done), then the
// span's scores and parents.
template <int CAP>
struct Layout {
  static constexpr int kRp = 16;
  static constexpr int kQp = kRp + chain_band::staged_bytes(CAP, 4);
  static constexpr int kQi = kQp + chain_band::staged_bytes(CAP, 4);
  static constexpr int kRv = kQi + chain_band::staged_bytes(CAP, 4);
  static constexpr int kSc = kRv + chain_band::staged_bytes(CAP, 1);
  static constexpr int kPar = kSc + CAP * 4;
  static constexpr int kBytes = kPar + CAP * 4;
};

// A group that does not fit in the span, on one warp from device memory:
// the DP as a 32-lane team, the band over the lanes, then the backtrack
// through windows of `win` parents and q_idx copied into the warp's own
// shared `win_par` and `win_qi`.
__device__ void long_group(const Args& a, int64_t g, int32_t* win_par,
                           int32_t* win_qi, int win) {
  const int lane = threadIdx.x & 31;
  const int64_t lo = a.offsets[g];
  const int n = (int)(a.offsets[g + 1] - lo);
  float* sc = a.scores + lo;
  int32_t* par = a.parents + lo;
  ScoreWindow recent;
  const Windowed<DpSrc> src{
      {a.ref_pos + lo, a.q_pos + lo, a.is_rev + lo, sc, a.max_dist,
       a.max_gap},
      &recent};
  float prev_s = 0.0f, top = 0.0f;
  int best = -1;
  for (int i = 0; i < n; ++i) {
    const Best b = band_best<32>(src, i, 0, a.band, prev_s, a.w,
                                             lane, 0xffffffffu);
    float s = a.w;
    int parent = -1;
    if (b.score > 0.0f) {
      s = b.score;
      parent = b.j;
    }
    if (lane == 0) {
      sc[i] = s;
      par[i] = parent;
    }
    if (s > top) {
      top = s;
      best = i;
    }
    prev_s = s;
    recent.push(s);
    // scores more than 64 anchors back are read from device memory: one
    // __syncwarp every 32 anchors orders them after their stores
    if ((i & 31) == 31) __syncwarp();
  }
  __syncwarp();

  // the chain from the best anchor down to its root, window by window
  const int32_t* qi = a.q_idx + lo;
  int32_t* pos = a.chain_pos + lo;
  int len = 0, at = best;
  while (at >= 0) {
    const int wlo = max(0, at + 1 - win);
    for (int x = lane; x <= at - wlo; x += 32) {
      win_par[x] = par[wlo + x];
      win_qi[x] = qi[wlo + x];
    }
    __syncwarp();
    if (lane == 0) {
      while (at >= wlo) {
        pos[len++] = win_qi[at - wlo];
        at = win_par[at - wlo];
      }
    }
    len = __shfl_sync(0xffffffffu, len, 0);
    at = __shfl_sync(0xffffffffu, at, 0);
    __syncwarp();
  }
  const int score = len >= 3 ? 2 * len - 1 - abs(pos[0] - pos[len - 1])
                             : INT_MIN;
  bool ascending = true, descending = true;
  for (int k = 1 + lane; k < len; k += 32) {
    ascending = ascending && pos[k - 1] <= pos[k];
    descending = descending && pos[k - 1] >= pos[k];
  }
  ascending = __all_sync(0xffffffffu, ascending);
  descending = __all_sync(0xffffffffu, descending);
  __syncwarp();  // every lane has read pos[0] and pos[len - 1]
  if (!ascending && descending) {
    for (int k = lane; k < len / 2; k += 32) {
      const int32_t x = pos[k];
      pos[k] = pos[len - 1 - k];
      pos[len - 1 - k] = x;
    }
  } else if (!ascending && lane == 0) {
    heap_sort(pos, len);
  }
  for (int k = len + lane; k < n; k += 32) pos[k] = -1;
  if (lane == 0) {
    a.best_index[g] = best;
    a.chain_len[g] = len;
    a.chain_score[g] = score;
  }
}

template <int NT, int CAP>
__global__ void __launch_bounds__(NT)
    chain_dp_kernel(const Args a, int64_t per_block) {
  using Lay = Layout<CAP>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_rp = reinterpret_cast<int32_t*>(smem + Lay::kRp);
  int32_t* s_qp = reinterpret_cast<int32_t*>(smem + Lay::kQp);
  int32_t* s_qi = reinterpret_cast<int32_t*>(smem + Lay::kQi);
  uint8_t* s_rv = smem + Lay::kRv;
  float* s_sc = reinterpret_cast<float*>(smem + Lay::kSc);
  int32_t* s_par = reinterpret_cast<int32_t*>(smem + Lay::kPar);

  const Tile t =
      chain_band::block_groups<NT>(a.offsets, a.n_groups, per_block, CAP);
  const int m = (int)(t.hi - t.lo);
  const chain_band::Range r[4] = {
      chain_band::span_range(a.ref_pos, t.lo, t.hi, 4),
      chain_band::span_range(a.q_pos, t.lo, t.hi, 4),
      chain_band::span_range(a.q_idx, t.lo, t.hi, 4),
      chain_band::span_range(a.is_rev, t.lo, t.hi, 1)};
  if (threadIdx.x == 0 && m > 0) {
    chain_band::bar_init(bar);
    chain_band::bar_expect(bar, r[0].bytes + r[1].bytes + r[2].bytes +
                                    r[3].bytes);
    chain_band::bulk_load(s_rp, r[0].src, r[0].bytes, bar);
    chain_band::bulk_load(s_qp, r[1].src, r[1].bytes, bar);
    chain_band::bulk_load(s_qi, r[2].src, r[2].bytes, bar);
    chain_band::bulk_load(s_rv, r[3].src, r[3].bytes, bar);
  }
  __syncthreads();
  // span-local views of the staged inputs
  const int32_t* rp = s_rp + r[0].pad;
  const int32_t* qp = s_qp + r[1].pad;
  const int32_t* qi = s_qi + r[2].pad;
  const uint8_t* rv = s_rv + r[3].pad;
  if (m > 0) chain_band::bar_wait(bar, 0);

  // the DP: one thread per group of the span
  const DpSrc src{rp, qp, rv, s_sc, a.max_dist, a.max_gap};
  for (int64_t g = t.g0 + threadIdx.x; g < t.g_span; g += NT) {
    const int gs = (int)(a.offsets[g] - t.lo);
    const int ge = (int)(a.offsets[g + 1] - t.lo);
    float prev_s = 0.0f;
    for (int i = gs; i < ge; ++i) {
      const Best b = band_best<1>(src, i, gs, a.band, prev_s,
                                              a.w, 0, 0u);
      float s = a.w;
      int parent = -1;
      if (b.score > 0.0f) {
        s = b.score;
        parent = b.j - gs;
      }
      s_sc[i] = s;
      s_par[i] = parent;
      prev_s = s;
    }
  }
  __syncthreads();

  // one thread per group: best_index, the backtrack and the sorted chain
  int32_t* s_pos = s_qp;  // q_pos is no longer read
  for (int64_t g = t.g0 + threadIdx.x; g < t.g_span; g += NT) {
    const int a0 = (int)(a.offsets[g] - t.lo);
    const int n = (int)(a.offsets[g + 1] - a.offsets[g]);
    float top = 0.0f;
    int best = -1;
    for (int k = 0; k < n; ++k) {
      if (s_sc[a0 + k] > top) {
        top = s_sc[a0 + k];
        best = k;
      }
    }
    int32_t* pos = s_pos + a0;
    int len = 0;
    for (int at = best; at != -1; at = s_par[a0 + at]) pos[len++] = qi[a0 + at];
    const int score = finish_chain(pos, len, n);
    a.best_index[g] = best;
    a.chain_len[g] = len;
    a.chain_score[g] = score;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < m; x += NT) {
    a.scores[t.lo + x] = s_sc[x];
    a.parents[t.lo + x] = s_par[x];
    a.chain_pos[t.lo + x] = s_pos[x];
  }
  if (t.g_span < t.g1) {
    // the span's buffers become the warps' backtrack windows
    __syncthreads();
    constexpr int kWarps = NT / 32, kWin = CAP / kWarps;
    const int warp = threadIdx.x / 32;
    for (int64_t g = t.g_span + warp; g < t.g1; g += kWarps) {
      long_group(a, g, s_par + warp * kWin, s_qi + warp * kWin, kWin);
    }
  }
}

template <int NT, int TILE, int CAP>
int launch(const Args& a, long long n_anchors, cudaStream_t stream) {
  static_assert(NT % 32 == 0 && TILE <= CAP && CAP % 16 == 0,
                "block, tile and span sizes");
  constexpr int bytes = Layout<CAP>::kBytes;
  auto kernel = chain_dp_kernel<NT, CAP>;
  static bool attribute_set = false;  // once, before any graph capture
  if (!attribute_set) {
    // all the shared memory a block asks for, and the most blocks on an SM
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  // groups per block: about TILE anchors at the mean group length
  const long long per_block =
      n_anchors > 0
          ? std::max<long long>(1, (long long)TILE * a.n_groups / n_anchors)
          : (long long)a.n_groups;
  const long long blocks = (a.n_groups + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, NT, bytes, stream>>>(a, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chain_dp_launch(const void* ref_pos, const void* q_pos,
                               const void* is_rev, const void* q_idx,
                               const void* offsets, long long n_groups,
                               long long n_anchors, int band, float w,
                               int max_dist, int max_gap, void* scores,
                               void* parents, void* best_index,
                               void* chain_len, void* chain_score,
                               void* chain_pos, void* stream) {
  if (n_groups <= 0) return 0;
  const Args a{(const int32_t*)ref_pos, (const int32_t*)q_pos,
               (const uint8_t*)is_rev,  (const int32_t*)q_idx,
               (const int64_t*)offsets, (int64_t)n_groups,
               band,                    w,
               max_dist,                max_gap,
               (float*)scores,          (int32_t*)parents,
               (int32_t*)best_index,    (int32_t*)chain_len,
               (int32_t*)chain_score,   (int32_t*)chain_pos};
  return launch<kThreads, kTile, kCap>(a, n_anchors, (cudaStream_t)stream);
}

extern "C" const char* chain_dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
