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
// of inputs and outputs per anchor, microseconds for the 4 Mb run's ~0.4 M
// anchors; but the DP is sequential along a group. The design
// (chain_band.cuh): a block takes about kTile anchors of consecutive groups
// and stages them in shared memory with TMA bulk copies; its threads test
// every (anchor, predecessor) pair of the span in parallel, the band over
// the lanes, into one 16-byte row of gaps per anchor; then one thread per
// group walks its rows with the band's ten scores in registers, each row
// read one anchor ahead, so a step's chain is ten f32 adds and compares.
// best_index comes out of the walk, and the block writes scores and parents
// back with coalesced stores. A group too long for the span is tested by
// the block and walked by one thread, chunk by chunk.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chain_band.cuh"

namespace {

using chain_band::Tile;

constexpr int kBand = 10;
constexpr int kRowBytes = 16;  // a gap row: kBand bytes, padded
constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kCap = 2048;  // staged anchors: kTile plus room for longer groups

// Predecessor gap rows. Row x holds, for d < W, the gap of predecessor
// x-1-d as one byte if that anchor chains to x, else kNoChain: the rule's
// whole verdict, so the walk below reads one row per anchor and no anchor.
// Gaps are at most max_gap <= 254.
constexpr uint8_t kNoChain = 255;

// Row x of anchors `src` (Src::anchor, Src::chains; group-local or span-local
// numbering): predecessors x-1-d for d < min(reach, W); first_of_group(y)
// says whether anchor y starts a group, so d stops at x's group start.
template <int W, int RB, class Src, class First>
__device__ __forceinline__ void gap_row(const Src& src, int x, int band,
                                        const First& first_of_group,
                                        uint8_t* row) {
  const typename Src::Anchor ax = src.anchor(x);
  uint32_t words[RB / 4];
#pragma unroll
  for (int k = 0; k < RB / 4; ++k) words[k] = 0xffffffffu;
  bool open = true;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    open = open && d < band && !first_of_group(x - d);
    if (open) {
      int gap;
      if (src.chains(ax, src.anchor(x - 1 - d), &gap)) {
        words[d / 4] &= ~(0xffu << (8 * (d % 4)));
        words[d / 4] |= (uint32_t)gap << (8 * (d % 4));
      }
    }
  }
  uint4* out = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int k = 0; k < RB / 16; ++k) {
    out[k] = make_uint4(words[4 * k], words[4 * k + 1], words[4 * k + 2],
                        words[4 * k + 3]);
  }
}

// (float)g for a byte g, exactly: 2^23 + g has g in its low mantissa bits.
__device__ __forceinline__ float byte_f32(uint32_t g) {
  return __fsub_rn(__int_as_float(0x4b000000 | g), 8388608.0f);
}

// One thread's walk of one group's rows [x0, x1) (RB bytes each) with the
// last W scores in registers (win[d] is the score of x-1-d): each anchor's
// score and parent (relative to `base`) into sc and par; `top` and `best`
// track the group's first maximal score. win carries from one call to the
// next, so a long group walks chunk by chunk.
template <int W, int RB>
__device__ __forceinline__ void walk_rows(const uint8_t* rows, int x0, int x1,
                                          int row0, float w, int base,
                                          float (&win)[W], float* sc,
                                          int32_t* par, float& top,
                                          int& best) {
  // each row is read one anchor ahead, off the scores' dependency chain
  uint4 next[RB / 16];
  const auto load = [&](int x) {
    const uint4* in =
        reinterpret_cast<const uint4*>(rows + (size_t)(x - row0) * RB);
#pragma unroll
    for (int k = 0; k < RB / 16; ++k) next[k] = in[k];
  };
  if (x0 < x1) load(x0);
  for (int x = x0; x < x1; ++x) {
    uint32_t words[RB / 4];
#pragma unroll
    for (int k = 0; k < RB / 16; ++k) {
      words[4 * k] = next[k].x;
      words[4 * k + 1] = next[k].y;
      words[4 * k + 2] = next[k].z;
      words[4 * k + 3] = next[k].w;
    }
    if (x + 1 < x1) load(x + 1);
    float b = -CUDART_INF_F;
    int bd = -1;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      const uint32_t g = (words[d / 4] >> (8 * (d % 4))) & 0xffu;
      if (g != kNoChain) {
        const float cand = __fadd_rn(win[d], __fsub_rn(w, byte_f32(g)));
        if (cand > b) {
          b = cand;
          bd = d;
        }
      }
    }
    float s = w;
    int parent = -1;
    if (b > 0.0f) {
      s = b;
      parent = x - 1 - bd - base;
    }
#pragma unroll
    for (int d = W - 1; d > 0; --d) win[d] = win[d - 1];
    win[0] = s;
    sc[x] = s;
    par[x] = parent;
    if (s > top) {
      top = s;
      best = x - base;
    }
  }
}


// The read-vs-contig rule for predecessor j of anchor i, over any anchor
// arrays (shared or device memory); bit 1 of is_rev marks a group's first
// anchor in the staged span.
struct ContigSrc {
  const int32_t* rp;
  const int32_t* qp;
  const int32_t* qb;
  const uint8_t* rv;
  int d_r_max, max_gap, bp_cap;

  struct Anchor {
    int rp, qp, qb, rv;
  };

  __device__ __forceinline__ Anchor anchor(int j) const {
    return {rp[j], qp[j], qb[j], rv[j] & 1};
  }

  __device__ __forceinline__ bool chains(const Anchor& i, const Anchor& j,
                                         int* gap) const {
    const int d_r = i.rp - j.rp;
    const int d_q = i.rv ? j.qp - i.qp : i.qp - j.qp;
    *gap = abs(d_r - d_q);
    const int d_bp = i.rv ? j.qb - i.qb : i.qb - j.qb;
    const bool order = i.rv ? !(i.qp > j.qp) : !(i.qp < j.qp);
    return j.rv == i.rv && j.rp != i.rp && j.qp != i.qp && d_r > 0 &&
           d_r <= d_r_max && *gap <= max_gap && d_bp <= bp_cap && order;
  }
};

struct Args {
  const int32_t* ref_pos;
  const int32_t* q_pos;
  const int32_t* q_bp;
  const uint8_t* is_rev;
  const int64_t* offsets;
  int64_t n_groups;
  int d_r_max;
  float w;
  int max_gap, bp_cap;
  float* scores;
  int32_t* parents;
  int32_t* best_index;
};

// Shared memory: the mbarrier, then ref_pos, q_pos, q_bp and is_rev as
// staged, then the span's scores, parents and gap rows.
template <int CAP>
struct Layout {
  static constexpr int kRp = 16;
  static constexpr int kQp = kRp + chain_band::staged_bytes(CAP, 4);
  static constexpr int kQb = kQp + chain_band::staged_bytes(CAP, 4);
  static constexpr int kRv = kQb + chain_band::staged_bytes(CAP, 4);
  static constexpr int kSc = kRv + chain_band::staged_bytes(CAP, 1);
  static constexpr int kPar = kSc + CAP * 4;
  static constexpr int kRows = kPar + CAP * 4;
  static constexpr int kBytes = kRows + CAP * kRowBytes;
};

template <int NT, int CAP>
__global__ void __launch_bounds__(NT)
    chain_contig_kernel(const Args a, int64_t per_block) {
  using Lay = Layout<CAP>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_rp = reinterpret_cast<int32_t*>(smem + Lay::kRp);
  int32_t* s_qp = reinterpret_cast<int32_t*>(smem + Lay::kQp);
  int32_t* s_qb = reinterpret_cast<int32_t*>(smem + Lay::kQb);
  uint8_t* s_rv = smem + Lay::kRv;
  float* s_sc = reinterpret_cast<float*>(smem + Lay::kSc);
  int32_t* s_par = reinterpret_cast<int32_t*>(smem + Lay::kPar);
  uint8_t* s_rows = smem + Lay::kRows;

  const Tile t =
      chain_band::block_groups<NT>(a.offsets, a.n_groups, per_block, CAP);
  const int m = (int)(t.hi - t.lo);
  const chain_band::Range r[4] = {
      chain_band::span_range(a.ref_pos, t.lo, t.hi, 4),
      chain_band::span_range(a.q_pos, t.lo, t.hi, 4),
      chain_band::span_range(a.q_bp, t.lo, t.hi, 4),
      chain_band::span_range(a.is_rev, t.lo, t.hi, 1)};
  if (threadIdx.x == 0 && m > 0) {
    chain_band::bar_init(bar);
    chain_band::bar_expect(bar, r[0].bytes + r[1].bytes + r[2].bytes +
                                    r[3].bytes);
    chain_band::bulk_load(s_rp, r[0].src, r[0].bytes, bar);
    chain_band::bulk_load(s_qp, r[1].src, r[1].bytes, bar);
    chain_band::bulk_load(s_qb, r[2].src, r[2].bytes, bar);
    chain_band::bulk_load(s_rv, r[3].src, r[3].bytes, bar);
  }
  __syncthreads();
  uint8_t* rv = s_rv + r[3].pad;
  if (m > 0) {
    chain_band::bar_wait(bar, 0);
    // mark each group's first anchor
    for (int64_t g = t.g0 + threadIdx.x; g < t.g_span; g += NT) {
      if (a.offsets[g + 1] > a.offsets[g]) rv[a.offsets[g] - t.lo] |= 2;
    }
  }
  __syncthreads();

  // the tests, the band over the lanes: one gap row per anchor of the span
  {
    const ContigSrc src{s_rp + r[0].pad, s_qp + r[1].pad, s_qb + r[2].pad,
                        rv, a.d_r_max, a.max_gap, a.bp_cap};
    const auto first = [rv](int y) { return (rv[y] & 2) != 0; };
    for (int x = threadIdx.x; x < m; x += NT) {
      gap_row<kBand, kRowBytes>(src, x, kBand, first,
                                            s_rows + x * kRowBytes);
    }
  }
  __syncthreads();

  // the DP and best_index: one thread per group walks its rows
  for (int64_t g = t.g0 + threadIdx.x; g < t.g_span; g += NT) {
    const int gs = (int)(a.offsets[g] - t.lo);
    const int ge = (int)(a.offsets[g + 1] - t.lo);
    float win[kBand] = {};
    float top = 0.0f;
    int best = -1;
    walk_rows<kBand, kRowBytes>(s_rows, gs, ge, 0, a.w, gs, win,
                                            s_sc, s_par, top, best);
    a.best_index[g] = best;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < m; x += NT) {
    a.scores[t.lo + x] = s_sc[x];
    a.parents[t.lo + x] = s_par[x];
  }

  // groups past the span, chunk by chunk: the block makes a chunk's rows
  // from device memory, then one thread walks them
  for (int64_t g = t.g_span; g < t.g1; ++g) {
    const int64_t lo = a.offsets[g];
    const int n = (int)(a.offsets[g + 1] - lo);
    const ContigSrc src{a.ref_pos + lo, a.q_pos + lo, a.q_bp + lo,
                        a.is_rev + lo,  a.d_r_max,    a.max_gap,
                        a.bp_cap};
    const auto first = [](int y) { return y == 0; };
    float win[kBand] = {};
    float top = 0.0f;
    int best = -1;
    for (int c = 0; c < n; c += CAP) {
      const int e = min(c + CAP, n);
      __syncthreads();  // the last chunk's walk is done with the rows
      for (int x = c + threadIdx.x; x < e; x += NT) {
        gap_row<kBand, kRowBytes>(src, x, kBand, first,
                                              s_rows + (x - c) * kRowBytes);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        walk_rows<kBand, kRowBytes>(s_rows, c, e, c, a.w, 0, win,
                                                a.scores + lo,
                                                a.parents + lo, top, best);
      }
    }
    if (threadIdx.x == 0) a.best_index[g] = best;
  }
}

template <int NT, int TILE, int CAP>
int launch(const Args& a, long long n_anchors, cudaStream_t stream) {
  static_assert(NT % 32 == 0 && TILE <= CAP && CAP % 16 == 0,
                "block, tile and span sizes");
  constexpr int bytes = Layout<CAP>::kBytes;
  auto kernel = chain_contig_kernel<NT, CAP>;
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

extern "C" int chain_contig_launch(const void* ref_pos, const void* q_pos,
                                   const void* q_bp, const void* is_rev,
                                   const void* offsets, long long n_groups,
                                   long long n_anchors, int d_r_max, float w,
                                   int max_gap, int bp_cap, void* scores,
                                   void* parents, void* best_index,
                                   void* stream) {
  if (n_groups <= 0) return 0;
  // a gap row holds each gap in a byte, kNoChain for none
  if (max_gap < 0 || max_gap >= kNoChain) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int32_t*)ref_pos, (const int32_t*)q_pos,
               (const int32_t*)q_bp,    (const uint8_t*)is_rev,
               (const int64_t*)offsets, (int64_t)n_groups,
               d_r_max,                 w,
               max_gap,                 bp_cap,
               (float*)scores,          (int32_t*)parents,
               (int32_t*)best_index};
  return launch<kThreads, kTile, kCap>(a, n_anchors, (cudaStream_t)stream);
}

extern "C" const char* chain_contig_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
