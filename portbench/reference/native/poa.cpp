// Partial-order-alignment window consensus engine (spoa-semantics).
//
// Provenance: the graph-maintenance routines here (TopologicalSort,
// AddAlignment, HeaviestBundle/branch completion, ExtractSubgraph) are
// DERIVED from the spoa library (https://github.com/rvaser/spoa, MIT
// license, (c) Robert Vaser), which the reference vendors at ext/spoa and
// uses through ContigPolisher (src/toBasespace/ContigPolisher.hpp:2141,
// 2587-2704). Byte-identical polishing requires spoa's exact traversal
// order and tie-break semantics (e.g. the scores/predecessors tie-break in
// heaviest-bundle, the aligned-node special case in the sort), so those
// functions intentionally keep spoa's structure; see LICENSE-THIRD-PARTY
// for the MIT text. The rest of the file — the batched ctypes window API,
// the vectorized linear-gap kNW DP rows (scores 3/-5/-4), subgraph-masked
// alignment, quality-weighted edges (phred-33), and the per-base coverage
// summary — is original to this repository.
//
// Batch API: one call polishes many windows, OpenMP-parallel across windows
// (the reference parallelizes the same loop across threads,
// ContigPolisher.hpp:2135-2250). Exposed via ctypes
// (metamdbg_tpu/basespace/poa_native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE4_1__)
#include <immintrin.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t kMatch = 3;
constexpr int32_t kMismatch = -5;
constexpr int32_t kGap = -4;
constexpr int32_t kNegInf = -(1 << 29);

struct Edge {
  int32_t tail;
  int32_t head;
  int64_t weight;
  std::vector<uint32_t> labels;
};

struct Graph {
  std::vector<uint8_t> code;                 // per node base code 0..3
  std::vector<std::vector<int32_t>> in;      // edge indices
  std::vector<std::vector<int32_t>> out;     // edge indices
  std::vector<std::vector<int32_t>> aligned; // aligned node ids
  std::vector<Edge> edges;
  std::vector<int32_t> rank_to_node;
  std::vector<int32_t> node_to_rank;
  uint32_t n_sequences = 0;

  int32_t AddNode(uint8_t c) {
    code.push_back(c);
    in.emplace_back();
    out.emplace_back();
    aligned.emplace_back();
    return (int32_t)code.size() - 1;
  }

  void AddEdge(int32_t tail, int32_t head, int64_t w) {
    for (int32_t ei : out[tail]) {
      if (edges[ei].head == head) {
        edges[ei].weight += w;
        edges[ei].labels.push_back(n_sequences);
        return;
      }
    }
    edges.push_back({tail, head, w, {n_sequences}});
    out[tail].push_back((int32_t)edges.size() - 1);
    in[head].push_back((int32_t)edges.size() - 1);
  }

  // Iterative DFS topological sort keeping aligned nodes adjacent in rank
  // order (same traversal contract as spoa::Graph::TopologicalSort, which
  // the alignment/consensus tie-breaks depend on).
  void TopologicalSort() {
    size_t n = code.size();
    rank_to_node.clear();
    rank_to_node.reserve(n);
    std::vector<uint8_t> marks(n, 0);
    std::vector<uint8_t> ignored(n, 0);
    std::vector<int32_t> stack;
    for (size_t s = 0; s < n; ++s) {
      if (marks[s]) continue;
      stack.push_back((int32_t)s);
      while (!stack.empty()) {
        int32_t curr = stack.back();
        bool is_valid = true;
        if (marks[curr] != 2) {
          for (int32_t ei : in[curr]) {
            if (marks[edges[ei].tail] != 2) {
              stack.push_back(edges[ei].tail);
              is_valid = false;
            }
          }
          if (!ignored[curr]) {
            for (int32_t a : aligned[curr]) {
              if (marks[a] != 2) {
                stack.push_back(a);
                ignored[a] = 1;
                is_valid = false;
              }
            }
          }
          if (is_valid) {
            marks[curr] = 2;
            if (!ignored[curr]) {
              rank_to_node.push_back(curr);
              for (int32_t a : aligned[curr]) rank_to_node.push_back(a);
            }
          } else {
            marks[curr] = 1;
          }
        }
        if (is_valid) stack.pop_back();
      }
    }
    node_to_rank.assign(n, 0);
    for (size_t i = 0; i < rank_to_node.size(); ++i)
      node_to_rank[rank_to_node[i]] = (int32_t)i;
  }

  uint32_t Coverage(int32_t v) const {
    std::vector<uint32_t> labels;
    for (int32_t ei : in[v])
      labels.insert(labels.end(), edges[ei].labels.begin(),
                    edges[ei].labels.end());
    for (int32_t ei : out[v])
      labels.insert(labels.end(), edges[ei].labels.begin(),
                    edges[ei].labels.end());
    std::sort(labels.begin(), labels.end());
    return (uint32_t)(std::unique(labels.begin(), labels.end()) -
                      labels.begin());
  }
};

// One (node_id, seq_pos) step of an alignment path; -1 marks a gap.
struct AlnStep {
  int32_t node;
  int32_t pos;
};

// Vectorizable DP row passes (restrict function params are honored by gcc,
// unlike restrict locals derived from the same backing vector). Templated
// on the score type: windows small enough run int16 rows (double the SIMD
// width and half the memory traffic of int32).
template <typename S>
static void RowInit(S* __restrict__ out, const S* __restrict__ hp,
                    const S* __restrict__ sv, int64_t W) {
  for (int64_t j = 1; j < W; ++j)
    out[j] = std::max<S>(hp[j - 1] + sv[j], hp[j] + (S)kGap);
}

template <typename S>
static void RowUpdate(S* __restrict__ out, const S* __restrict__ hq,
                      const S* __restrict__ sv, int64_t W) {
  for (int64_t j = 1; j < W; ++j)
    out[j] = std::max<S>(out[j],
                         std::max<S>(hq[j - 1] + sv[j], hq[j] + (S)kGap));
}

// Horizontal-gap closure: out[j] = max(out[j], out[j-1] + kGap), the only
// loop-carried pass of the DP (~80% of alignment time when scalar). Solved
// as a prefix max of t[j] = out[j] - j*kGap (a ramp), SIMD log-step within
// 128-bit blocks + carried running max across blocks.
template <typename S>
static void GapScan(S* __restrict__ out, const S* __restrict__ ramp,
                    int64_t W);

#if defined(__SSE4_1__)
// Values are biased into the unsigned domain (XOR the sign bit) so the
// zeros _mm_slli_si128 shifts in are the MINIMUM and never win the max.
template <>
void GapScan<int16_t>(int16_t* __restrict__ out,
                      const int16_t* __restrict__ ramp, int64_t W) {
  int64_t j = 1;
  const __m128i bias = _mm_set1_epi16((int16_t)0x8000);
  const __m128i bcast_last = _mm_set1_epi16(0x0F0E);
  __m128i carry = _mm_xor_si128(
      _mm_set1_epi16((int16_t)(out[0] + ramp[0])), bias);
  for (; j + 8 <= W; j += 8) {
    __m128i r = _mm_loadu_si128((const __m128i*)(ramp + j));
    __m128i t = _mm_add_epi16(_mm_loadu_si128((const __m128i*)(out + j)), r);
    t = _mm_xor_si128(t, bias);
    t = _mm_max_epu16(t, _mm_slli_si128(t, 2));
    t = _mm_max_epu16(t, _mm_slli_si128(t, 4));
    t = _mm_max_epu16(t, _mm_slli_si128(t, 8));
    t = _mm_max_epu16(t, carry);
    carry = _mm_shuffle_epi8(t, bcast_last);
    t = _mm_xor_si128(t, bias);
    _mm_storeu_si128((__m128i*)(out + j), _mm_sub_epi16(t, r));
  }
  int16_t run = (int16_t)(_mm_extract_epi16(carry, 0) ^ 0x8000);
  for (; j < W; ++j) {
    int16_t t = (int16_t)(out[j] + ramp[j]);
    if (run > t) t = run;
    run = t;
    out[j] = (int16_t)(t - ramp[j]);
  }
}

template <>
void GapScan<int32_t>(int32_t* __restrict__ out,
                      const int32_t* __restrict__ ramp, int64_t W) {
  int64_t j = 1;
  const __m128i bias = _mm_set1_epi32((int32_t)0x80000000);
  __m128i carry = _mm_xor_si128(_mm_set1_epi32(out[0] + ramp[0]), bias);
  for (; j + 4 <= W; j += 4) {
    __m128i r = _mm_loadu_si128((const __m128i*)(ramp + j));
    __m128i t = _mm_add_epi32(_mm_loadu_si128((const __m128i*)(out + j)), r);
    t = _mm_xor_si128(t, bias);
    t = _mm_max_epu32(t, _mm_slli_si128(t, 4));
    t = _mm_max_epu32(t, _mm_slli_si128(t, 8));
    t = _mm_max_epu32(t, carry);
    carry = _mm_shuffle_epi32(t, 0xFF);
    t = _mm_xor_si128(t, bias);
    _mm_storeu_si128((__m128i*)(out + j), _mm_sub_epi32(t, r));
  }
  int32_t run = _mm_cvtsi128_si32(carry) ^ (int32_t)0x80000000;
  for (; j < W; ++j) {
    int32_t t = out[j] + ramp[j];
    if (run > t) t = run;
    run = t;
    out[j] = t - ramp[j];
  }
}
#else
template <typename S>
static void GapScan(S* __restrict__ out, const S* __restrict__ ramp,
                    int64_t W) {
  S run = (S)(out[0] + ramp[0]);
  for (int64_t j = 1; j < W; ++j) {
    S t = (S)(out[j] + ramp[j]);
    if (run > t) t = run;
    run = t;
    out[j] = (S)(t - ramp[j]);
  }
}
#endif

// kNW linear-gap alignment of `seq` against the graph restricted to the
// node set `mask` (empty mask = whole graph). Uses the global rank order
// filtered by the mask (a valid topological order of the subgraph) — this
// plays the role of spoa's Subgraph + Align + UpdateAlignment.
template <typename S>
static void AlignToGraphT(const Graph& g, const uint8_t* seq, int32_t len,
                          const std::vector<uint8_t>& mask,
                          std::vector<AlnStep>* alignment,
                          const std::vector<int32_t>& sub_rank) {
  const bool use_mask = !mask.empty();
  int32_t nr = (int32_t)sub_rank.size();

  // row index in H for each node: rank-in-subgraph + 1 (row 0 = origin)
  static thread_local std::vector<int32_t> node_row;
  node_row.assign(g.code.size(), -1);
  for (int32_t i = 0; i < nr; ++i) node_row[sub_rank[i]] = i + 1;

  int64_t W = len + 1;
  static thread_local std::vector<int32_t> h32;
  static thread_local std::vector<int16_t> h16;
  S* H;
  if (sizeof(S) == 2) {
    h16.assign((size_t)(nr + 1) * W, 0);
    H = (S*)h16.data();
  } else {
    h32.assign((size_t)(nr + 1) * W, 0);
    H = (S*)h32.data();
  }
  for (int64_t j = 1; j < W; ++j) H[j] = (S)(j * kGap);

  // collect in-mask predecessors per subgraph row
  static thread_local std::vector<std::vector<int32_t>> preds;
  if ((int32_t)preds.size() < nr) preds.resize(nr);
  for (int32_t i = 0; i < nr; ++i) {
    int32_t v = sub_rank[i];
    preds[i].clear();
    for (int32_t ei : g.in[v]) {
      int32_t t = g.edges[ei].tail;
      if (!use_mask || mask[t]) preds[i].push_back(node_row[t]);
    }
    // first-column init (spoa Initialize, kLinear/kNW)
    int32_t penalty = preds[i].empty() ? 0 : kNegInf;
    for (int32_t p : preds[i])
      penalty = std::max(penalty, (int32_t)H[(size_t)p * W]);
    H[(size_t)(i + 1) * W] = (S)(penalty + kGap);
  }

  int32_t max_score = kNegInf;
  int32_t max_i = 0, max_j = 0;

  // ramp for the gap-closure prefix-max scan: ramp[j] = j * (-kGap)
  static thread_local std::vector<S> ramp16or32;
  ramp16or32.resize(W);
  for (int64_t j = 0; j < W; ++j) ramp16or32[j] = (S)(j * (-kGap));
  const S* ramp = ramp16or32.data();

  // per-fragment substitution profiles, one per DISTINCT graph character
  // (sequences are raw bytes; typically <= 5 distinct): replaces the
  // per-ROW profile build (saves an O(W) pass per graph node). Built
  // lazily the first time a row needs that character.
  static thread_local std::vector<S> prof_storage;
  static thread_local std::vector<int16_t> prof_slot;
  prof_storage.clear();
  prof_slot.assign(256, -1);
  auto profile_of = [&](uint8_t c) -> const S* {
    if (prof_slot[c] < 0) {
      prof_slot[c] = (int16_t)(prof_storage.size() / W);
      prof_storage.resize(prof_storage.size() + W);
      S* pv = prof_storage.data() + (size_t)prof_slot[c] * W;
      for (int64_t j = 1; j < W; ++j)
        pv[j] = (S)((c == seq[j - 1]) ? kMatch : kMismatch);
    }
    return prof_storage.data() + (size_t)prof_slot[c] * W;
  };

  for (int32_t i = 0; i < nr; ++i) {
    int32_t v = sub_rank[i];
    uint8_t c = g.code[v];
    S* __restrict__ Hrow = &H[(size_t)(i + 1) * W];
    bool has_out = false;
    if (use_mask) {
      for (int32_t ei : g.out[v])
        if (mask[g.edges[ei].head]) { has_out = true; break; }
    } else {
      has_out = !g.out[v].empty();
    }

    const S* sv = profile_of(c);

    int32_t pred0 = preds[i].empty() ? 0 : preds[i][0];
    RowInit<S>(Hrow, &H[(size_t)pred0 * W], sv, W);
    for (size_t p = 1; p < preds[i].size(); ++p)
      RowUpdate<S>(Hrow, &H[(size_t)preds[i][p] * W], sv, W);
    GapScan<S>(Hrow, ramp, W);
    if (!has_out && (int32_t)Hrow[W - 1] > max_score) {
      max_score = Hrow[W - 1];
      max_i = i + 1;
      max_j = (int32_t)(W - 1);
    }
  }
  if (max_i == 0 && max_j == 0) return;

  // traceback with spoa's preference order: diagonal (preds in edge
  // order), vertical (preds in order), horizontal.
  int32_t i = max_i, j = max_j;
  while (!(i == 0 && j == 0)) {
    int32_t Hij = H[(size_t)i * W + j];
    int32_t prev_i = i, prev_j = j;
    bool found = false;
    if (i != 0 && j != 0) {
      int32_t v = sub_rank[i - 1];
      int32_t sub = (g.code[v] == seq[j - 1]) ? kMatch : kMismatch;
      int32_t p0 = preds[i - 1].empty() ? 0 : preds[i - 1][0];
      if (Hij == (int32_t)H[(size_t)p0 * W + j - 1] + sub) {
        prev_i = p0; prev_j = j - 1; found = true;
      } else {
        for (size_t p = 1; p < preds[i - 1].size() && !found; ++p) {
          if (Hij == (int32_t)H[(size_t)preds[i - 1][p] * W + j - 1] + sub) {
            prev_i = preds[i - 1][p]; prev_j = j - 1; found = true;
          }
        }
      }
    }
    if (!found && i != 0) {
      int32_t p0 = preds[i - 1].empty() ? 0 : preds[i - 1][0];
      if (Hij == (int32_t)H[(size_t)p0 * W + j] + kGap) {
        prev_i = p0; prev_j = j; found = true;
      } else {
        for (size_t p = 1; p < preds[i - 1].size() && !found; ++p) {
          if (Hij == (int32_t)H[(size_t)preds[i - 1][p] * W + j] + kGap) {
            prev_i = preds[i - 1][p]; prev_j = j; found = true;
          }
        }
      }
    }
    if (!found && j != 0 && Hij == (int32_t)H[(size_t)i * W + j - 1] + kGap) {
      prev_i = i; prev_j = j - 1;
    }
    if (prev_i == i && prev_j == j) {
      // no predecessor reproduces Hij: DP invariant broken (should be
      // impossible) — drop the alignment instead of spinning
      alignment->clear();
      return;
    }
    alignment->push_back({i == prev_i ? -1 : sub_rank[i - 1],
                          j == prev_j ? -1 : j - 1});
    i = prev_i;
    j = prev_j;
  }
  std::reverse(alignment->begin(), alignment->end());
}

void AlignToGraph(const Graph& g, const uint8_t* seq, int32_t len,
                  const std::vector<uint8_t>& mask,
                  std::vector<AlnStep>* alignment,
                  std::vector<int32_t>* /*h_storage*/,
                  std::vector<int32_t>* sub_rank_storage,
                  std::vector<int32_t>* /*sub_storage*/) {
  alignment->clear();
  const bool use_mask = !mask.empty();
  std::vector<int32_t>& sub_rank = *sub_rank_storage;
  sub_rank.clear();
  for (int32_t v : g.rank_to_node) {
    if (!use_mask || mask[v]) sub_rank.push_back(v);
  }
  if (sub_rank.empty() || len == 0) return;
  // int16 rows when every reachable score fits comfortably: extremes are
  // bounded by |kGap|*(rows+cols) and kMatch*cols.
  int64_t bound = (int64_t)(-kGap) * ((int64_t)sub_rank.size() + len + 2);
  if (bound < 30000) {
    AlignToGraphT<int16_t>(g, seq, len, mask, alignment, sub_rank);
  } else {
    AlignToGraphT<int32_t>(g, seq, len, mask, alignment, sub_rank);
  }
}

// spoa::Graph::AddAlignment semantics (graph.cpp:155-246).
void AddAlignment(Graph* g, const std::vector<AlnStep>& alignment,
                  const uint8_t* seq, int32_t len, const uint8_t* weights) {
  if (len == 0) return;
  auto add_chain = [&](int32_t begin, int32_t end) -> int32_t {
    // adds seq[begin, end) as fresh nodes, returns first node id or -1
    if (begin >= end) return -1;
    int32_t prev = -1, first = -1;
    for (int32_t k = begin; k < end; ++k) {
      int32_t curr = g->AddNode(seq[k]);
      if (first < 0) first = curr;
      if (prev >= 0)
        g->AddEdge(prev, curr, (int64_t)weights[k - 1] + weights[k]);
      prev = curr;
    }
    return first;
  };

  if (alignment.empty()) {
    add_chain(0, len);
    g->n_sequences += 1;
    g->TopologicalSort();
    return;
  }

  int32_t valid_front = -1, valid_back = -1;
  for (const AlnStep& s : alignment) {
    if (s.pos != -1) {
      if (valid_front < 0) valid_front = s.pos;
      valid_back = s.pos;
    }
  }
  if (valid_front < 0) return;

  int32_t begin = add_chain(0, valid_front);
  int32_t prev = begin >= 0 ? (int32_t)g->code.size() - 1 : -1;
  int32_t last = add_chain(valid_back + 1, len);

  for (const AlnStep& s : alignment) {
    if (s.pos == -1) continue;
    uint8_t c = seq[s.pos];
    int32_t curr = -1;
    if (s.node == -1) {
      curr = g->AddNode(c);
    } else {
      if (g->code[s.node] == c) {
        curr = s.node;
      } else {
        for (int32_t a : g->aligned[s.node]) {
          if (g->code[a] == c) { curr = a; break; }
        }
        if (curr < 0) {
          curr = g->AddNode(c);
          for (int32_t a : g->aligned[s.node]) {
            g->aligned[a].push_back(curr);
            g->aligned[curr].push_back(a);
          }
          g->aligned[s.node].push_back(curr);
          g->aligned[curr].push_back(s.node);
        }
      }
    }
    if (begin < 0) begin = curr;
    if (prev >= 0)
      g->AddEdge(prev, curr, (int64_t)weights[s.pos - 1 >= 0 ? s.pos - 1 : 0] +
                                 weights[s.pos]);
    prev = curr;
  }
  if (last >= 0)
    g->AddEdge(prev, last,
               (int64_t)weights[valid_back] + weights[valid_back + 1]);
  g->n_sequences += 1;
  g->TopologicalSort();
}

// spoa::Graph::TraverseHeaviestBundle + BranchCompletion (graph.cpp:466-549).
void HeaviestBundle(const Graph& g, std::vector<int32_t>* consensus) {
  consensus->clear();
  size_t n = g.code.size();
  if (g.rank_to_node.empty()) return;
  std::vector<int32_t> predecessors(n, -1);
  std::vector<int64_t> scores(n, -1);
  int32_t max_v = -1;

  auto relax = [&](int32_t v) {
    for (int32_t ei : g.in[v]) {
      const Edge& e = g.edges[ei];
      if (scores[v] < e.weight ||
          (scores[v] == e.weight &&
           scores[predecessors[v]] <= scores[e.tail])) {
        scores[v] = e.weight;
        predecessors[v] = e.tail;
      }
    }
    if (predecessors[v] >= 0) scores[v] += scores[predecessors[v]];
  };

  for (int32_t v : g.rank_to_node) {
    relax(v);
    if (max_v < 0 || scores[max_v] < scores[v]) max_v = v;
  }

  if (!g.out[max_v].empty()) {
    while (!g.out[max_v].empty()) {
      // BranchCompletion from rank(max_v)
      int32_t rank = g.node_to_rank[max_v];
      int32_t start = g.rank_to_node[rank];
      for (int32_t ei : g.out[start]) {
        for (int32_t ej : g.in[g.edges[ei].head]) {
          if (g.edges[ej].tail != start) scores[g.edges[ej].tail] = -1;
        }
      }
      int32_t new_max = -1;
      for (size_t i = rank + 1; i < g.rank_to_node.size(); ++i) {
        int32_t v = g.rank_to_node[i];
        scores[v] = -1;
        predecessors[v] = -1;
        for (int32_t ei : g.in[v]) {
          const Edge& e = g.edges[ei];
          if (scores[e.tail] == -1) continue;
          if (scores[v] < e.weight ||
              (scores[v] == e.weight &&
               scores[predecessors[v]] <= scores[e.tail])) {
            scores[v] = e.weight;
            predecessors[v] = e.tail;
          }
        }
        if (predecessors[v] >= 0) scores[v] += scores[predecessors[v]];
        if (new_max < 0 || scores[new_max] < scores[v]) new_max = v;
      }
      max_v = new_max;
    }
  }

  while (max_v >= 0) {
    consensus->push_back(max_v);
    max_v = predecessors[max_v];
  }
  std::reverse(consensus->begin(), consensus->end());
}

// spoa::Graph::ExtractSubgraph (graph.cpp:551-572): nodes reachable
// backwards from `end_node` (via in-edges and aligned links) with
// id >= begin_node.
void ExtractSubgraph(const Graph& g, int32_t begin_node, int32_t end_node,
                     std::vector<uint8_t>* mask) {
  mask->assign(g.code.size(), 0);
  std::vector<int32_t> stack{end_node};
  while (!stack.empty()) {
    int32_t curr = stack.back();
    stack.pop_back();
    if (!(*mask)[curr] && curr >= begin_node) {
      for (int32_t ei : g.in[curr]) stack.push_back(g.edges[ei].tail);
      for (int32_t a : g.aligned[curr]) stack.push_back(a);
      (*mask)[curr] = 1;
    }
  }
}

int32_t ConsensusOneWindow(
    const uint8_t* backbone, int32_t backbone_len, int32_t n_frags,
    const uint8_t* frags, const int64_t* frag_offs, const uint8_t* quals,
    const uint8_t* has_qual, const int32_t* pos_start, const int32_t* pos_end,
    uint8_t* out_seq, uint32_t* out_cov, int32_t max_out) {
  Graph g;
  // backbone: quality '!' == weight 0 (ContigPolisher.hpp:2589-2598)
  {
    std::vector<uint8_t> w(backbone_len, 0);
    std::vector<AlnStep> empty;
    AddAlignment(&g, empty, backbone, backbone_len, w.data());
  }
  int32_t offset = (int32_t)(0.01 * backbone_len);

  std::vector<AlnStep> alignment;
  std::vector<int32_t> h_storage, sub_rank_storage, sub_storage;
  std::vector<uint8_t> mask;
  std::vector<uint8_t> w;

  for (int32_t f = 0; f < n_frags; ++f) {
    const uint8_t* seq = frags + frag_offs[f];
    int32_t len = (int32_t)(frag_offs[f + 1] - frag_offs[f]);
    if (len == 0) continue;
    int32_t ps = pos_start[f], pe = pos_end[f];
    if (ps < offset && pe > backbone_len - offset) {
      mask.clear();
      AlignToGraph(g, seq, len, mask, &alignment, &h_storage,
                   &sub_rank_storage, &sub_storage);
    } else {
      ExtractSubgraph(g, ps, pe, &mask);
      AlignToGraph(g, seq, len, mask, &alignment, &h_storage,
                   &sub_rank_storage, &sub_storage);
    }
    w.assign(len, 1);
    if (has_qual[f]) {
      const uint8_t* q = quals + frag_offs[f];
      for (int32_t k = 0; k < len; ++k)
        w[k] = q[k] >= 33 ? q[k] - 33 : 0;  // phred-33 (graph.cpp:142-145)
    }
    AddAlignment(&g, alignment, seq, len, w.data());
  }

  std::vector<int32_t> consensus;
  HeaviestBundle(g, &consensus);
  int32_t out_len = std::min((int32_t)consensus.size(), max_out);
  for (int32_t i = 0; i < out_len; ++i) {
    int32_t v = consensus[i];
    out_seq[i] = g.code[v];
    uint32_t cov = g.Coverage(v);
    for (int32_t a : g.aligned[v]) cov += g.Coverage(a);
    out_cov[i] = cov;
  }
  return out_len;
}

}  // namespace

extern "C" {

// Polishes a batch of windows. All sequences are base codes (values 0..255,
// compared by equality only). Layout: backbones/frags/quals concatenated,
// *_offs are element offsets with a trailing total. Returns 0.
int poa_polish_windows(
    int32_t n_windows, const uint8_t* backbones, const int64_t* backbone_offs,
    const int32_t* frag_counts, const int64_t* window_frag_start,
    const uint8_t* frags, const int64_t* frag_offs, const uint8_t* quals,
    const uint8_t* has_qual, const int32_t* pos_start, const int32_t* pos_end,
    uint8_t* out_seq, const int64_t* out_offs, int32_t* out_len,
    uint32_t* out_cov, int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic)
#endif
  for (int32_t wdx = 0; wdx < n_windows; ++wdx) {
    const uint8_t* bb = backbones + backbone_offs[wdx];
    int32_t bb_len = (int32_t)(backbone_offs[wdx + 1] - backbone_offs[wdx]);
    int64_t fs = window_frag_start[wdx];
    int32_t max_out = (int32_t)(out_offs[wdx + 1] - out_offs[wdx]);
    out_len[wdx] = ConsensusOneWindow(
        bb, bb_len, frag_counts[wdx], frags, frag_offs + fs, quals,
        has_qual + fs, pos_start + fs, pos_end + fs, out_seq + out_offs[wdx],
        out_cov + out_offs[wdx], max_out);
  }
  return 0;
}

}  // extern "C"
