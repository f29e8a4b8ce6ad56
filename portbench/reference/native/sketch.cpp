// Native host batch sketcher: rolling canonical 2-bit k-mers + bit-exact
// MurmurHash3 threshold selection over many reads, OpenMP across reads.
//
// This is the HOST production twin of the device sketch kernel
// (metamdbg_tpu/kernels/sketch.py) — used while the asynchronous device
// claim is pending (utils/devwarm.py) and on backend-less machines. It
// replays the reference's hot loop (KmerModel::iterate + MinimizerParser,
// src/utils/kmer/Kmer.hpp:458-627,1339-1456) at C++ speed; outputs are
// bit-identical to the numpy golden path (sketch/minimizers.py), asserted
// by tests/test_sketch.py.
//
// Semantics (cited against the reference):
// - base codes 0..3 (A,C,T,G per (ascii>>1)&3); >=4 marks a bad char whose
//   windows are invalid (value 2^64-1, never selected; Kmer.hpp:567,580).
// - canonical = min(fwd, revcomp), ties -> reverse, direction 1 when the
//   reverse slot is chosen (KmerCanonical::updateChoice, Kmer.hpp:427).
// - selected iff double(MurmurHash3_x64_128(value, 8, seed=42).low64) <
//   double(float(density)) * double(2^64-1) (Kmer.hpp:1421,1434).
// - one window trimmed per read end (_trimBps, Kmer.hpp:1362,1395).
// - optional sorted u32 blacklist on the truncated minimizer value
//   (repetitiveMinimizers.bin, ReadSelection.hpp:497-561).

#include <algorithm>
#include <cmath>
#include <limits>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t Rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t Fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128 low word for an 8-byte little-endian key
// (MurmurHash3.cpp:246-322 specialized to len=8: zero blocks, 8-byte tail).
inline uint64_t Murmur64U64Key(uint64_t key, uint32_t seed) {
  uint64_t h1 = seed, h2 = seed;
  uint64_t k1 = key;
  k1 *= 0x87c37b91114253d5ULL;
  k1 = Rotl64(k1, 31);
  k1 *= 0x4cf5ad432745937fULL;
  h1 ^= k1;
  h1 ^= 8;
  h2 ^= 8;
  h1 += h2;
  h2 += h1;
  h1 = Fmix64(h1);
  h2 = Fmix64(h2);
  h1 += h2;  // h2 += h1 dropped: only the low word is used
  return h1;
}

struct ReadResult {
  std::vector<uint32_t> vals;
  std::vector<uint32_t> pos;
  std::vector<uint8_t> dirs;
};

void SketchOne(const uint8_t* codes, int64_t n, int32_t l, double bound,
               const uint32_t* rep, int64_t n_rep, int32_t trim,
               ReadResult* out) {
  int64_t nk = n - l + 1;
  if (nk <= 0) return;
  const uint64_t mask =
      (2 * l < 64) ? ((1ULL << (2 * l)) - 1) : ~0ULL;
  uint64_t fwd = 0, rev = 0;
  int64_t last_bad = -1;
  const int shift_hi = 2 * (l - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = codes[i];
    bool bad = c >= 4;
    uint64_t cc = bad ? 0 : c;
    fwd = ((fwd << 2) | cc) & mask;
    rev = (rev >> 2) | ((2ULL ^ cc) << shift_hi);
    if (bad) last_bad = i;
    int64_t w = i - l + 1;
    if (w < 0) continue;
    if (last_bad >= w) continue;          // invalid window, never selected
    if (w < trim || w >= nk - trim) continue;
    bool dir_rev = !(fwd < rev);          // ties -> reverse slot
    uint64_t value = dir_rev ? rev : fwd;
    uint64_t h = Murmur64U64Key(value, 42);
    if (!((double)h < bound)) continue;
    uint32_t v32 = (uint32_t)value;       // MinimizerType truncation
    if (n_rep) {
      const uint32_t* it = std::lower_bound(rep, rep + n_rep, v32);
      if (it != rep + n_rep && *it == v32) continue;
    }
    out->vals.push_back(v32);
    out->pos.push_back((uint32_t)w);
    out->dirs.push_back(dir_rev ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// codes: concatenated reads; offsets[n_reads+1] delimits them. Outputs are
// compacted in read order; out_read_offsets[n_reads+1] delimits per read.
// Returns total selected, or -(needed) when cap is too small (retry with
// the reported capacity).
int64_t sketch_reads(const uint8_t* codes, const int64_t* offsets,
                     int32_t n_reads, int32_t l, double bound,
                     const uint32_t* repetitive, int64_t n_repetitive,
                     int32_t trim, uint32_t* out_vals, uint32_t* out_pos,
                     uint8_t* out_dirs, int64_t* out_read_offsets,
                     int64_t cap, int32_t n_threads) {
  std::vector<ReadResult> results(n_reads);
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 16)
#endif
  for (int32_t r = 0; r < n_reads; ++r) {
    SketchOne(codes + offsets[r], offsets[r + 1] - offsets[r], l, bound,
              repetitive, n_repetitive, trim, &results[r]);
  }
  int64_t total = 0;
  out_read_offsets[0] = 0;
  for (int32_t r = 0; r < n_reads; ++r) {
    total += (int64_t)results[r].vals.size();
    out_read_offsets[r + 1] = total;
  }
  if (total > cap) return -total;
  int64_t o = 0;
  for (int32_t r = 0; r < n_reads; ++r) {
    const ReadResult& rr = results[r];
    std::copy(rr.vals.begin(), rr.vals.end(), out_vals + o);
    std::copy(rr.pos.begin(), rr.pos.end(), out_pos + o);
    std::copy(rr.dirs.begin(), rr.dirs.end(), out_dirs + o);
    o += (int64_t)rr.vals.size();
  }
  return total;
}

// Anchor-chaining DP, batch over groups (the host production twin of
// kernels/chain_jax.chain_contig_device; semantics of
// ReadVsContigMapper::processAnchors, src/toBasespace/
// ReadVsContigMapper.hpp:820-923, as re-expressed by
// basespace/contig_mapper._chain — bit-identical, tests/test_basespace.py).
// Anchors are concatenated; offsets[n_groups+1] delimits groups. Outputs:
// per-anchor parent (group-local index, -1 = chain root) and per-group
// best index (-1 when no positive-score chain) + float32 best score.
int64_t chain_batch(const int64_t* ref_pos, const int64_t* q_pos,
                    const int64_t* q_bp, const uint8_t* is_rev,
                    const int64_t* offsets, int32_t n_groups,
                    double avg_dist, int32_t band, float w, int64_t max_gap,
                    int64_t max_span_bp, float* best_scores,
                    int32_t* best_idx, int32_t* parents, int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 8)
#endif
  for (int32_t gidx = 0; gidx < n_groups; ++gidx) {
    int64_t a = offsets[gidx], b = offsets[gidx + 1];
    int64_t n = b - a;
    const int64_t* rp = ref_pos + a;
    const int64_t* qp = q_pos + a;
    const int64_t* qb = q_bp + a;
    const uint8_t* rv = is_rev + a;
    int32_t* par = parents + a;
    std::vector<float> scores(n);
    for (int64_t i = 0; i < n; ++i) {
      float best_score = 0.0f;
      int64_t best_prev = i;
      for (int64_t j = i - 1; j >= 0; --j) {
        if (i - j > band) break;
        if (rv[i] != rv[j]) continue;
        if (rp[i] == rp[j] || qp[i] == qp[j]) continue;
        int64_t d_r = rp[i] - rp[j];
        if ((double)d_r * avg_dist > (double)max_span_bp) continue;
        if (d_r <= 0) continue;
        int64_t d_q = rv[i] ? (qp[j] - qp[i]) : (qp[i] - qp[j]);
        int64_t gap = d_r - d_q;
        if (gap < 0) gap = -gap;
        if (gap > max_gap) continue;
        if (rv[i]) {
          if (qb[j] - qb[i] > max_span_bp) continue;
          if (qp[i] > qp[j]) continue;
        } else {
          if (qb[i] - qb[j] > max_span_bp) continue;
          if (qp[i] < qp[j]) continue;
        }
        float new_score = scores[j] + (w - (float)gap);
        if (new_score > best_score) {
          best_score = new_score;
          best_prev = j;
        }
      }
      if (best_prev != i) {
        scores[i] = best_score;
        par[i] = (int32_t)best_prev;
      } else {
        scores[i] = w;
        par[i] = -1;
      }
    }
    int64_t bi = -1;
    float ms = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
      if (scores[i] > ms) {
        ms = scores[i];
        bi = i;
      }
    }
    best_idx[gidx] = (int32_t)bi;
    best_scores[gidx] = ms;
  }
  return 0;
}

// Correction-chainer DP, batch over groups (host production twin of
// kernels/chain_jax.chain_dp_device; semantics of
// MinimizerChainer::chainAnchors + argmaxPosition,
// src/readSelection/MinimizerChainer.hpp:735-961, as re-expressed by
// correction/chainer.chain_dp — bit-identical float32 scoring, descending-j
// strict-> tie-break (largest j wins), strict-> first-wins argmax).
// Anchors concatenated; offsets[n_groups+1] delimits groups. Outputs:
// per-anchor float32 scores and parent (group-local, -1 = root), per-group
// best index (-1 when empty).
int64_t chain_corr_batch(const int64_t* ref_pos, const int64_t* q_pos,
                         const uint8_t* is_rev, const int64_t* offsets,
                         int32_t n_groups, int32_t band, float w,
                         int64_t max_dist, int64_t max_gap,
                         float* out_scores, int32_t* parents,
                         int32_t* best_idx, int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 16)
#endif
  for (int32_t gidx = 0; gidx < n_groups; ++gidx) {
    int64_t a = offsets[gidx], b = offsets[gidx + 1];
    int64_t n = b - a;
    const int64_t* rp = ref_pos + a;
    const int64_t* qp = q_pos + a;
    const uint8_t* rv = is_rev + a;
    float* scores = out_scores + a;
    int32_t* par = parents + a;
    for (int64_t i = 0; i < n; ++i) {
      float best_score = 0.0f;
      int64_t best_prev = i;
      for (int64_t j = i - 1; j >= 0; --j) {
        if (i - j > band) break;
        if (rv[i] != rv[j]) continue;
        if (rp[i] == rp[j] || qp[i] == qp[j]) continue;
        int64_t d_r = rp[i] - rp[j];
        int64_t d_q = rv[i] ? (qp[j] - qp[i]) : (qp[i] - qp[j]);
        if (d_q > max_dist || d_r > max_dist) continue;
        if (d_r <= 0) continue;
        int64_t gap = d_r - d_q;
        if (gap < 0) gap = -gap;
        if (gap > max_gap) continue;
        if (rv[i]) {
          if (qp[i] > qp[j]) continue;
        } else {
          if (qp[i] < qp[j]) continue;
        }
        float cand = scores[j] + (w - (float)gap);
        if (cand > best_score) {
          best_score = cand;
          best_prev = j;
        }
      }
      if (best_prev != i) {
        scores[i] = best_score;
        par[i] = (int32_t)best_prev;
      } else {
        scores[i] = w;
        par[i] = -1;
      }
    }
    int64_t bi = -1;
    float ms = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
      if (scores[i] > ms) {
        ms = scores[i];
        bi = i;
      }
    }
    best_idx[gidx] = (int32_t)bi;
  }
  return 0;
}

// Mapper chaining: the correction-chainer DP plus the backtrack and
// match-position extraction of ReadMapper::chainAnchors
// (src/readSelection/ReadMapper.hpp:887-1087), one call for many groups
// (correction/mapper.chain_read_pair is the Python oracle — the per-pair
// ctypes dispatch was ~30 s of an 86 Mbp ONT correction run).
// Outputs per group: score (INT32_MIN when no >=3-anchor chain) and the
// chain's query-pair indexes ascending in out_positions
// (out_pos_offsets[n_groups+1] delimits; capacity = offsets[n_groups] is
// always sufficient since a chain is a subset of its group's anchors).
int64_t chain_mapper_batch(const int64_t* ref_pos, const int64_t* q_pos,
                           const uint8_t* is_rev, const int64_t* q_idx,
                           const int64_t* offsets, int32_t n_groups,
                           int32_t band, float w, int64_t max_dist,
                           int64_t max_gap, int32_t* out_scores,
                           int64_t* out_pos_offsets, uint32_t* out_positions,
                           int32_t n_threads) {
  std::vector<std::vector<uint32_t>> results(n_groups);
#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
    std::vector<float> scores;
    std::vector<int32_t> par;
    std::vector<int64_t> interval;
    std::vector<uint32_t> qidx;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int32_t gidx = 0; gidx < n_groups; ++gidx) {
      out_scores[gidx] = INT32_MIN;
      int64_t a = offsets[gidx], b = offsets[gidx + 1];
      int64_t n = b - a;
      const int64_t* rp = ref_pos + a;
      const int64_t* qp = q_pos + a;
      const uint8_t* rv = is_rev + a;
      scores.assign(n, 0.0f);
      par.assign(n, -1);
      for (int64_t i = 0; i < n; ++i) {
        float best_score = 0.0f;
        int64_t best_prev = i;
        for (int64_t j = i - 1; j >= 0; --j) {
          if (i - j > band) break;
          if (rv[i] != rv[j]) continue;
          if (rp[i] == rp[j] || qp[i] == qp[j]) continue;
          int64_t d_r = rp[i] - rp[j];
          int64_t d_q = rv[i] ? (qp[j] - qp[i]) : (qp[i] - qp[j]);
          if (d_q > max_dist || d_r > max_dist) continue;
          if (d_r <= 0) continue;
          int64_t gap = d_r - d_q;
          if (gap < 0) gap = -gap;
          if (gap > max_gap) continue;
          if (rv[i]) {
            if (qp[i] > qp[j]) continue;
          } else {
            if (qp[i] < qp[j]) continue;
          }
          float cand = scores[j] + (w - (float)gap);
          if (cand > best_score) {
            best_score = cand;
            best_prev = j;
          }
        }
        if (best_prev != i) {
          scores[i] = best_score;
          par[i] = (int32_t)best_prev;
        } else {
          scores[i] = w;
          par[i] = -1;
        }
      }
      int64_t bi = -1;
      float ms = 0.0f;
      for (int64_t i = 0; i < n; ++i) {
        if (scores[i] > ms) {
          ms = scores[i];
          bi = i;
        }
      }
      if (bi < 0) continue;
      interval.clear();
      for (int64_t idx = bi; idx != -1; idx = par[idx]) interval.push_back(idx);
      if ((int64_t)interval.size() < 3) continue;
      // interval is best->root here; ascending query order = sorted qidx
      qidx.clear();
      for (int64_t t : interval) qidx.push_back((uint32_t)q_idx[a + t]);
      int64_t first_q = (int64_t)qidx.front();   // best
      int64_t last_q = (int64_t)qidx.back();     // root
      int64_t nb_matches = (int64_t)qidx.size();
      int64_t diff_q = (first_q > last_q)
                           ? (first_q - last_q + 1) - nb_matches
                           : (last_q - first_q + 1) - nb_matches;
      std::sort(qidx.begin(), qidx.end());
      out_scores[gidx] = (int32_t)(nb_matches - diff_q);
      results[gidx] = qidx;
    }
  }
  int64_t total = 0;
  out_pos_offsets[0] = 0;
  for (int32_t g = 0; g < n_groups; ++g) {
    total += (int64_t)results[g].size();
    out_pos_offsets[g + 1] = total;
  }
  int64_t o = 0;
  for (int32_t g = 0; g < n_groups; ++g) {
    std::copy(results[g].begin(), results[g].end(), out_positions + o);
    o += (int64_t)results[g].size();
  }
  return total;
}

// Read filters: DUST-like trinucleotide complexity + f32 mean read quality
// (ReadSelection.hpp:1171-1228, 870-879; sketch/filters.py is the numpy
// oracle). qual_table: the exact f32 phred->error table from the Python
// side. out_complexity: NaN when no complete window. Window scores are
// summed sequentially like the reference's windowScoreSum.
int64_t read_filters_batch(const uint8_t* seq_cat, const int64_t* seq_offs,
                           const uint8_t* qual_cat, const int64_t* qual_offs,
                           int32_t n_reads, int64_t w, int64_t step,
                           const float* qual_table,
                           double* out_complexity, float* out_meanq,
                           int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 16)
#endif
  for (int32_t r = 0; r < n_reads; ++r) {
    const uint8_t* s = seq_cat + seq_offs[r];
    int64_t n = seq_offs[r + 1] - seq_offs[r];

    // --- complexity ---
    int64_t nk = n - 2;  // trinucleotide windows
    double comp = std::numeric_limits<double>::quiet_NaN();
    if (nk >= w) {
      double l = (double)w - 2.0;
      double score_sum = 0.0;
      int64_t n_windows = 0;
      int32_t counts[64];
      for (int64_t start = 0; start + w <= nk; start += step) {
        for (int i = 0; i < 64; ++i) counts[i] = 0;
        for (int64_t i = start; i < start + w; ++i) {
          uint8_t b0 = s[i], b1 = s[i + 1], b2 = s[i + 2];
          if (((b0 >> 3) | (b1 >> 3) | (b2 >> 3)) & 1) continue;  // bad
          int k = (((b0 >> 1) & 3) << 4) | (((b1 >> 1) & 3) << 2)
                  | ((b2 >> 1) & 3);
          counts[k] += 1;
        }
        double sc = 0.0;
        for (int i = 0; i < 64; ++i)
          sc += (double)counts[i] * ((double)counts[i] - 1.0) / 2.0;
        score_sum += sc / (l - 1.0);
        n_windows += 1;
      }
      if (n_windows > 0) comp = score_sum / (double)n_windows;
    }
    out_complexity[r] = comp;

    // --- mean quality ---
    const uint8_t* q = qual_cat + qual_offs[r];
    int64_t qn = qual_offs[r + 1] - qual_offs[r];
    if (qn == 0) {
      out_meanq[r] = std::numeric_limits<float>::quiet_NaN();
    } else {
      long double err_sum = 0.0L;
      for (int64_t i = 0; i < qn; ++i) err_sum += (long double)qual_table[q[i]];
      float mean_err = (float)(err_sum / (long double)qn);
      out_meanq[r] = -10.0f * log10f(mean_err);
    }
  }
  return 0;
}

// ---- MurmurHash3_x64_128_original over u32 windows (KmerVec::hash128,
// src/Commons.hpp:956-969; utils/hashing.py murmur128_u32rows is the
// oracle) fused with KmerVec::normalize: for each w-window of the flat
// u32 stream, hash min(seq, reversed seq) without materializing it.
static void Murmur128Window(const uint32_t* s, int32_t w, int rev,
                            uint64_t* out1, uint64_t* out2) {
  const uint64_t c1 = 0x87C37B91114253D5ULL;
  const uint64_t c2 = 0x4CF5AD432745937FULL;
  uint64_t h1 = 0, h2 = 0;
  int32_t nblocks = w / 4;
  int32_t remv = w % 4;
  auto word = [&](int32_t j) -> uint64_t {
    return (uint64_t)(rev ? s[w - 1 - j] : s[j]);
  };
  for (int32_t b = 0; b < nblocks; ++b) {
    uint64_t k1 = word(4 * b) | (word(4 * b + 1) << 32);
    uint64_t k2 = word(4 * b + 2) | (word(4 * b + 3) << 32);
    k1 *= c1; k1 = Rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = Rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52DCE729ULL;
    k2 *= c2; k2 = Rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = Rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495AB5ULL;
  }
  int32_t base = 4 * nblocks;
  if (remv == 3) {
    uint64_t k2 = word(base + 2);
    k2 *= c2; k2 = Rotl64(k2, 33); k2 *= c1; h2 ^= k2;
  }
  if (remv >= 1) {
    uint64_t k1 = word(base);
    if (remv >= 2) k1 |= word(base + 1) << 32;
    k1 *= c1; k1 = Rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  uint64_t length = 4ULL * (uint64_t)w;
  h1 ^= length; h2 ^= length;
  h1 += h2; h2 += h1;
  h1 = Fmix64(h1); h2 = Fmix64(h2);
  h1 += h2; h2 += h1;
  *out1 = h1;
  *out2 = h2;
}

// Plain (non-normalized) MurmurHash3_x64_128 of contiguous u32 rows, seed 0
// (utils/hashing.murmur128_u32rows is the numpy oracle; the numpy path's
// per-call overhead on small row sets dominated the multi-k ladder at
// small scales — 30k calls / 24 s on a 30 Mbp ONT run).
int64_t row_hash_batch(const uint32_t* cat, int64_t n, int32_t w,
                       uint64_t* out_h1, uint64_t* out_h2,
                       int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    Murmur128Window(cat + i * w, w, 0, &out_h1[i], &out_h2[i]);
  }
  return 0;
}

int64_t window_hash_batch(const uint32_t* cat, const int64_t* starts,
                          int64_t n, int32_t w, uint64_t* out_h1,
                          uint64_t* out_h2, int32_t n_threads) {
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t* s = cat + starts[i];
    // canonical: min(seq, reversed); equal (palindrome) hashes the same
    int rev = 0;
    for (int32_t j = 0; j < w; ++j) {
      uint32_t a = s[j], b = s[w - 1 - j];
      if (a != b) { rev = (b < a); break; }
    }
    Murmur128Window(s, w, rev, &out_h1[i], &out_h2[i]);
  }
  return 0;
}

}  // extern "C"
