// Native batch window-cutting for contig polishing: for every
// (read-vs-contig alignment, 500 bp window) pair, find the read interval
// aligned to the window boundaries by walking outward from the nearest
// exact-match anchor, with a unit-cost edit-DP fallback — the racon
// find_breaking_points role (src/toBasespace/ContigPolisher.hpp:1550-1795).
//
// This is the HOST production twin of the pure-Python oracle
// basespace/polisher.find_breaking_points (+_walk_back/_walk_fwd/_nw_core/
// _nw_back/_nw_fwd), OpenMP across alignments; bit-identical outputs are
// asserted by tests/test_window_cut.py. The quality filter and fragment
// materialization stay in Python (they need the window pool's eviction
// state).

#include <algorithm>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// polisher._match_run_back: k bases before (q, t) match exactly
inline bool MatchRunBack(const uint8_t* r, const uint8_t* c, int64_t q,
                         int64_t t, int64_t k) {
  k = std::min(k, std::min(q, t));
  if (k <= 0) return false;
  for (int64_t i = 1; i <= k; ++i)
    if (r[q - i] != c[t - i]) return false;
  return true;
}

// polisher._match_run_fwd
inline bool MatchRunFwd(const uint8_t* r, int64_t rlen, const uint8_t* c,
                        int64_t clen, int64_t q, int64_t t, int64_t k) {
  k = std::min(k, std::min(rlen - q, clen - t));
  if (k <= 0) return false;
  for (int64_t i = 0; i < k; ++i)
    if (r[q + i] != c[t + i]) return false;
  return true;
}

// polisher._walk_back: greedy micro-alignment toward t_stop
void WalkBack(const uint8_t* r, const uint8_t* c, int64_t* q_io,
              int64_t* t_io, int64_t t_stop) {
  int64_t q = *q_io, t = *t_io;
  while (t > t_stop && q > 0) {
    if (r[q - 1] == c[t - 1]) {
      --q;
      --t;
      continue;
    }
    if (q >= 2 && t - 1 >= t_stop && MatchRunBack(r, c, q - 1, t - 1, 3)) {
      --q;
      --t;
      continue;
    }
    bool moved = false;
    for (int64_t s = 1; s <= 3; ++s) {
      if (t - s >= t_stop && MatchRunBack(r, c, q, t - s, 4)) {
        t -= s;
        moved = true;
        break;
      }
      if (q - s >= 0 && MatchRunBack(r, c, q - s, t, 4)) {
        q -= s;
        moved = true;
        break;
      }
    }
    if (!moved) break;
  }
  *q_io = q;
  *t_io = t;
}

// polisher._walk_fwd
void WalkFwd(const uint8_t* r, int64_t rlen, const uint8_t* c, int64_t clen,
             int64_t* q_io, int64_t* t_io, int64_t t_stop) {
  int64_t q = *q_io, t = *t_io;
  while (t < t_stop && q < rlen) {
    if (r[q] == c[t]) {
      ++q;
      ++t;
      continue;
    }
    if (t + 1 < t_stop && MatchRunFwd(r, rlen, c, clen, q + 1, t + 1, 3)) {
      ++q;
      ++t;
      continue;
    }
    bool moved = false;
    for (int64_t s = 1; s <= 3; ++s) {
      if (t + s <= t_stop && MatchRunFwd(r, rlen, c, clen, q, t + s, 4)) {
        t += s;
        moved = true;
        break;
      }
      if (q + s <= rlen && MatchRunFwd(r, rlen, c, clen, q + s, t, 4)) {
        q += s;
        moved = true;
        break;
      }
    }
    if (!moved) break;
  }
  *q_io = q;
  *t_io = t;
}

// polisher._nw_core: unit-cost edit DP of `a` (fully consumed, possibly
// reversed) vs a prefix of `b` (free end, possibly reversed); returns the
// b-length of the best alignment (first argmin on ties, like np.argmin).
int64_t NwCore(const uint8_t* a, int64_t alen, bool a_rev, const uint8_t* b,
               int64_t blen, bool b_rev, std::vector<int32_t>* row_buf) {
  std::vector<int32_t>& prev = *row_buf;
  prev.resize(blen + 1);
  for (int64_t j = 0; j <= blen; ++j) prev[j] = (int32_t)j;
  for (int64_t i = 1; i <= alen; ++i) {
    uint8_t ac = a_rev ? a[alen - i] : a[i - 1];
    int32_t diag = prev[0];  // prev[j-1] from the previous row
    prev[0] = (int32_t)i;
    for (int64_t j = 1; j <= blen; ++j) {
      uint8_t bc = b_rev ? b[blen - j] : b[j - 1];
      int32_t sub = diag + (ac != bc ? 1 : 0);
      int32_t del = prev[j] + 1;
      int32_t ins = prev[j - 1] + 1;
      diag = prev[j];
      prev[j] = std::min(sub, std::min(del, ins));
    }
  }
  int64_t best = 0;
  int32_t best_v = prev[0];
  for (int64_t j = 1; j <= blen; ++j) {
    if (prev[j] < best_v) {
      best_v = prev[j];
      best = j;
    }
  }
  return best;
}

inline int64_t NwSlack(int64_t m) { return 30 + m / 10; }

struct CutResult {
  std::vector<int64_t> fq, lq, ft, lt;
  int32_t dropped = 0;
};

// polisher.find_breaking_points minus the quality filter and fragment
// materialization; emits (first_q, last_q, first_t, last_t) per surviving
// window, ascending window order, with the oracle's exact stop semantics.
void CutOne(const uint8_t* read, int64_t read_len, const uint8_t* contig,
            int64_t contig_len, const int64_t* aq, const int64_t* at,
            int64_t n_anchors, int64_t t_begin, int64_t t_end,
            int64_t window_len, int64_t align_l, int64_t nw_max_m,
            std::vector<int32_t>* row_buf, CutResult* out) {
  if (n_anchors == 0) return;

  std::vector<int64_t> window_ends;
  for (int64_t i = 0; i < t_end; i += window_len)
    if (i > t_begin) window_ends.push_back(i - 1);
  window_ends.push_back(t_end - 1);

  int64_t ws = t_begin;
  for (size_t wi = 0; wi < window_ends.size(); ++wi) {
    int64_t we = window_ends[wi];
    if (wi > 0) ws = window_ends[wi - 1] + 1;

    // entry point: first anchor whose inclusive end reaches ws
    // (t_finals = at + align_l - 1; searchsorted left)
    int64_t k = std::lower_bound(at, at + n_anchors, ws - (align_l - 1)) - at;
    if (k >= n_anchors) continue;
    int64_t first_q, first_t;
    if (at[k] <= ws) {
      first_t = ws;
      first_q = aq[k] + (ws - at[k]);
    } else {
      first_q = aq[k];
      first_t = at[k];
      WalkBack(read, contig, &first_q, &first_t, ws);
      if (first_t > ws) {
        // _nw_back(read, contig, q_hi=aq[k], t_hi=at[k], t_stop=ws)
        int64_t m = at[k] - ws;
        if (m > 0) {
          if (m > nw_max_m) {
            out->dropped += 1;
          } else {
            int64_t slack = NwSlack(m);
            int64_t q_lo = std::max((int64_t)0, aq[k] - m - slack);
            if (aq[k] > q_lo) {
              int64_t j = NwCore(contig + ws, m, true, read + q_lo,
                                 aq[k] - q_lo, true, row_buf);
              first_q = aq[k] - j;
              first_t = ws;
            }
          }
        }
      }
    }
    if (first_t > we) continue;

    // exit point: last anchor starting at or before we (searchsorted
    // right - 1)
    int64_t k2 = std::upper_bound(at, at + n_anchors, we) - at - 1;
    if (k2 < 0) continue;
    int64_t last_q, last_t;
    int64_t t_final2 = at[k2] + align_l - 1;
    if (t_final2 <= we) {
      last_q = aq[k2] + align_l;
      last_t = t_final2 + 1;
      WalkFwd(read, read_len, contig, contig_len, &last_q, &last_t, we + 1);
      if (last_t < we + 1) {
        // _nw_fwd(read, contig, q_lo=aq[k2]+align_l, t_lo=t_final2+1,
        //         t_stop=we+1)
        int64_t q_lo = aq[k2] + align_l;
        int64_t t_lo = t_final2 + 1;
        int64_t m = (we + 1) - t_lo;
        if (m > 0) {
          if (m > nw_max_m) {
            out->dropped += 1;
          } else {
            int64_t slack = NwSlack(m);
            int64_t q_hi = std::min(read_len, q_lo + m + slack);
            if (q_hi > q_lo) {
              int64_t j = NwCore(contig + t_lo, m, false, read + q_lo,
                                 q_hi - q_lo, false, row_buf);
              last_q = q_lo + j;
              last_t = we + 1;
            }
          }
        }
      }
    } else {
      last_t = we + 1;
      last_q = aq[k2] + (we - at[k2]) + 1;
    }
    if (last_t <= first_t || last_q <= first_q) continue;
    if (first_q >= read_len || last_q > read_len) return;  // stop
    if ((double)(last_q - first_q) < 0.02 * (double)window_len) continue;
    out->fq.push_back(first_q);
    out->lq.push_back(last_q);
    out->ft.push_back(first_t);
    out->lt.push_back(last_t);
  }
}

}  // namespace

extern "C" {

// Batch over alignments; anchors concatenated (anchor_offs[n_items+1]).
// read_seqs/contig_seqs are per-item base pointers. Outputs are compacted
// in item order (out_offs[n_items+1] filled); capacity bound from Python
// (sum over items of t_end/window_len + 2) is exact, so no retry path.
int64_t window_cut_batch(const uint8_t** read_seqs, const int64_t* read_lens,
                         const uint8_t** contig_seqs,
                         const int64_t* contig_lens, const int64_t* anchors_q,
                         const int64_t* anchors_t, const int64_t* anchor_offs,
                         const int64_t* t_begin, const int64_t* t_end,
                         int32_t n_items, int32_t window_len, int32_t align_l,
                         int64_t nw_max_m, int64_t* out_offs, int64_t* out_fq,
                         int64_t* out_lq, int64_t* out_ft, int64_t* out_lt,
                         int32_t* out_dropped, int32_t n_threads) {
  std::vector<CutResult> results(n_items);
#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
    std::vector<int32_t> row_buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int32_t i = 0; i < n_items; ++i) {
      int64_t a = anchor_offs[i];
      CutOne(read_seqs[i], read_lens[i], contig_seqs[i], contig_lens[i],
             anchors_q + a, anchors_t + a, anchor_offs[i + 1] - a,
             t_begin[i], t_end[i], window_len, align_l, nw_max_m, &row_buf,
             &results[i]);
      out_dropped[i] = results[i].dropped;
    }
  }
  int64_t total = 0;
  out_offs[0] = 0;
  for (int32_t i = 0; i < n_items; ++i) {
    total += (int64_t)results[i].fq.size();
    out_offs[i + 1] = total;
  }
  int64_t o = 0;
  for (int32_t i = 0; i < n_items; ++i) {
    const CutResult& r = results[i];
    std::copy(r.fq.begin(), r.fq.end(), out_fq + o);
    std::copy(r.lq.begin(), r.lq.end(), out_lq + o);
    std::copy(r.ft.begin(), r.ft.end(), out_ft + o);
    std::copy(r.lt.begin(), r.lt.end(), out_lt + o);
    o += (int64_t)r.fq.size();
  }
  return total;
}

}  // extern "C"
