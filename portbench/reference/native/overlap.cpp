// Native anchor-based overlap/mapping engine — the minimap2 role of
// basespace/overlap.py (seed lookup in a sorted minimizer table, densest
// diagonal-corridor chain extraction, closed-form identity from seed
// survival), OpenMP across queries.
//
// This is the HOST production twin of the pure-Python oracle
// basespace/overlap.map_sketched/_extract_chains (bit-identical chains,
// tests/test_overlap_native.py). It accelerates every base-space consumer:
// the polish-pass read-vs-contig mapping (was a fork pool of per-read
// numpy calls — ~73 s of a 12 Mb toBasespace), the tiling junction
// verification (overlap_pair), chimera detection, and self-overlap checks.
//
// Reference roles: ToBasespace2.hpp:3547-3720 computeAlignment,
// ContigPolisher.hpp:451-518 MapReadsFunctor, ContigDerep.hpp:75-133.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Chain {
  int64_t qs, qe, ts, te;
  int64_t matches;
  double identity;
  int32_t tid;
  uint8_t rev;
  std::vector<int64_t> aq, at;  // kept anchors, query order
};

// overlap._extract_chains: iterative diagonal-band chain extraction for
// one (target, strand) anchor group. q/t are the gathered anchors in
// query-major order; identity math kept in double to match numpy scalars.
void ExtractChains(const std::vector<int64_t>& q, const std::vector<int64_t>& t,
                   bool rev, int64_t qlen, int64_t tlen, int32_t tid,
                   double density, int64_t min_span, int64_t band,
                   int32_t max_chains, int64_t min_anchors, int32_t align_l,
                   std::vector<Chain>* out) {
  int64_t n = (int64_t)q.size();
  std::vector<int64_t> diag(n);
  for (int64_t i = 0; i < n; ++i) diag[i] = rev ? (t[i] + q[i]) : (t[i] - q[i]);
  std::vector<char> alive(n, 1);
  size_t first_new = out->size();

  std::vector<int64_t> idx, ds, sel_q, sel_t, order;
  for (int32_t it = 0; it < max_chains; ++it) {
    idx.clear();
    for (int64_t i = 0; i < n; ++i)
      if (alive[i]) idx.push_back(i);
    if ((int64_t)idx.size() < min_anchors) break;

    ds.clear();
    for (int64_t i : idx) ds.push_back(diag[i]);
    std::sort(ds.begin(), ds.end());
    // densest corridor [ds[peak], ds[peak]+band]; first argmax wins
    int64_t peak = 0, best_count = -1;
    for (size_t i = 0; i < ds.size(); ++i) {
      int64_t j = std::upper_bound(ds.begin(), ds.end(), ds[i] + band)
                  - ds.begin();
      int64_t count = j - (int64_t)i;
      if (count > best_count) {
        best_count = count;
        peak = (int64_t)i;
      }
    }
    int64_t lo = ds[peak], hi = ds[peak] + band;

    sel_q.clear();
    sel_t.clear();
    int64_t n_sel = 0;
    for (int64_t i : idx) {
      if (diag[i] >= lo && diag[i] <= hi) {
        alive[i] = 0;
        ++n_sel;
        sel_q.push_back(q[i]);
        sel_t.push_back(t[i]);
      }
    }
    if (n_sel < min_anchors) continue;

    // np.lexsort((t, q)): primary q, secondary t, stable
    order.resize(n_sel);
    for (int64_t i = 0; i < n_sel; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      if (sel_q[a] != sel_q[b]) return sel_q[a] < sel_q[b];
      return sel_t[a] < sel_t[b];
    });

    // keep record-setters of (rev ? -t : t) along q
    std::vector<int64_t> kq, kt;
    int64_t run_max = INT64_MIN;
    for (int64_t i = 0; i < n_sel; ++i) {
      int64_t o = order[i];
      int64_t tt = rev ? -sel_t[o] : sel_t[o];
      if (tt >= run_max) {  // np.maximum.accumulate record-setters
        run_max = tt;
        kq.push_back(sel_q[o]);
        kt.push_back(sel_t[o]);
      }
    }
    if ((int64_t)kq.size() < min_anchors) continue;

    int64_t qs = kq.front(), qe = kq.back() + align_l;
    int64_t ts, te;
    if (rev) {
      ts = kt.back();
      te = kt.front() + align_l;
    } else {
      ts = kt.front();
      te = kt.back() + align_l;
    }
    int64_t span = std::min(qe - qs, te - ts);
    if (span < min_span) continue;

    int64_t covered = align_l;
    for (size_t i = 1; i < kq.size(); ++i)
      covered += std::min(kq[i] - kq[i - 1], (int64_t)align_l);
    double cov_frac =
        std::min(1.0, (double)covered / (double)std::max((int64_t)1, qe - qs));
    double identity;
    if (cov_frac >= 0.999) {
      identity = 1.0;
    } else {
      double s = std::min(
          1.0, -std::log(1.0 - cov_frac) / ((double)align_l * density));
      identity = std::pow(s, 1.0 / (double)align_l);
    }
    int64_t matches = (int64_t)(identity * (double)span);
    if (matches < min_span) continue;

    Chain c;
    c.qs = qs;
    c.qe = qe;
    c.ts = ts;
    c.te = te;
    c.matches = matches;
    c.identity = identity;
    c.tid = tid;
    c.rev = rev ? 1 : 0;
    c.aq = std::move(kq);
    c.at = std::move(kt);
    out->push_back(std::move(c));
  }
  // per-group: out.sort(key=-nb_matches), stable
  std::stable_sort(out->begin() + first_new, out->end(),
                   [](const Chain& a, const Chain& b) {
                     return a.matches > b.matches;
                   });
}

// overlap.map_sketched for one query against the sorted index.
void MapOne(const uint32_t* ivals, const int64_t* itids, const int64_t* ipos,
            const uint8_t* idirs, int64_t ni, const int64_t* tid_lengths,
            const uint32_t* qv, const int64_t* qp, const uint8_t* qd,
            int64_t nq, int64_t qlen, double density, int64_t min_span,
            int64_t max_occ, int64_t band, int32_t max_chains,
            int64_t min_anchors, int32_t align_l, int64_t exclude_tid,
            uint8_t exclude_self_diag, std::vector<Chain>* out) {
  if (nq == 0 || ni == 0) return;
  // gather anchors in (query index asc, table order asc)
  std::vector<int64_t> a_t, a_tid, a_q;
  std::vector<uint8_t> a_rev;
  for (int64_t i = 0; i < nq; ++i) {
    const uint32_t* lo = std::lower_bound(ivals, ivals + ni, qv[i]);
    const uint32_t* hi = std::upper_bound(lo, ivals + ni, qv[i]);
    int64_t cnt = hi - lo;
    if (cnt > max_occ) continue;  // mid_occ seed filter
    for (const uint32_t* p = lo; p != hi; ++p) {
      int64_t j = p - ivals;
      int64_t tid = itids[j];
      uint8_t rev = ((idirs[j] != 0) != (qd[i] != 0)) ? 1 : 0;
      if (exclude_tid >= 0 && tid == exclude_tid) continue;
      if (exclude_self_diag && !rev && ipos[j] == qp[i]) continue;
      a_t.push_back(ipos[j]);
      a_tid.push_back(tid);
      a_rev.push_back(rev);
      a_q.push_back(qp[i]);
    }
  }
  int64_t total = (int64_t)a_t.size();
  if (total == 0) return;

  // group by key = tid*2 + rev, stable (np.argsort kind=stable)
  std::vector<int64_t> order(total);
  for (int64_t i = 0; i < total; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return a_tid[a] * 2 + a_rev[a] < a_tid[b] * 2 + a_rev[b];
  });

  std::vector<int64_t> gq, gt;
  int64_t s = 0;
  while (s < total) {
    int64_t key = a_tid[order[s]] * 2 + a_rev[order[s]];
    int64_t e = s;
    while (e < total && a_tid[order[e]] * 2 + a_rev[order[e]] == key) ++e;
    if (e - s >= min_anchors) {
      gq.clear();
      gt.clear();
      for (int64_t i = s; i < e; ++i) {
        gq.push_back(a_q[order[i]]);
        gt.push_back(a_t[order[i]]);
      }
      int32_t tid = (int32_t)a_tid[order[s]];
      ExtractChains(gq, gt, a_rev[order[s]] != 0, qlen, tid_lengths[tid],
                    tid, density, min_span, band, max_chains, min_anchors,
                    align_l, out);
    }
    s = e;
  }
  // final: out.sort(key=-nb_matches), stable over the group order
  std::stable_sort(out->begin(), out->end(),
                   [](const Chain& a, const Chain& b) {
                     return a.matches > b.matches;
                   });
}

}  // namespace

extern "C" {

// Batch mapping of many pre-sketched queries against one sorted index.
// Index arrays (ivals sorted asc with itids/ipos/idirs aligned) and query
// sketches are concatenated (q_offs[n_queries+1]). tid_lengths is indexed
// by tid (caller sizes it to max_tid+1). exclude_tid: per-query (-1 =
// none). Outputs: per-chain field arrays + kept-anchor arrays, chain
// ranges per query in chain_offs[n_queries+1]. Returns total chains, or
// -(needed_chains) / -(needed_anchors)<<32 style is avoided — instead the
// call reports needs via out_needed[0]=chains, [1]=anchors and returns -1
// when either cap is too small (caller retries with the reported sizes).
int64_t ovl_map_batch(
    const uint32_t* ivals, const int64_t* itids, const int64_t* ipos,
    const uint8_t* idirs, int64_t ni, const int64_t* tid_lengths,
    const uint32_t* q_vals, const int64_t* q_pos, const uint8_t* q_dirs,
    const int64_t* q_offs, const int64_t* q_lens, int32_t n_queries,
    const int64_t* exclude_tid, uint8_t exclude_self_diag, double density,
    int64_t min_span, int64_t max_occ, int64_t band, int32_t max_chains,
    int64_t min_anchors, int32_t align_l,
    int64_t* chain_offs,                       // n_queries+1
    int64_t* out_qs, int64_t* out_qe, int64_t* out_ts, int64_t* out_te,
    int64_t* out_matches, double* out_identity, int32_t* out_tid,
    uint8_t* out_rev, int64_t chain_cap,
    int64_t* anchor_offs,                      // chain_cap+1
    int64_t* out_aq, int64_t* out_at, int64_t anchor_cap,
    int64_t* out_needed, int32_t n_threads) {
  std::vector<std::vector<Chain>> results(n_queries);
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 16)
#endif
  for (int32_t qi = 0; qi < n_queries; ++qi) {
    int64_t a = q_offs[qi];
    MapOne(ivals, itids, ipos, idirs, ni, tid_lengths, q_vals + a, q_pos + a,
           q_dirs + a, q_offs[qi + 1] - a, q_lens[qi], density, min_span,
           max_occ, band, max_chains, min_anchors, align_l, exclude_tid[qi],
           exclude_self_diag, &results[qi]);
  }
  int64_t total_chains = 0, total_anchors = 0;
  for (int32_t qi = 0; qi < n_queries; ++qi) {
    total_chains += (int64_t)results[qi].size();
    for (const Chain& c : results[qi]) total_anchors += (int64_t)c.aq.size();
  }
  out_needed[0] = total_chains;
  out_needed[1] = total_anchors;
  if (total_chains > chain_cap || total_anchors > anchor_cap) return -1;

  int64_t ci = 0, ai = 0;
  chain_offs[0] = 0;
  anchor_offs[0] = 0;
  for (int32_t qi = 0; qi < n_queries; ++qi) {
    for (const Chain& c : results[qi]) {
      out_qs[ci] = c.qs;
      out_qe[ci] = c.qe;
      out_ts[ci] = c.ts;
      out_te[ci] = c.te;
      out_matches[ci] = c.matches;
      out_identity[ci] = c.identity;
      out_tid[ci] = c.tid;
      out_rev[ci] = c.rev;
      std::copy(c.aq.begin(), c.aq.end(), out_aq + ai);
      std::copy(c.at.begin(), c.at.end(), out_at + ai);
      ai += (int64_t)c.aq.size();
      anchor_offs[ci + 1] = ai;
      ++ci;
    }
    chain_offs[qi + 1] = ci;
  }
  return total_chains;
}

}  // extern "C"
