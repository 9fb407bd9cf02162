// Anchor chaining: minimizer matches -> overlap coordinates (C++ core).
//
// Same algorithm as raven_tpu/overlap/chain.py (the ram-dependency
// replacement; see that file's docstring): diagonal-banded grouping by
// (target, strand), longest strictly-monotonic subsequence per group,
// gap-splitting, minimum anchor/span filters.  This is the host hot loop
// of the all-vs-all construct phase for large read sets.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr std::int64_t kDiagonalBand = 500;
constexpr std::int64_t kMinMatches = 4;
constexpr std::int64_t kMaxGap = 10000;
constexpr std::int64_t kMinSpan = 100;

// indices of one longest strictly-increasing subsequence (patience)
void lis_indices(const std::vector<std::int64_t>& v,
                 std::vector<std::int64_t>* out) {
  out->clear();
  const std::size_t n = v.size();
  if (n == 0) return;
  std::vector<std::int64_t> tails;       // smallest tail value per length
  std::vector<std::int64_t> tails_idx;   // its index
  std::vector<std::int64_t> prev(n, -1);
  tails.reserve(n);
  for (std::size_t i = 0; i < n; ++i) {
    const std::int64_t x = v[i];
    const std::size_t j =
        std::lower_bound(tails.begin(), tails.end(), x) - tails.begin();
    if (j == tails.size()) {
      tails.push_back(x);
      tails_idx.push_back(i);
    } else {
      tails[j] = x;
      tails_idx[j] = i;
    }
    prev[i] = j > 0 ? tails_idx[j - 1] : -1;
  }
  for (std::int64_t i = tails_idx.back(); i != -1; i = prev[i])
    out->push_back(i);
  std::reverse(out->begin(), out->end());
}

// Chain one read's matches (the shared core of the per-read and batch
// entries).  Returns overlaps written (<= cap) or -1 on overflow.
long long chain_read(
    const std::uint32_t* tid, const std::uint8_t* same,
    const std::int64_t* qpos, const std::int64_t* tpos, long long n,
    int kmer, std::uint32_t* o_lhs_begin,
    std::uint32_t* o_lhs_end, std::uint32_t* o_rhs_id,
    std::uint32_t* o_rhs_begin, std::uint32_t* o_rhs_end,
    std::uint32_t* o_score, std::uint8_t* o_strand, long long cap,
    std::int64_t* anchor_q, std::int64_t* anchor_t, std::int64_t* anchor_end,
    long long anchor_cap) {
  if (n == 0) return 0;

  struct M {
    std::uint32_t tid;
    std::uint8_t same;
    std::int64_t diag;
    std::int64_t q;
    std::int64_t t;
  };
  std::vector<M> ms(n);
  for (long long i = 0; i < n; ++i) {
    const std::int64_t d = same[i] ? tpos[i] - qpos[i] : tpos[i] + qpos[i];
    ms[i] = M{tid[i], same[i], d, qpos[i], tpos[i]};
  }
  std::sort(ms.begin(), ms.end(), [](const M& a, const M& b) {
    if (a.tid != b.tid) return a.tid < b.tid;
    if (a.same != b.same) return a.same < b.same;
    return a.diag < b.diag;
  });

  long long written = 0;
  long long anchors_written = 0;
  std::vector<std::int64_t> vals, keep;
  std::vector<std::pair<std::int64_t, std::int64_t>> group;  // (q, t)

  long long gs = 0;
  for (long long i = 1; i <= n; ++i) {
    const bool boundary =
        i == n || ms[i].tid != ms[gs].tid || ms[i].same != ms[gs].same ||
        ms[i].diag - ms[i - 1].diag > kDiagonalBand;
    if (!boundary) continue;

    const long long ge = i;
    if (ge - gs >= kMinMatches) {
      const bool g_same = ms[gs].same != 0;
      group.clear();
      for (long long j = gs; j < ge; ++j) group.emplace_back(ms[j].q, ms[j].t);
      std::sort(group.begin(), group.end());

      vals.clear();
      for (const auto& p : group) vals.push_back(g_same ? p.second : -p.second);
      lis_indices(vals, &keep);

      if (static_cast<long long>(keep.size()) >= kMinMatches) {
        // split on large gaps
        std::size_t piece_start = 0;
        for (std::size_t j = 1; j <= keep.size(); ++j) {
          bool cut = j == keep.size();
          if (!cut) {
            const auto& a = group[keep[j - 1]];
            const auto& b = group[keep[j]];
            const std::int64_t gap = std::max(
                std::llabs(b.first - a.first), std::llabs(b.second - a.second));
            cut = gap > kMaxGap;
          }
          if (!cut) continue;
          const long long cnt = static_cast<long long>(j - piece_start);
          if (cnt >= kMinMatches) {
            std::int64_t lhs_b = group[keep[piece_start]].first;
            std::int64_t lhs_e = group[keep[j - 1]].first + kmer;
            std::int64_t t_lo = group[keep[piece_start]].second;
            std::int64_t t_hi = t_lo;
            for (std::size_t m = piece_start; m < j; ++m) {
              t_lo = std::min(t_lo, group[keep[m]].second);
              t_hi = std::max(t_hi, group[keep[m]].second);
            }
            t_hi += kmer;
            if (lhs_e - lhs_b >= kMinSpan && t_hi - t_lo >= kMinSpan) {
              if (written >= cap) return -1;
              if (anchor_q != nullptr) {
                if (anchors_written + cnt > anchor_cap) return -1;
                for (std::size_t m2 = piece_start; m2 < j; ++m2) {
                  anchor_q[anchors_written] = group[keep[m2]].first;
                  anchor_t[anchors_written] = group[keep[m2]].second;
                  ++anchors_written;
                }
                anchor_end[written] = anchors_written;
              }
              o_lhs_begin[written] = static_cast<std::uint32_t>(lhs_b);
              o_lhs_end[written] = static_cast<std::uint32_t>(lhs_e);
              o_rhs_id[written] = ms[gs].tid;
              o_rhs_begin[written] = static_cast<std::uint32_t>(t_lo);
              o_rhs_end[written] = static_cast<std::uint32_t>(t_hi);
              o_score[written] = static_cast<std::uint32_t>(cnt);
              o_strand[written] = g_same ? 1 : 0;
              ++written;
            }
          }
          piece_start = j;
        }
      }
    }
    gs = i;
  }
  return written;
}

}  // namespace

extern "C" {

// Returns the number of overlaps written (<= cap), or -1 on overflow.
// When anchor buffers are non-null, each overlap's chain anchors (q, t)
// are appended to anchor_q/anchor_t with exclusive-end offsets in
// anchor_end[i]; anchors beyond anchor_cap spill -> returns -1.
long long raven_chain_anchors(
    const std::uint32_t* tid, const std::uint8_t* same,
    const std::int64_t* qpos, const std::int64_t* tpos, long long n,
    int kmer, std::uint32_t lhs_id, std::uint32_t* o_lhs_begin,
    std::uint32_t* o_lhs_end, std::uint32_t* o_rhs_id,
    std::uint32_t* o_rhs_begin, std::uint32_t* o_rhs_end,
    std::uint32_t* o_score, std::uint8_t* o_strand, long long cap,
    std::int64_t* anchor_q, std::int64_t* anchor_t, std::int64_t* anchor_end,
    long long anchor_cap) {
  (void)lhs_id;
  return chain_read(tid, same, qpos, tpos, n, kmer, o_lhs_begin, o_lhs_end,
                    o_rhs_id, o_rhs_begin, o_rhs_end, o_score, o_strand, cap,
                    anchor_q, anchor_t, anchor_end, anchor_cap);
}

// Chain a whole batch of reads in one call: matches are pre-sorted by
// query read (read r's matches at [read_start[r], read_start[r+1])), each
// read writes its overlaps at out_off[r] (capacity out_off[r+1] -
// out_off[r]) and, when anchor buffers are given, its anchors at
// aout_off[r].  anchor_end entries are ABSOLUTE exclusive indices into
// the global anchor arrays.  o_counts[r] = overlaps written for read r,
// or -1 if that read overflowed its capacity (caller re-chains it on the
// unbounded path).  Reads are distributed over n_threads worker threads
// (the GIL-free replacement for the per-read thread-pool dispatch, whose
// Python-side slicing serialized on the GIL).
void raven_chain_batch(
    const std::int64_t* read_start, long long n_reads,
    const std::uint32_t* tid, const std::uint8_t* same,
    const std::int64_t* qpos, const std::int64_t* tpos, int kmer,
    int n_threads, const std::int64_t* out_off, const std::int64_t* aout_off,
    std::uint32_t* o_lhs_begin, std::uint32_t* o_lhs_end,
    std::uint32_t* o_rhs_id, std::uint32_t* o_rhs_begin,
    std::uint32_t* o_rhs_end, std::uint32_t* o_score,
    std::uint8_t* o_strand, std::int64_t* anchor_q, std::int64_t* anchor_t,
    std::int64_t* anchor_end, std::int64_t* o_counts) {
  std::atomic<long long> next{0};
  auto worker = [&]() {
    for (;;) {
      const long long r = next.fetch_add(1);
      if (r >= n_reads) return;
      const std::int64_t s0 = read_start[r], s1 = read_start[r + 1];
      const std::int64_t o0 = out_off[r];
      const std::int64_t ocap = out_off[r + 1] - o0;
      std::int64_t a0 = 0, acap = 0;
      if (aout_off != nullptr) {
        a0 = aout_off[r];
        acap = aout_off[r + 1] - a0;
      }
      const long long m = chain_read(
          tid + s0, same + s0, qpos + s0, tpos + s0, s1 - s0, kmer,
          o_lhs_begin + o0, o_lhs_end + o0, o_rhs_id + o0, o_rhs_begin + o0,
          o_rhs_end + o0, o_score + o0, o_strand + o0, ocap,
          aout_off != nullptr ? anchor_q + a0 : nullptr,
          aout_off != nullptr ? anchor_t + a0 : nullptr,
          aout_off != nullptr ? anchor_end + o0 : nullptr, acap);
      o_counts[r] = m;
      if (m > 0 && aout_off != nullptr) {
        for (long long i = 0; i < m; ++i) anchor_end[o0 + i] += a0;
      }
    }
  };
  const int nt = n_threads < 1 ? 1 : n_threads;
  if (nt == 1 || n_reads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 0; t < nt - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// Backwards-compatible entry without anchor outputs.
long long raven_chain(const std::uint32_t* tid, const std::uint8_t* same,
                      const std::int64_t* qpos, const std::int64_t* tpos,
                      long long n, int kmer, std::uint32_t lhs_id,
                      std::uint32_t* o_lhs_begin, std::uint32_t* o_lhs_end,
                      std::uint32_t* o_rhs_id, std::uint32_t* o_rhs_begin,
                      std::uint32_t* o_rhs_end, std::uint32_t* o_score,
                      std::uint8_t* o_strand, long long cap) {
  return raven_chain_anchors(tid, same, qpos, tpos, n, kmer, lhs_id,
                             o_lhs_begin, o_lhs_end, o_rhs_id, o_rhs_begin,
                             o_rhs_end, o_score, o_strand, cap, nullptr,
                             nullptr, nullptr, 0);
}

}  // extern "C"
