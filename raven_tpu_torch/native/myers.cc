// Myers bit-parallel edit distance (block-based, Hyyro formulation).
//
// First-party replacement for the reference's edlib dependency use sites
// (global NW edit distance only: construct.cc:190-199, assemble.cc:271-281,
// graph_repr.cc:250-258, raven_test.cpp:38-44).  Pattern rows live in 64-bit
// blocks; vertical deltas are carried per block, horizontal deltas chain
// across blocks; the score tracks D[n][j] at the pattern's last row.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Block {
  std::uint64_t P;  // plus-vertical
  std::uint64_t M;  // minus-vertical
};

}  // namespace

extern "C" {

// a = pattern codes (0..3 or arbitrary bytes), b = text codes.
// Returns the global (NW) edit distance.
long long raven_myers_ed(const std::uint8_t* a, long long n,
                         const std::uint8_t* b, long long m) {
  if (n == 0) return m;
  if (m == 0) return n;

  const int W = 64;
  const long long nblocks = (n + W - 1) / W;
  std::vector<std::uint64_t> peq(256 * nblocks, 0);
  for (long long i = 0; i < n; ++i) {
    peq[a[i] * nblocks + i / W] |= 1ULL << (i % W);
  }

  std::vector<Block> blocks(nblocks);
  for (long long j = 0; j < nblocks; ++j) {
    blocks[j].P = ~0ULL;
    blocks[j].M = 0;
  }

  const int last_bit = static_cast<int>((n - 1) % W);
  long long score = n;

  for (long long j = 0; j < m; ++j) {
    const std::uint64_t* eq_row = &peq[b[j] * nblocks];
    int hin = 1;  // top boundary D[0][j] - D[0][j-1] = +1 (global alignment)
    for (long long bidx = 0; bidx < nblocks; ++bidx) {
      std::uint64_t Pv = blocks[bidx].P;
      std::uint64_t Mv = blocks[bidx].M;
      std::uint64_t Eq = eq_row[bidx];
      if (hin < 0) Eq |= 1ULL;
      const std::uint64_t Xv = Eq | Mv;
      const std::uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
      std::uint64_t Ph = Mv | ~(Xh | Pv);
      std::uint64_t Mh = Pv & Xh;

      if (bidx == nblocks - 1) {
        // horizontal delta at the pattern's last row -> score
        score += (Ph >> last_bit) & 1ULL;
        score -= (Mh >> last_bit) & 1ULL;
      }

      int hout = 0;
      if (Ph >> 63) hout = 1;
      else if (Mh >> 63) hout = -1;

      Ph <<= 1;
      Mh <<= 1;
      if (hin < 0) Mh |= 1ULL;
      else if (hin > 0) Ph |= 1ULL;

      blocks[bidx].P = Mh | ~(Xv | Ph);
      blocks[bidx].M = Ph & Xv;
      hin = hout;
    }
  }
  return score;
}

// Block-banded Myers (the edlib "block band" + Ukkonen threshold scheme):
// only pattern blocks intersecting the band around the end diagonal are
// advanced, so the cost is O(m * k / 64) instead of O(m * n / 64).
//
// Band safety: any path through cell (i, j) costs at least
// |i-j| + |(n-m)-(i-j)| indels, so cells with i-j outside
// [min(0,n-m)-k, max(0,n-m)+k] cannot lie on a path of cost <= k.
// Blocks entering the band are initialized with all-+1 vertical deltas
// (an upper bound, by D[i+1][j] <= D[i][j]+1) and the truncated band top
// uses hin=+1 (the global top-boundary delta) — both keep every computed
// cell an upper bound of the true DP value, while cells on any optimal
// path of cost <= k are computed exactly.  Hence: a returned score <= k is
// the exact edit distance; returns -1 when the score exceeds k (caller
// doubles k and retries — Ukkonen's scheme).
long long raven_myers_ed_banded(const std::uint8_t* a, long long n,
                                const std::uint8_t* b, long long m,
                                long long k) {
  if (n == 0) return m <= k ? m : -1;
  if (m == 0) return n <= k ? n : -1;
  if (k >= n || k >= m) {
    long long full = raven_myers_ed(a, n, b, m);
    return full;  // band covers everything the doubling loop would
  }

  const int W = 64;
  const long long nblocks = (n + W - 1) / W;
  const long long n_pad = nblocks * W;  // rows padded to the block grid
  // NOTE: the result is read at the real last row's bit (like the full
  // kernel), NOT at the padded block bottom — pad rows absorb insertions
  // via cost-1 mismatch diagonals, so D[n_pad][m] != D[n][m] + pad.
  std::vector<std::uint64_t> peq(256 * nblocks, 0);
  for (long long i = 0; i < n; ++i) {
    peq[a[i] * nblocks + i / W] |= 1ULL << (i % W);
  }

  const long long lo_off = (n < m ? n - m : 0) - k;          // i-j lower
  const long long hi_off = (n_pad > m ? n_pad - m : 0) + k;  // i-j upper

  const int last_bit = static_cast<int>((n - 1) % W);
  std::vector<Block> blocks(nblocks);
  std::vector<long long> score(nblocks, 0);
  long long b_first = 0;
  long long b_last = (hi_off) / W;  // rows [0, hi_off] active at column 0
  if (b_last >= nblocks) b_last = nblocks - 1;
  for (long long bidx = 0; bidx <= b_last; ++bidx) {
    blocks[bidx].P = ~0ULL;
    blocks[bidx].M = 0;
    score[bidx] = W * (bidx + 1);  // D[i][0] = i at block bottoms
  }
  // score at the REAL last pattern row (valid once the last block is
  // active); when the last block activates late its implied column value
  // is the +1-per-row extension of the block above
  long long score_n = (b_last == nblocks - 1) ? n : -1;

  for (long long j = 0; j < m; ++j) {
    // slide the band: activate blocks entering from below (values are the
    // +1-per-row extension of the block above, an upper bound)
    const long long want_last = ((j + 1) + hi_off) / W;
    while (b_last < nblocks - 1 && b_last < want_last) {
      ++b_last;
      blocks[b_last].P = ~0ULL;
      blocks[b_last].M = 0;
      score[b_last] = score[b_last - 1] + W;
      if (b_last == nblocks - 1) {
        score_n = score[b_last - 1] + last_bit + 1;
      }
    }
    // drop blocks leaving through the top (their rows can no longer be on
    // a <= k path); the new top receives hin=+1 like the matrix boundary
    const long long want_first = ((j + 1) + lo_off) / W;
    if (want_first > b_first) {
      b_first = want_first < b_last ? want_first : b_last;
    }

    const std::uint64_t* eq_row = &peq[b[j] * nblocks];
    int hin = 1;
    for (long long bidx = b_first; bidx <= b_last; ++bidx) {
      std::uint64_t Pv = blocks[bidx].P;
      std::uint64_t Mv = blocks[bidx].M;
      std::uint64_t Eq = eq_row[bidx];
      if (hin < 0) Eq |= 1ULL;
      const std::uint64_t Xv = Eq | Mv;
      const std::uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
      std::uint64_t Ph = Mv | ~(Xh | Pv);
      std::uint64_t Mh = Pv & Xh;

      int hout = 0;
      if (Ph >> 63) hout = 1;
      else if (Mh >> 63) hout = -1;
      score[bidx] += hout;
      if (bidx == nblocks - 1) {
        score_n += (Ph >> last_bit) & 1ULL;
        score_n -= (Mh >> last_bit) & 1ULL;
      }

      Ph <<= 1;
      Mh <<= 1;
      if (hin < 0) Mh |= 1ULL;
      else if (hin > 0) Ph |= 1ULL;

      blocks[bidx].P = Mh | ~(Xv | Ph);
      blocks[bidx].M = Ph & Xv;
      hin = hout;
    }
  }

  if (b_last != nblocks - 1) return -1;  // band never reached row n
  return score_n <= k ? score_n : -1;
}

}  // extern "C"
