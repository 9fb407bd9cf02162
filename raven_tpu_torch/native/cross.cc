// Alignment-path boundary crossings (C++ core).
//
// Same contract as raven_tpu/ops/align_dp.py::batched_boundary_crossings
// (the racon-dependency FindBreakPoints analog): for each job, the optimal
// global edit-distance alignment of target[0..n) vs query[0..m) crosses
// target row `cross` at the query column minimizing forward + backward
// cost (ties -> smallest column).  Two linear-memory row sweeps per job,
// no traceback; jobs fan out over a thread pool.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// D rows of the global edit-distance DP: fills `row` (size m+1) with
// D[rows][*] for target t[0..rows) vs query q[0..m).
void forward_row(const std::uint8_t* t, std::int64_t rows,
                 const std::uint8_t* q, std::int64_t m, std::int32_t* row) {
  for (std::int64_t j = 0; j <= m; ++j) row[j] = j;
  std::vector<std::int32_t> e(m + 1);
  for (std::int64_t r = 0; r < rows; ++r) {
    const std::uint8_t tc = t[r];
    e[0] = r + 1;
    for (std::int64_t j = 1; j <= m; ++j) {
      const std::int32_t sub = row[j - 1] + (q[j - 1] != tc);
      const std::int32_t up = row[j] + 1;
      e[j] = sub < up ? sub : up;
    }
    // horizontal closure (insertions)
    row[0] = e[0];
    for (std::int64_t j = 1; j <= m; ++j) {
      const std::int32_t left = row[j - 1] + 1;
      row[j] = e[j] < left ? e[j] : left;
    }
  }
}

void solve_range(const std::uint8_t* tgt, const std::int64_t* t_off,
                 const std::int64_t* t_len, const std::uint8_t* qry,
                 const std::int64_t* q_off, const std::int64_t* q_len,
                 const std::int64_t* cross, std::int64_t lo, std::int64_t hi,
                 std::int64_t* out_j) {
  std::vector<std::int32_t> fwd, bwd;
  std::vector<std::uint8_t> rt, rq;
  for (std::int64_t i = lo; i < hi; ++i) {
    const std::uint8_t* t = tgt + t_off[i];
    const std::uint8_t* q = qry + q_off[i];
    const std::int64_t n = t_len[i], m = q_len[i], c = cross[i];
    fwd.resize(m + 1);
    bwd.resize(m + 1);
    forward_row(t, c, q, m, fwd.data());
    rt.assign(t, t + n);
    rq.assign(q, q + m);
    std::reverse(rt.begin(), rt.end());
    std::reverse(rq.begin(), rq.end());
    forward_row(rt.data(), n - c, rq.data(), m, bwd.data());
    std::int64_t best_j = 0;
    std::int32_t best = fwd[0] + bwd[m];
    for (std::int64_t j = 1; j <= m; ++j) {
      const std::int32_t v = fwd[j] + bwd[m - j];
      if (v < best) {
        best = v;
        best_j = j;
      }
    }
    out_j[i] = best_j;
  }
}

}  // namespace

extern "C" {

void raven_boundary_crossings(const std::uint8_t* tgt,
                              const std::int64_t* t_off,
                              const std::int64_t* t_len,
                              const std::uint8_t* qry,
                              const std::int64_t* q_off,
                              const std::int64_t* q_len,
                              const std::int64_t* cross, long long n_jobs,
                              int n_threads, std::int64_t* out_j) {
  if (n_jobs <= 0) return;
  n_threads = std::max(1, std::min<int>(n_threads, n_jobs));
  if (n_threads == 1) {
    solve_range(tgt, t_off, t_len, qry, q_off, q_len, cross, 0, n_jobs,
                out_j);
    return;
  }
  // static split by total DP area so threads finish together
  std::vector<double> area(n_jobs);
  double total = 0;
  for (std::int64_t i = 0; i < n_jobs; ++i) {
    area[i] = static_cast<double>(t_len[i]) * q_len[i];
    total += area[i];
  }
  std::vector<std::thread> pool;
  std::int64_t start = 0;
  double acc = 0;
  for (int w = 0; w < n_threads && start < n_jobs; ++w) {
    const double budget = total * (w + 1) / n_threads;
    std::int64_t end = start;
    while (end < n_jobs && (acc < budget || end == start)) acc += area[end++];
    if (w == n_threads - 1) end = n_jobs;
    pool.emplace_back(solve_range, tgt, t_off, t_len, qry, q_off, q_len,
                      cross, start, end, out_j);
    start = end;
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
