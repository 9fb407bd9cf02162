// Segment tiling + 2-bit packing for the device index build (C++ core).
//
// Mirrors raven_tpu/ops/sketch.py segment_reads() followed by the 4x
// base packing in overlap/device_index.py: reads are tiled into
// fixed-width halo'd segments and each segment row is emitted already
// 2-bit packed (4 bases/byte) for the h2d upload.  This is the serial
// host head of the device overlap stage (reference equivalent: the
// sequence marshalling in front of ram Minimize, construct.cc:42); the
// python/numpy version cost ~5 s of a ~9 s steady stage at 115 Mbp.
//
// Semantics (must stay bit-identical to segment_reads):
//   halo   = (k-1) + 2*(w-1); stride = width - halo
//   reads shorter than k+w-1 produce no segments
//   segment s starts at offset s*stride; eff = min(width, n - off)
//   claim_lo = 0 for the first segment else w-1
//   claim_hi = width when the segment reaches the read end else
//              (w-1) + stride
//
// The caller precomputes per-read row offsets (exact, vectorized numpy)
// so the fill parallelizes over reads with no synchronization.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void fill_range(const std::uint8_t* codes, const std::int64_t* starts,
                const std::int64_t* lengths, const std::int64_t* ids,
                const std::int64_t* row_off, long long j0, long long j1,
                int k, int w, int width, std::uint8_t* out_packed,
                std::int32_t* out_eff, std::int32_t* out_rid,
                std::int32_t* out_base, std::int32_t* out_clo,
                std::int32_t* out_chi) {
  const int halo = (k - 1) + 2 * (w - 1);
  const int stride = width - halo;
  const int wbytes = width / 4;
  for (long long j = j0; j < j1; ++j) {
    const std::int64_t id = ids[j];
    const std::int64_t n = lengths[id];
    if (n < k + w - 1) continue;
    const std::uint8_t* read = codes + starts[id];
    long long r = row_off[j];
    std::int64_t s = 0;
    for (int seg_idx = 0;; ++seg_idx, ++r) {
      const std::int64_t eff =
          (n - s) < (std::int64_t)width ? (n - s) : (std::int64_t)width;
      const bool last = s + width >= n;
      out_eff[r] = (std::int32_t)eff;
      out_rid[r] = (std::int32_t)id;
      out_base[r] = (std::int32_t)s;
      out_clo[r] = seg_idx == 0 ? 0 : (w - 1);
      out_chi[r] = last ? width : (w - 1) + stride;
      std::uint8_t* row = out_packed + (std::int64_t)r * wbytes;
      std::memset(row, 0, wbytes);
      const std::uint8_t* src = read + s;
      const std::int64_t full = eff / 4;
      for (std::int64_t b = 0; b < full; ++b) {
        const std::uint8_t* c = src + 4 * b;
        row[b] = (std::uint8_t)(c[0] | (c[1] << 2) | (c[2] << 4) |
                                (c[3] << 6));
      }
      for (std::int64_t i = 4 * full; i < eff; ++i)
        row[i >> 2] = (std::uint8_t)(row[i >> 2] | (src[i] << (2 * (i & 3))));
      if (last) break;
      s += stride;
    }
  }
}

}  // namespace

extern "C" {

// Fill `total_rows` segment rows (row_off[n_ids] == total_rows).  Returns 0.
int raven_segment_pack(const std::uint8_t* codes, const std::int64_t* starts,
                       const std::int64_t* lengths, const std::int64_t* ids,
                       long long n_ids, const std::int64_t* row_off, int k,
                       int w, int width, std::uint8_t* out_packed,
                       std::int32_t* out_eff, std::int32_t* out_rid,
                       std::int32_t* out_base, std::int32_t* out_clo,
                       std::int32_t* out_chi, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_ids < 64) {
    fill_range(codes, starts, lengths, ids, row_off, 0, n_ids, k, w, width,
               out_packed, out_eff, out_rid, out_base, out_clo, out_chi);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  // balance by rows, not reads (read lengths are highly skewed)
  const long long total_rows = row_off[n_ids];
  long long j = 0;
  for (int t = 0; t < n_threads && j < n_ids; ++t) {
    const long long target = (total_rows * (t + 1)) / n_threads;
    long long j_end = j;
    while (j_end < n_ids && row_off[j_end] < target) ++j_end;
    if (t == n_threads - 1) j_end = n_ids;
    threads.emplace_back(fill_range, codes, starts, lengths, ids, row_off, j,
                         j_end, k, w, width, out_packed, out_eff, out_rid,
                         out_base, out_clo, out_chi);
    j = j_end;
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
