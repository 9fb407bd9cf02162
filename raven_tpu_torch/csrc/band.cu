// Shift-banded window consensus: kernel K3, the slope-1 banded NW forward,
// and kernel K4, the reverse row walk that turns each alignment into
// per-row votes; and band_pack, which lays out the fragment rows they read
// (its note is above its kernel).
//
// Replace raven_tpu/ops/consensus_band.py::band_forward and the row scan of
// its mask_walk_votes (XLA scans on the TPU, not Pallas kernels) and compute
// what they compute, bit for bit.
//
// K3.  Fragment b is stored pre-shifted: fw_sh[b, c] = base | weight << 2 of
// fragment column c - r0 - BW/2 - 1, so at DP row r band lane u holds column
// j = r + u - BW/2 - r0 and reads its base at shifted column r + u: the band
// advances one column a row.  Row 0 holds j*GAP for 0 <= j <= qlen, else
// NEG.  Row r + 1 (r = 0 .. T-1, consensus code cw[b, r]):
//   diag = prev[u] + (base == cw ? 3 : -5), up = prev[u + 1] - 4 (NEG - 4
//   past the band's last lane), e = max, move diag when diag >= up;
//   column j == 0 restarts at e = 0 with move up, before the closure;
//   closed = cummax over u of (e + 4u), less 4u; move left, and the value
//   closed, only when closed > e;
//   lanes outside 0 <= j <= qlen hold NEG after the closure (their moves
//   stay as computed); the end score of the row is max(value, NEG) at the
//   lane of j == qlen when r < tlen and that lane is in the band, else NEG.
// Moves go out 2 bits a lane, 16 lanes a word: moves[r, b, u / 16].  Values
// stay within a few thousand of 0 or of NEG = -2^20, so int32 never wraps.
//
// K4.  The walk starts at row 0 when qlen * GAP >= the best end score, else
// one row below the first row holding it, at the lane of column qlen (no
// walk when that lane is outside the band).  Per row r = T .. 1: an
// insertion vote 1 | byte << 1 from the walker's lane p when its move is
// left and j >= 1; the walker slides to the highest lane q <= p whose move
// is not left and whose j >= 1 (none: no vote, and the walk ends); a vote
// 1 | col << 1 | w << 4 at q (diag: col = its base, up: col = 4), then the
// next lane is q (diag) or q + 1 (up), and the walk ends when that lane
// leaves the band or a diag reaches j == 1.  Row 0 gives one more
// insertion at the walker's lane when j >= 1.  votes[b, r - 1] and ins[b,
// r] hold row r's votes, ins[b, 0] row 0's; 0 where nothing was cast.
//
// What bounds them on an H100.  K3: integer instructions.  Each band cell
// needs at the fewest 10 (the score's compare and select, the diag add, the
// up add fused with the max, the which-won predicate, the closure as the
// recurrence max(e, left + GAP) in one add-max, the left predicate, the
// domain's compare and select, one pack of the move bits); 671 M cells a
// production launch ([4096, 640, 256]) against ~193 MB of traffic.  What
// held the first, simple version at 16% of that: a 5-step __shfl_up_sync
// scan for the left closure and three more shuffles a row, all on the
// row's critical path, for 8 cells a lane; an unaligned shared-memory byte
// read, the j == 0, domain and j == qlen tests and the move rewrite in every
// cell (~25 instructions a cell).  K4: its traffic (the end scores, the
// fragment rows, a move word a walked row, the vote rows) and the walk's
// serial length: a few dependent steps a row, 640 rows a fragment.  What
// held the first version at 2.4% of its bytes bound: each walked row's move
// word was a DRAM round trip (rows of a fragment lie B * 64 bytes apart, and
// K3 has just written 168 MB past the 50 MB L2) sent only after the
// previous row's shuffle, ballot and __clz chain; and the best-row pass read
// one end score a lane at a 4B-byte stride.
//
// Design (the engine's band of BW = 256):
//   * K3, the layout.  16 lanes of a warp take a fragment, so a warp runs
//     two; lane l holds band lanes 16l .. 16l + 15 of the previous row in
//     registers.  Against one fragment a warp at 8 cells a lane, this halves
//     the work a row that does not scale with the cells (the shuffles, the
//     closure's rounds, the edge lanes' branches, the stores); measured on
//     an H100 at [4096, 640, 256], it was the faster of the two.
//   * K3, the closure.  The cummax is the linear-gap recurrence D[u] =
//     max(e[u], D[u-1] + GAP), the form K2 uses: the same integers and ties
//     ("left when closed > e" is D[u] != e[u]).  Each lane runs it over its
//     strip from nothing, keeping only the last value (one VIADDMNMX a
//     cell); the carries between lanes are then resolved to their fixed
//     point: each round one __shfl_up_sync of the lanes' last values, last =
//     max(strip last, carry + 16 GAP), and __any_sync on whether a lane
//     changed; the strip then runs again from its carry (one more VIADDMNMX
//     a cell), which gives the values and the left moves.  Exact by
//     construction: the lanes form a chain, so a round in which nothing
//     changes is the fixed point.  Started from the strips alone, it needs a
//     round a lane wherever the band runs past column qlen + 1: the carry
//     into those lanes (near NEG, every move left) slides down 4 a column
//     across the rest of the band.  So lanes whose columns are all past qlen
//     + 1 start at a high guess, and keep it while their carry exceeds NEG +
//     3 + 4 BW (then every cell to the band's end is left whatever the
//     carry's exact value, and the values are masked to NEG); when no lane
//     of the row holds a column at or below qlen + 1, they start from their
//     strip.  Most rows then take one round.  No warp scan.  Lane
//     pipelining as in K2 does not carry over: in band coordinates up comes
//     from lane u + 1 of the previous row and left from lane u - 1 of this
//     one, so no skew of rows across lanes serves both.
//   * K3, the cells.  e and the diag-won predicate come from __vibmax_s32;
//     the score from the lane's 16 bases kept 2-bit packed in a register and
//     matched all at once by XOR against the replicated consensus code; the
//     band has slope 1, so the next row's bases are this lane's shifted by
//     one, the new one from the next lane by one shuffle.  The up and left
//     moves are gathered one bit a cell and spread to 2-bit fields once a
//     row.  The j == 0 reset, the domain mask (a bit mask of the strip's
//     cells in the fragment) and the end score (a tree of selects, not a
//     register index, which would go to local memory) touch one or two
//     lanes a row and run in branches only those lanes take.  Each lane
//     stores its 16 move fields as one word: a fragment's row, 64 bytes, in
//     one coalesced store.  Values stay int32: 16-bit pairs (K2's route)
//     would need the lanes outside the fragment, whose moves are outputs,
//     mapped into 16 bits with every comparison kept; left for a later
//     change.  What bounds K3 in this form (cuobjdump -sass, which
//     chip_smoke.py prints): most of its row loop's instructions are
//     compares, selects, logic and min/max, which the integer ALU pipe
//     takes one warp instruction every other cycle.
//   * K4.  8 lanes of a warp take a fragment, four a warp.  The move rows
//     are staged ahead of the walker: 32 rows of the fragment (2 KB) a
//     chunk, copied by cp.async into shared memory, double-buffered one
//     chunk ahead on a schedule the warp shares, only chunks that hold a
//     row at or below t0 - 1, and none once the walk ends.  The walk itself
//     is scalar, the same in each of the 8 lanes: the move word at the
//     walker from shared memory, and when that move is not left (most rows)
//     the walker's lane is the vote's; only a left move scans the row's
//     words below the walker for the slide target.  No shuffle or vote is
//     on the walk's chain, and neither are the fragment's bytes: a row keeps
//     the vote's lane and move, and the 8 lanes read the bytes and pack the
//     votes when they write them.  The rows go in blocks of 8, unrolled, so
//     the per-row work around the walk is a test of the start row and a
//     select into the lane that writes the row; the block boundaries carry
//     the chunk schedule and the writes.  The 8 lanes also copy the chunks.  The best row comes from the block's 16 fragments read
//     together: 64 contiguous bytes an end-score row.
//   * Other widths (raven_tpu takes any multiple of 16; these kernels up to
//     512).  BW = 256 has its own instantiation, as above.  Any other width
//     keeps 16 band lanes a lane: K3 gives a fragment a group of GP = 16
//     lanes up to BW = 256 and a whole warp (GP = 32) above, 32 / GP
//     fragments a warp, and the width is a run-time value.  The lanes of a
//     group past BW / 16 take part in the shuffles and votes but hold no
//     band lane: they read and store nothing, the last band lane takes NEG
//     from its right as at 256, and they never keep the closure's loop
//     going.  K4 is the same walk with the width's
//     BW / 16 words a move row; a row of 4 * (BW / 16) bytes is staged 16
//     bytes a copy when BW is a multiple of 64, else 4.  BW = 256 keeps its
//     own staging routine: the general one, even with the width fixed at
//     256, compiled to 54 more SASS instructions in the walk's loop and
//     cost 5-6% of K4's device time on an H100.
//   * Past those kernels' limits (BW above 512, or consensus rows too long
//     for a block's shared memory: K3 holds round16(T + BW + 1) + round16(T)
//     bytes for each of its 8 (GP 16) or 4 (GP 32) fragments, K4 2 * 32 *
//     BW / 4 + round16(T + BW + 1) for each of its 16 beside 512 bytes of
//     best-row tables, so T > 14,399 at BW = 256 for K3 and T > 10,143 at
//     256 or 5,791 at 512 for K4), two more routes that keep nothing of T or
//     of the band's width in shared memory.  The wrapper's launch_plan picks
//     the route and its fragments a block from the shape; the launcher takes
//     both.
//     K3 "wide" (band_forward_wide_kernel): one fragment a block, BW / 16
//     threads of 16 band lanes each (rounded up to whole warps, at most 1024:
//     BW up to 16,384), the cells as above.  The consensus code and each
//     thread's next base are read from device memory a row ahead (a warp's
//     threads read 16 bytes apart, the same line for 8 rows).  The up value
//     across a warp boundary goes through shared memory; the closure's carry
//     across the block is an exclusive prefix max of (strip last + 64 k) over
//     the strips k (the linear-gap recurrence across strips of 16 cells,
//     max_m last_m + 16 GAP (k - 1 - m), written as a max scan: the same
//     integers), a warp scan of shuffles and one pass over the warps' totals
//     in shared memory, two block barriers a row.  No fixed point and no
//     guess: a scan takes the same steps on every row.  Registers are the
//     other kernels' (16 band lanes a thread); the ptxas line that
//     chip_smoke.py prints shows no spill.
//     K4 "direct" (band_walk_direct_kernel): a warp a fragment, four a block,
//     the walk uniform over the warp and read straight from device memory:
//     the move word at the walker (one address, broadcast), and when the
//     move there is left, the row's words below it 32 at a time, one a lane,
//     the highest word holding a move that is not left found by a ballot.
//     The vote rows are zeroed by the warp first and lane 0 writes each vote
//     where it is cast.  Each walked row is a dependent load from L2 or
//     DRAM; staging only the words near the walker is later work.  It has
//     no width limit of its own (up to 2^27 lanes, K3's).
//     K3 "global" (band_forward_global_kernel), past BW 16,384: one fragment
//     a block of 512 threads, strip s of 16 band lanes taken by thread s %
//     512 in round s / 512 of each row, and the previous row in device
//     memory (a scratch of BW int32 a fragment), which each strip
//     overwrites with its new values once the round's barrier has passed
//     (a strip reads only its own lanes and the next strip's first, which
//     its own round or a later one writes after that barrier).  The
//     closure's carry is the wide route's scan over all strips of the row:
//     each round's block scan, maxed with the earlier rounds' totals.  The
//     bases come from device memory a byte a lane and row.  A simple route:
//     each cell's previous value is a load and its new one a store.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (see raven_tpu_torch/csrc/__init__.py); each launcher returns the CUDA
// error code and the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kMatch = 3;
constexpr int kMismatch = -5;
constexpr int kGap = -4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int C = 16;              // K3: band lanes a lane holds, one move word
constexpr int kMaxBW = 512;        // the widest band taken: 32 lanes of 16
// the closure's carry into lane 0: never wins, and never wraps when GAP is
// added a band's width of times
constexpr int kNone = -(1 << 30);
constexpr int kGuess = 0;          // the high guess (any value above high_of(BW))
constexpr int kChunk = 32;         // move rows a K4 stage holds
constexpr int kGroup = 8;          // K4: lanes of the warp a fragment takes
constexpr int kFragsPerWarp = 32 / kGroup;
constexpr int kWalkWarps = 4;      // K4: warps a block
constexpr int kWalkFrags = kWalkWarps * kFragsPerWarp;
constexpr int kWideMaxBW = 1024 * C;  // K3's wide route: a block's threads of 16 lanes
constexpr int kGlobalThreads = 512;   // K3's global route: threads a block
// the widest band of K3's global route and K4's direct one: the closure's
// scan adds 64 a strip to values above NEG and subtracts it from kNone
constexpr int kMaxBWAny = 1 << 27;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
constexpr int kFwdWarps = 4;       // K3: warps a block
// a lane whose columns are all past qlen + 1 holds values within 8 of NEG:
// a carry above this makes every cell left up to the band's end
__host__ __device__ constexpr int high_of(int bw) { return kNeg + 3 - kGap * bw; }

// shared memory a fragment uses: K3 its base codes [T + BW + 1] and the
// consensus codes [T]; K4 two move chunks and the fragment row
__host__ __device__ constexpr int forward_bytes(int T, int bw) {
  return round16(T + bw + 1) + round16(T);
}
__host__ __device__ constexpr int walk_bytes(int T, int bw) {
  return 2 * kChunk * (bw / 4) + round16(T + bw + 1);
}

// bit i of a 16-bit x to bit 2i
__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// v[k] for a k known only at run time, as a tree of selects on k's bits
// (indexing the registers would send the array to local memory)
template <int W>
__device__ __forceinline__ int pick_level(int (&t)[C], int k) {
  const bool upper = (k & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = upper ? t[i + W] : t[i];
  if constexpr (W > 1) {
    return pick_level<W / 2>(t, k);
  } else {
    return t[0];
  }
}
__device__ __forceinline__ int pick(const int (&v)[C], int k) {
  int t[C];
#pragma unroll
  for (int i = 0; i < C; ++i) t[i] = v[i];
  return pick_level<C / 2>(t, k);
}

// GP lanes of a warp take a fragment (16 or 32), 32 / GP fragments a
// warp; BWT is the band's width when it is fixed at compile time (BW = 256,
// GP = 16), else 0 and the width is bw_arg, BW / 16 <= GP lanes active.
template <int GP, int BWT>
__global__ void __launch_bounds__(32 * kFwdWarps)
band_forward_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                    const uint8_t* __restrict__ fw_sh, const int32_t* __restrict__ q_lens,
                    const int32_t* __restrict__ r0s, uint32_t* __restrict__ moves,
                    int32_t* __restrict__ ends, int32_t* __restrict__ row0, long long B,
                    int T, int bw_arg) {
  static_assert(BWT == 0 || BWT == GP * C, "a fixed width fills its lanes");
  constexpr int kFwdFrags = 32 / GP;
  const int BW = BWT != 0 ? BWT : bw_arg;
  const int G = BW / C;         // the lanes of a fragment that hold band lanes
  const int kHalf = BW / 2;
  const int kWords = BW / 16;   // move words a row
  const int kHigh = high_of(BW);
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / GP, sub = lane % GP;
  // the lanes past G take part in the warp's shuffles and votes, read and
  // store nothing, and never hold the closure's loop
  const bool live = BWT != 0 || sub < G;
  const long long bw0 = (static_cast<long long>(blockIdx.x) * kFwdWarps + warp) * kFwdFrags;
  if (bw0 >= B) return;  // the whole warp
  const long long b = bw0 + g;
  const bool valid = b < B;
  const int SW = T + BW + 1;
  uint8_t* s_fc = smem + static_cast<size_t>(warp * kFwdFrags + g) * forward_bytes(T, BW);
  uint8_t* s_tc = s_fc + round16(SW);
  if (valid) {
    const uint8_t* f_row = fw_sh + b * SW;
    for (int i = sub; i < SW; i += GP) s_fc[i] = f_row[i] & 3;
    const int32_t* c_row = cw + b * T;
    for (int t = sub; t < T; t += GP) {
      const int c = c_row[t];
      // a code outside 0-3 never equals a fragment base
      s_tc[t] = (c >= 0 && c <= 3) ? static_cast<uint8_t>(c) : 0xFF;
    }
  } else {
    for (int i = sub; i < SW; i += GP) s_fc[i] = 0;
    for (int t = sub; t < T; t += GP) s_tc[t] = 0xFF;
  }
  __syncwarp();

  const int ql = valid ? q_lens[b] : 0;
  const int tl = valid ? t_lens[b] : 0;
  const int r0 = valid ? r0s[b] : 0;
  const int u0 = sub * C;
  const bool last_sub = sub == G - 1;
  int prev[C];
  uint32_t fb = 0;  // the bases of my band lanes on the next DP row, 2 bits each
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = u0 + i - kHalf - r0;
    prev[i] = (j >= 0 && j <= ql) ? j * kGap : kNeg;
    if (live) fb |= static_cast<uint32_t>(s_fc[1 + u0 + i]) << (2 * i);
  }
  if (valid && sub == 0) row0[b] = ql * kGap;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_out = moves + b * kWords + sub;
  int32_t* end_out = ends + b;
  for (int r = 0; r < T; ++r) {
    const int jb = r + 1 + u0 - kHalf - r0;  // j of my first lane on DP row r + 1
    const uint32_t tch = s_tc[r];
    // the next lane's first value, and its first base (my last on the next row)
    const int up_next = __shfl_down_sync(kFull, prev[0], 1, GP);
    const uint32_t nb_in = __shfl_down_sync(kFull, fb & 3u, 1, GP);
    const int up_in = last_sub ? kNeg : up_next;
    const uint32_t nb = last_sub ? s_fc[r + 1 + BW] : nb_in;
    const uint32_t x = fb ^ (tch * 0x55555555u);
    const uint32_t mb = tch <= 3 ? ~(x | (x >> 1)) & 0x55555555u : 0u;  // 1: a match
    int e[C];
    uint32_t up_bits = 0;  // bit i: cell i's move is up (or it is column 0)
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int dg = prev[i] + (((mb >> (2 * i)) & 1u) ? kMatch : kMismatch);
      const int up = (i + 1 < C ? prev[i + 1] : up_in) + kGap;
      bool diag_won;
      e[i] = __vibmax_s32(dg, up, &diag_won);
      up_bits |= static_cast<uint32_t>(!diag_won) << i;
    }
    // the free consensus prefix: column j == 0 restarts at 0 with move up,
    // before the closure
    const int uz = kHalf + r0 - (r + 1);
    if (uz >= 0 && uz < BW && sub == uz / C) {
      const uint32_t at = 1u << (uz % C);
#pragma unroll
      for (int i = 0; i < C; ++i) e[i] = (at >> i) & 1u ? 0 : e[i];
      up_bits |= at;
    }
    // the left closure over my strip from no carry: its last value
    int run = kNone;
#pragma unroll
    for (int i = 0; i < C; ++i) run = __viaddmax_s32(run, kGap, e[i]);
    // the carries between lanes, to their fixed point
    const bool past = jb >= ql + 2;                      // all my columns past qlen + 1
    const bool all_past = r + 1 - kHalf - r0 >= ql + 2;  // the first lane's, so the row's
    int last = past && !all_past ? kGuess : run;
    int carry;
    while (true) {
      int c = __shfl_up_sync(kFull, last, 1, GP);
      if (sub == 0) c = kNone;
      int nl = __viaddmax_s32(c, C * kGap, run);
      if (past && c > kHigh) nl = kGuess;
      const bool changed = live && nl != last;
      carry = c;
      last = nl;
      if (!__any_sync(kFull, changed)) break;
    }
    // the closure again from the carry; bit i: cell i's move is left
    int d[C];
    uint32_t left_bits = 0;
    run = carry;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      run = __viaddmax_s32(run, kGap, e[i]);
      d[i] = run;
      left_bits |= static_cast<uint32_t>(run != e[i]) << i;
    }
    if (valid && live) {
      mv_out[static_cast<size_t>(r) * row_words] =
          spread2(up_bits & ~left_bits) | (spread2(left_bits) << 1);
    }
    // lanes outside 0 <= j <= qlen hold NEG: a mask of my cells in the
    // fragment, from the range's two ends
    if (jb >= 0 && jb + C - 1 <= ql) {
#pragma unroll
      for (int i = 0; i < C; ++i) prev[i] = d[i];
    } else {
      const int lo = max(-jb, 0), hi = min(ql - jb, C - 1);
      const uint32_t in = lo <= hi ? ((2u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
#pragma unroll
      for (int i = 0; i < C; ++i) prev[i] = (in >> i) & 1u ? d[i] : kNeg;
    }
    // the row's end score: from the lane of column qlen, or NEG from the
    // first lane when that column is outside the band
    const int uq = ql + kHalf + r0 - (r + 1);
    if (uq >= 0 && uq < BW) {
      if (valid && sub == uq / C) {
        const int v = pick(prev, uq % C);
        end_out[static_cast<size_t>(r) * B] = r < tl ? max(v, kNeg) : kNeg;
      }
    } else if (valid && sub == 0) {
      end_out[static_cast<size_t>(r) * B] = kNeg;
    }
    fb = (fb >> 2) | (nb << (2 * (C - 1)));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
// x, held in a register from here on: the compiler may not recompute it
__device__ __forceinline__ unsigned in_register(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ uint32_t lds_u32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ int lds_u8(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return static_cast<int>(v);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage chunk c of a fragment's moves, rows 32c .. 32c + 31 (those < T),
// into buffer c & 1 (slot m & 31 holds row m); the group's 8 lanes copy
// 16 bytes at a time.  Every lane commits, so the warp's groups stay counted
// alike.  This is the BW = 256 form (16 move words, 64 bytes a row), kept
// as it was written for that width: stage_chunk_any below takes any width.
__device__ __forceinline__ void stage_chunk(uint8_t* s_mv, const uint32_t* mv_frag,
                                            size_t row_words, int c, int T, bool need,
                                            int sub) {
  if (need && c >= 0) {
    uint8_t* dst = s_mv + (c & 1) * (kChunk * 64);
#pragma unroll 4
    for (int k = sub; k < kChunk * 4; k += kGroup) {
      const int slot = k >> 2, part = k & 3;
      const int m = kChunk * c + slot;
      if (m < T) cp_async16(dst + slot * 64 + part * 16, mv_frag + m * row_words + part * 4);
    }
  }
  cp_async_commit();
}

// stage_chunk at a row of kWords move words, kCopy bytes a copy (16 when a
// row is a multiple of 16 bytes, BW a multiple of 64; else 4).
template <int kCopy>
__device__ __forceinline__ void stage_chunk_any(uint8_t* s_mv, const uint32_t* mv_frag,
                                                size_t row_words, int c, int T, bool need,
                                                int sub, int kWords) {
  if (need && c >= 0) {
    const int parts = kWords * 4 / kCopy;  // copies a row
    uint8_t* dst = s_mv + (c & 1) * (kChunk * kWords * 4);
    for (int k = sub; k < kChunk * parts; k += kGroup) {
      const int slot = k / parts, part = k % parts;
      const int m = kChunk * c + slot;
      if (m < T) {
        uint8_t* to = dst + slot * (kWords * 4) + part * kCopy;
        const uint32_t* from = mv_frag + m * row_words + part * (kCopy / 4);
        if constexpr (kCopy == 16) {
          cp_async16(to, from);
        } else {
          cp_async4(to, from);
        }
      }
    }
  }
  cp_async_commit();
}

// The walk's staging at its width: BW = 256's own form, or any width's.
template <int BWT, int kCopy>
__device__ __forceinline__ void stage(uint8_t* s_mv, const uint32_t* mv_frag, size_t row_words,
                                      int c, int T, bool need, int sub, int kWords) {
  if constexpr (BWT == 256) {
    stage_chunk(s_mv, mv_frag, row_words, c, T, need, sub);
  } else {
    stage_chunk_any<kCopy>(s_mv, mv_frag, row_words, c, T, need, sub, kWords);
  }
}

// BWT is the band's width when it is fixed at compile time (256), else 0
// and the width is bw_arg; kCopy as for stage_chunk_any.
template <int BWT, int kCopy>
__global__ void __launch_bounds__(32 * kWalkWarps)
band_walk_kernel(const uint32_t* __restrict__ moves, const int32_t* __restrict__ ends,
                 const int32_t* __restrict__ row0, const uint8_t* __restrict__ fw_sh,
                 const int32_t* __restrict__ q_lens, const int32_t* __restrict__ r0s,
                 int32_t* __restrict__ votes, int32_t* __restrict__ ins, long long B, int T,
                 int bw_arg) {
  const int BW = BWT != 0 ? BWT : bw_arg;
  const int kHalf = BW / 2;
  const int kWords = BW / 16;              // move words a row
  const int kChunkBytes = kChunk * kWords * 4;
  extern __shared__ __align__(16) uint8_t smem[];
  // [warp][fragment of the block]
  __shared__ int s_best[kWalkWarps][kWalkFrags], s_best_r[kWalkWarps][kWalkFrags];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup, sub = lane % kGroup;
  const long long b0 = static_cast<long long>(blockIdx.x) * kWalkFrags;
  const int fl = warp * kFragsPerWarp + g;  // my fragment in the block
  const long long b = b0 + fl;
  const bool valid = b < B;

  // the best end score and the first row holding it, for the block's 16
  // fragments at once: thread t reads fragment t % 16 of rows t / 16, +8, ..
  {
    const int f = threadIdx.x % kWalkFrags;
    int best = INT_MIN, best_r = 0;
    if (b0 + f < B) {
      for (int t = threadIdx.x / kWalkFrags; t < T; t += 32 * kWalkWarps / kWalkFrags) {
        const int x = ends[static_cast<size_t>(t) * B + b0 + f];
        if (x > best) {
          best = x;
          best_r = t;
        }
      }
    }
#pragma unroll
    for (int o = kWalkFrags; o < 32; o <<= 1) {
      const int ov = __shfl_xor_sync(kFull, best, o);
      const int orr = __shfl_xor_sync(kFull, best_r, o);
      if (ov > best || (ov == best && orr < best_r)) {
        best = ov;
        best_r = orr;
      }
    }
    if (lane < kWalkFrags) {
      s_best[warp][lane] = best;
      s_best_r[warp][lane] = best_r;
    }
  }
  __syncthreads();
  if (b0 + warp * kFragsPerWarp >= B) return;  // the whole warp
  int best = s_best[0][fl], best_r = s_best_r[0][fl];
#pragma unroll
  for (int w = 1; w < kWalkWarps; ++w) {
    const int ov = s_best[w][fl], orr = s_best_r[w][fl];
    if (ov > best || (ov == best && orr < best_r)) {
      best = ov;
      best_r = orr;
    }
  }
  const int t0 = valid ? (row0[b] >= best ? 0 : best_r + 1) : 0;
  const int ql = valid ? q_lens[b] : 0;
  const int r0 = valid ? r0s[b] : 0;

  const int SW = T + BW + 1;
  const int WB = walk_bytes(T, BW);
  uint8_t* s_warp = smem + static_cast<size_t>(warp) * kFragsPerWarp * WB;
  uint8_t* s_mv = s_warp + g * WB;
  uint8_t* s_fw = s_mv + 2 * kChunkBytes;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  const uint32_t* mv_frag = moves + (valid ? b : 0) * kWords;
  // the top two chunks that hold a row the walk can reach (< t0), under the
  // fragment rows' copy
  const int ctop = (T - 1) / kChunk;
  stage<BWT, kCopy>(s_mv, mv_frag, row_words, ctop, T, valid && kChunk * ctop <= t0 - 1, sub,
                    kWords);
  stage<BWT, kCopy>(s_mv, mv_frag, row_words, ctop - 1, T,
                    valid && kChunk * (ctop - 1) <= t0 - 1, sub, kWords);
  // the warp's fragment rows, one after another: [4, SW] bytes from row b
  for (int gg = 0; gg < kFragsPerWarp; ++gg) {
    const long long bg = b0 + warp * kFragsPerWarp + gg;
    if (bg >= B) break;
    const uint8_t* f_row = fw_sh + bg * SW;
    uint8_t* dst = s_warp + gg * WB + 2 * kChunkBytes;
    for (int i = lane; i < SW; i += 32) dst[i] = f_row[i];
  }
  __syncwarp();

  // shared-space addresses, so the walk's loads need no generic conversion
  const unsigned mv_sh = in_register(static_cast<unsigned>(__cvta_generic_to_shared(s_mv)));
  const unsigned fw_sh_base = in_register(static_cast<unsigned>(__cvta_generic_to_shared(s_fw)));
  int p = -1;           // the walker's lane (uniform over the group), -1: none
  bool walked = false;  // the walk has started and ended
  // blocks of 8 rows, m = 8k + 7 down to 8k (DP rows m + 1), 4 blocks a chunk
  constexpr int kBlocks = kChunk / kGroup;
  const int ktop = (T - 1) / kGroup;
  // lane sub writes votes[b, 8k + sub] and ins[b, 8k + sub + 1]
  int32_t* v_at = votes + b * T + kGroup * ktop + sub;
  int32_t* i_at = ins + b * (T + 1) + kGroup * ktop + sub + 1;
  for (int k = ktop; k >= 0; --k, v_at -= kGroup, i_at -= kGroup) {
    const int c = k / kBlocks;
    if (k == ktop || k % kBlocks == kBlocks - 1) {  // entering chunk c (the warp together)
      if (k != ktop) {
        __syncwarp();  // every lane is done with the buffer chunk c - 1 takes
        stage<BWT, kCopy>(s_mv, mv_frag, row_words, c - 1, T,
                          valid && !walked && kChunk * (c - 1) <= t0 - 1, sub, kWords);
      }
      cp_async_wait_one();  // chunk c has landed (c - 1 may be in flight)
      __syncwarp();
    }
    int vreg = 0, ireg = 0;  // lane sub: row 8k + sub's vote and insertion, packed
    // the block's first move row in shared memory, and row 8k's lowest lane
    // with j >= 1 (row 8k + i's is i lower)
    const unsigned blk = in_register(mv_sh + (c & 1) * kChunkBytes +
                                     (k % kBlocks) * (kGroup * kWords * 4));
    const int ulo0 = kHalf + r0 - kGroup * k;
#pragma unroll
    for (int i = kGroup - 1; i >= 0; --i) {
      const int m = kGroup * k + i, r = m + 1;
      if (m >= T) continue;  // the top block only
      if (r == t0) {
        const int ui = ql + kHalf + r0 - r;
        if (ui >= 0 && ui < BW) p = ui;
      }
      if (p < 0) continue;
      const unsigned row = blk + i * (kWords * 4);
      const int ulo = ulo0 - i;  // the lowest lane with j >= 1
      const uint32_t wp = lds_u32(row + 4 * (p >> 4));
      int mvq = static_cast<int>((wp >> (2 * (p & 15))) & 3u);
      int q = p;
      if (mvq == 2 || p < ulo) {
        // an insertion at the walker (its byte read at the flush)
        if (mvq == 2 && p >= ulo && sub == i) ireg = 1 | (p << 1);
        // slide: the highest lane in [ulo, p] whose move is not left (the
        // low bit of its 2-bit field), a move word at a time
        q = -1;
        const int first = max(ulo, 0);
        for (int w = p >> 4; w >= first >> 4; --w) {
          const uint32_t word = w == p >> 4 ? wp : lds_u32(row + 4 * w);
          const int hi = w == p >> 4 ? p & 15 : 15;
          const int lo = max(first - 16 * w, 0);
          if (lo > hi) break;
          const uint32_t top = hi == 15 ? ~0u : (1u << (2 * hi + 2)) - 1u;
          const uint32_t cand = ~((word >> 1) & ~word) & top & ~((1u << (2 * lo)) - 1u) &
                                0x55555555u;
          if (cand != 0) {
            const int bit = (31 - __clz(cand)) >> 1;
            q = 16 * w + bit;
            mvq = static_cast<int>((word >> (2 * bit)) & 3u);
            break;
          }
        }
      }
      if (q < 0) {
        p = -1;
      } else {
        if (sub == i) vreg = 1 | (mvq << 1) | (q << 3);  // its byte read at the flush
        const int nxt = q + (mvq != 0);  // diag: the same lane, up: the next
        p = nxt < BW && nxt > ulo ? nxt : -1;  // j of nxt on row r - 1 above 1
      }
      walked = p < 0;
    }
    // the block's votes: the fragment's bytes read and the rows written by
    // the 8 lanes side by side, off the walk's chain
    const int m = kGroup * k + sub;
    if (valid && m < T) {
      int v = 0;
      if (vreg != 0) {
        const int fq = lds_u8(fw_sh_base + m + 1 + (vreg >> 3));
        v = 1 | ((((vreg >> 1) & 3) == 0 ? (fq & 3) : 4) << 1) | ((fq >> 2) << 4);
      }
      *v_at = v;
      *i_at = ireg != 0 ? 1 | (lds_u8(fw_sh_base + m + 1 + (ireg >> 1)) << 1) : 0;
    }
  }
  cp_async_wait_all();  // chunks staged for a walk that ended early
  if (t0 == 0) {
    const int ui = ql + kHalf + r0;
    if (ui >= 0 && ui < BW) p = ui;
  }
  if (valid && sub == 0) {
    ins[b * (T + 1)] = p >= 0 && p - kHalf - r0 >= 1 ? 1 | (lds_u8(fw_sh_base + p) << 1) : 0;
  }
}

// K3's wide route: fragment blockIdx.x, thread k holding band lanes 16 k ..
// 16 k + 15 (threads past BW / 16 take part in the barriers and shuffles,
// read and store nothing)
__global__ void __launch_bounds__(1024)
band_forward_wide_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                         const uint8_t* __restrict__ fw_sh, const int32_t* __restrict__ q_lens,
                         const int32_t* __restrict__ r0s, uint32_t* __restrict__ moves,
                         int32_t* __restrict__ ends, int32_t* __restrict__ row0, long long B,
                         int T, int BW) {
  __shared__ int s_first[32];  // each warp's first previous-row value
  __shared__ int s_tot[32];    // each warp's inclusive scan total
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const int warp = k >> 5, lane = k & 31;
  const int n_warps = blockDim.x >> 5;
  const int G = BW / C;
  const bool live = k < G;
  const int kHalf = BW / 2;
  const int kWords = BW / 16;
  const int SW = T + BW + 1;
  const uint8_t* f_row = fw_sh + b * SW;
  const int32_t* c_row = cw + b * T;
  const int ql = q_lens[b], tl = t_lens[b], r0 = r0s[b];
  const int u0 = k * C;
  int prev[C];
  uint32_t fb = 0;  // the bases of my band lanes on the next DP row, 2 bits each
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = u0 + i - kHalf - r0;
    prev[i] = (j >= 0 && j <= ql) ? j * kGap : kNeg;
    if (live) fb |= static_cast<uint32_t>(f_row[1 + u0 + i] & 3) << (2 * i);
  }
  if (k == 0) row0[b] = ql * kGap;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_out = moves + b * kWords + k;
  int32_t* end_out = ends + b;
  // a row ahead: the consensus code, and the base at column r + 1 + u0 + 16
  // that enters my last band lane on the row after
  int tc_next = c_row[0];
  uint32_t nb_next = live ? f_row[1 + u0 + C] & 3u : 0u;
  for (int r = 0; r < T; ++r) {
    const int jb = r + 1 + u0 - kHalf - r0;  // j of my first lane on DP row r + 1
    const int tc = tc_next;
    const uint32_t nb = nb_next;
    if (r + 1 < T) {
      tc_next = c_row[r + 1];
      if (live) nb_next = f_row[r + 2 + u0 + C] & 3u;
    }
    // a code outside 0-3 never equals a fragment base
    const uint32_t tch = (tc >= 0 && tc <= 3) ? static_cast<uint32_t>(tc) : 0xFFu;
    // the next strip's first value of the previous row: a shuffle within
    // the warp, shared memory across warps; NEG past the band's last lane
    if (lane == 0) s_first[warp] = prev[0];
    __syncthreads();
    int up_in = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) up_in = warp + 1 < n_warps ? s_first[warp + 1] : kNeg;
    if (k == G - 1) up_in = kNeg;
    const uint32_t x = fb ^ (tch * 0x55555555u);
    const uint32_t mb = tch <= 3 ? ~(x | (x >> 1)) & 0x55555555u : 0u;  // 1: a match
    int e[C];
    uint32_t up_bits = 0;  // bit i: cell i's move is up (or it is column 0)
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int dg = prev[i] + (((mb >> (2 * i)) & 1u) ? kMatch : kMismatch);
      const int up = (i + 1 < C ? prev[i + 1] : up_in) + kGap;
      bool diag_won;
      e[i] = __vibmax_s32(dg, up, &diag_won);
      up_bits |= static_cast<uint32_t>(!diag_won) << i;
    }
    // the free consensus prefix: column j == 0 restarts at 0 with move up,
    // before the closure
    const int uz = kHalf + r0 - (r + 1);
    if (uz >= 0 && uz < BW && k == uz / C) {
      const uint32_t at = 1u << (uz % C);
#pragma unroll
      for (int i = 0; i < C; ++i) e[i] = (at >> i) & 1u ? 0 : e[i];
      up_bits |= at;
    }
    // the left closure over my strip from no carry: its last value
    int run = kNone;
#pragma unroll
    for (int i = 0; i < C; ++i) run = __viaddmax_s32(run, kGap, e[i]);
    // my carry, max over the strips m < k of run_m + 16 GAP (k - 1 - m):
    // an exclusive prefix max of run_m - 16 GAP m, less 16 GAP (k - 1)
    int inc = live ? run - C * kGap * k : kNone;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc = max(inc, y);
    }
    if (lane == 31) s_tot[warp] = inc;
    __syncthreads();
    int exc = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) exc = kNone;
    for (int w = 0; w < warp; ++w) exc = max(exc, s_tot[w]);
    const int carry = k == 0 ? kNone : exc + C * kGap * (k - 1);
    // the closure again from the carry; bit i: cell i's move is left
    int d[C];
    uint32_t left_bits = 0;
    run = carry;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      run = __viaddmax_s32(run, kGap, e[i]);
      d[i] = run;
      left_bits |= static_cast<uint32_t>(run != e[i]) << i;
    }
    if (live) {
      mv_out[static_cast<size_t>(r) * row_words] =
          spread2(up_bits & ~left_bits) | (spread2(left_bits) << 1);
    }
    // lanes outside 0 <= j <= qlen hold NEG
    if (jb >= 0 && jb + C - 1 <= ql) {
#pragma unroll
      for (int i = 0; i < C; ++i) prev[i] = d[i];
    } else {
      const int lo = max(-jb, 0), hi = min(ql - jb, C - 1);
      const uint32_t in = lo <= hi ? ((2u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
#pragma unroll
      for (int i = 0; i < C; ++i) prev[i] = (in >> i) & 1u ? d[i] : kNeg;
    }
    // the row's end score: from the lane of column qlen, or NEG from the
    // first thread when that column is outside the band
    const int uq = ql + kHalf + r0 - (r + 1);
    if (uq >= 0 && uq < BW) {
      if (k == uq / C) {
        const int v = pick(prev, uq % C);
        end_out[static_cast<size_t>(r) * B] = r < tl ? max(v, kNeg) : kNeg;
      }
    } else if (k == 0) {
      end_out[static_cast<size_t>(r) * B] = kNeg;
    }
    fb = (fb >> 2) | (nb << (2 * (C - 1)));
  }
}

// K3's global route: fragment blockIdx.x, kGlobalThreads threads; strip s
// of 16 band lanes is thread s % kGlobalThreads's in round s /
// kGlobalThreads of every row, and the previous row lies in device memory
// (prev_all[b, BW]), overwritten strip by strip as the row goes
__global__ void __launch_bounds__(kGlobalThreads)
band_forward_global_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                           const uint8_t* __restrict__ fw_sh, const int32_t* __restrict__ q_lens,
                           const int32_t* __restrict__ r0s, uint32_t* __restrict__ moves,
                           int32_t* __restrict__ ends, int32_t* __restrict__ row0,
                           int32_t* __restrict__ prev_all, long long B, int T, int BW) {
  __shared__ int s_tot[kGlobalThreads / 32];  // each warp's inclusive scan total
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const int warp = k >> 5, lane = k & 31;
  const int G = BW / C;
  const int rounds = (G + kGlobalThreads - 1) / kGlobalThreads;
  const int kHalf = BW / 2;
  const int kWords = BW / 16;
  const uint8_t* f_row = fw_sh + b * (T + BW + 1);
  const int32_t* c_row = cw + b * T;
  int32_t* pv = prev_all + b * BW;
  const int ql = q_lens[b], tl = t_lens[b], r0 = r0s[b];
  for (int u = k; u < BW; u += kGlobalThreads) {
    const int j = u - kHalf - r0;
    pv[u] = (j >= 0 && j <= ql) ? j * kGap : kNeg;
  }
  if (k == 0) row0[b] = ql * kGap;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_frag = moves + b * kWords;
  int32_t* end_out = ends + b;
  __syncthreads();
  for (int r = 0; r < T; ++r) {
    const int tc = c_row[r];
    // a code outside 0-3 never equals a fragment base
    const uint32_t tch = (tc >= 0 && tc <= 3) ? static_cast<uint32_t>(tc) : 0xFFu;
    const int uz = kHalf + r0 - (r + 1);      // the lane of column 0
    const int uq = ql + kHalf + r0 - (r + 1);  // the lane of column qlen
    int before = kNone;  // the scan's maximum over the earlier rounds' strips
    for (int m = 0; m < rounds; ++m) {
      const int sp = m * kGlobalThreads + k;  // my strip this round
      const bool live = sp < G;
      const int u0 = sp * C;
      int prev[C];
      int up_in = kNeg;
      uint32_t fb = 0;  // my band lanes' bases on this row, 2 bits each
#pragma unroll
      for (int i = 0; i < C; ++i) {
        prev[i] = live ? pv[u0 + i] : kNeg;
        if (live) fb |= static_cast<uint32_t>(f_row[r + 1 + u0 + i] & 3) << (2 * i);
      }
      if (live && sp + 1 < G) up_in = pv[u0 + C];
      const uint32_t x = fb ^ (tch * 0x55555555u);
      const uint32_t mb = tch <= 3 ? ~(x | (x >> 1)) & 0x55555555u : 0u;  // 1: a match
      int e[C];
      uint32_t up_bits = 0;  // bit i: cell i's move is up (or it is column 0)
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int dg = prev[i] + (((mb >> (2 * i)) & 1u) ? kMatch : kMismatch);
        const int up = (i + 1 < C ? prev[i + 1] : up_in) + kGap;
        bool diag_won;
        e[i] = __vibmax_s32(dg, up, &diag_won);
        up_bits |= static_cast<uint32_t>(!diag_won) << i;
      }
      // the free consensus prefix, before the closure
      if (uz >= 0 && uz < BW && sp == uz / C) {
        const uint32_t at = 1u << (uz % C);
#pragma unroll
        for (int i = 0; i < C; ++i) e[i] = (at >> i) & 1u ? 0 : e[i];
        up_bits |= at;
      }
      int run = kNone;
#pragma unroll
      for (int i = 0; i < C; ++i) run = __viaddmax_s32(run, kGap, e[i]);
      // the carry into my strip: an exclusive prefix max over every strip
      // before it of run_m - 16 GAP m, less 16 GAP (sp - 1), as the wide
      // route's, the earlier rounds' strips included
      int inc = live ? run - C * kGap * sp : kNone;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc = max(inc, y);
      }
      if (lane == 31) s_tot[warp] = inc;
      __syncthreads();  // every read of this round's previous row is done
      int exc = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) exc = kNone;
      int total = kNone;
      for (int w = 0; w < kGlobalThreads / 32; ++w) {
        if (w < warp) exc = max(exc, s_tot[w]);
        total = max(total, s_tot[w]);
      }
      exc = max(exc, before);
      before = max(before, total);
      const int carry = sp == 0 ? kNone : exc + C * kGap * (sp - 1);
      int d[C];
      uint32_t left_bits = 0;
      run = carry;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        run = __viaddmax_s32(run, kGap, e[i]);
        d[i] = run;
        left_bits |= static_cast<uint32_t>(run != e[i]) << i;
      }
      if (live) {
        mv_frag[static_cast<size_t>(r) * row_words + sp] =
            spread2(up_bits & ~left_bits) | (spread2(left_bits) << 1);
        // lanes outside 0 <= j <= qlen hold NEG
        const int jb = r + 1 + u0 - kHalf - r0;
        const int lo = max(-jb, 0), hi = min(ql - jb, C - 1);
        const uint32_t in = lo <= hi ? ((2u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          d[i] = (in >> i) & 1u ? d[i] : kNeg;
          pv[u0 + i] = d[i];
        }
      }
      // the row's end score: from the strip of column qlen, or NEG from
      // strip 0 when that column is outside the band
      if (uq >= 0 && uq < BW) {
        if (sp == uq / C) {
          const int v = pick(d, uq % C);
          end_out[static_cast<size_t>(r) * B] = r < tl ? max(v, kNeg) : kNeg;
        }
      } else if (sp == 0) {
        end_out[static_cast<size_t>(r) * B] = kNeg;
      }
      __syncthreads();  // s_tot is free, and this round's row is written
    }
  }
}

// K4's direct route: fragment 4 blockIdx.x + warp, the walk the same in
// every lane of the warp
__global__ void __launch_bounds__(32 * kWalkWarps)
band_walk_direct_kernel(const uint32_t* __restrict__ moves, const int32_t* __restrict__ ends,
                        const int32_t* __restrict__ row0, const uint8_t* __restrict__ fw_sh,
                        const int32_t* __restrict__ q_lens, const int32_t* __restrict__ r0s,
                        int32_t* __restrict__ votes, int32_t* __restrict__ ins, long long B,
                        int T, int BW) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWalkWarps + warp;
  if (b >= B) return;  // the whole warp
  const int kHalf = BW / 2;
  const int kWords = BW / 16;
  // the best end score and the first row holding it
  int best = INT_MIN, best_r = 0;
  for (int t = lane; t < T; t += 32) {
    const int x = ends[static_cast<size_t>(t) * B + b];
    if (x > best) {
      best = x;
      best_r = t;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, o);
    const int orr = __shfl_xor_sync(kFull, best_r, o);
    if (ov > best || (ov == best && orr < best_r)) {
      best = ov;
      best_r = orr;
    }
  }
  const int t0 = row0[b] >= best ? 0 : best_r + 1;
  const int ql = q_lens[b], r0 = r0s[b];
  int32_t* v_row = votes + b * T;
  int32_t* i_row = ins + b * (T + 1);
  for (int t = lane; t < T; t += 32) v_row[t] = 0;
  for (int t = lane; t <= T; t += 32) i_row[t] = 0;
  __syncwarp();  // lane 0's votes land on the zeros
  const uint8_t* f_row = fw_sh + b * (T + BW + 1);
  const uint32_t* mv_frag = moves + b * kWords;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  int p = -1;  // the walker's lane, -1: none
  if (t0 >= 1) {
    const int ui = ql + kHalf + r0 - t0;
    if (ui >= 0 && ui < BW) p = ui;
  }
  for (int r = t0; r >= 1 && p >= 0; --r) {
    const uint32_t* row = mv_frag + static_cast<size_t>(r - 1) * row_words;
    const int ulo = 1 + kHalf + r0 - r;  // the lowest lane with j >= 1
    const uint32_t wp = row[p >> 4];
    int mvq = static_cast<int>((wp >> (2 * (p & 15))) & 3u);
    int q = p;
    if (mvq == 2 || p < ulo) {
      if (mvq == 2 && p >= ulo && lane == 0) i_row[r] = 1 | (f_row[r + p] << 1);
      // slide: the highest lane in [ulo, p] whose move is not left, the
      // words from p's down, one a lane, 32 at a time
      q = -1;
      const int first = max(ulo, 0);
      for (int w0 = p >> 4; w0 >= first >> 4 && q < 0; w0 -= 32) {
        const int w = w0 - lane;
        uint32_t word = 0, cand = 0;
        if (w >= first >> 4) {
          word = w == p >> 4 ? wp : row[w];
          const int hi = w == p >> 4 ? p & 15 : 15;
          const int lo = max(first - 16 * w, 0);
          if (lo <= hi) {
            const uint32_t top = hi == 15 ? ~0u : (1u << (2 * hi + 2)) - 1u;
            cand = ~((word >> 1) & ~word) & top & ~((1u << (2 * lo)) - 1u) & 0x55555555u;
          }
        }
        const unsigned found = __ballot_sync(kFull, cand != 0);
        if (found != 0) {  // the lowest such lane holds the highest word
          const int src = __ffs(found) - 1;
          const uint32_t c = __shfl_sync(kFull, cand, src);
          const uint32_t wd = __shfl_sync(kFull, word, src);
          const int bit = (31 - __clz(c)) >> 1;
          q = 16 * (w0 - src) + bit;
          mvq = static_cast<int>((wd >> (2 * bit)) & 3u);
        }
      }
    }
    if (q < 0) {
      p = -1;
      break;
    }
    if (lane == 0) {
      const int fq = f_row[r + q];
      v_row[r - 1] = 1 | ((mvq == 0 ? (fq & 3) : 4) << 1) | ((fq >> 2) << 4);
    }
    const int nxt = q + (mvq != 0);  // diag: the same lane, up: the next
    p = nxt < BW && nxt > ulo ? nxt : -1;  // j of nxt on row r - 1 above 1
  }
  if (t0 == 0) {
    const int ui = ql + kHalf + r0;
    if (ui >= 0 && ui < BW) p = ui;
  }
  if (lane == 0 && p >= 0 && p - kHalf - r0 >= 1) i_row[0] = 1 | (f_row[p] << 1);
}

template <typename Kernel>
int launch_setup(Kernel kernel, long long B, int per_block, long long smem, unsigned* blocks) {
  // the card refuses a block past its shared memory here; the wrapper's
  // launch_plan sizes per_block so that it never asks for one
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check to report
      return static_cast<int>(e);
    }
  }
  const long long n = (B + per_block - 1) / per_block;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <int GP, int BWT>
int launch_forward(const void* cw, const void* t_lens, const void* fw_sh, const void* q_lens,
                   const void* r0, void* moves, void* ends, void* row0, long long B, int T,
                   int BW, cudaStream_t stream) {
  constexpr int per_block = kFwdWarps * (32 / GP);
  const long long smem = static_cast<long long>(per_block) * forward_bytes(T, BW);
  unsigned blocks = 0;
  const int err = launch_setup(band_forward_kernel<GP, BWT>, B, per_block, smem, &blocks);
  if (err != 0) return err;
  band_forward_kernel<GP, BWT><<<blocks, 32 * kFwdWarps, static_cast<size_t>(smem), stream>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
      static_cast<const uint8_t*>(fw_sh), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(ends), static_cast<int32_t*>(row0), B, T, BW);
  return static_cast<int>(cudaGetLastError());
}

template <int BWT, int kCopy>
int launch_walk(const void* moves, const void* ends, const void* row0, const void* fw_sh,
                const void* q_lens, const void* r0, void* votes, void* ins, long long B, int T,
                int BW, cudaStream_t stream) {
  const long long smem = static_cast<long long>(kWalkFrags) * walk_bytes(T, BW);
  unsigned blocks = 0;
  const int err = launch_setup(band_walk_kernel<BWT, kCopy>, B, kWalkFrags, smem, &blocks);
  if (err != 0) return err;
  band_walk_kernel<BWT, kCopy><<<blocks, 32 * kWalkWarps, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint32_t*>(moves), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(row0), static_cast<const uint8_t*>(fw_sh),
      static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(r0),
      static_cast<int32_t*>(votes), static_cast<int32_t*>(ins), B, T, BW);
  return static_cast<int>(cudaGetLastError());
}

// band_pack: a group's shifted fragment rows, laid out on the card.
//
// Replaces no TPU kernel: raven_tpu packs the rows on the host
// (consensus_band.py::pack_shifted_fragments, a loop over the fragments),
// and the port did too, ~87 ms of host time a group of ~6,700 fragments
// against K3 and K4's ~1 ms on the card.  The host now uploads the group's
// fragment bytes back to back (and their weights when a window of the
// group carries weights) with a source offset, q_len and r0 a row, and
// this kernel writes every byte of fw_sh [B, SW], SW = T + BW + 1:
//   fw_sh[i, c] = base | min(w, 63) << 2 for c in [off, off + n), where
//   off = r0[i] + BW/2 + 1 and n = min(q_len[i], max(SW - off, 0)), base
//   and w the bytes src[i] + c - off of the flat buffers (w = 1 without
//   weights); 0 elsewhere, so the output needs no fill first.
// What bounds it: bytes.  It writes B * SW bytes (7.35 MB at [8192, 640,
// 256]) and reads about the fragments' bytes (~3.2 MB) and 16 B a row:
// ~3 us at 3.35 TB/s.  Design: a thread builds 16 consecutive bytes of the
// flattened output in registers, from the one or two rows they cross (SW
// is odd at the engine's shapes, so rows do not start on a word), and
// stores them as one 16-byte word (byte by byte at the ragged end or on an
// output that is not 16-byte aligned).  Neighbouring threads take
// neighbouring words, so a warp's store is 512 contiguous bytes and the
// fragment bytes it reads are contiguous too.
constexpr int kPackThreads = 256;
constexpr int kPackBytes = 16;  // output bytes a thread

__global__ void __launch_bounds__(kPackThreads)
band_pack_kernel(const uint8_t* __restrict__ bases, const uint8_t* __restrict__ wts,
                 const int64_t* __restrict__ src, const int32_t* __restrict__ q_lens,
                 const int32_t* __restrict__ r0, uint8_t* __restrict__ out, long long B, int SW,
                 int half, bool aligned) {
  const long long total = B * SW;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x) * kPackBytes;
  if (first >= total) return;
  long long row = first / SW;
  int col = static_cast<int>(first - row * SW);
  long long s = 0;
  int off = 0, n = 0;
  auto enter = [&](long long r) {
    s = src[r];
    off = r0[r] + half;
    n = min(q_lens[r], max(SW - off, 0));
  };
  enter(row);
  uint32_t word[kPackBytes / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kPackBytes; ++k) {
    if (col == SW) {
      ++row;
      col = 0;
      if (row < B) enter(row);
    }
    const int j = col - off;
    if (first + k < total && j >= 0 && j < n) {
      const long long p = s + j;
      const uint32_t w = wts != nullptr ? min(static_cast<uint32_t>(wts[p]), 63u) : 1u;
      word[k / 4] |= ((static_cast<uint32_t>(bases[p]) | (w << 2)) & 0xFFu) << (8 * (k % 4));
    }
    ++col;
  }
  if (aligned && first + kPackBytes <= total) {
    *reinterpret_cast<uint4*>(out + first) = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPackBytes; ++k) {  // unrolled: word stays in registers
      if (first + k < total) out[first + k] = static_cast<uint8_t>(word[k / 4] >> (8 * (k % 4)));
    }
  }
}

bool supported(int T, int BW) { return T >= 1 && BW >= 16 && BW <= kMaxBW && BW % 16 == 0; }
// K3's wide route: any T, BW up to 1024 threads of 16 lanes; its global
// route and K4's direct one: any T, BW up to kMaxBWAny
bool supported_wide(int T, int BW) {
  return T >= 1 && BW >= 16 && BW <= kWideMaxBW && BW % 16 == 0;
}
bool supported_any(int T, int BW) {
  return T >= 1 && BW >= 16 && BW <= kMaxBWAny && BW % 16 == 0;
}

}  // namespace

extern "C" {

// Each launcher takes, last, the fragments a block that the wrapper's
// launch_plan gave its route (the route is the launcher called), and
// refuses a count its kernels are not built for.  The count comes after
// the stream, so that a build without the argument ignores it.

// Launches K3's strip kernels on `stream` over B fragments at a band of BW
// lanes (a multiple of 16 up to 512): cw [B, T], t_lens, q_lens, r0 [B]
// int32, fw_sh [B, T + BW + 1] uint8; moves [T, B, BW / 16], ends [T, B]
// and row0 [B] int32 out.  per_block 8 runs 16-lane groups (BW up to 256;
// BW = 256 its own instantiation), 4 a warp a fragment (BW up to 512).
// Returns the CUDA error code of the launch (0 on success).
int raven_band_forward_launch(const void* cw, const void* t_lens, const void* fw_sh,
                              const void* q_lens, const void* r0, void* moves, void* ends,
                              void* row0, long long B, int T, int BW, void* stream,
                              int per_block) {
  if (B == 0) return 0;
  if (!supported(T, BW)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_block == kFwdWarps * 2 && BW <= 256) {
    if (BW == 256) return launch_forward<16, 256>(cw, t_lens, fw_sh, q_lens, r0, moves, ends, row0, B, T, BW, st);
    return launch_forward<16, 0>(cw, t_lens, fw_sh, q_lens, r0, moves, ends, row0, B, T, BW, st);
  }
  if (per_block == kFwdWarps && BW > 256) {
    return launch_forward<32, 0>(cw, t_lens, fw_sh, q_lens, r0, moves, ends, row0, B, T, BW, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches K4's staged walk on `stream` over B fragments at a band of BW
// lanes, per_block 16: K3's moves, ends and row0, with fw_sh, q_lens and
// r0 as K3 took them; votes [B, T] and ins [B, T + 1] int32 out.  Returns
// the CUDA error code of the launch (0 on success).
int raven_band_walk_launch(const void* moves, const void* ends, const void* row0,
                           const void* fw_sh, const void* q_lens, const void* r0, void* votes,
                           void* ins, long long B, int T, int BW, void* stream, int per_block) {
  if (B == 0) return 0;
  if (!supported(T, BW) || per_block != kWalkFrags) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BW == 256) return launch_walk<256, 16>(moves, ends, row0, fw_sh, q_lens, r0, votes, ins, B, T, BW, st);
  if (BW % 64 == 0) return launch_walk<0, 16>(moves, ends, row0, fw_sh, q_lens, r0, votes, ins, B, T, BW, st);
  return launch_walk<0, 4>(moves, ends, row0, fw_sh, q_lens, r0, votes, ins, B, T, BW, st);
}

// K3's wide route, one fragment a block (per_block 1), for any T and any BW
// (a multiple of 16 up to 16,384): arguments and outputs as
// raven_band_forward_launch.
int raven_band_forward_wide_launch(const void* cw, const void* t_lens, const void* fw_sh,
                                   const void* q_lens, const void* r0, void* moves, void* ends,
                                   void* row0, long long B, int T, int BW, void* stream,
                                   int per_block) {
  if (B == 0) return 0;
  if (!supported_wide(T, BW) || per_block != 1 || B > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (BW / C + 31) / 32 * 32;
  band_forward_wide_kernel<<<static_cast<unsigned>(B), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
      static_cast<const uint8_t*>(fw_sh), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(ends), static_cast<int32_t*>(row0), B, T, BW);
  return static_cast<int>(cudaGetLastError());
}

// K3's global route, one fragment a block (per_block 1), for any T and BW
// a multiple of 16 up to 2^27: arguments and outputs as
// raven_band_forward_launch, and prev a scratch of B * BW int32 (each
// fragment's previous DP row).
int raven_band_forward_global_launch(const void* cw, const void* t_lens, const void* fw_sh,
                                     const void* q_lens, const void* r0, void* moves,
                                     void* ends, void* row0, void* prev, long long B, int T,
                                     int BW, void* stream, int per_block) {
  if (B == 0) return 0;
  if (!supported_any(T, BW) || per_block != 1 || B > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band_forward_global_kernel<<<static_cast<unsigned>(B), kGlobalThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
      static_cast<const uint8_t*>(fw_sh), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(ends), static_cast<int32_t*>(row0), static_cast<int32_t*>(prev), B,
      T, BW);
  return static_cast<int>(cudaGetLastError());
}

// K4's direct route, a warp a fragment (per_block 4), for any T and BW a
// multiple of 16 up to 2^27: arguments and outputs as
// raven_band_walk_launch.
int raven_band_walk_direct_launch(const void* moves, const void* ends, const void* row0,
                                  const void* fw_sh, const void* q_lens, const void* r0,
                                  void* votes, void* ins, long long B, int T, int BW,
                                  void* stream, int per_block) {
  if (B == 0) return 0;
  if (!supported_any(T, BW) || per_block != kWalkWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  band_walk_direct_kernel<<<static_cast<unsigned>(blocks), 32 * kWalkWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(moves), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(row0), static_cast<const uint8_t*>(fw_sh),
      static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(r0),
      static_cast<int32_t*>(votes), static_cast<int32_t*>(ins), B, T, BW);
  return static_cast<int>(cudaGetLastError());
}

// Launches band_pack on `stream`: fw_sh [B, T + BW + 1] uint8 out from
// the group's fragment bytes `bases` and weights `wts` (uint8, back to back;
// wts null: every weight 1), and per row src int64 (its first byte in
// bases), q_lens and r0 int32.  `threads` is the wrapper's pack_plan's
// (256).  Returns the CUDA error code of the launch (0 on success).
int raven_band_pack_launch(const void* bases, const void* wts, const void* src,
                           const void* q_lens, const void* r0, void* out, long long B, int T,
                           int BW, void* stream, int threads) {
  if (B == 0) return 0;
  const long long SW = static_cast<long long>(T) + BW + 1;
  if (!supported_any(T, BW) || threads != kPackThreads || B < 0 || SW > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = (B * SW + kPackBytes - 1) / kPackBytes;
  const long long blocks = (words + kPackThreads - 1) / kPackThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  band_pack_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(wts),
      static_cast<const int64_t*>(src), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<uint8_t*>(out), B, static_cast<int>(SW),
      BW / 2 + 1, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
