// Anchored banded window consensus: kernel K9, the banded NW forward whose
// band follows each fragment's placement on the consensus, and kernel K10,
// the banded walk that turns each alignment into per-row vote primitives.
//
// Replace raven_tpu/ops/consensus_device.py::nw_moves_banded_kernel and
// traceback_banded_kernel (XLA scans on the TPU, not Pallas kernels), with
// the path decoding of its _votes_from_paths, and compute what they compute,
// bit for bit.
//
// K9.  Fragment b (frags [B, Q] int32, qlen, placement r0..r1 on the
// consensus cw[b, :tlen]) is aligned in a band of BW fragment columns a DP
// row.  DP row r + 1 (r = 0 .. T-1) holds columns off_r .. off_r + BW - 1
// with
//   row = min(r + 1, max(tlen, 1)), q = min(qlen, Q),
//   c = clip((row - r0) * q / max(r1 - r0, 1), 0, q)   (integer division),
//   off_r = clip(c - BW/2, 0, max(Q + 1 - BW, 0));
// DP row 0 holds j * GAP for j <= qlen at off_{-1} (always 0), else NEG.
// The band start never falls down the rows but may rise by any d >= 0, so
// each row regathers the previous one at its own start: lane i reads the
// previous row's lanes i + d (up) and i + d - 1 (diag), NEG outside
// [0, BW).  Then, as in K2 and K3:
//   diag = prev[i + d - 1] + (frags[min(j, Q) - 1] == cw[r] ? 3 : -5), up =
//   prev[i + d] - 4, e = max, move diag when diag >= up (with Q + 1 < BW
//   the band runs past the fragment, and those columns read its last code);
//   column j == 0 restarts at e = 0 with move up, before the closure;
//   closed = cummax over i of (e + 4i), less 4i; move left, and the value
//   closed, only when closed > e (lane 0 takes nothing from its left);
//   lanes with j > qlen hold NEG after the closure (their moves stay as
//   computed, and are outputs);
//   the end score of the row is its value at j == qlen when that lane is in
//   the band, else NEG.
// Rows r >= tlen keep the previous row and its start, with move 3 in every
// lane and end score NEG.  Outputs: moves [T, B, BW/16], 2 bits a lane,
// lane i at bits 2 (i % 16) of word i / 16; offs [T, B] (the band start
// kept); end_scores [T, B]; row0 [B] = qlen * GAP when qlen <= Q, else NEG.
// Values stay within a few thousand of 0 or of NEG = -2^20: the moves of
// lanes fed only by NEG are decided by exact int32 comparisons of such
// values, which any narrower packing would have to keep.
//
// K10.  The walk starts at t = 0 when row0 >= the best end score, else at
// one row below the first row holding it, at j = qlen, and moves back one
// move a step until j == 0.  The move at (t, j) is lane i = j - offs[t - 1]
// of row t - 1 (at t == 0, still row 1's band offs[0], and the move is
// left).  Outside that band the walk stalls on the top row (t == 0) or stops
// (t != 0, raven_tpu's defensive stop, which an optimal path never takes);
// a move 3 (a row past the consensus) ends it too.  A diag or up move at
// (t, j) votes at row t - 1: col_sym its base (diag) or 4 (up), col_w its
// weight, both of fragment column clip(j - 1, 0, Q - 1); the first left
// move of a run, in walk order, votes the same base and weight at junction
// t (ins_b, ins_w).  Outputs: col_sym, col_w [B, T], ins_b, ins_w [B,
// T + 1], 5 / 0 and -1 / 0 where nothing was cast (K2's primitives; the
// vote epilogue raven_tpu_torch/ops/consensus_cuda.py serves both engines).
//
// What bounds them on an H100.  K9: integer instructions.  Its recurrence is
// K2's, so at the fewest K2's 4 a band cell on 16-bit pair instructions, or
// K3's 10 in int32 (the score's compare and select, the diag add, the up
// add fused with the max, the which-won predicate, the closure as one
// add-max, the left predicate, the domain's compare and select, one pack of
// the move bits); 259 M cells within the consensus at the engine's chunk
// ([2048, 640, 768, 256]) against ~106 MB of traffic.  K10: its traffic (the
// end scores, a move word and band start for each move of the walks, the
// primitives written once) and the walk's serial length: up to T + Q
// dependent steps a fragment.
//
// What held the first versions back (a warp a fragment each; NVIDIA H100
// 80GB HBM3 at 700 W: K9 0.63-0.69 ms, ~5% of its bound; K10 0.21-0.26 ms,
// ~6%).  K9 held 8 band lanes a lane and ran, each row, a band-start
// division, a 5-step __shfl_up_sync scan for the closure, two __syncwarps
// around a shared-memory round trip of the whole row (store, then a
// regather of 9 words at the step d), a shared-memory read of the fragment
// code a cell and the j == 0 and j > qlen tests in every cell: cuobjdump
// counted 409 SASS instructions in its row loop, 51 a cell.  K10 walked on
// one lane while 31 waited, staged its move rows synchronously on the
// walk's chain (each stage a DRAM round trip: K9 has just written 84 MB of
// moves, past the 50 MB L2), read the end scores one a lane at a 4B-byte
// stride, and wrote every primitive twice.
//
// Design (the engine's band of BW = 256):
//   * K9, the layout.  16 lanes of a warp take a fragment, two fragments a
//     warp, four warps a block; lane l holds band lanes 16l .. 16l + 15 of
//     the previous row in registers.  The warp runs its two fragments in
//     step, to the later one's last row (the other's rows past its own end
//     are computed and not stored), so every shuffle and vote names the
//     whole warp: masks of one half cost a divergence check at each.
//     One fragment a warp at 8 band lanes a lane, with the same closure,
//     was slower at the engine's chunk (PERF.md holds both times).
//   * K9, the band start and the consensus code.  Every 16 rows lane l
//     computes row r + l's band start (the division once) and loads its
//     consensus code a batch ahead; each row takes both by a shuffle each.
//     The band starts of all T rows, the frozen ones past the consensus
//     included, are written before the DP.
//   * K9, the regather by the step d, the one thing K3's band (always d =
//     1) never had.  The warp picks one source for its row from the
//     largest and smallest step of its active fragments (two warp
//     reductions): both d == 1 (most rows of a full-span fragment), the
//     registers as they are and the next lane's first by a shuffle; both
//     d == 0 (the rows before the band leaves column 0), the
//     registers one lane down and the previous lane's last; otherwise the
//     previous row gathered into pd[0 .. 16]: for steps of 0 to 2 by
//     selects among the registers and three shuffles, for any other step
//     (a steep span steps by 3 to 255, a span of one row leaps by 256 or
//     more) through shared memory, the row stored one padding word in 16
//     so that the lanes' strided reads hit distinct banks, with a NEG word
//     past the band's end.  The cell loop is instantiated for each source,
//     so the common rows move no register.
//   * K9, the cells.  The fragment's codes are packed 2 bits a column in
//     shared memory, with a second word array marking the columns whose
//     code is a base (0-3); a lane takes its 16 columns as one funnel shift
//     of two words and matches them all at once by XOR against the
//     replicated consensus code (a consensus code outside 0-3 matches only
//     an equal fragment code, read from the fragment itself).  e is one
//     add-max of the up value and the diag, the up move e != diag.  The
//     closure is K3's (see band.cu): the linear-gap recurrence over each
//     strip, the carries between lanes iterated to their fixed point with
//     __any_sync, lanes whose columns are all past qlen + 1 starting from a
//     high guess.  The j == 0 reset, the domain mask and the end score run
//     in branches only the lanes concerned take.  Each lane stores its 16
//     moves as one word through a pointer stepped a row at a time: a
//     fragment's row, 64 bytes, in one coalesced store.  Values stay int32
//     (the NEG-fed lanes' moves are outputs).  What bounds K9 in this form
//     (cuobjdump -sass, which chip_smoke.py prints): its row loop holds 803
//     instructions for 16 cells, three copies of the cell loop (one a
//     source of the previous row, a row runs one) and the gather among
//     them, 424 of them on the integer ALU pipe, which takes a warp
//     instruction every other cycle; with two fragments a warp the bank
//     chunk leaves about two warps a scheduler to hide the closure's
//     dependent chains.
//   * K10.  8 lanes of a warp take a fragment, four a warp, 16 a block.
//     The best row comes from the block's 16 fragments read together, 64
//     contiguous bytes an end-score row, sixteen rows in flight a thread.
//     The walk is scalar and the same in each of the 8 lanes, one move a
//     step without branches but for a block's store, so the warp's four
//     walks step together; on the step's chain are only the move word's
//     shared-memory load and a few integer operations (the next row's band
//     start and the vote's base and weight are read beside it).  Nothing on
//     the walk touches device memory: the four walks of a warp share its
//     load scoreboard and cp.async counter, so any load or wait of one
//     walk stalls the others.  The fragment's move rows with their band
//     starts, and its codes and weights, are staged 64 rows (64 columns) at
//     a time by cp.async into shared memory, double-buffered, slot m & 127;
//     every 32 steps the warp stages together, for each walk that has
//     entered its lowest staged chunk, the chunk below, and waits for the
//     stages of the point before: a walk takes at least 64 steps to cross a
//     chunk, so a stage has landed a point before its walk gets there.
//     Each lane keeps one row of the block of 8 rows its walk is in, as the
//     primitives it will store, and stores them when the walk leaves the
//     block: every primitive is written once (the rows above the walk
//     first, the rows below where it ended last).
//   * The other width.  raven_tpu's engine takes BW = min(256, pow2(q_pad)),
//     so 128 for q_pad <= 128.  Both kernels are instantiated for 128 and
//     256 (Band<BW>): at 128 K9 gives a fragment 8 lanes, four fragments a
//     warp, its row batches are 8 rows, kHigh follows BW, and the regather
//     through shared memory clamps at the padded row's end whatever the
//     step; K10's move rows are 32 bytes.  With Q + 1 < BW (the band wider
//     than the fragment, at either width) the band starts stay at 0, the
//     packed fragment holds the band's BW / 16 + 1 words, and the columns
//     past Q carry the fragment's last code as raven_tpu's clipped gather
//     gives them.
//   * Any fragment length.  K9 keeps 8 fragments a block at BW = 256 (16 at
//     128) whatever Q is; each fragment's packed codes take forward_words(Q,
//     BW) words of shared memory, which at BW = 256 hold Q up to 55,887 in
//     the 227 KB a block may have.  Past that the codes go to a scratch in
//     device memory that the wrapper allocates (kGlobalCodes, the "global"
//     route; raven_nw_moves_banded_global_launch): the kernel packs them
//     there as it packs them into shared memory, and each row reads its four
//     words from there (L1 hits: a lane reads the same two words for 16
//     rows), with only the regather row in shared memory.  The wrapper's
//     launch_plan picks the route and its fragments a block from the shape;
//     the launcher takes both.  K10's shared memory
//     depends on neither Q nor T, so K10 has one route.  Band starts are
//     (row - r0) * q / span in int32, as raven_tpu and the plain version
//     compute them: below 2^31 while T * Q is, and wrapping like theirs
//     past it; every other position (a column, a row, a step) stays below
//     T + Q, and device-memory offsets are 64-bit.
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
// the closure's carry into lane 0: never wins, and never wraps when GAP is
// added a band's width of times
constexpr int kNone = -(1 << 30);
constexpr int kGuess = 0;         // the high guess (any value above kHigh)
constexpr int C = 16;             // K9: band lanes a lane holds, one move word
constexpr int kFwdWarps = 4;      // K9: warps a block

constexpr int kChunk = 64;                 // K10: move rows, and fragment columns, a stage holds
constexpr int kStride = kChunk / 2;        // K10: walk steps between two staging points
constexpr int kGroup = 8;                  // K10: lanes of the warp a fragment takes
constexpr int kFragsPerWarp = 32 / kGroup;
constexpr int kWalkWarps = 4;              // K10: warps a block
constexpr int kWalkFrags = kWalkWarps * kFragsPerWarp;

// What depends on the band's width, BW = 256 (16 lanes a fragment, two
// fragments a warp) or 128 (8 lanes, four a warp): raven_tpu's
// min(256, pow2(q_pad)) gives only these two.
template <int BW>
struct Band {
  static_assert(BW == 128 || BW == 256, "the anchored band is 128 or 256 lanes");
  static constexpr int kWords = BW / 16;                    // move words a row
  static constexpr int kFwdGroup = BW / C;                  // K9: lanes of the warp a fragment takes
  static constexpr int kFwdFrags = kFwdWarps * 32 / kFwdGroup;
  // a lane whose columns are all past qlen + 1 holds values within 8 of
  // NEG: a carry above kHigh makes every cell left up to the band's end
  static constexpr int kHigh = kNeg + 3 - kGap * BW;
  static constexpr int kRowBytes = kWords * 4;              // K10: a move row
  static constexpr int kChunkBytes = kChunk * kRowBytes;
  // K10's shared memory a fragment, two stages of each: move rows, their
  // band starts, the fragment's codes and its weights
  static constexpr int kWalkBytes = 2 * kChunkBytes + 3 * 2 * kChunk * 4;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// K9's packed fragment: words of 16 columns, column j at bits 2 (j % 16) of
// word j / 16, and one more word for the funnel shift at the band's end
// (with Q + 1 < BW, off to the band's end)
__host__ __device__ constexpr int code_words(int Q, int bw) {
  return Q / 16 + 2 > bw / 16 + 1 ? Q / 16 + 2 : bw / 16 + 1;
}
// K9's regather row: band lane s at rpad(s), one padding word every C
__host__ __device__ constexpr int rpad(int s) { return s + s / C; }
// words of shared memory a K9 fragment uses: its packed codes (none when
// they are in device memory) and its regather row
__host__ __device__ constexpr int row_words_smem(int bw) { return round4(rpad(bw) + 1); }
__host__ __device__ constexpr int forward_words(int Q, int bw) {
  return round4(2 * code_words(Q, bw)) + row_words_smem(bw);
}

template <int BW>
__device__ __forceinline__ int band_start(int r, int tl1, int r0, int span, int q, int hi) {
  const int row = min(r + 1, tl1);
  // a negative numerator clips to 0 whether the division floors or truncates
  int c = (row - r0) * q / span;
  c = min(max(c, 0), q);
  return min(max(c - BW / 2, 0), hi);
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

// Where a K9 lane's cells take the previous row from: band lane C sub + d -
// 1 + k feeds cell k's diag and the next one its up.  kStep1: d == 1, my
// own registers and the next lane's first; kStep0: d == 0, my own and the
// previous lane's last; kGathered: pd[0 .. C], gathered for any d.
enum Source { kStep1, kStep0, kGathered };

template <int SRC>
__device__ __forceinline__ int prev_at(const int (&p)[C], const int (&pd)[C + 1], int edge,
                                       int k) {
  if constexpr (SRC == kStep1) {
    return k < C ? p[k] : edge;
  } else if constexpr (SRC == kStep0) {
    return k > 0 ? p[k - 1] : edge;
  } else {
    return pd[k];
  }
}

// e[k] = max(diag, up) of my cells, diag = the previous row at k + its
// score (bit 2k of mb: a match), up = the previous row at k + 1 + GAP;
// returns the cells whose move is up (bit k)
template <int SRC>
__device__ __forceinline__ uint32_t row_cells(const int (&p)[C], const int (&pd)[C + 1],
                                              int edge, uint32_t mb, int (&e)[C]) {
  uint32_t up_bits = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int dg = prev_at<SRC>(p, pd, edge, k) + (((mb >> (2 * k)) & 1u) ? kMatch : kMismatch);
    e[k] = __viaddmax_s32(prev_at<SRC>(p, pd, edge, k + 1), kGap, dg);
    up_bits |= static_cast<uint32_t>(e[k] != dg) << k;
  }
  return up_bits;
}

// kGlobalCodes: the packed codes in `codes` ([B, 2 code_words(Q, BW)]
// words of device memory), else in shared memory (`codes` unused)
template <int BW, bool kGlobalCodes>
__global__ void __launch_bounds__(32 * kFwdWarps)
nw_moves_banded_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                       const int32_t* __restrict__ frags, const int32_t* __restrict__ q_lens,
                       const int32_t* __restrict__ r0s, const int32_t* __restrict__ r1s,
                       uint32_t* __restrict__ moves, int32_t* __restrict__ offs,
                       int32_t* __restrict__ ends, int32_t* __restrict__ row0, long long B,
                       int T, int Q, uint32_t* codes) {
  constexpr int kWords = Band<BW>::kWords;
  constexpr int kFwdGroup = Band<BW>::kFwdGroup;
  constexpr int kFwdFrags = Band<BW>::kFwdFrags;
  constexpr int kHigh = Band<BW>::kHigh;
  extern __shared__ __align__(16) uint32_t smem_fwd[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kFwdGroup, sub = lane % kFwdGroup;
  const int fl = warp * (32 / kFwdGroup) + g;  // my fragment in the block
  const long long bw0 = static_cast<long long>(blockIdx.x) * kFwdFrags + warp * (32 / kFwdGroup);
  if (bw0 >= B) return;  // the whole warp
  // a fragment past B runs beside its warp's other on the last one's
  // inputs, and stores nothing
  const bool valid = bw0 + g < B;
  const long long b = valid ? bw0 + g : B - 1;
  const int PW = code_words(Q, BW);
  uint32_t* s_code;  // 2-bit codes
  int* s_row;        // the regather row
  if constexpr (kGlobalCodes) {
    s_code = codes + b * 2 * PW;
    s_row = reinterpret_cast<int*>(smem_fwd + fl * row_words_smem(BW));
  } else {
    s_code = smem_fwd + fl * forward_words(Q, BW);
    s_row = reinterpret_cast<int*>(s_code + round4(2 * PW));
  }
  uint32_t* s_base = s_code + PW;  // 1 at a base (0-3)

  const int32_t* f_row = frags + b * Q;
  for (int w = sub; w < PW; w += kFwdGroup) {
    uint32_t code = 0, base = 0;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      // column j reads fragment code j - 1, past the fragment its last
      // (raven_tpu's gather clips at Q)
      const int j = 16 * w + k;
      if (j >= 1) {
        const int f = f_row[min(j, Q) - 1];
        if (f >= 0 && f <= 3) {
          code |= static_cast<uint32_t>(f) << (2 * k);
          base |= 1u << (2 * k);
        }
      }
    }
    // a fragment past B packs the last one's codes: in device memory the
    // last one's own lanes store them
    if (!kGlobalCodes || valid) {
      s_code[w] = code;
      s_base[w] = base;
    }
  }
  if (sub == 0) s_row[rpad(BW)] = kNeg;  // past the band's end

  const int tl = t_lens[b], ql = q_lens[b], r0 = r0s[b];
  const int span = max(r1s[b] - r0, 1);
  const int q = min(ql, Q);
  const int hi = max(Q + 1 - BW, 0);
  const int tl1 = max(tl, 1);
  const int rows = valid ? min(T, max(tl, 0)) : 0;  // my DP rows; the rest are constants
  const int rows_w = __reduce_max_sync(kFull, static_cast<unsigned>(rows));  // the warp's
  // every row's band start: past the consensus, the last DP row's
  for (int r = sub; valid && r < T; r += kFwdGroup) {
    offs[static_cast<size_t>(r) * B + b] = band_start<BW>(tl > 0 ? r : -1, tl1, r0, span, q, hi);
  }
  if (valid && sub == 0) row0[b] = ql <= Q ? ql * kGap : kNeg;

  int off_prev = band_start<BW>(-1, tl1, r0, span, q, hi);
  int prev[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = off_prev + C * sub + k;
    prev[k] = j <= ql ? j * kGap : kNeg;
  }
  __syncwarp();  // the packed fragments are whole

  const int32_t* c_row = cw + b * T;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_out = moves + b * kWords + sub;
  int32_t* end_out = ends + b;
  // the consensus codes, a batch of kFwdGroup rows ahead; 0 (any base) on
  // the rows I run only beside my warp's other fragment
  int tc_next = sub < rows ? c_row[sub] : 0;
  int tc_batch = 0, off_batch = 0;
  for (int r = 0; r < rows_w; ++r) {
    const int rs = r % kFwdGroup;
    if (rs == 0) {
      tc_batch = tc_next;
      const int rn = r + kFwdGroup + sub;
      tc_next = rn < rows ? c_row[rn] : 0;
      off_batch = band_start<BW>(r + sub, tl1, r0, span, q, hi);
    }
    const int tch = __shfl_sync(kFull, tc_batch, rs, kFwdGroup);
    const int off = __shfl_sync(kFull, off_batch, rs, kFwdGroup);
    const bool active = r < rows;
    const int d = off - off_prev;
    off_prev = off;
    // the step's source for the whole warp, from the largest and smallest
    // step of its active fragments
    const unsigned du = static_cast<unsigned>(d);
    const unsigned dmax = __reduce_max_sync(kFull, active ? du : 0u);
    const unsigned dmin = __reduce_min_sync(kFull, active ? du : ~0u);

    // my columns' matches against the consensus code, bit 2k for cell k
    const int jb = off + C * sub;  // column of my first band lane
    const int w0 = jb >> 4, sh = 2 * (jb & 15);
    uint32_t mb;
    if (static_cast<unsigned>(tch) <= 3u) {
      const uint32_t code = __funnelshift_r(s_code[w0], s_code[w0 + 1], sh);
      const uint32_t x = code ^ (static_cast<uint32_t>(tch) * 0x55555555u);
      mb = ~(x | (x >> 1)) & __funnelshift_r(s_base[w0], s_base[w0 + 1], sh);
    } else {  // a code outside 0-3 matches only an equal fragment code
      mb = 0;
      for (int k = 0; k < C; ++k) {
        const int j = jb + k;
        mb |= static_cast<uint32_t>((j >= 1 ? f_row[min(j, Q) - 1] : -1) == tch) << (2 * k);
      }
    }

    int e[C];
    int pd[C + 1];
    uint32_t up_bits;
    if (dmax == 1 && dmin == 1) {
      const int x = __shfl_down_sync(kFull, prev[0], 1, kFwdGroup);
      up_bits = row_cells<kStep1>(prev, pd, sub == kFwdGroup - 1 ? kNeg : x, mb, e);
    } else if (dmax == 0) {
      const int x = __shfl_up_sync(kFull, prev[C - 1], 1, kFwdGroup);
      up_bits = row_cells<kStep0>(prev, pd, sub == 0 ? kNeg : x, mb, e);
    } else {
      if (dmax <= 2) {  // steps of 0 to 2 across the warp: selects
        const int xl = __shfl_up_sync(kFull, prev[C - 1], 1, kFwdGroup);
        const int x0 = __shfl_down_sync(kFull, prev[0], 1, kFwdGroup);
        const int x1 = __shfl_down_sync(kFull, prev[1], 1, kFwdGroup);
        const bool last = sub == kFwdGroup - 1;
        const int lo = sub == 0 ? kNeg : xl, r0v = last ? kNeg : x0, r1v = last ? kNeg : x1;
#pragma unroll
        for (int k = 0; k <= C; ++k) {
          const int a = k == 0 ? lo : prev[k - 1];
          const int m = k < C ? prev[k] : r0v;
          const int z = k + 1 < C ? prev[k + 1] : (k + 1 == C ? r0v : r1v);
          pd[k] = d == 0 ? a : (d == 1 ? m : z);
        }
      } else {  // any step: through shared memory
        __syncwarp();  // the last regather's reads are done
#pragma unroll
        for (int k = 0; k < C; ++k) s_row[rpad(C * sub + k)] = prev[k];
        __syncwarp();
        const unsigned at = static_cast<unsigned>(C * sub + d - 1);
#pragma unroll
        for (int k = 0; k <= C; ++k) {
          pd[k] = s_row[rpad(min(at + k, static_cast<unsigned>(BW)))];
        }
      }
      up_bits = row_cells<kGathered>(prev, pd, 0, mb, e);
    }
    // the free consensus prefix: column j == 0 restarts at 0 with move up,
    // before the closure
    if (jb == 0) {
      e[0] = 0;
      up_bits |= 1u;
    }
    // the left closure over my strip from no carry: its last value
    int run = kNone;
#pragma unroll
    for (int k = 0; k < C; ++k) run = __viaddmax_s32(run, kGap, e[k]);
    // the carries between lanes, to their fixed point
    const bool past = jb >= ql + 2;       // all my columns past qlen + 1
    const bool all_past = off >= ql + 2;  // the first lane's, so the row's
    int last = past && !all_past ? kGuess : run;
    int carry;
    while (true) {
      int c = __shfl_up_sync(kFull, last, 1, kFwdGroup);
      if (sub == 0) c = kNone;
      int nl = __viaddmax_s32(c, C * kGap, run);
      if (past && c > kHigh) nl = kGuess;
      const bool changed = nl != last;
      carry = c;
      last = nl;
      if (!__any_sync(kFull, changed)) break;
    }
    // the closure again from the carry; bit k: cell k's move is left
    int dv[C];
    uint32_t left_bits = 0;
    run = carry;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      run = __viaddmax_s32(run, kGap, e[k]);
      dv[k] = run;
      left_bits |= static_cast<uint32_t>(run != e[k]) << k;
    }
    const uint32_t bits = spread2(up_bits & ~left_bits) | (spread2(left_bits) << 1);
    if (active) *mv_out = bits;
    mv_out += row_words;
    // lanes with j > qlen hold NEG
    if (jb + C - 1 <= ql) {
#pragma unroll
      for (int k = 0; k < C; ++k) prev[k] = dv[k];
    } else {
      const int top = ql - jb;  // my last cell within the fragment (< C - 1)
      const uint32_t in = top >= 0 ? (2u << top) - 1u : 0u;
#pragma unroll
      for (int k = 0; k < C; ++k) prev[k] = (in >> k) & 1u ? dv[k] : kNeg;
    }
    // the row's end score: from the lane of column qlen, or NEG from the
    // first lane when that column is outside the band
    const int iq = ql - off;
    if (static_cast<unsigned>(iq) < static_cast<unsigned>(BW)) {
      if (active && sub == iq / C) end_out[static_cast<size_t>(r) * B] = pick(prev, iq % C);
    } else if (active && sub == 0) {
      end_out[static_cast<size_t>(r) * B] = kNeg;
    }
  }
  if (!valid) return;
  // rows past the consensus: the previous row kept, move 3 everywhere
  for (int k = sub; k < (T - rows) * kWords; k += kFwdGroup) {
    moves[(rows + k / kWords) * row_words + b * kWords + k % kWords] = 0xFFFFFFFFu;
  }
  for (int r = rows + sub; r < T; r += kFwdGroup) end_out[static_cast<size_t>(r) * B] = kNeg;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
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
__device__ __forceinline__ uint32_t lds_u32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Stage chunk c of a fragment's moves and band starts, rows 64c .. 64c + 63
// (those < T), into buffer c & 1: row m's move words at slot m & 127 of the
// moves, its band start at slot m & 127 of the band starts.  The warp's 32
// lanes copy.
template <int BW>
__device__ __forceinline__ void stage_moves(uint8_t* s_frag, const uint32_t* mv_frag,
                                            const int32_t* off_frag, size_t row_words,
                                            long long B, int c, int T, int lane) {
  constexpr int kRowBytes = Band<BW>::kRowBytes;
  constexpr int kParts = kRowBytes / 16;  // 16-byte copies a row
  uint8_t* dst = s_frag + (c & 1) * Band<BW>::kChunkBytes;
#pragma unroll
  for (int k = lane; k < kChunk * kParts; k += 32) {
    const int slot = k / kParts, part = k % kParts;
    const int m = kChunk * c + slot;
    if (m < T) cp_async16(dst + slot * kRowBytes + part * 16, mv_frag + m * row_words + part * 4);
  }
  int* od = reinterpret_cast<int*>(s_frag + 2 * Band<BW>::kChunkBytes) + (c & 1) * kChunk;
#pragma unroll
  for (int k = lane; k < kChunk; k += 32) {
    const int m = kChunk * c + k;
    if (m < T) cp_async4(od + k, off_frag + m * B);
  }
}

// Stage chunk k of a fragment's codes and weights, columns 64k .. 64k + 63
// (those < Q), into buffer k & 1: column c's at slot c & 127 of each.  The
// warp's 32 lanes copy.
template <int BW>
__device__ __forceinline__ void stage_cols(uint8_t* s_frag, const int32_t* f_row,
                                           const int32_t* w_row, int k, int Q, int lane) {
  int* dst = reinterpret_cast<int*>(s_frag + 2 * Band<BW>::kChunkBytes) + 2 * kChunk +
             (k & 1) * kChunk;
#pragma unroll
  for (int c = lane; c < kChunk; c += 32) {
    const int col = kChunk * k + c;
    if (col < Q) {
      cp_async4(dst + c, f_row + col);
      cp_async4(dst + 2 * kChunk + c, w_row + col);
    }
  }
}

template <int BW>
__global__ void __launch_bounds__(32 * kWalkWarps)
traceback_banded_kernel(const uint32_t* __restrict__ moves, const int32_t* __restrict__ offs,
                        const int32_t* __restrict__ ends, const int32_t* __restrict__ row0,
                        const int32_t* __restrict__ q_lens, const int32_t* __restrict__ frags,
                        const int32_t* __restrict__ wts, int32_t* __restrict__ col_sym,
                        int32_t* __restrict__ col_w, int32_t* __restrict__ ins_b,
                        int32_t* __restrict__ ins_w, long long B, int T, int Q) {
  constexpr int kWords = Band<BW>::kWords;
  constexpr int kRowBytes = Band<BW>::kRowBytes;
  constexpr int kChunkBytes = Band<BW>::kChunkBytes;
  constexpr int kWalkBytes = Band<BW>::kWalkBytes;
  extern __shared__ __align__(16) uint8_t smem_walk[];
  // [warp][fragment of the block]
  __shared__ int s_best[kWalkWarps][kWalkFrags], s_best_r[kWalkWarps][kWalkFrags];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup, sub = lane % kGroup;
  const long long b0 = static_cast<long long>(blockIdx.x) * kWalkFrags;
  const int fl = warp * kFragsPerWarp + g;  // my fragment in the block
  // a fragment past B walks nothing and stores nothing, beside its warp's
  const bool valid = b0 + fl < B;
  const long long b = valid ? b0 + fl : B - 1;

  // the best end score and the first row holding it, for the block's 16
  // fragments at once: thread t reads fragment t % 16 of rows t / 16, +8,
  // .., sixteen rows in flight
  {
    constexpr int kStep = 32 * kWalkWarps / kWalkFrags;
    const int f = threadIdx.x % kWalkFrags;
    int best = INT_MIN, best_r = 0;
    if (b0 + f < B) {
      for (int t = threadIdx.x / kWalkFrags; t < T; t += 16 * kStep) {
        int x[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int tu = t + u * kStep;
          x[u] = tu < T ? ends[static_cast<size_t>(tu) * B + b0 + f] : INT_MIN;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (x[u] > best) {
            best = x[u];
            best_r = t + u * kStep;
          }
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
  int best = s_best[0][fl], best_r = s_best_r[0][fl];
#pragma unroll
  for (int w = 1; w < kWalkWarps; ++w) {
    const int ov = s_best[w][fl], orr = s_best_r[w][fl];
    if (ov > best || (ov == best && orr < best_r)) {
      best = ov;
      best_r = orr;
    }
  }
  const int t0 = row0[b] >= best ? 0 : best_r + 1;
  int32_t* cs = col_sym + b * T;
  int32_t* cwt = col_w + b * T;
  int32_t* ib = ins_b + b * (T + 1);
  int32_t* iw = ins_w + b * (T + 1);

  // lane sub keeps row m = 8k + sub of the walker's block k (walker rows t
  // = m + 1) and writes col_sym[m], col_w[m], ins_b[m + 1] and ins_w[m +
  // 1].  The rows above the walker's first block first.
  const int kt = t0 >= 1 ? (t0 - 1) / kGroup : -1;
  for (int m = kGroup * (kt + 1) + sub; valid && m < T; m += kGroup) {
    cs[m] = 5;
    cwt[m] = 0;
    ib[m + 1] = -1;
    iw[m + 1] = 0;
  }

  uint8_t* s_frag = smem_walk + static_cast<size_t>(fl) * kWalkBytes;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  int t = t0, j = q_lens[b], prev_mv = 3;
  const int qm1 = Q - 1;
  // the move row and the fragment column of the walker, and the lowest
  // chunks of each staged so far
  const int ti0 = max(t0 - 1, 0);
  const int col0 = min(max(j - 1, 0), qm1);
  int mv_low = ti0 / kChunk, col_low = col0 / kChunk;
  // The warp stages together, each fragment's chunks in turn: the chunks
  // `mv` and `col` that my group's lane 0 asks for (-1: none).
  auto stage = [&](int mv, int col) {
#pragma unroll 1
    for (int gg = 0; gg < kFragsPerWarp; ++gg) {
      const int sm = __shfl_sync(kFull, mv, gg * kGroup);
      const int sc = __shfl_sync(kFull, col, gg * kGroup);
      const int fg = warp * kFragsPerWarp + gg;
      const long long bg = b0 + fg;
      uint8_t* sf = smem_walk + static_cast<size_t>(fg) * kWalkBytes;
      if (sm >= 0) stage_moves<BW>(sf, moves + bg * kWords, offs + bg, row_words, B, sm, T, lane);
      if (sc >= 0) stage_cols<BW>(sf, frags + bg * Q, wts + bg * Q, sc, Q, lane);
    }
  };
  stage(valid ? mv_low : -1, valid ? col_low : -1);
  --mv_low;
  --col_low;
  stage(valid ? mv_low : -1, valid ? col_low : -1);
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();
  // shared-space addresses (any row m or column c, the slots of those not
  // staged included): row m's move words at mv_sh + (m & 127) * kRowBytes, its
  // band start at off_sh + (m & 127) * 4, column c's code at col_sh + (c &
  // 127) * 4 and its weight 512 bytes on
  const unsigned mv_sh = static_cast<unsigned>(__cvta_generic_to_shared(s_frag));
  const unsigned off_sh = mv_sh + 2 * kChunkBytes;
  const unsigned col_sh = off_sh + 2 * kChunk * 4;
  constexpr int kSlots = 2 * kChunk - 1;
  auto off_at = [&](int m) { return static_cast<int>(lds_u32(off_sh + (m & kSlots) * 4)); };
  unsigned row = mv_sh + (ti0 & kSlots) * kRowBytes;  // the walker's move row
  int ro = off_at(ti0);                        // and its band start

  bool done = !valid;
  // this lane's row of the walker's block: its primitives as they will be
  // stored (no vote: 5, 0, -1, 0); the insertion at junction 0 apart
  int v_sym = 5, v_w = 0, i_b = -1, i_w = 0, i0_b = -1, i0_w = 0;
  auto store_block = [&](int k) {
    const int m = kGroup * k + sub;
    if (m < T) {
      cs[m] = v_sym;
      cwt[m] = v_w;
      ib[m + 1] = i_b;
      iw[m + 1] = i_w;
    }
    v_sym = 5;
    v_w = 0;
    i_b = -1;
    i_w = 0;
  };

  // one move a step, the same in the group's 8 lanes and without branches
  // but for a block's store; every kStride steps the warp stages, for each
  // walker that has entered the lowest chunk staged, the chunk below, waits
  // for the stages of the point before, and goes on while a walk goes on (a
  // walker takes at least kChunk = 2 kStride steps to cross a chunk, so the
  // point that waits for a stage comes before the walker reaches it)
  bool going = __any_sync(kFull, !done);
  while (going) {
#pragma unroll 1
    for (int step = 0; step < kStride; ++step) {
      const int i = j - ro;
      const unsigned ic = min(static_cast<unsigned>(i), static_cast<unsigned>(BW - 1));
      const uint32_t word = lds_u32(row + 4 * (ic >> 4));
      const int col = min(max(j - 1, 0), qm1);
      const unsigned at = col_sh + (col & kSlots) * 4;
      const int pk = min(max(static_cast<int>(lds_u32(at)), 0), 3) |
                     (static_cast<int>(lds_u32(at + 2 * kChunk * 4)) << 2);
      const int tn = t - 1, tin = t - 2;  // t and its move row after a move up a row
      const int ro_in = off_at(tin);
      // outside the band: a stall on the top row, else a stop; both end the
      // walk without a vote, as do a row past the consensus (3) and column 0
      const bool live = !done && j > 0 && static_cast<unsigned>(i) < static_cast<unsigned>(BW);
      const int mv = t > 0 ? static_cast<int>((word >> (2 * (ic & 15))) & 3u) : 2;
      const bool go = live && mv != 3;
      done = !go;
      const bool up_row = go && mv <= 1;  // diag or up: the walker moves a row up
      const bool mine = sub == (tn & (kGroup - 1));
      const bool ins = go && mv == 2 && prev_mv != 2;
      v_sym = up_row && mine ? (mv == 0 ? pk & 3 : 4) : v_sym;
      v_w = up_row && mine ? pk >> 2 : v_w;
      i_b = ins && t > 0 && mine ? pk & 3 : i_b;
      i_w = ins && t > 0 && mine ? pk >> 2 : i_w;
      i0_b = ins && t == 0 ? pk & 3 : i0_b;
      i0_w = ins && t == 0 ? pk >> 2 : i0_w;
      prev_mv = go ? mv : prev_mv;
      j -= go && mv != 1;
      const bool row_up = up_row && tn >= 1;  // at t == 0 the band stays row 1's
      ro = row_up ? ro_in : ro;
      row = row_up ? mv_sh + (tin & kSlots) * kRowBytes : row;
      t = up_row ? tn : t;
      if (up_row && (tn & (kGroup - 1)) == 0) store_block(tn / kGroup);  // the walker left it
    }
    __syncwarp();  // the lanes' reads of the buffers a stage takes are done
    int ask_mv = -1, ask_col = -1;
    if (!done && mv_low >= 0 && mv_low == max(t - 1, 0) / kChunk) ask_mv = --mv_low;
    if (!done && col_low >= 0 && col_low == min(max(j - 1, 0), qm1) / kChunk) ask_col = --col_low;
    stage(ask_mv, ask_col);
    cp_async_commit();
    cp_async_wait_one();  // the stages of the point before have landed
    __syncwarp();         // and the warp's lanes see them
    going = __any_sync(kFull, !done);
  }
  cp_async_wait_all();  // stages for walks that ended early
  if (!valid) return;
  if (t >= 1) {  // the walker's block, then the rows below it
    const int k = (t - 1) / kGroup;
    store_block(k);
    for (int m = sub; m < kGroup * k; m += kGroup) {
      cs[m] = 5;
      cwt[m] = 0;
      ib[m + 1] = -1;
      iw[m + 1] = 0;
    }
  }
  if (sub == 0) {
    ib[0] = i0_b;
    iw[0] = i0_w;
  }
}

bool supported(int T, int Q, int BW) { return T >= 1 && Q >= 1 && (BW == 128 || BW == 256); }
// K9 also takes the fragments a block its instantiation is built for
bool supported(int T, int Q, int BW, int per_block) {
  return supported(T, Q, BW) &&
         per_block == (BW == 128 ? Band<128>::kFwdFrags : Band<256>::kFwdFrags);
}

template <typename Kernel>
int launch_setup(Kernel kernel, long long B, int per_block, long long smem, unsigned* blocks) {
  // raised on every launch: the limit belongs to the current device.  The
  // card refuses a block past its shared memory here; the wrapper's
  // launch_plan picks the route so that it never asks for one
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

template <int BW, bool kGlobalCodes>
int launch_forward(const void* cw, const void* t_lens, const void* frags, const void* q_lens,
                   const void* r0, const void* r1, void* moves, void* offs, void* ends,
                   void* row0, long long B, int T, int Q, void* codes, cudaStream_t stream) {
  constexpr int kFwdFrags = Band<BW>::kFwdFrags;
  const long long words = kGlobalCodes ? row_words_smem(BW) : forward_words(Q, BW);
  const long long smem = static_cast<long long>(kFwdFrags) * words * 4;
  unsigned blocks = 0;
  const int err =
      launch_setup(nw_moves_banded_kernel<BW, kGlobalCodes>, B, kFwdFrags, smem, &blocks);
  if (err != 0) return err;
  nw_moves_banded_kernel<BW, kGlobalCodes>
      <<<blocks, 32 * kFwdWarps, static_cast<size_t>(smem), stream>>>(
          static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
          static_cast<const int32_t*>(frags), static_cast<const int32_t*>(q_lens),
          static_cast<const int32_t*>(r0), static_cast<const int32_t*>(r1),
          static_cast<uint32_t*>(moves), static_cast<int32_t*>(offs),
          static_cast<int32_t*>(ends), static_cast<int32_t*>(row0), B, T, Q,
          static_cast<uint32_t*>(codes));
  return static_cast<int>(cudaGetLastError());
}

template <int BW>
int launch_walk(const void* moves, const void* offs, const void* ends, const void* row0,
                const void* q_lens, const void* frags, const void* wts, void* col_sym,
                void* col_w, void* ins_b, void* ins_w, long long B, int T, int Q,
                cudaStream_t stream) {
  const long long smem = static_cast<long long>(kWalkFrags) * Band<BW>::kWalkBytes;
  unsigned blocks = 0;
  const int err = launch_setup(traceback_banded_kernel<BW>, B, kWalkFrags, smem, &blocks);
  if (err != 0) return err;
  traceback_banded_kernel<BW><<<blocks, 32 * kWalkWarps, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint32_t*>(moves), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(frags),
      static_cast<const int32_t*>(wts), static_cast<int32_t*>(col_sym),
      static_cast<int32_t*>(col_w), static_cast<int32_t*>(ins_b), static_cast<int32_t*>(ins_w),
      B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K9 on `stream` over B fragments at a band of BW = 128 or 256
// lanes (T, Q >= 1, and the packed codes of a block's fragments within its
// shared memory: Q up to 55,887 at 256): cw [B, T], frags [B, Q], t_lens,
// q_lens, r0, r1 [B] int32; moves [T, B, BW / 16], offs and ends [T, B],
// row0 [B] int32 out.  per_block, after the stream, is the fragments a
// block that the wrapper's launch_plan gave (16 at 128, 8 at 256); another
// count is refused.  Returns the CUDA error code of the launch (0 on
// success).
int raven_nw_moves_banded_launch(const void* cw, const void* t_lens, const void* frags,
                                 const void* q_lens, const void* r0, const void* r1,
                                 void* moves, void* offs, void* ends, void* row0,
                                 long long B, int T, int Q, int BW, void* stream,
                                 int per_block) {
  if (B == 0) return 0;
  if (!supported(T, Q, BW, per_block)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BW == 128) {
    return launch_forward<128, false>(cw, t_lens, frags, q_lens, r0, r1, moves, offs, ends,
                                      row0, B, T, Q, nullptr, st);
  }
  return launch_forward<256, false>(cw, t_lens, frags, q_lens, r0, r1, moves, offs, ends, row0,
                                    B, T, Q, nullptr, st);
}

// K9 with the packed codes in device memory, for any Q: as
// raven_nw_moves_banded_launch, with `codes` a scratch of B * 2 *
// code_words(Q, BW) 32-bit words.
int raven_nw_moves_banded_global_launch(const void* cw, const void* t_lens, const void* frags,
                                        const void* q_lens, const void* r0, const void* r1,
                                        void* moves, void* offs, void* ends, void* row0,
                                        void* codes, long long B, int T, int Q, int BW,
                                        void* stream, int per_block) {
  if (B == 0) return 0;
  if (!supported(T, Q, BW, per_block)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BW == 128) {
    return launch_forward<128, true>(cw, t_lens, frags, q_lens, r0, r1, moves, offs, ends,
                                     row0, B, T, Q, codes, st);
  }
  return launch_forward<256, true>(cw, t_lens, frags, q_lens, r0, r1, moves, offs, ends, row0,
                                   B, T, Q, codes, st);
}

// Launches K10 on `stream` over B fragments at a band of BW = 128 or 256
// lanes: K9's moves, offs, ends and row0, with q_lens, frags and wts [B, Q]
// int32; col_sym, col_w [B, T] and ins_b, ins_w [B, T + 1] int32 out.
// Returns the CUDA error code of the launch (0 on success).
int raven_traceback_banded_launch(const void* moves, const void* offs, const void* ends,
                                  const void* row0, const void* q_lens, const void* frags,
                                  const void* wts, void* col_sym, void* col_w, void* ins_b,
                                  void* ins_w, long long B, int T, int Q, int BW,
                                  void* stream) {
  if (B == 0) return 0;
  if (!supported(T, Q, BW)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BW == 128) {
    return launch_walk<128>(moves, offs, ends, row0, q_lens, frags, wts, col_sym, col_w, ins_b,
                            ins_w, B, T, Q, st);
  }
  return launch_walk<256>(moves, offs, ends, row0, q_lens, frags, wts, col_sym, col_w, ins_b,
                          ins_w, B, T, Q, st);
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
