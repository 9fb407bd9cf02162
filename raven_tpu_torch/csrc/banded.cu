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
//   diag = prev[i + d - 1] + (frags[j - 1] == cw[r] ? 3 : -5), up =
//   prev[i + d] - 4, e = max, move diag when diag >= up;
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
// What bounds them on an H100.  K9: integer instructions.  Each band cell
// needs at the fewest K3's 10 (the score's compare and select, the diag add,
// the up add fused with the max, the which-won predicate, the closure as one
// add-max, the left predicate, the domain's compare and select, one pack of
// the move bits), plus the regather of two previous-row values, which in
// this layout is shared-memory traffic; 335 M cells at the engine's chunk
// ([2048, 640, 256]) against ~107 MB of traffic.  K10: the serial walk,
// up to T + Q dependent steps a fragment, and its traffic (the end scores,
// the primitives written whole, a move word and band start a walked row).
//
// Design (first version: simple and right; the engine's band of BW = 256):
//   * K9.  One warp a fragment, four a block; lane l holds band lanes
//     8l .. 8l + 7.  The fragment (with the pad at j == 0) and the previous
//     row live in shared memory, each word s at s + s / 8, so that the 32
//     lanes reading 8 consecutive words each hit 32 different banks; the
//     regather by any d is then an indexed read, NEG outside the band.  The
//     consensus codes come 32 rows at a time, one a lane, and each row's by
//     one shuffle.  The left closure is a 5-step warp max-scan of each
//     lane's max of e + 4i, then a running max over the lane's 8 cells.
//     Each lane packs its 8 moves into 16 bits; the even lane of a pair
//     writes the pair's word, so a fragment's row (64 bytes) goes out in one
//     coalesced store.  Rows past the consensus are written as constants
//     without a DP.
//   * K10.  One warp a fragment, four a block.  The warp writes the four
//     primitive rows as "no vote" (coalesced), packs the fragment's bases
//     and weights (base | weight << 2, as raven_tpu packs them) into shared
//     memory, finds the best end row by a strided read and a warp argmax
//     (the first maximal row), then stages 32 move rows (2 KB) and their
//     band starts into shared memory ahead of the walker, lane 0 walks them
//     from shared memory and writes its votes over the "no vote" entries,
//     and the warp stages the next 32 rows when the walker leaves them.
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
constexpr int BW = 256;           // band lanes
constexpr int kCells = BW / 32;   // K9: band lanes a lane holds
static_assert(kCells == 8, "K9 packs a lane's moves into 16 bits");
constexpr int kWords = BW / 16;   // move words a row
constexpr int kWarps = 4;         // warps a block, both kernels
constexpr int kStage = 32;        // K10: move rows a stage holds
constexpr int kMaxQ = 8192;       // the longest padded fragment taken

// shared-memory word of logical index s: one padding word every 8, so that
// lanes reading 8 consecutive words each land on distinct banks
__host__ __device__ constexpr int pad(int s) { return s + (s >> 3); }
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// words of shared memory a warp uses
__host__ __device__ constexpr int forward_words(int Q) {
  return round4(pad(Q) + 1) + round4(pad(BW - 1) + 1);
}
__host__ __device__ constexpr int walk_words(int Q) {
  return round4(Q) + kStage * kWords + kStage;
}

__device__ __forceinline__ int band_start(int r, int tl1, int r0, int span, int q, int hi) {
  const int row = min(r + 1, tl1);
  // a negative numerator clips to 0 whether the division floors or truncates
  int c = (row - r0) * q / span;
  c = min(max(c, 0), q);
  return min(max(c - BW / 2, 0), hi);
}

__global__ void __launch_bounds__(32 * kWarps)
nw_moves_banded_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                       const int32_t* __restrict__ frags, const int32_t* __restrict__ q_lens,
                       const int32_t* __restrict__ r0s, const int32_t* __restrict__ r1s,
                       uint32_t* __restrict__ moves, int32_t* __restrict__ offs,
                       int32_t* __restrict__ ends, int32_t* __restrict__ row0, long long B,
                       int T, int Q) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  int* s_f = smem + warp * forward_words(Q);  // fragment code of column j at pad(j)
  int* s_p = s_f + round4(pad(Q) + 1);        // previous row, band lane i at pad(i)
  const int32_t* f_row = frags + b * Q;
  for (int j = lane; j <= Q; j += 32) s_f[pad(j)] = j == 0 ? -1 : f_row[j - 1];

  const int tl = t_lens[b], ql = q_lens[b], r0 = r0s[b];
  const int span = max(r1s[b] - r0, 1);
  const int q = min(ql, Q);
  const int hi = max(Q + 1 - BW, 0);
  const int tl1 = max(tl, 1);
  const int i0 = lane * kCells;  // my first band lane
  int off_prev = band_start(-1, tl1, r0, span, q, hi);
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int j = off_prev + i0 + c;
    s_p[pad(i0 + c)] = j <= ql ? j * kGap : kNeg;
  }
  if (lane == 0) row0[b] = ql <= Q ? ql * kGap : kNeg;
  __syncwarp();

  const int32_t* c_row = cw + b * T;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_out = moves + b * kWords + (lane >> 1);
  int tc_buf = 0;
  int r = 0;
  for (; r < T && r < tl; ++r) {
    if ((r & 31) == 0) tc_buf = r + lane < T ? c_row[r + lane] : -1;
    const int tch = __shfl_sync(kFull, tc_buf, r & 31);
    const int off = band_start(r, tl1, r0, span, q, hi);
    const int base = off - off_prev + i0 - 1;  // previous-row lane of my first diag
    int pv[kCells + 1];
#pragma unroll
    for (int k = 0; k <= kCells; ++k) {
      const int s = base + k;
      pv[k] = (s >= 0 && s < BW) ? s_p[pad(s)] : kNeg;
    }
    __syncwarp();  // every read of the previous row is done before it is overwritten
    const int jb = off + i0;  // column of my first band lane
    int e[kCells];
    int mv[kCells];
    int vmax = INT_MIN;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int dg = pv[c] + (s_f[pad(jb + c)] == tch ? kMatch : kMismatch);
      const int up = pv[c + 1] + kGap;
      const bool take_diag = dg >= up;
      e[c] = take_diag ? dg : up;
      mv[c] = take_diag ? 0 : 1;
      if (jb + c == 0) {  // the free consensus prefix
        e[c] = 0;
        mv[c] = 1;
      }
      vmax = max(vmax, e[c] - kGap * (i0 + c));
    }
    // the left closure: an exclusive max-scan of e - GAP i over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vmax, o);
      if (lane >= o) vmax = max(vmax, y);
    }
    int run = __shfl_up_sync(kFull, vmax, 1);
    if (lane == 0) run = INT_MIN;
    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      run = max(run, e[c] - kGap * (i0 + c));
      const int closed = run + kGap * (i0 + c);
      int cur = e[c];
      if (closed > cur) {
        cur = closed;
        mv[c] = 2;
      }
      if (jb + c > ql) cur = kNeg;
      s_p[pad(i0 + c)] = cur;
      bits |= static_cast<uint32_t>(mv[c]) << (2 * c);
    }
    const uint32_t hi_bits = __shfl_down_sync(kFull, bits, 1);
    if ((lane & 1) == 0) mv_out[r * row_words] = bits | (hi_bits << 16);
    __syncwarp();  // the row is whole before its end score is read
    if (lane == 0) {
      const int iq = ql - off;
      ends[r * B + b] = (iq >= 0 && iq < BW) ? s_p[pad(iq)] : kNeg;
      offs[r * B + b] = off;
    }
    off_prev = off;
  }
  // rows past the consensus: the previous row kept, move 3 everywhere
  for (; r < T; ++r) {
    if (lane < kWords) moves[r * row_words + b * kWords + lane] = 0xFFFFFFFFu;
    if (lane == 0) {
      ends[r * B + b] = kNeg;
      offs[r * B + b] = off_prev;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
traceback_banded_kernel(const uint32_t* __restrict__ moves, const int32_t* __restrict__ offs,
                        const int32_t* __restrict__ ends, const int32_t* __restrict__ row0,
                        const int32_t* __restrict__ q_lens, const int32_t* __restrict__ frags,
                        const int32_t* __restrict__ wts, int32_t* __restrict__ col_sym,
                        int32_t* __restrict__ col_w, int32_t* __restrict__ ins_b,
                        int32_t* __restrict__ ins_w, long long B, int T, int Q) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  int* s_pk = smem + warp * walk_words(Q);  // base | weight << 2 of fragment column q
  uint32_t* s_mv = reinterpret_cast<uint32_t*>(s_pk + round4(Q));  // staged move rows
  int* s_off = reinterpret_cast<int*>(s_mv + kStage * kWords);       // their band starts

  int32_t* cs = col_sym + b * T;
  int32_t* cwt = col_w + b * T;
  int32_t* ib = ins_b + b * (T + 1);
  int32_t* iw = ins_w + b * (T + 1);
  for (int t = lane; t < T; t += 32) {
    cs[t] = 5;
    cwt[t] = 0;
  }
  for (int t = lane; t <= T; t += 32) {
    ib[t] = -1;
    iw[t] = 0;
  }
  for (int k = lane; k < Q; k += 32) {
    const int f = frags[b * Q + k];
    s_pk[k] = min(max(f, 0), 3) | (wts[b * Q + k] << 2);
  }
  // the best end row: the first row holding the maximum
  int best = INT_MIN, best_r = 0;
  for (int r = lane; r < T; r += 32) {
    const int v = ends[r * B + b];
    if (v > best) {
      best = v;
      best_r = r;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, o);
    const int orow = __shfl_xor_sync(kFull, best_r, o);
    if (ov > best || (ov == best && orow < best_r)) {
      best = ov;
      best_r = orow;
    }
  }
  int t = row0[b] >= best ? 0 : best_r + 1;
  int j = q_lens[b];
  int prev_mv = 3;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  while (true) {
    // stage the move rows top - kStage + 1 .. top below the walker
    const int top = max(t - 1, 0);
    const int lo = max(top - kStage + 1, 0);
    for (int k = lane; k < kStage * kWords; k += 32) {
      const int row = lo + k / kWords;
      if (row <= top) s_mv[k] = moves[row * row_words + b * kWords + k % kWords];
    }
    if (lo + lane <= top) s_off[lane] = offs[(lo + lane) * B + b];
    __syncwarp();
    int done = 0;
    if (lane == 0) {
      while (true) {
        if (j <= 0) {
          done = 1;
          break;
        }
        const int ti = max(t - 1, 0);
        if (ti < lo) break;  // past the staged rows
        const int i = j - s_off[ti - lo];
        // outside the band: a stall on the top row, else a stop; both end
        // the walk without a vote, as does a row past the consensus (3)
        if (i < 0 || i >= BW) {
          done = 1;
          break;
        }
        const int mv = t == 0 ? 2 : (s_mv[(ti - lo) * kWords + (i >> 4)] >> (2 * (i & 15))) & 3;
        if (mv == 3) {
          done = 1;
          break;
        }
        const int p = s_pk[min(max(j - 1, 0), Q - 1)];
        if (mv <= 1) {
          cs[t - 1] = mv == 0 ? (p & 3) : 4;
          cwt[t - 1] = p >> 2;
          --t;
        } else if (prev_mv != 2) {
          ib[t] = p & 3;
          iw[t] = p >> 2;
        }
        if (mv != 1) --j;
        prev_mv = mv;
      }
    }
    done = __shfl_sync(kFull, done, 0);
    if (done) break;
    t = __shfl_sync(kFull, t, 0);
    j = __shfl_sync(kFull, j, 0);
    prev_mv = __shfl_sync(kFull, prev_mv, 0);
    __syncwarp();  // the walker is done with the stage before it is refilled
  }
}

bool supported(int T, int Q) { return T >= 1 && Q >= BW - 1 && Q <= kMaxQ; }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Launches K9 on `stream` over B fragments at BW = 256 (needs 255 <= Q <=
// 8192, T >= 1): cw [B, T], frags [B, Q], t_lens, q_lens, r0, r1 [B] int32;
// moves [T, B, 16], offs and ends [T, B], row0 [B] int32 out.  Returns the
// CUDA error code of the launch (0 on success).
int raven_nw_moves_banded_launch(const void* cw, const void* t_lens, const void* frags,
                                 const void* q_lens, const void* r0, const void* r1,
                                 void* moves, void* offs, void* ends, void* row0,
                                 long long B, int T, int Q, void* stream) {
  if (B == 0) return 0;
  if (!supported(T, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(kWarps) * forward_words(Q) * 4;
  cudaError_t e = set_smem(nw_moves_banded_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  nw_moves_banded_kernel<<<static_cast<unsigned int>(blocks), 32 * kWarps,
                           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
      static_cast<const int32_t*>(frags), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<const int32_t*>(r1),
      static_cast<uint32_t*>(moves), static_cast<int32_t*>(offs), static_cast<int32_t*>(ends),
      static_cast<int32_t*>(row0), B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

// Launches K10 on `stream` over B fragments at BW = 256: K9's moves, offs,
// ends and row0, with q_lens, frags and wts [B, Q] int32; col_sym, col_w
// [B, T] and ins_b, ins_w [B, T + 1] int32 out.  Returns the CUDA error
// code of the launch (0 on success).
int raven_traceback_banded_launch(const void* moves, const void* offs, const void* ends,
                                  const void* row0, const void* q_lens, const void* frags,
                                  const void* wts, void* col_sym, void* col_w, void* ins_b,
                                  void* ins_w, long long B, int T, int Q, void* stream) {
  if (B == 0) return 0;
  if (!supported(T, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(kWarps) * walk_words(Q) * 4;
  cudaError_t e = set_smem(traceback_banded_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  traceback_banded_kernel<<<static_cast<unsigned int>(blocks), 32 * kWarps,
                            static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(moves), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(frags),
      static_cast<const int32_t*>(wts), static_cast<int32_t*>(col_sym),
      static_cast<int32_t*>(col_w), static_cast<int32_t*>(ins_b), static_cast<int32_t*>(ins_w),
      B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
