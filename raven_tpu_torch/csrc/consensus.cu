// Window-consensus vote primitives, kernel K2: per fragment, a full-
// rectangle NW against its window consensus, the traceback, and one vote
// primitive per consensus row.
//
// Replaces the TPU kernel raven_tpu/ops/pallas_consensus.py::
// pallas_votes_primitives (_consensus_block_kernel, _prefix_max_lanes) and
// computes what it computes, bit for bit.  For fragment b with consensus
// cw[b, :tlen] and fragment frags[b, :qlen]:
//
//   D[0][j] = j*GAP, D[r][0] = 0 (free consensus prefix); loop row r uses
//   cw[r]: diag = D[r-1][j-1] + (frag[j-1] == cw[r] ? 3 : -5),
//   up = D[r-1][j] - 4, e = max(diag, up) (move diag when diag >= up);
//   the left closure cm = inclusive prefix max over j of (e - j*GAP),
//   closed = max(cm, 0) + j*GAP, move left only when closed > e.
//   The walk starts at column qlen, at row 0 when qlen*GAP >= the best end
//   value over the active rows, else one below the first row holding it;
//   it writes col[t-1] = 1 | sym<<1 | w<<4 on diag (sym = fragment base)
//   and up (sym = 4), and ins[t] = 1 | base<<1 | w<<3 where a run of left
//   moves starts (in walk order).  Outputs decode as the TPU wrapper does:
//   col_sym 5 / col_w 0 / ins_b -1 / ins_w 0 where nothing was written.
//
// Rows at or past tlen and columns past qlen never reach an output (the
// walk starts at or above row tlen and at column qlen, and column j depends
// only on columns <= j), so the kernel runs rows r < tlen only; a fragment
// with qlen 0 writes nothing.
//
// What bounds it on an H100: integer instructions.  The forward needs some
// 14 per DP cell at the fewest (compare and select of the substitution
// score, two adds, the diag/up max and its move bit, the closure's
// subtract, running max, clamp, add, compare and select, and the 2-bit
// move pack); the moves, 2 bits a cell, are the only large traffic and
// take about a fifth of that time at the card's memory rate.  Design: one
// warp per fragment, four fragments per block.  Each lane owns a strip of
// C consecutive columns (C = ceil(Q/32) rounded up to a multiple of 4, a
// template parameter, so the strip lives in registers).  A row takes the
// left neighbour's previous value through __shfl_up_sync, computes diag
// and up for its strip right to left in place, then the prefix max of the
// closure as a serial max within the strip and a 5-step warp scan across
// strips.  Each lane writes its row of 2-bit moves as C/16 words
// (neighbouring lanes on neighbouring words) to a global scratch; lane 0
// then walks the traceback from those words, with the window consensus
// row and the per-row vote primitives in shared memory, and the warp
// writes the four decoded outputs with neighbouring lanes on neighbouring
// addresses.  The walk is serial (tlen + qlen dependent loads at most) and
// leaves 31 lanes idle; it is this first version's known cost.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (see raven_tpu_torch/csrc/__init__.py); the launcher returns
// the CUDA error code and the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // fragments per block
constexpr int kMatch = 3;
constexpr int kMismatch = -5;
constexpr int kGap = -4;
constexpr int kNeg = -(1 << 20);   // no end value yet
constexpr int kNeg2 = -(1 << 26);  // below any closure value
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxQ = 32 * 32;

__host__ __device__ constexpr int words_per_lane(int c) { return (c + 15) / 16; }

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
votes_primitives_kernel(const int32_t* __restrict__ cw,
                        const int32_t* __restrict__ tlens,
                        const int32_t* __restrict__ frags,
                        const int32_t* __restrict__ qlens,
                        const int32_t* __restrict__ wts,
                        uint32_t* __restrict__ moves,
                        int32_t* __restrict__ col_sym,
                        int32_t* __restrict__ col_w,
                        int32_t* __restrict__ ins_b,
                        int32_t* __restrict__ ins_w,
                        long long B, int T, int Q) {
  constexpr int WPL = words_per_lane(C);
  constexpr int ROW_WORDS = 32 * WPL;
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // whole warps only
  int32_t* s_cw = smem + warp * (3 * T + 1);  // [T] window consensus
  int32_t* s_col = s_cw + T;                  // [T] packed column votes
  int32_t* s_ins = s_col + T;                 // [T + 1] packed insertions

  const int tlen = min(max(tlens[b], 0), T);
  const int qlen = min(max(qlens[b], 0), Q);
  const int32_t* cw_row = cw + b * T;
  for (int t = lane; t < T; t += 32) {
    s_cw[t] = cw_row[t];
    s_col[t] = 0;
  }
  for (int t = lane; t <= T; t += 32) s_ins[t] = 0;
  __syncwarp();

  if (qlen > 0) {  // warp-uniform
    const int32_t* f_row = frags + b * Q;
    const int j0 = lane * C;  // array column of strip slot 0 (DP column j0+1)
    int fc[C];
    int prev[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int col = j0 + i;
      fc[i] = col < Q ? f_row[col] : -1;  // columns past Q never reach an output
      prev[i] = (col + 1) * kGap;         // DP row 0
    }
    const int lane_q = (qlen - 1) / C;
    const int iq = (qlen - 1) % C;
    int best_val = kNeg;
    int best_r = 0;
    uint32_t* mv_lane = moves + static_cast<size_t>(b) * T * ROW_WORDS + lane * WPL;

    for (int r = 0; r < tlen; ++r) {
      const int tch = s_cw[r];
      int left = __shfl_up_sync(kFull, prev[C - 1], 1);
      if (lane == 0) left = 0;  // D[r-1][0] = 0
      uint32_t up_bits = 0;
      int lmax = kNeg2;
      // diag / up, right to left so prev[i-1] is still the previous row
#pragma unroll
      for (int i = C - 1; i >= 0; --i) {
        const int pj1 = i > 0 ? prev[i - 1] : left;
        const int diag = pj1 + (fc[i] == tch ? kMatch : kMismatch);
        const int up = prev[i] + kGap;
        if (up > diag) up_bits |= 1u << i;
        const int e = max(diag, up);
        prev[i] = e;
        lmax = max(lmax, e - (j0 + i + 1) * kGap);
      }
      // exclusive prefix max of the strips' maxima across the warp
      int incl = lmax;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl = max(incl, o);
      }
      int run = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) run = kNeg2;
      // left closure within the strip, moves packed 16 per word
      uint32_t w[WPL];
#pragma unroll
      for (int k = 0; k < WPL; ++k) w[k] = 0;
      int endv = kNeg;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int jg = (j0 + i + 1) * kGap;
        const int e = prev[i];
        run = max(run, e - jg);
        const int closed = max(run, 0) + jg;
        uint32_t mv = (up_bits >> i) & 1u;
        if (closed > e) {
          mv = 2u;
          prev[i] = closed;
        }
        w[i / 16] |= mv << (2 * (i % 16));
        if (i == iq) endv = prev[i];
      }
#pragma unroll
      for (int k = 0; k < WPL; ++k) mv_lane[static_cast<size_t>(r) * ROW_WORDS + k] = w[k];
      if (lane == lane_q && endv > best_val) {  // the first max row wins
        best_val = endv;
        best_r = r;
      }
    }
    best_val = __shfl_sync(kFull, best_val, lane_q);
    best_r = __shfl_sync(kFull, best_r, lane_q);
    __syncwarp();  // the moves of every lane are visible to lane 0

    if (lane == 0) {
      const int32_t* w_row = wts + b * Q;
      const uint32_t* mv_frag = moves + static_cast<size_t>(b) * T * ROW_WORDS;
      int t = qlen * kGap >= best_val ? 0 : best_r + 1;
      int j = qlen;
      int prev_mv = 3;
      while (j > 0) {
        int mv = 2;  // row 0: left only
        if (t > 0) {
          const int c = j - 1;
          const int i = c % C;
          const uint32_t word =
              mv_frag[static_cast<size_t>(t - 1) * ROW_WORDS + (c / C) * WPL + i / 16];
          mv = (word >> (2 * (i % 16))) & 3u;
        }
        const int fb = min(max(f_row[j - 1], 0), 3);
        const int fw = w_row[j - 1];
        if (mv <= 1) {
          s_col[t - 1] = 1 | ((mv == 0 ? fb : 4) << 1) | (fw << 4);
          --t;
        } else if (prev_mv != 2) {
          s_ins[t] = 1 | (fb << 1) | (fw << 3);
        }
        if (mv != 1) --j;
        prev_mv = mv;
      }
    }
    __syncwarp();
  }

  int32_t* cs = col_sym + b * T;
  int32_t* cwt = col_w + b * T;
  for (int t = lane; t < T; t += 32) {
    const int p = s_col[t];
    cs[t] = (p & 1) ? ((p >> 1) & 7) : 5;
    cwt[t] = (p & 1) ? (p >> 4) : 0;
  }
  int32_t* ib = ins_b + b * (T + 1);
  int32_t* iw = ins_w + b * (T + 1);
  for (int t = lane; t <= T; t += 32) {
    const int p = s_ins[t];
    ib[t] = (p & 1) ? ((p >> 1) & 3) : -1;
    iw[t] = (p & 1) ? (p >> 3) : 0;
  }
}

int strip_width(int Q) {
  const int c = (Q + 31) / 32;
  return ((c + 3) / 4) * 4;
}

template <int C>
int launch(const void* cw, const void* tlens, const void* frags,
           const void* qlens, const void* wts, void* moves, void* col_sym,
           void* col_w, void* ins_b, void* ins_w, long long B, int T, int Q,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * (3 * T + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        votes_primitives_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (B + kWarps - 1) / kWarps;
  votes_primitives_kernel<C><<<static_cast<unsigned int>(blocks), kWarps * 32,
                               smem, stream>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(frags), static_cast<const int32_t*>(qlens),
      static_cast<const int32_t*>(wts), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(col_sym), static_cast<int32_t*>(col_w),
      static_cast<int32_t*>(ins_b), static_cast<int32_t*>(ins_w), B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 32-bit words of move scratch the launcher needs for [B, T, Q] (0 when
// the shape is not supported: Q outside 1..1024 or T < 1).
long long raven_votes_moves_words(long long B, int T, int Q) {
  if (Q < 1 || Q > kMaxQ || T < 1) return 0;
  return B * T * 32LL * words_per_lane(strip_width(Q));
}

// Launches K2 on `stream` over B fragments: cw [B, T], frags and wts
// [B, Q], tlens and qlens [B], all int32; moves is the scratch of
// raven_votes_moves_words(B, T, Q) words; col_sym, col_w [B, T] and ins_b,
// ins_w [B, T + 1] int32 out.  Returns the CUDA error code of the launch
// (0 on success).
int raven_votes_primitives_launch(const void* cw, const void* tlens,
                                  const void* frags, const void* qlens,
                                  const void* wts, void* moves, void* col_sym,
                                  void* col_w, void* ins_b, void* ins_w,
                                  long long B, int T, int Q, void* stream) {
  if (B == 0) return 0;
  if (Q < 1 || Q > kMaxQ || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAVEN_K2_CASE(C)                                                      \
  case C:                                                                     \
    return launch<C>(cw, tlens, frags, qlens, wts, moves, col_sym, col_w,     \
                     ins_b, ins_w, B, T, Q, s);
  switch (strip_width(Q)) {
    RAVEN_K2_CASE(4)
    RAVEN_K2_CASE(8)
    RAVEN_K2_CASE(12)
    RAVEN_K2_CASE(16)
    RAVEN_K2_CASE(20)
    RAVEN_K2_CASE(24)
    RAVEN_K2_CASE(28)
    RAVEN_K2_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RAVEN_K2_CASE
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
