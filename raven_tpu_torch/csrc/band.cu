// Shift-banded window consensus: kernel K3, the slope-1 banded NW forward,
// and kernel K4, the reverse row walk that turns each alignment into
// per-row votes.
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
// production launch ([4096, 640, 256]) against ~193 MB of traffic.  K4: its traffic (the end scores, the
// fragment rows, a move word a walked row, the vote rows) and the walk's
// serial length: a few dependent steps a row, 640 rows a fragment.
//
// Design (a first, simple version, for the engine's band of BW = 256):
//   * K3: one warp a fragment, four fragments a block; lane l holds band
//     lanes 8l .. 8l + 7 of the previous row in registers.  up reads the
//     next lane's first value by one __shfl_down_sync; the closure's prefix
//     max is a strip max plus a 5-step warp scan; the fragment's base codes
//     and the consensus codes sit in shared memory; each row's moves are
//     packed by a shuffle into whole words (64 bytes a row) and its end
//     score is written by the lane that holds column qlen.
//   * K4: one warp a fragment, the same lane layout; the walker's lane p is
//     warp-uniform.  Per walked row each lane reads its part of the row's
//     move words, the move at p comes by one shuffle, the slide is a ballot
//     over the lanes' candidate masks (the highest lane with a candidate,
//     then its highest candidate by __clz), and the fragment's bytes sit in
//     shared memory.  Votes and insertions are kept one row a lane and
//     written 32 rows at a time.
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
constexpr int kWarps = 4;          // fragments a block, one warp each
constexpr int C = 8;               // band lanes a lane of the warp
constexpr int BW = 32 * C;         // band lanes
constexpr int kHalf = BW / 2;
constexpr int kWords = BW / 16;    // move words a row, 2 lanes of the warp each

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// shared memory a warp uses: the fragment row [T + BW + 1] (both kernels)
// and the consensus codes [T] (K3)
__host__ __device__ constexpr int forward_bytes(int T) {
  return round16(T + BW + 1) + round16(T);
}
__host__ __device__ constexpr int walk_bytes(int T) { return round16(T + BW + 1); }

__global__ void __launch_bounds__(32 * kWarps)
band_forward_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ t_lens,
                    const uint8_t* __restrict__ fw_sh, const int32_t* __restrict__ q_lens,
                    const int32_t* __restrict__ r0s, uint32_t* __restrict__ moves,
                    int32_t* __restrict__ ends, int32_t* __restrict__ row0, long long B,
                    int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const int SW = T + BW + 1;
  uint8_t* s_fc = smem + static_cast<size_t>(warp) * forward_bytes(T);
  uint8_t* s_tc = s_fc + round16(SW);
  const uint8_t* f_row = fw_sh + b * SW;
  for (int i = lane; i < SW; i += 32) s_fc[i] = f_row[i] & 3;
  const int32_t* c_row = cw + b * T;
  for (int t = lane; t < T; t += 32) {
    const int c = c_row[t];
    // a code outside 0-3 never equals a fragment base
    s_tc[t] = (c >= 0 && c <= 3) ? static_cast<uint8_t>(c) : 0xFF;
  }
  __syncwarp();

  const int ql = q_lens[b];
  const int tl = t_lens[b];
  const int r0 = r0s[b];
  const int u0 = lane * C;
  int prev[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = u0 + i - kHalf - r0;
    prev[i] = (j >= 0 && j <= ql) ? j * kGap : kNeg;
  }
  if (lane == 0) row0[b] = ql * kGap;
  const size_t row_words = static_cast<size_t>(B) * kWords;
  uint32_t* mv_out = moves + b * kWords + lane / 2;
  int32_t* end_out = ends + b;
  for (int r = 0; r < T; ++r) {
    const int jb = r + 1 + u0 - kHalf - r0;  // j of my first lane on DP row r + 1
    const int tch = s_tc[r];
    const uint8_t* fc = s_fc + r + 1 + u0;
    const int up_in = __shfl_down_sync(kFull, prev[0], 1);  // the next lane's first
    int e[C];
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int dg = prev[i] + (fc[i] == tch ? kMatch : kMismatch);
      const int up = (i + 1 < C ? prev[i + 1] : (lane == 31 ? kNeg : up_in)) + kGap;
      int v = dg;
      uint32_t m = 0;
      if (dg < up) {
        v = up;
        m = 1;
      }
      if (jb + i == 0) {  // the free consensus prefix
        v = 0;
        m = 1;
      }
      e[i] = v;
      bits |= m << (2 * i);
    }
    // the left closure: inclusive prefix max of e + 4u over the band
    int pm[C];
    int run = INT_MIN;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      run = max(run, e[i] - kGap * (u0 + i));
      pm[i] = run;
    }
    int scan = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, scan, o);
      if (lane >= o) scan = max(scan, v);
    }
    int carry = __shfl_up_sync(kFull, scan, 1);
    if (lane == 0) carry = INT_MIN;
    int endv = kNeg;
    bool own = false;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int closed = max(pm[i], carry) + kGap * (u0 + i);
      int cur = e[i];
      if (closed > cur) {
        cur = closed;
        bits = (bits & ~(3u << (2 * i))) | (2u << (2 * i));
      }
      const int j = jb + i;
      if (j < 0 || j > ql) cur = kNeg;
      prev[i] = cur;
      if (j == ql) {
        own = true;
        endv = max(cur, kNeg);
      }
    }
    // the row's end score: from the lane of column qlen, or NEG from lane 0
    // when that column is outside the band
    const int uq = ql + kHalf + r0 - (r + 1);
    if (own || (lane == 0 && (uq < 0 || uq >= BW))) {
      end_out[static_cast<size_t>(r) * B] = own && r < tl ? endv : kNeg;
    }
    // a move word holds the 16 band lanes of two neighbouring lanes
    const uint32_t w = bits | (__shfl_down_sync(kFull, bits, 1) << 16);
    if ((lane & 1) == 0) mv_out[static_cast<size_t>(r) * row_words] = w;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
band_walk_kernel(const uint32_t* __restrict__ moves, const int32_t* __restrict__ ends,
                 const int32_t* __restrict__ row0, const uint8_t* __restrict__ fw_sh,
                 const int32_t* __restrict__ q_lens, const int32_t* __restrict__ r0s,
                 int32_t* __restrict__ votes, int32_t* __restrict__ ins, long long B, int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const int SW = T + BW + 1;
  uint8_t* s_fw = smem + static_cast<size_t>(warp) * walk_bytes(T);
  const uint8_t* f_row = fw_sh + b * SW;
  for (int i = lane; i < SW; i += 32) s_fw[i] = f_row[i];
  __syncwarp();
  const int ql = q_lens[b];
  const int r0 = r0s[b];

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

  const int u0 = lane * C;
  const uint32_t* mv_in = moves + b * kWords + lane / 2;
  const int sh = 16 * (lane & 1);
  const size_t row_words = static_cast<size_t>(B) * kWords;
  int32_t* v_out = votes + b * T;
  int32_t* i_out = ins + b * (T + 1);
  int p = -1;  // the walker's lane (warp-uniform), -1: no walk
  int vreg = 0, ireg = 0;  // this lane's row of the 32-row chunk in flight
  for (int r = T; r >= 1; --r) {
    if (r == t0) {
      const int ui = ql + kHalf + r0 - r;
      if (ui >= 0 && ui < BW) p = ui;
    }
    int vote = 0, insv = 0;
    if (p >= 0) {
      const uint32_t bits = (mv_in[static_cast<size_t>(r - 1) * row_words] >> sh) & 0xFFFFu;
      const int ulo = 1 + kHalf + r0 - r;  // the lowest lane with j >= 1
      const uint32_t bp = __shfl_sync(kFull, bits, p / C);
      if (((bp >> (2 * (p % C))) & 3u) == 2u && p >= ulo) insv = 1 | (s_fw[r + p] << 1);
      // my lanes in [ulo, p] whose move is not left: the low bit of each
      // 2-bit field
      const int lo = max(ulo - u0, 0);
      const int hi = min(p - u0, C - 1);
      uint32_t cand = 0;
      if (lo <= hi) {
        const uint32_t span = ((1u << (2 * hi + 2)) - 1u) & ~((1u << (2 * lo)) - 1u);
        cand = ~((bits >> 1) & ~bits) & span & 0x55555555u;
      }
      const unsigned who = __ballot_sync(kFull, cand != 0);
      if (who == 0) {
        p = -1;
      } else {
        const int src = 31 - __clz(who);
        const int q = __shfl_sync(kFull, u0 + (31 - __clz(cand)) / 2, src);
        const uint32_t bq = __shfl_sync(kFull, bits, src);
        const int mvq = static_cast<int>((bq >> (2 * (q - src * C))) & 3u);
        const int fq = s_fw[r + q];
        vote = 1 | ((mvq == 0 ? (fq & 3) : 4) << 1) | ((fq >> 2) << 4);
        const int nxt = mvq == 0 ? q : q + 1;
        p = nxt < BW && nxt + r - kHalf - r0 > 1 ? nxt : -1;
      }
    }
    if (lane == ((r - 1) & 31)) vreg = vote;
    if (lane == (r & 31)) ireg = insv;
    if (((r - 1) & 31) == 0 && r - 1 + lane < T) v_out[r - 1 + lane] = vreg;
    if ((r & 31) == 0 && r + lane <= T) i_out[r + lane] = ireg;
  }
  if (t0 == 0) {
    const int ui = ql + kHalf + r0;
    if (ui >= 0 && ui < BW) p = ui;
  }
  const int i0 = p >= 0 && p - kHalf - r0 >= 1 ? 1 | (s_fw[p] << 1) : 0;
  if (lane == 0) ireg = i0;
  if (lane <= T) i_out[lane] = ireg;
}

template <typename Kernel>
int launch_setup(Kernel kernel, long long B, long long smem, unsigned* blocks) {
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n = (B + kWarps - 1) / kWarps;
  if (n > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

int launch_forward(const void* cw, const void* t_lens, const void* fw_sh, const void* q_lens,
                   const void* r0, void* moves, void* ends, void* row0, long long B, int T,
                   cudaStream_t stream) {
  const long long smem = static_cast<long long>(kWarps) * forward_bytes(T);
  unsigned blocks = 0;
  const int err = launch_setup(band_forward_kernel, B, smem, &blocks);
  if (err != 0) return err;
  band_forward_kernel<<<blocks, 32 * kWarps, static_cast<size_t>(smem), stream>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(t_lens),
      static_cast<const uint8_t*>(fw_sh), static_cast<const int32_t*>(q_lens),
      static_cast<const int32_t*>(r0), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(ends), static_cast<int32_t*>(row0), B, T);
  return static_cast<int>(cudaGetLastError());
}

int launch_walk(const void* moves, const void* ends, const void* row0, const void* fw_sh,
                const void* q_lens, const void* r0, void* votes, void* ins, long long B, int T,
                cudaStream_t stream) {
  const long long smem = static_cast<long long>(kWarps) * walk_bytes(T);
  unsigned blocks = 0;
  const int err = launch_setup(band_walk_kernel, B, smem, &blocks);
  if (err != 0) return err;
  band_walk_kernel<<<blocks, 32 * kWarps, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint32_t*>(moves), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(row0), static_cast<const uint8_t*>(fw_sh),
      static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(r0),
      static_cast<int32_t*>(votes), static_cast<int32_t*>(ins), B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over B fragments at BW = 256: cw [B, T], t_lens,
// q_lens, r0 [B] int32, fw_sh [B, T + 257] uint8; moves [T, B, 16], ends
// [T, B] and row0 [B] int32 out.  Returns the CUDA error code of the launch
// (0 on success).
int raven_band_forward_launch(const void* cw, const void* t_lens, const void* fw_sh,
                              const void* q_lens, const void* r0, void* moves, void* ends,
                              void* row0, long long B, int T, void* stream) {
  if (B == 0) return 0;
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_forward(cw, t_lens, fw_sh, q_lens, r0, moves, ends, row0, B, T,
                        static_cast<cudaStream_t>(stream));
}

// Launches K4 on `stream` over B fragments at BW = 256: K3's moves, ends and
// row0, with fw_sh, q_lens and r0 as K3 took them; votes [B, T] and ins [B,
// T + 1] int32 out.  Returns the CUDA error code of the launch (0 on
// success).
int raven_band_walk_launch(const void* moves, const void* ends, const void* row0,
                           const void* fw_sh, const void* q_lens, const void* r0, void* votes,
                           void* ins, long long B, int T, void* stream) {
  if (B == 0) return 0;
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk(moves, ends, row0, fw_sh, q_lens, r0, votes, ins, B, T,
                     static_cast<cudaStream_t>(stream));
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
