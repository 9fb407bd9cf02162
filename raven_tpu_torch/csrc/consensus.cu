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
//   value over the active rows (from NEG = -2^20: no row when none exceeds
//   it, and then row 0 stands in), else one below the first row holding it;
//   it writes col[t-1] = 1 | sym<<1 | w<<4 on diag (sym = fragment base)
//   and up (sym = 4), and ins[t] = 1 | base<<1 | w<<3 where a run of left
//   moves starts (in walk order).  Outputs decode as the TPU wrapper does:
//   col_sym 5 / col_w 0 / ins_b -1 / ins_w 0 where nothing was written.
//
// The closure is the linear-gap recurrence D[r][j] = max(e[j], D[r][j-1] +
// GAP) with D[r][0] = 0, and "left when closed > e" is D[r][j-1] + GAP >
// e[j]: the same integers and the same ties.  Rows at or past tlen and
// columns past qlen never reach an output, so they are not needed.
//
// Values: D lies in [-4Q, 3Q].  The kernel keeps D'[r][j] = D[r][j] - 3r
// + 0xC000 in 16 bits: the row shift folds the match score into the row
// (diag' = D'[r-1][j-1] - 8 on a mismatch, up' = D'[r-1][j] - 7, left' =
// D'[r][j-1] - 4; every comparison of a row is shifted alike, so the moves
// and their ties are unchanged), and the bias keeps every value in [8,
// 0xFFFF] while 4Q + 3T + 8 <= 0xC000, so that unsigned 16-bit pair
// max/min and plain 32-bit adds and subtracts of two packed values never
// carry between the halves.  The launcher refuses Q > 1024 and T past that
// bound.  Fragment and consensus codes are compared on their low 16 bits,
// as the plain version compares them in int16 (the codes are 0-3, pads
// -1).
//
// What bounds it on an H100: integer instructions.  On Hopper's 16-bit
// pair instructions (DPX) a pair of cells needs at the fewest 8: the
// substitution score's compare and select, the diag add, the up add and
// max with its which-won predicate, the left add and max with its
// predicate, and one pack of the predicates into move bits; so 4 a cell.
// The moves, 2 bits a cell, are the only large traffic.  The integer ALU
// pipe takes a warp instruction every other cycle on each scheduler, so
// the pair instructions that only it runs (the score compare, the add-max
// pairs, the 0/1 tests of the move bits) set the forward's pace; the adds,
// subtracts and the bit packing go to the IMAD pipe beside it.
//
// Design:
//   * Two fragments a warp (rows 2p and 2p+1 of the chunk), one in each
//     16-bit half of every register; the add-max pairs are one VIADDMNMX
//     each, the rest splits between the integer and the IMAD pipes.  Each
//     half keeps its own tlen, qlen, best end value and walk.
//   * Lane-pipelined rows: the warp sweeps a tile of 256 columns, each
//     lane a strip of 8 in registers, and at step s lane l computes row
//     s - l over its strip (e right to left, then the closure as the
//     recurrence above left to right), so one __shfl_up_sync a step hands
//     each lane its left neighbour's last column; no scan, one sweep.  The
//     fill is 31 steps.  The row's consensus codes come from shared memory
//     a step ahead.
//   * Column tiles sized to the fragment: the pair takes ceil(max(qlen) /
//     256) tiles, each half's columns aligned so that its column qlen is
//     the tile row's last (lane 31, slot 7).  The columns left of a
//     half's column 1 are held at D'[r][0].  Lane 31's last column goes to
//     shared memory each row: it is the next tile's left boundary and,
//     after the last tile, every row's end value, from which the warp
//     takes the best row.
//   * Moves: one 32-bit word per lane and step (8 columns x 2 halves x 2
//     bits), stored at (step, lane), so a step's 32 stores are one
//     128-byte line.  Code 3 (up and left both won) reads as left.  The
//     move bits are taken before the positions left of a half's column 1
//     are held at D'[r][0] (see forward_tile).
//   * The walk: lane 0 walks half 0 and lane 1 half 1.  When a walker
//     leaves its box of moves, the warp loads, for both walkers in one
//     batch, the box ahead of each (64 steps x 8 lanes of one tile: the
//     rows above and the columns to the left) into shared memory; a walker
//     then steps in shared memory, its box position updated move by move,
//     with the fragment's bases and weights staged there too.  One memory
//     round trip per ~55 moves, not per move.
//   * One warp a block; shared memory per warp is ~6T + 2Q words, so a
//     T = 640 chunk holds ~10 warps an SM, more than the 8 a 2,048-row
//     chunk puts there.  Registers (~128 a thread) are not the limit.
//
// The int32 route (votes_primitives_i32_kernel), for every shape the pair
// route refuses: Q > 1024, 4Q + 3T + 8 > 0xC000 (the 16-bit range), or a
// warp's 6T + 2Q + 99 words past a block's 227 KB of shared memory (T >
// 9,412 at Q = 768, which binds before the 16-bit range does).  The
// wrapper's launch_plan picks the route and its fragments a block from the
// shape, and the launcher takes both.  From Q * |GAP| > 2^20 on, every end
// value can fall below NEG (D >= -4Q), and raven_tpu's two K2 versions pick
// the walk's row differently there: its Pallas kernel as above, its XLA
// engine (fused_votes_kernel) by jnp.argmax over all T rows with NEG at
// and past tlen, so that row tlen, inactive, wins once every active value
// is below NEG, and a walk from there reads move 3 and casts nothing.  The
// route takes the rule as a template argument (the wrapper passes the one
// of the raven_tpu function its caller stands for); the pair route's
// shapes never reach NEG, so it has one.  One fragment a
// warp, one cell to a 32-bit value: D itself, no row shift and no bias, the
// moves and ties of the plain version (which is int32 already).  The rows
// are the pair route's lane-pipelined 256-column tiles (8 columns a lane,
// the add-max pairs one scalar VIADDMNMX each), with each half's 2-bit
// fields in one 16-bit move word a lane and step; the traceback is the pair
// route's, one walker (lane 0) in 64-step x 8-lane boxes of moves loaded by
// the warp into shared memory.  Nothing that grows with T or Q is in shared
// memory: the consensus codes are read from device memory a step ahead (a
// step's 32 lanes read 32 neighbouring words), the tile boundary column
// (each row's end value after the last tile) goes to a scratch of T + 1
// words a fragment in device memory (lane 31 writes a row, lane 0 of the
// next tile reads it a step ahead, a 128-byte line serving 32 rows), the
// fragment's bases and weights are read where the walk reaches them, and
// the walk writes each primitive to the outputs, which the warp first fills
// with "no vote".  Values stay within 4 (T + Q) of 0.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (see raven_tpu_torch/csrc/__init__.py); the launcher returns
// the CUDA error code and the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kC = 8;               // columns a lane
constexpr int kTile = 32 * kC;      // columns a tile
constexpr int kMatch = 3;
constexpr int kMismatch = -5;
constexpr int kGap = -4;
constexpr int kNeg = -(1 << 20);    // no end value yet
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxQ = 1024;
constexpr int kBoxRows = 64;        // move-storage steps a traceback box holds
constexpr int kBoxLanes = 8;        // lanes (8 columns each) a box holds
constexpr int kBox = kBoxRows * kBoxLanes;
constexpr uint32_t kGap2 = 0xFFFCFFFCu;  // GAP in both halves
constexpr uint32_t kUp2 = 0xFFF9FFF9u;   // GAP - MATCH in both halves
constexpr uint32_t kOnes = 0x00010001u;
constexpr uint32_t kRow2 = 0x00030003u;  // MATCH in both halves
constexpr int kBias = 0xC000;            // added to every stored DP value

// max(a + b, c) per unsigned 16-bit half: one VIADDMNMX
__device__ __forceinline__ uint32_t addmax2(uint32_t a, uint32_t b, uint32_t c) {
  return __viaddmax_u16x2(a, b, c);
}

// 1 in each 16-bit half of x that is not 0, else 0
__device__ __forceinline__ uint32_t nonzero2(uint32_t x) { return __vminu2(x, kOnes); }

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

// DP row 0 at strip position p: column j = p - off + 1 of each half holds
// j*GAP, and the positions left of column 1 hold D[0][0] = 0
__device__ __forceinline__ uint32_t row0(int p, int off0, int off1) {
  const int j0 = p - off0 + 1, j1 = p - off1 + 1;
  return pack2(kBias + (j0 >= 1 ? j0 * kGap : 0), kBias + (j1 >= 1 ? j1 * kGap : 0));
}

// D'[r][0] = -MATCH*r in both halves, biased
__device__ __forceinline__ uint32_t col0(int r) {
  return pack2(kBias, kBias) - static_cast<uint32_t>(r) * kRow2;
}

// One tile of the forward: steps 0 .. tmax + 30, lane `lane` on row
// s - lane.  kMasked holds the positions left of a half's column 1 at
// D'[r][0].
template <bool kMasked>
__device__ __forceinline__ void forward_tile(
    const uint32_t (&fc)[kC], uint32_t (&prev)[kC], const uint32_t (&keep)[kC],
    uint32_t dleft, const uint32_t* s_cw, uint32_t* s_bnd, uint32_t* mv_tile,
    int lane, bool first_tile, int tmax) {
  uint32_t lin = 0;
  // this step's consensus codes and (lane 0) left boundary, loaded a step
  // ahead so the shared-memory latency stays off the row's critical path
  uint32_t tch = s_cw[-lane];  // padded: no clamp
  uint32_t bnd = first_tile ? 0u : s_bnd[1];
  uint32_t* mvp = mv_tile + lane;
  for (int s = 0; s < tmax + 31; ++s) {
    const int rho = s - lane;
    const uint32_t fill = col0(rho + 1);  // D'[rho + 1][0]
    if (lane == 0) lin = first_tile ? fill : bnd;
    const uint32_t tch_next = s_cw[rho + 1];
    const uint32_t bnd_next = lane == 0 && !first_tile ? s_bnd[rho + 2] : 0u;
    if (rho >= 0 && rho < tmax) {
      // e right to left (each column reads the previous row's values at
      // its own and its left neighbour's column), then the closure and the
      // move bits left to right, writing the row over the previous one
      uint32_t ev[kC], dg[kC];
#pragma unroll
      for (int i = kC - 1; i >= 0; --i) {
        const uint32_t dl = i > 0 ? prev[i - 1] : dleft;  // D'[rho][column - 1]
        // diag' = D'[rho][column - 1], less MATCH - MISMATCH where the
        // codes differ (the row shift holds the MATCH)
        dg[i] = dl - (nonzero2(fc[i] ^ tch) << 3);
        ev[i] = addmax2(prev[i], kUp2, dg[i]);
      }
      uint32_t left = lin;  // D'[rho + 1][strip - 1]
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        uint32_t d = addmax2(left, kGap2, ev[i]);
        word += nonzero2(ev[i] - dg[i]) << (2 * i);  // up won
        word += nonzero2(d - ev[i]) << (2 * i + 1);  // left won
        // the mask after the move bits: in each half d >= ev, so the
        // subtraction above never borrows across the halves.  A held value
        // (D'[r][0]) can lie below ev (a pad code -1 past a half's
        // consensus "matches" the masked fragment code -1), and a borrow
        // from the low half would set the high half's left bit.
        if (kMasked) d = (d & keep[i]) | (fill & ~keep[i]);
        prev[i] = d;
        left = d;
      }
      dleft = lin;
      *mvp = word;
      if (lane == 31) s_bnd[rho + 1] = prev[kC - 1];
    }
    tch = tch_next;
    bnd = bnd_next;
    mvp += 32;
    lin = __shfl_up_sync(kFull, prev[kC - 1], 1);
  }
}

// the shapes whose stored values D - 3r + kBias all lie in [8, 0xFFFF]
constexpr bool supported(int T, int Q) {
  return Q >= 1 && Q <= kMaxQ && T >= 1 && 4LL * Q + 3LL * T + 8 <= kBias;
}

__host__ __device__ constexpr int tiles(int Q) { return (Q + kTile - 1) / kTile; }

// the forward's part of a warp's shared memory (s_cw with 32 words of pad
// on either side, s_bnd with 32 past its end), which the walk's boxes reuse
__host__ __device__ constexpr int forward_words(int T) {
  return 2 * T + 97 > 2 * kBox ? 2 * T + 97 : 2 * kBox;
}

__host__ __device__ constexpr long long smem_words(int T, int Q) {
  return forward_words(T) + 2LL * Q + 4LL * T + 2;
}

__global__ void __launch_bounds__(32, 16)
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
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x;
  const long long pair = blockIdx.x;
  const long long b0 = 2 * pair;
  const int T31 = T + 31;  // move-storage steps a tile
  const int fw = forward_words(T);
  uint32_t* s_cw = smem + 32;        // [T] both halves' consensus codes (forward)
  uint32_t* s_bnd = smem + T + 64;   // [T + 1] last column of a tile (forward)
  uint32_t* s_box = smem;       // [2][kBox] traceback boxes (walk)
  int32_t* s_pk = reinterpret_cast<int32_t*>(smem + fw);  // [2][Q] base | w<<2
  int32_t* s_col = s_pk + 2 * Q;                          // [2][T]
  int32_t* s_ins = s_col + 2 * T;                         // [2][T + 1]

  int tl[2], ql[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long b = b0 + h;
    tl[h] = b < B ? min(max(tlens[b], 0), T) : 0;
    ql[h] = b < B ? min(max(qlens[b], 0), Q) : 0;
  }
  const bool has1 = b0 + 1 < B;
  // a half without fragment bases needs no row (its walk writes nothing)
  const int tmax = max(ql[0] > 0 ? tl[0] : 0, ql[1] > 0 ? tl[1] : 0);
  const int kt = tiles(max(ql[0], ql[1]));
  const int off0 = kt * kTile - ql[0];
  const int off1 = kt * kTile - ql[1];

  const int32_t* cw0 = cw + b0 * T;
  const int32_t* cw1 = cw0 + T;
  for (int t = lane; t < T; t += 32) {
    s_cw[t] = pack2(cw0[t], has1 ? cw1[t] : 0);
    s_col[t] = 0;
    s_col[T + t] = 0;
  }
  for (int t = lane; t <= T; t += 32) {
    s_ins[t] = 0;
    s_ins[T + 1 + t] = 0;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int32_t* f_row = frags + (b0 + h) * Q;
    const int32_t* w_row = wts + (b0 + h) * Q;
    for (int j = lane; j < ql[h]; j += 32) {
      s_pk[h * Q + j] = static_cast<int32_t>(
          static_cast<uint32_t>(min(max(f_row[j], 0), 3)) |
          (static_cast<uint32_t>(w_row[j]) << 2));
    }
  }
  __syncwarp();

  // forward, tile by tile
  uint32_t* mv_pair = moves + static_cast<size_t>(pair) * tiles(Q) * T31 * 32;
  const int32_t* f0 = frags + b0 * Q;
  const int32_t* f1 = f0 + Q;
  for (int k = 0; k < kt; ++k) {
    const int p0 = k * kTile + lane * kC;
    uint32_t fc[kC], prev[kC], keep[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c0 = p0 + i - off0, c1 = p0 + i - off1;  // fragment columns
      fc[i] = pack2(c0 >= 0 ? f0[c0] : -1, c1 >= 0 ? f1[c1] : -1);
      prev[i] = row0(p0 + i, off0, off1);
      keep[i] = (c0 >= 0 ? 0x0000FFFFu : 0u) | (c1 >= 0 ? 0xFFFF0000u : 0u);
    }
    const uint32_t dleft = row0(p0 - 1, off0, off1);  // D'[0][strip - 1]
    uint32_t* mv_tile = mv_pair + static_cast<size_t>(k) * T31 * 32;
    if (k * kTile < max(off0, off1)) {
      forward_tile<true>(fc, prev, keep, dleft, s_cw, s_bnd, mv_tile, lane,
                         k == 0, tmax);
    } else {
      forward_tile<false>(fc, prev, keep, dleft, s_cw, s_bnd, mv_tile, lane,
                          k == 0, tmax);
    }
    __syncwarp();
  }

  // best end value per half over its rows: the first maximal row wins
  int best_v[2], best_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v = kNeg, r = 0;
    const int rows = ql[h] > 0 ? tl[h] : 0;
    for (int rr = lane; rr < rows; rr += 32) {
      const int x = static_cast<int>((s_bnd[rr + 1] >> (16 * h)) & 0xFFFFu) -
                    kBias + 3 * (rr + 1);
      if (x > v) {
        v = x;
        r = rr;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ov = __shfl_xor_sync(kFull, v, o);
      const int orr = __shfl_xor_sync(kFull, r, o);
      if (ov > v || (ov == v && orr < r)) {
        v = ov;
        r = orr;
      }
    }
    best_v[h] = v;
    best_r[h] = r;
  }
  __syncwarp();  // the boxes overwrite s_cw and s_bnd

  // the walks: lane 0 on half 0, lane 1 on half 1
  const int h = lane & 1;
  const int off = h ? off1 : off0;
  int wt = 0, wj = 0, wprev = 3;
  if (lane < 2) {
    wj = ql[h];
    wt = ql[h] * kGap >= best_v[h] ? 0 : best_r[h] + 1;
  }
  int bk = -1, bs0 = 0, bl0 = 0;  // the walker's box: tile, first step, first lane
  const uint32_t* my_box = s_box + h * kBox;
  int32_t* my_col = s_col + h * T;
  int32_t* my_ins = s_ins + h * (T + 1);
  const int32_t* my_pk = s_pk + h * Q;
  while (true) {
    const bool walking = lane < 2 && wj > 0;
    int k = 0, s = 0, lam = 0;
    bool need = false;
    if (walking && wt > 0) {
      const unsigned p = wj - 1 + off;  // strip position of column j
      k = p / kTile;
      lam = (p / kC) % 32;
      s = wt - 1 + lam;
      need = k != bk || static_cast<unsigned>(lam - bl0) >= kBoxLanes ||
             static_cast<unsigned>(s - bs0) >= kBoxRows;
    }
    if (__ballot_sync(kFull, walking) == 0) break;
    // when one walker leaves its box, both take a new one, in one batch
    const unsigned needs = __ballot_sync(kFull, need);
    const unsigned reading = __ballot_sync(kFull, walking && wt > 0);
    if (needs != 0) {  // warp-uniform
      uint32_t v[2][kBox / 32];
      bool fetch[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        fetch[hh] = (reading >> hh) & 1u;
        const int fk = __shfl_sync(kFull, k, hh);
        const int s0 = max(__shfl_sync(kFull, s, hh) - (kBoxRows - 1), 0);
        const int l0 = max(__shfl_sync(kFull, lam, hh) - (kBoxLanes - 1), 0);
        if (lane == hh && fetch[hh]) {
          bk = fk;
          bs0 = s0;
          bl0 = l0;
        }
        const uint32_t* src = mv_pair + static_cast<size_t>(fk) * T31 * 32;
#pragma unroll
        for (int m = 0; m < kBox / 32; ++m) {
          const int e = lane + 32 * m;
          const int sr = s0 + e / kBoxLanes;
          v[hh][m] = fetch[hh] && sr < T31
                         ? src[static_cast<size_t>(sr) * 32 + l0 + e % kBoxLanes]
                         : 0u;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!fetch[hh]) continue;
#pragma unroll
        for (int m = 0; m < kBox / 32; ++m) s_box[hh * kBox + lane + 32 * m] = v[hh][m];
      }
    }
    __syncwarp();
    if (walking) {
      // the walker's column as a strip position, and its step and lane in
      // the box, kept up to date move by move (the box holds it on entry)
      unsigned p = wj - 1 + off;
      int bl = static_cast<int>((p / kC) % 32) - bl0;
      int bs = wt - 1 + bl + bl0 - bs0;
      uint32_t word = wt > 0 ? my_box[bs * kBoxLanes + bl] : 0u;  // under the walker
      while (wj > 0) {
        const int32_t pk = my_pk[wj - 1];
        const bool edge = p % kC == 0;  // a move left leaves the lane's strip
        // the words the next position can fall on, loaded before the move
        // is known so that the load is off the walk's critical path: one
        // step up (up, and diag within the strip), and one step up or two
        // steps up in the lane to the left (left and diag out of the strip)
        const int iu = (bs - 1) * kBoxLanes + bl;
        const uint32_t w_up = bs >= 1 ? my_box[iu] : 0u;
        const uint32_t w_dg = edge && bs >= 2 && bl >= 1 ? my_box[iu - kBoxLanes - 1] : 0u;
        const uint32_t w_lf = edge && bs >= 1 && bl >= 1 ? my_box[iu - 1] : 0u;
        // row 0: left only
        const uint32_t mv = wt > 0 ? min((word >> (16 * h + 2 * (p % kC))) & 3u, 2u) : 2u;
        const uint32_t fb = static_cast<uint32_t>(pk) & 3u;
        const uint32_t fwt = static_cast<uint32_t>(pk >> 2);
        const bool vote = mv <= 1;
        const bool ins = mv == 2 && wprev != 2;
        if (vote) my_col[wt - 1] = static_cast<int32_t>(1u | ((mv == 0 ? fb : 4u) << 1) | (fwt << 4));
        if (ins) my_ins[wt] = static_cast<int32_t>(1u | (fb << 1) | (fwt << 3));
        const int dt = vote ? 1 : 0;
        const int dj = mv != 1 ? 1 : 0;
        const int wrap = dj && edge ? 1 : 0;
        wt -= dt;
        wj -= dj;
        p -= dj;
        bl -= wrap;
        bs -= dt + wrap;
        wprev = static_cast<int>(mv);
        word = mv == 1 ? w_up : mv == 0 ? (edge ? w_dg : w_up) : (edge ? w_lf : word);
        if (wt > 0 && wj > 0 && (bs | bl) < 0) break;  // past the box: the warp loads the next
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long b = b0 + hh;
    if (b >= B) break;
    int32_t* cs = col_sym + b * T;
    int32_t* cwt = col_w + b * T;
    for (int t = lane; t < T; t += 32) {
      const int p = s_col[hh * T + t];
      cs[t] = (p & 1) ? ((p >> 1) & 7) : 5;
      cwt[t] = (p & 1) ? (p >> 4) : 0;
    }
    int32_t* ib = ins_b + b * (T + 1);
    int32_t* iw = ins_w + b * (T + 1);
    for (int t = lane; t <= T; t += 32) {
      const int p = s_ins[hh * (T + 1) + t];
      ib[t] = (p & 1) ? ((p >> 1) & 3) : -1;
      iw[t] = (p & 1) ? (p >> 3) : 0;
    }
  }
}

// ------------------------------------------------------------ int32 route

// One tile of the int32 route's forward: as forward_tile, one fragment,
// D unshifted; moves one 16-bit word a lane and step.
template <bool kMasked>
__device__ __forceinline__ void forward_tile_i32(
    const int (&fc)[kC], int (&prev)[kC], uint32_t keep, int dleft, const int32_t* c_row,
    int32_t* bnd, uint16_t* mv_tile, int lane, bool first_tile, int tmax, int T) {
  int lin = 0;
  // this step's consensus code and (lane 0) left boundary, loaded a step
  // ahead; rows outside the consensus read 0 and are never computed
  auto code = [&](int t) { return t >= 0 && t < T ? c_row[t] : 0; };
  int tch = code(-lane);
  int bndv = first_tile || tmax < 1 ? 0 : bnd[1];
  uint16_t* mvp = mv_tile + lane;
  for (int s = 0; s < tmax + 31; ++s) {
    const int rho = s - lane;
    if (lane == 0) lin = first_tile ? 0 : bndv;  // D[rho + 1][0] = 0
    const int tch_next = code(rho + 1);
    const int bnd_next = lane == 0 && !first_tile && rho + 2 <= tmax ? bnd[rho + 2] : 0;
    if (rho >= 0 && rho < tmax) {
      int ev[kC], dg[kC];
#pragma unroll
      for (int i = kC - 1; i >= 0; --i) {
        const int dl = i > 0 ? prev[i - 1] : dleft;  // D[rho][column - 1]
        dg[i] = dl + (fc[i] == tch ? kMatch : kMismatch);
        ev[i] = __viaddmax_s32(prev[i], kGap, dg[i]);
      }
      int left = lin;  // D[rho + 1][strip - 1]
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        int d = __viaddmax_s32(left, kGap, ev[i]);
        if (kMasked && !((keep >> i) & 1u)) d = 0;  // left of column 1: D[r][0]
        word |= static_cast<uint32_t>(ev[i] != dg[i]) << (2 * i);      // up won
        word |= static_cast<uint32_t>(d != ev[i]) << (2 * i + 1);      // left won
        prev[i] = d;
        left = d;
      }
      dleft = lin;
      *mvp = static_cast<uint16_t>(word);
      if (lane == 31) bnd[rho + 1] = prev[kC - 1];
    }
    tch = tch_next;
    bndv = bnd_next;
    mvp += 32;
    lin = __shfl_up_sync(kFull, prev[kC - 1], 1);
  }
}

// kArgmax picks the walk's start row by raven_tpu's jnp.argmax (the
// engine's fused_votes_kernel), else by its Pallas kernel's rule
template <bool kArgmax>
__global__ void __launch_bounds__(32)
votes_primitives_i32_kernel(const int32_t* __restrict__ cw,
                            const int32_t* __restrict__ tlens,
                            const int32_t* __restrict__ frags,
                            const int32_t* __restrict__ qlens,
                            const int32_t* __restrict__ wts,
                            uint16_t* __restrict__ moves,
                            int32_t* bnd_all,
                            int32_t* __restrict__ col_sym,
                            int32_t* __restrict__ col_w,
                            int32_t* __restrict__ ins_b,
                            int32_t* __restrict__ ins_w,
                            long long B, int T, int Q) {
  __shared__ uint16_t s_box[kBox];  // the walker's box of moves
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const int tl = min(max(tlens[b], 0), T);
  const int ql = min(max(qlens[b], 0), Q);
  // a fragment without bases needs no row (its walk writes nothing); the
  // active rows are its consensus rows, and row 0 is computed for an empty
  // consensus too (the Pallas rule's walk can start at row 1 there)
  const int tact = ql > 0 ? tl : 0;
  const int tmax = ql > 0 ? max(tl, 1) : 0;
  const int kt = tiles(ql);
  const int off = kt * kTile - ql;  // column qlen is the last tile's last
  const int T31 = T + 31;
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
  const int32_t* c_row = cw + b * T;
  const int32_t* f_row = frags + b * Q;
  const int32_t* w_row = wts + b * Q;
  int32_t* bnd = bnd_all + b * (T + 1);
  uint16_t* mv_frag = moves + static_cast<size_t>(b) * tiles(Q) * T31 * 32;

  // forward, tile by tile
  for (int k = 0; k < kt; ++k) {
    const int p0 = k * kTile + lane * kC;
    int fc[kC], prev[kC];
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int c = p0 + i - off;  // fragment column, j = c + 1
      fc[i] = c >= 0 ? f_row[c] : -1;
      prev[i] = c >= 0 ? (c + 1) * kGap : 0;  // row 0
      keep |= static_cast<uint32_t>(c >= 0) << i;
    }
    const int jl = p0 - off;  // column j of position p0 - 1
    const int dleft = jl >= 1 ? jl * kGap : 0;
    uint16_t* mv_tile = mv_frag + static_cast<size_t>(k) * T31 * 32;
    if (k * kTile < off) {
      forward_tile_i32<true>(fc, prev, keep, dleft, c_row, bnd, mv_tile, lane, k == 0, tmax, T);
    } else {
      forward_tile_i32<false>(fc, prev, keep, dleft, c_row, bnd, mv_tile, lane, k == 0, tmax, T);
    }
    __syncwarp();
  }

  // the best end value over the rows, the first maximal row winning.
  // The Pallas rule: over the active rows, from NEG (row 0 when no value
  // exceeds NEG).  The argmax rule: over all T rows, NEG at and past
  // tlen, so that row tlen stands for the inactive ones.
  int best_v = kArgmax ? INT_MIN : kNeg, best_r = 0;
  const int rows = kArgmax ? min(tact + 1, T) : tact;
  for (int rr = lane; rr < rows; rr += 32) {
    const int x = !kArgmax || rr < tact ? bnd[rr + 1] : kNeg;
    if (x > best_v) {
      best_v = x;
      best_r = rr;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best_v, o);
    const int orr = __shfl_xor_sync(kFull, best_r, o);
    if (ov > best_v || (ov == best_v && orr < best_r)) {
      best_v = ov;
      best_r = orr;
    }
  }

  // the walk, lane 0; the warp loads its boxes
  int wt = 0, wj = 0, wprev = 3;
  if (lane == 0) {
    wj = ql;
    wt = ql * kGap >= best_v ? 0 : best_r + 1;
    // the argmax rule's walk from a row past the consensus reads move 3
    // (inactive) there and casts nothing
    if (kArgmax && wt > tact) wj = 0;
  }
  int bk = -1, bs0 = 0, bl0 = 0;  // the walker's box: tile, first step, first lane
  while (true) {
    const bool walking = lane == 0 && wj > 0;
    int k = 0, s = 0, lam = 0;
    bool need = false;
    if (walking && wt > 0) {
      const unsigned p = wj - 1 + off;  // strip position of column j
      k = p / kTile;
      lam = (p / kC) % 32;
      s = wt - 1 + lam;
      need = k != bk || static_cast<unsigned>(lam - bl0) >= kBoxLanes ||
             static_cast<unsigned>(s - bs0) >= kBoxRows;
    }
    if (__ballot_sync(kFull, walking) == 0) break;
    if (__shfl_sync(kFull, need, 0)) {  // warp-uniform
      const int fk = __shfl_sync(kFull, k, 0);
      const int s0 = max(__shfl_sync(kFull, s, 0) - (kBoxRows - 1), 0);
      const int l0 = max(__shfl_sync(kFull, lam, 0) - (kBoxLanes - 1), 0);
      if (lane == 0) {
        bk = fk;
        bs0 = s0;
        bl0 = l0;
      }
      const uint16_t* src = mv_frag + static_cast<size_t>(fk) * T31 * 32;
      uint16_t v[kBox / 32];
#pragma unroll
      for (int m = 0; m < kBox / 32; ++m) {
        const int e = lane + 32 * m;
        const int sr = s0 + e / kBoxLanes;
        v[m] = sr < T31 ? src[static_cast<size_t>(sr) * 32 + l0 + e % kBoxLanes] : 0;
      }
#pragma unroll
      for (int m = 0; m < kBox / 32; ++m) s_box[lane + 32 * m] = v[m];
    }
    __syncwarp();
    if (walking) {
      // the walker's column as a strip position, and its step and lane in
      // the box, kept up to date move by move (the box holds it on entry)
      unsigned p = wj - 1 + off;
      int bl = static_cast<int>((p / kC) % 32) - bl0;
      int bs = wt - 1 + bl + bl0 - bs0;
      uint32_t word = wt > 0 ? s_box[bs * kBoxLanes + bl] : 0u;  // under the walker
      while (wj > 0) {
        const uint32_t pk = static_cast<uint32_t>(min(max(f_row[wj - 1], 0), 3)) |
                            (static_cast<uint32_t>(w_row[wj - 1]) << 2);
        const bool edge = p % kC == 0;  // a move left leaves the lane's strip
        // the words the next position can fall on, loaded before the move
        // is known (as in the pair route's walk)
        const int iu = (bs - 1) * kBoxLanes + bl;
        const uint32_t w_up = bs >= 1 ? s_box[iu] : 0u;
        const uint32_t w_dg = edge && bs >= 2 && bl >= 1 ? s_box[iu - kBoxLanes - 1] : 0u;
        const uint32_t w_lf = edge && bs >= 1 && bl >= 1 ? s_box[iu - 1] : 0u;
        // row 0: left only; code 3 (up and left both won) reads as left
        const uint32_t mv = wt > 0 ? min((word >> (2 * (p % kC))) & 3u, 2u) : 2u;
        const uint32_t fb = pk & 3u;
        const uint32_t fwt = static_cast<uint32_t>(static_cast<int32_t>(pk) >> 2);
        const bool vote = mv <= 1;
        const bool ins = mv == 2 && wprev != 2;
        // the pair route's packed primitives, decoded as it decodes them
        if (vote) {
          const int pc = static_cast<int32_t>(1u | ((mv == 0 ? fb : 4u) << 1) | (fwt << 4));
          cs[wt - 1] = (pc >> 1) & 7;
          cwt[wt - 1] = pc >> 4;
        }
        if (ins) {
          const int pi = static_cast<int32_t>(1u | (fb << 1) | (fwt << 3));
          ib[wt] = (pi >> 1) & 3;
          iw[wt] = pi >> 3;
        }
        const int dt = vote ? 1 : 0;
        const int dj = mv != 1 ? 1 : 0;
        const int wrap = dj && edge ? 1 : 0;
        wt -= dt;
        wj -= dj;
        p -= dj;
        bl -= wrap;
        bs -= dt + wrap;
        wprev = static_cast<int>(mv);
        word = mv == 1 ? w_up : mv == 0 ? (edge ? w_dg : w_up) : (edge ? w_lf : word);
        if (wt > 0 && wj > 0 && (bs | bl) < 0) break;  // past the box: the warp loads the next
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches K2's int32 route on `stream` over B fragments, one a block
// (per_block 1), for T, Q >= 1 with 4 (T + Q) + 1024 in int32: inputs and
// outputs as raven_votes_primitives_launch; moves a scratch of a 16-bit
// word a lane and step (T + 31 steps a tile, ceil(Q / 256) tiles a
// fragment), bnd one of B * (T + 1) int32.  argmax non-zero picks the
// walk's start row by raven_tpu's jnp.argmax, else by its Pallas kernel's
// rule.
int raven_votes_primitives_i32_launch(const void* cw, const void* tlens, const void* frags,
                                      const void* qlens, const void* wts, void* moves,
                                      void* bnd, void* col_sym, void* col_w, void* ins_b,
                                      void* ins_w, long long B, int T, int Q, void* stream,
                                      int per_block, int argmax) {
  if (B == 0) return 0;
  if (T < 1 || Q < 1 || per_block != 1 || B > 0x7FFFFFFFLL ||
      4LL * (static_cast<long long>(T) + Q) + 1024 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = argmax ? votes_primitives_i32_kernel<true> : votes_primitives_i32_kernel<false>;
  kernel<<<static_cast<unsigned>(B), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(frags), static_cast<const int32_t*>(qlens),
      static_cast<const int32_t*>(wts), static_cast<uint16_t*>(moves),
      static_cast<int32_t*>(bnd), static_cast<int32_t*>(col_sym), static_cast<int32_t*>(col_w),
      static_cast<int32_t*>(ins_b), static_cast<int32_t*>(ins_w), B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit words of move scratch the launcher needs for [B, T, Q] (0 when
// the shape is not supported: Q outside 1..1024, T < 1, or 4Q + 3T + 8 >
// 49152).
long long raven_votes_moves_words(long long B, int T, int Q) {
  if (!supported(T, Q)) return 0;
  return (B + 1) / 2 * tiles(Q) * (T + 31LL) * 32;
}

// Launches K2's pair route on `stream` over B fragments, two a block
// (per_block 2): cw [B, T], frags and wts [B, Q], tlens and qlens [B], all
// int32; moves is the scratch of raven_votes_moves_words(B, T, Q) words;
// col_sym, col_w [B, T] and ins_b, ins_w [B, T + 1] int32 out.  per_block
// comes after the stream, as the wrapper's launch_plan gives it, so that a
// build without the argument ignores it; the card refuses a warp's shared
// memory past a block's, which launch_plan never asks for.  Returns the
// CUDA error code of the launch (0 on success).
int raven_votes_primitives_launch(const void* cw, const void* tlens,
                                  const void* frags, const void* qlens,
                                  const void* wts, void* moves, void* col_sym,
                                  void* col_w, void* ins_b, void* ins_w,
                                  long long B, int T, int Q, void* stream, int per_block) {
  if (B == 0) return 0;
  if (!supported(T, Q) || per_block != 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_words(T, Q) * static_cast<long long>(sizeof(uint32_t));
  if (smem > 48 * 1024) {
    if (smem > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        votes_primitives_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check to report
      return static_cast<int>(e);
    }
  }
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  votes_primitives_kernel<<<static_cast<unsigned int>(blocks), 32,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cw), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(frags), static_cast<const int32_t*>(qlens),
      static_cast<const int32_t*>(wts), static_cast<uint32_t*>(moves),
      static_cast<int32_t*>(col_sym), static_cast<int32_t*>(col_w),
      static_cast<int32_t*>(ins_b), static_cast<int32_t*>(ins_w), B, T, Q);
  return static_cast<int>(cudaGetLastError());
}

const char* raven_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
