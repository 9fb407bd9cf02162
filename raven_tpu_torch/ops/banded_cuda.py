"""Anchored banded window consensus: the CUDA kernels K9 (banded NW forward)
and K10 (banded walk), their plain PyTorch versions, and the fused votes.

`nw_moves_banded(cw, t_lens, frags, q_lens, r0, r1, T, Q, BW)` is the port
of raven_tpu/ops/consensus_device.py::nw_moves_banded_kernel, and
`traceback_banded(moves, offs, end_scores, row0_score, q_lens, frags, wts,
T, Q, BW)` the port of its traceback_banded_kernel followed by the path
decoding of _votes_from_paths: it returns K2's per-fragment vote
primitives, so that consensus_cuda.votes_from_primitives sums the tables
of both device engines.  On a CUDA tensor each launches its hand-written
kernel in raven_tpu_torch/csrc/banded.cu (see the note there for what
bounds it and how the design answers that) or raises; on a CPU tensor each
runs its plain version, the same function in torch ops.  Integer outputs
are bit-identical to raven_tpu's.

`fused_votes_banded` is the drop-in for raven_tpu's
fused_votes_banded_kernel.  `LAUNCHES` counts kernel launches per kernel,
so a run can show that its main path went through the kernels, and
`ROUTE_LAUNCHES` per route: K9 holds a block's packed fragments in shared
memory ("nw_moves_banded") while they fit, and in device memory past that
("nw_moves_banded_global"), as `launch_plan` picks from the shape.
"""

from __future__ import annotations

import ctypes

import torch

from raven_tpu_torch.csrc import SMEM_BYTES
from raven_tpu_torch.ops.consensus_cuda import votes_from_primitives

NEG = -(1 << 20)
MATCH, MISMATCH, GAP = 3, -5, -4
# the band widths the kernels take, raven_tpu's min(256, pow2(q_pad)): K9
# holds 16 band lanes a lane, 16 lanes a fragment at 256 and 8 at 128
KERNEL_BWS = (128, 256)
FWD_FRAGS = {128: 16, 256: 8}  # K9's fragments a block
LAUNCHES = {"nw_moves_banded": 0, "traceback_banded": 0}
ROUTE_LAUNCHES = {"nw_moves_banded": 0, "nw_moves_banded_global": 0, "traceback_banded": 0}


def _band_offsets(t_lens, q_lens, r0, r1, T: int, Q: int, BW: int):
    """offs[r, b]: the first fragment column of DP row r + 1's band for
    r = -1 .. T-1 ([T + 1, B] int32), before the freeze past the consensus
    end.  The band centres on the fragment's anchored diagonal, (row - r0)
    * qlen / (r1 - r0) with qlen cut to Q, and starts BW/2 before it,
    clipped to [0, max(Q + 1 - BW, 0)]; the row stops at the consensus
    end."""
    dev = q_lens.device
    span = (r1 - r0).clamp(min=1)[None, :]
    qq = q_lens.clamp(max=Q)[None, :]
    rows = torch.arange(T + 1, dtype=torch.int32, device=dev)[:, None]
    row = torch.minimum(rows, t_lens.clamp(min=1)[None, :])
    c = torch.div((row - r0[None, :]) * qq, span, rounding_mode="floor")
    c = torch.minimum(c.clamp(min=0), qq)
    return (c - BW // 2).clamp(0, max(Q + 1 - BW, 0)).to(torch.int32)


def nw_moves_banded_plain(cw, t_lens, frags, q_lens, r0, r1, T: int, Q: int, BW: int):
    """Anchored banded NW forward, one loop step per DP row over [B, BW].

    cw [B, T] int32 per-fragment consensus rows (pad < 0), t_lens [B],
    frags [B, Q] int32 (pad -1), q_lens [B], r0 / r1 [B] int32 the
    fragment's placement on the consensus.  DP row r + 1 holds the band of
    fragment columns offs[r] .. offs[r] + BW - 1 and regathers the previous
    row at its own start (NEG outside it).  Returns (moves [T, B, BW/16]
    int32, 2 bits a lane: 0 diag, 1 up or the free column j == 0, 2 left,
    3 a row past the consensus; offs [T, B], end_scores [T, B], row0_score
    [B]) int32, raven_tpu's layout.

    Identical input rows give identical outputs, so the DP runs once per
    distinct row (a chunk's padding rows are all alike), and only down to
    the longest consensus: the rows past it are constant."""
    B = cw.shape[0]
    dev = cw.device
    i32 = torch.int32
    row0 = torch.where(q_lens <= Q, q_lens * GAP, NEG).to(i32)
    if B == 0:
        return (torch.empty((T, 0, BW // 16), dtype=i32, device=dev),
                torch.empty((T, 0), dtype=i32, device=dev),
                torch.empty((T, 0), dtype=i32, device=dev), row0)
    key = torch.cat([cw, frags, torch.stack([t_lens, q_lens, r0, r1], dim=1)], dim=1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    cw, frags = uniq[:, :T], uniq[:, T : T + Q]
    t_lens, q_lens, r0, r1 = uniq[:, T + Q :].unbind(dim=1)
    B = uniq.shape[0]
    i = torch.arange(BW, device=dev)[None, :]  # band lanes, int64 for the gathers
    i4 = (i * -GAP).to(i32)
    ql = q_lens[:, None]
    off_all = _band_offsets(t_lens, q_lens, r0, r1, T, Q, BW).to(torch.int64)
    # fragment codes padded so column j reads frags[:, j - 1] (j == 0: pad)
    fpad = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev), frags.to(i32)], dim=1)
    # the previous row between two NEG lanes: lane p at p + 1
    prevp = torch.full((B, BW + 2), NEG, dtype=i32, device=dev)
    j = off_all[0][:, None] + i
    prevp[:, 1 : BW + 1] = torch.where(j <= ql, j * GAP, NEG)
    off_prev = off_all[0]
    shifts = 2 * torch.arange(16, dtype=i32, device=dev)
    moves = torch.full((T, B, BW // 16), -1, dtype=i32, device=dev)  # move 3 everywhere
    offs = torch.empty((T, B), dtype=i32, device=dev)
    ends = torch.full((T, B), NEG, dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    Te = min(T, int(t_lens.max()))
    t_min = int(t_lens.min())
    # column j of the band reads fragment column j - 1: within the fragment
    # whenever the band ends within it
    jmax = Q if Q + 1 < BW else None
    ii = torch.arange(BW + 1, device=dev)[None, :]
    for r in range(Te):
        off = off_all[r + 1]
        # the previous row at lanes d - 1 .. d + BW - 1: diag, then up (NEG
        # outside it; d < 0 where raven_tpu's int32 band start wraps)
        g = prevp.gather(1, ((off - off_prev)[:, None] + ii).clamp_(0, BW + 1))
        up = g[:, 1:] + GAP
        diag = g[:, :BW]
        j = off[:, None] + i
        same = fpad.gather(1, j if jmax is None else j.clamp(max=jmax)) == cw[:, r : r + 1]
        diag += same.to(i32).mul_(MATCH - MISMATCH).add_(MISMATCH)
        mv = (up > diag).to(i32)  # 1: up; diag wins ties
        e = torch.maximum(diag, up)
        # free consensus prefix: column j == 0 (lane 0 of a band at 0)
        # restarts at 0 with move up, before the closure
        at0 = off == 0
        e[:, 0].masked_fill_(at0, 0)
        mv[:, 0].masked_fill_(at0, 1)
        # left closure within the band: cummax(e - i*GAP) + i*GAP, never
        # below e; move left where it is above
        cur = torch.cummax(e + i4, dim=1).values.sub_(i4)
        mv = torch.maximum(mv, (cur > e).to(i32).mul_(2))
        cur.masked_fill_(j > ql, NEG)
        if r >= t_min:  # rows past some consensus keep the previous row
            done = (r >= t_lens)[:, None]
            cur = torch.where(done, prevp[:, 1 : BW + 1], cur)
            mv.masked_fill_(done, 3)
            off = torch.where(done[:, 0], off_prev, off)
        iq = q_lens - off
        end = cur[bidx, iq.clamp(0, BW - 1)]
        ends[r] = torch.where((r < t_lens) & (iq >= 0) & (iq < BW), end, NEG)
        offs[r] = off
        moves[r] = (mv.view(B, BW // 16, 16) << shifts).sum(dim=2, dtype=i32)
        prevp[:, 1 : BW + 1] = cur
        off_prev = off
    offs[Te:] = off_prev
    return moves[:, inv], offs[:, inv], ends[:, inv], row0


def traceback_banded_plain(moves, offs, end_scores, row0_score, q_lens, frags, wts,
                           T: int, Q: int, BW: int, return_walks: bool = False):
    """The banded traceback, all fragments in lockstep, one move a step.

    Per fragment: the walk starts at row 0 when row0_score >= the best end
    score, else one row below the first row holding it, at column q_len,
    and moves back to column 0.  The move at (t, j) is read band-relative,
    lane j - offs[t - 1] of row t - 1; at t == 0 it is left, and the band
    tested is still offs[0], row 1's.  Outside that band the walk stalls on
    the top row, or, at t != 0, stops (it would leave the band).  A diag or
    up move votes at row t - 1 with the weight of fragment base
    clip(j - 1, 0, Q - 1) (diag: that base, up: a deletion, 4); the first
    left move of a run, in walk order, votes an insertion of that base at
    junction t.  Returns (col_sym, col_w [B, T], ins_b, ins_w [B, T + 1])
    int32, K2's primitives (col_sym 5 and ins_b -1 where nothing was cast,
    weight 0 there); with return_walks also how each walk ended ([B]
    int64: 0 at column 0, 1 stalled on the top row, 2 stopped at the band's
    edge, 3 on a row past the consensus) and its moves ([B] int64)."""
    B = q_lens.shape[0]
    dev = q_lens.device
    i64 = torch.int64
    ends = end_scores.to(i64)
    best_r = ends.argmax(dim=0)  # ties: the first best row
    bidx = torch.arange(B, device=dev)
    best = ends[best_r, bidx] if B else ends.new_zeros(0)
    t = torch.where(row0_score.to(i64) >= best, 0, best_r + 1)
    j = q_lens.to(i64)
    words = moves.reshape(-1)
    offs_flat = offs.reshape(-1)
    W = BW // 16
    steps = int((t + j.clamp(min=0)).max()) + 1 if B else 0
    hist_t = torch.empty((steps, B), dtype=i64, device=dev)
    hist_j = torch.empty((steps, B), dtype=i64, device=dev)
    hist_mv = torch.empty((steps, B), dtype=i64, device=dev)
    for s in range(steps):
        row = (t - 1).clamp_(min=0).mul_(B).add_(bidx)
        i = j - offs_flat[row]
        ic = i.clamp(0, BW - 1)
        mv = (words[row.mul_(W).add_(ic >> 4)] >> ((ic & 15) << 1)).to(i64) & 3
        mv.masked_fill_(t == 0, 2)
        # a walk ends outside the band (a stall on the top row, else a stop)
        # and at column 0, with move 3 from then on
        mv.masked_fill_((ic != i) | (j <= 0), 3)
        hist_t[s] = t
        hist_j[s] = j
        hist_mv[s] = mv
        t = t - (mv <= 1).to(i64)
        j = j - ((mv & 1) ^ 1)  # diag and left move a column, up and 3 do not
        # a move 3 keeps its walk's state, so once every walk has one each
        # later step repeats it: stop there (steps is the longest possible)
        if s % 256 == 255 and bool((mv == 3).all()):
            steps = s + 1
            break
    hist_t, hist_j, hist_mv = hist_t[:steps], hist_j[:steps], hist_mv[:steps]

    # one gather serves base and weight, packed as raven_tpu packs them
    pk = (frags.clamp(0, 3) | (wts << 2)).to(i64)
    hist_pk = pk[bidx, (hist_j - 1).clamp_(0, Q - 1)]
    # every (fragment, row) gets at most one column vote and every
    # (fragment, junction) at most one insertion; the rest lands in a dump
    # column past the row
    fb = hist_pk & 3
    fw = hist_pk >> 2
    diag_up = hist_mv <= 1
    prev_mv = torch.cat([torch.full((1, B), 3, dtype=i64, device=dev), hist_mv[:-1]])
    is_ins = (hist_mv == 2) & (prev_mv != 2)
    col_sym = torch.full((B, T + 1), 5, dtype=i64, device=dev)
    col_w = torch.zeros((B, T + 1), dtype=i64, device=dev)
    at = (bidx, torch.where(diag_up, hist_t - 1, T))
    col_sym[at] = torch.where(diag_up, torch.where(hist_mv == 0, fb, 4), 5)
    col_w[at] = torch.where(diag_up, fw, 0)
    ins_b = torch.full((B, T + 2), -1, dtype=i64, device=dev)
    ins_w = torch.zeros((B, T + 2), dtype=i64, device=dev)
    at = (bidx, torch.where(is_ins, hist_t, T + 1))
    ins_b[at] = torch.where(is_ins, fb, -1)
    ins_w[at] = torch.where(is_ins, fw, 0)
    out = tuple(
        x.to(torch.int32).contiguous()
        for x in (col_sym[:, :T], col_w[:, :T], ins_b[:, : T + 1], ins_w[:, : T + 1])
    )
    if not return_walks:
        return out
    # the final state: stalled on the top row, stopped at the band's edge,
    # or on a row past the consensus, unless at column 0
    i = j - offs_flat[(t - 1).clamp(min=0) * B + bidx]
    in_band = (i >= 0) & (i < BW)
    kinds = torch.where(t == 0, 1, torch.where(in_band, 3, 2))
    return out, torch.where(j > 0, kinds, 0), (hist_mv != 3).sum(dim=0)


def _check(named, device):
    for name, x, dtype, shape in named:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise TypeError(
                f"{name} must be {list(shape)} {dtype}, got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != device:
            raise ValueError("all inputs must lie on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_kernel_shape(T: int, Q: int, BW: int):
    """Raise ValueError on a shape the card kernels do not take: BW other
    than 128 or 256 (raven_tpu's min(256, pow2(q_pad)) gives no other), Q
    < 1 or T < 1.  Any Q and T above that are taken (`launch_plan`); a band
    wider than the fragment (Q + 1 < BW) too, as raven_tpu takes it."""
    if BW not in KERNEL_BWS or Q < 1 or T < 1:
        raise ValueError(
            f"the anchored banded kernels take BW in {KERNEL_BWS}, Q >= 1 and T >= 1, "
            f"got T={T}, Q={Q}, BW={BW}"
        )


def code_words(Q: int, BW: int) -> int:
    """K9's packed words a fragment (banded.cu's code_words): 16 columns a
    word, one more for the funnel shift, at least the band's."""
    return max(Q // 16 + 2, BW // 16 + 1)


def launch_plan(T: int, Q: int, BW: int) -> tuple[str, int]:
    """K9's route for [T, Q, BW] and its fragments a block:
    ("nw_moves_banded", FWD_FRAGS[BW]) while a block's packed fragments and
    regather rows fit its shared memory (at BW 256, Q <= 55,887), else
    ("nw_moves_banded_global", the same): the packed codes in device
    memory.  T does not enter (K9 keeps no row in shared memory); K10 has
    one route at every shape.  Raises as check_kernel_shape."""
    check_kernel_shape(T, Q, BW)
    n = FWD_FRAGS[BW]
    row = (BW + BW // 16 + 1 + 3) & ~3
    codes = (2 * code_words(Q, BW) + 3) & ~3
    fits = n * (codes + row) * 4 <= SMEM_BYTES
    return ("nw_moves_banded" if fits else "nw_moves_banded_global"), n


_FNS = None


def _fns():
    """The launchers' C functions, typed once per process."""
    global _FNS
    if _FNS is None:
        from raven_tpu_torch import csrc

        lib = csrc.load("banded")
        fwd = lib.raven_nw_moves_banded_launch
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int,
        ]
        walk = lib.raven_traceback_banded_launch
        walk.restype = ctypes.c_int
        walk.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fwd_global = lib.raven_nw_moves_banded_global_launch
        fwd_global.restype = ctypes.c_int
        fwd_global.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int,
        ]
        _FNS = lib, fwd, walk, fwd_global
    return _FNS


def _forward_kernel(cw, t_lens, frags, q_lens, r0, r1, T: int, Q: int, BW: int):
    from raven_tpu_torch import csrc

    B = cw.shape[0]
    i32 = torch.int32
    route, per_block = launch_plan(T, Q, BW)
    _check((
        ("cw", cw, i32, (B, T)), ("t_lens", t_lens, i32, (B,)),
        ("frags", frags, i32, (B, Q)), ("q_lens", q_lens, i32, (B,)),
        ("r0", r0, i32, (B,)), ("r1", r1, i32, (B,)),
    ), cw.device)
    dev = cw.device
    moves = torch.empty((T, B, BW // 16), dtype=i32, device=dev)
    offs = torch.empty((T, B), dtype=i32, device=dev)
    ends = torch.empty((T, B), dtype=i32, device=dev)
    row0 = torch.empty(B, dtype=i32, device=dev)
    if B == 0:
        return moves, offs, ends, row0
    lib, fwd, _, fwd_global = _fns()
    ptrs = [x.data_ptr() for x in (cw, t_lens, frags, q_lens, r0, r1, moves, offs, ends, row0)]
    if route == "nw_moves_banded_global":  # the packed codes' scratch
        codes = torch.empty(B * 2 * code_words(Q, BW), dtype=i32, device=dev)
        fwd, ptrs = fwd_global, [*ptrs, codes.data_ptr()]
    # the tensors' card is current for the launch and its shared-memory
    # limit, and the launch goes on that card's stream
    with torch.cuda.device(dev):
        err = fwd(*ptrs, B, T, Q, BW, torch.cuda.current_stream(dev).cuda_stream, per_block)
    csrc.check(lib, err, "anchored banded forward kernel launch")
    LAUNCHES["nw_moves_banded"] += 1
    ROUTE_LAUNCHES[route] += 1
    return moves, offs, ends, row0


def _walk_kernel(moves, offs, end_scores, row0_score, q_lens, frags, wts,
                 T: int, Q: int, BW: int):
    from raven_tpu_torch import csrc

    B = q_lens.shape[0]
    i32 = torch.int32
    check_kernel_shape(T, Q, BW)
    _check((
        ("moves", moves, i32, (T, B, BW // 16)), ("offs", offs, i32, (T, B)),
        ("end_scores", end_scores, i32, (T, B)), ("row0_score", row0_score, i32, (B,)),
        ("q_lens", q_lens, i32, (B,)), ("frags", frags, i32, (B, Q)),
        ("wts", wts, i32, (B, Q)),
    ), q_lens.device)
    dev = q_lens.device
    col_sym = torch.empty((B, T), dtype=i32, device=dev)
    col_w = torch.empty((B, T), dtype=i32, device=dev)
    ins_b = torch.empty((B, T + 1), dtype=i32, device=dev)
    ins_w = torch.empty((B, T + 1), dtype=i32, device=dev)
    if B == 0:
        return col_sym, col_w, ins_b, ins_w
    lib, _, walk, _ = _fns()
    with torch.cuda.device(dev):
        err = walk(
            moves.data_ptr(), offs.data_ptr(), end_scores.data_ptr(), row0_score.data_ptr(),
            q_lens.data_ptr(), frags.data_ptr(), wts.data_ptr(), col_sym.data_ptr(),
            col_w.data_ptr(), ins_b.data_ptr(), ins_w.data_ptr(), B, T, Q, BW,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    csrc.check(lib, err, "anchored banded walk kernel launch")
    LAUNCHES["traceback_banded"] += 1
    ROUTE_LAUNCHES["traceback_banded"] += 1
    return col_sym, col_w, ins_b, ins_w


def nw_moves_banded(cw, t_lens, frags, q_lens, r0, r1, T: int, Q: int, BW: int):
    """K9 on a CUDA tensor, its plain version on a CPU tensor."""
    if cw.device.type == "cuda":
        return _forward_kernel(cw, t_lens, frags, q_lens, r0, r1, T, Q, BW)
    if cw.device.type == "cpu":
        return nw_moves_banded_plain(cw, t_lens, frags, q_lens, r0, r1, T, Q, BW)
    raise ValueError(f"no anchored banded forward kernel for device {cw.device}")


def traceback_banded(moves, offs, end_scores, row0_score, q_lens, frags, wts,
                     T: int, Q: int, BW: int):
    """K10 on a CUDA tensor, its plain version on a CPU tensor."""
    if q_lens.device.type == "cuda":
        return _walk_kernel(moves, offs, end_scores, row0_score, q_lens, frags, wts, T, Q, BW)
    if q_lens.device.type == "cpu":
        return traceback_banded_plain(
            moves, offs, end_scores, row0_score, q_lens, frags, wts, T, Q, BW
        )
    raise ValueError(f"no anchored banded walk kernel for device {q_lens.device}")


def fused_votes_banded(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx,
                       r0, r1, T: int, Q: int, BW: int, NWIN: int):
    """Vote tables of one fragment chunk through the anchored banded NW:
    the drop-in for raven_tpu.ops.consensus_device.fused_votes_banded_kernel.
    cons_arr [NWIN, T] (pad < 0), cons_lens [NWIN], cons_runs [NWIN, T+1,
    4], frags / wts [B, Q], q_lens, win_idx, r0, r1 [B], all int32 on one
    device.  Returns (base_votes [NWIN, T, 5], ins_votes [NWIN, T+1, 4],
    cover [NWIN, T]) int32."""
    if cons_arr.shape != (NWIN, T) or frags.shape[1] != Q:
        raise ValueError(
            f"cons_arr {tuple(cons_arr.shape)} / frags {tuple(frags.shape)} do "
            f"not match NWIN={NWIN}, T={T}, Q={Q}"
        )
    wi = win_idx.to(torch.int64)
    cw = cons_arr[wi].contiguous()
    cwl = cons_lens[wi].contiguous()
    moves, offs, ends, row0 = nw_moves_banded(cw, cwl, frags, q_lens, r0, r1, T, Q, BW)
    prims = traceback_banded(moves, offs, ends, row0, q_lens, frags, wts, T, Q, BW)
    return votes_from_primitives(*prims, win_idx, cons_runs, T, NWIN)
