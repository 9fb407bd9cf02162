"""Shift-banded window consensus: the CUDA kernels K3 (banded forward) and K4
(walk and votes), their plain PyTorch versions, and the vote epilogue.

`band_forward(cw, t_lens, fw_sh, q_lens, r0, T, BW)` is the port of
raven_tpu/ops/consensus_band.py::band_forward, and `mask_walk_votes(moves,
end_scores, row0_score, fw_sh, q_lens, r0, T, BW)` the port of the row scan of
its mask_walk_votes (the per-fragment vote rows, before the per-window sums).
On a CUDA tensor each launches its hand-written kernel in
raven_tpu_torch/csrc/band.cu (see the note there for what bounds it and how
the design answers that) or raises; on a CPU tensor each runs its plain
version, the same function in torch ops.  Integer outputs are bit-identical
to raven_tpu's.

`vote_tables` is the epilogue (integer index_add_ into the per-window tables,
where raven_tpu sums with one-hot float32 matmuls) and `band_votes` the walk
and the epilogue together: the drop-in for raven_tpu's mask_walk_votes.

`band_pack(bases, wts, src, q_lens, r0, T, BW)` lays out the fragment rows
K3 and K4 read (fw_sh, what consensus_band.py::pack_shifted_fragments makes
on the host) from a flat upload of a group's fragment bytes: the kernel
band_pack in band.cu on a CUDA tensor, its plain version on a CPU tensor,
byte for byte the same.

`LAUNCHES` counts kernel launches per kernel, so a run can show that its main
path went through the kernels, and `ROUTE_LAUNCHES` per route (band_pack has
one, of its own name): `launch_plan`
picks, from the shape, K3's strip kernels ("band_forward"), its wide one
("band_forward_wide", BW above 512 or consensus rows past a block's shared
memory) or its global one ("band_forward_global", BW above 16,384), and
K4's staged walk ("mask_walk_votes") or its direct one
("mask_walk_votes_direct").
"""

from __future__ import annotations

import ctypes

import torch

from raven_tpu_torch.csrc import SMEM_BYTES

NEG = -(1 << 20)
MATCH, MISMATCH, GAP = 3, -5, -4
# K3's wide route holds 16 band lanes a thread, at most a block's 1024
# threads a fragment; past it, its global route keeps the previous row in
# device memory
WIDE_MAX_BW = 16384
# the widest band the kernels take (raven_tpu takes any multiple of 16): the
# closure's scan adds 64 a strip of 16 lanes to int32 values
KERNEL_MAX_BW = 1 << 27
STRIP_MAX_BW = 512  # the strip kernels: at most a warp's 32 lanes a fragment
WALK_STATIC_BYTES = 2 * 4 * 16 * 4  # K4's best-row tables, beside its staging
PACK_THREADS, PACK_BYTES = 256, 16  # band_pack: threads a block, output bytes a thread
WCAP = 63  # the weight cap of the packed byte (2 bits base + 6 bits weight)
LAUNCHES = {"band_forward": 0, "mask_walk_votes": 0, "band_pack": 0}
ROUTE_LAUNCHES = {"band_forward": 0, "band_forward_wide": 0, "band_forward_global": 0,
                  "mask_walk_votes": 0, "mask_walk_votes_direct": 0, "band_pack": 0}


def band_pack_plain(bases, wts, src, q_lens, r0, T: int, BW: int):
    """The shifted packed fragment rows from a flat upload, in torch ops.

    bases [N] uint8: a group's fragment bytes back to back; wts [N] uint8
    their weights, or None for a weight of 1 everywhere; src [B] int64 each
    row's first byte in bases; q_lens [B] (its length cut at the query pad)
    and r0 [B] (its placement row, at least 0) int32.  Returns fw_sh [B, T +
    BW + 1] uint8: row i holds base | min(w, 63) << 2 of its first n bytes
    at columns off .. off + n - 1, off = r0 + BW/2 + 1, n = min(q_len,
    max(T + BW + 1 - off, 0)), and 0 elsewhere: pack_shifted_fragments's
    rows.  Only the n bytes of each row are gathered (one repeat_interleave
    over the rows), not the whole [B, SW] grid."""
    B = q_lens.shape[0]
    SW = T + BW + 1
    dev = q_lens.device
    i64 = torch.int64
    off = r0.to(i64) + BW // 2 + 1
    n = torch.minimum(q_lens.to(i64), (SW - off).clamp(min=0))
    out = torch.zeros(B * SW, dtype=torch.uint8, device=dev)
    total = int(n.sum())
    if total:
        row = torch.repeat_interleave(torch.arange(B, device=dev), n)
        k = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[row]
        p = src.to(i64)[row] + k
        w = wts[p].clamp(max=WCAP) << 2 if wts is not None else 4
        out[row * SW + off[row] + k] = bases[p] | w
    return out.view(B, SW)


def band_forward_plain(cw, t_lens, fw_sh, q_lens, r0, T: int, BW: int):
    """Slope-1 banded NW forward, one loop step per DP row over [B, BW].

    cw [B, T] int32 per-fragment consensus rows (pad < 0), t_lens [B],
    fw_sh [B, T+BW+1] uint8 shifted packed fragments, q_lens [B], r0 [B]
    int32.  At DP row r the band lane u holds fragment column
    j = r + u - BW/2 - r0.  Returns (moves [T, B, BW/16] int32, 2 bits a
    lane, end_scores [T, B] int32, row0_score [B] int32); move codes 0 diag,
    1 up or the free column j == 0, 2 left.

    Lane u of DP row r reads position k = r + u of the shifted rows, whose
    column k - BW/2 - r0 does not depend on r: each row's mask of the lanes
    outside [0, q_len] is a slice of one mask over k, and the lanes of
    columns 0 and q_len are one a fragment.  Masks are clamps and maxima,
    not torch.where, which costs several times as much on the CPU."""
    B = cw.shape[0]
    dev = cw.device
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    half = BW // 2
    jk = torch.arange(T + BW + 1, dtype=i32, device=dev)[None, :] - half - r0[:, None]
    outside = (jk < 0) | (jk > q_lens[:, None])
    # a clamp to [lo, hi] sets the lanes outside the fragment to NEG
    lo = torch.where(outside, NEG, torch.iinfo(i32).min).to(i32)
    hi = torch.where(outside, NEG, torch.iinfo(i32).max).to(i32)
    prev = torch.where(outside[:, :BW], NEG, jk[:, :BW] * GAP).to(i32)
    u4 = torch.arange(BW, dtype=i32, device=dev)[None, :] * -GAP
    fch = (fw_sh & 3).to(torch.int8)
    c8 = cw.clamp(-1, 4).to(torch.int8)  # pad: -1, never a base
    rows = torch.arange(B, device=dev)
    r0l, qll, tll = r0.to(i64), q_lens.to(i64), t_lens.to(i64)
    up = torch.empty((B, BW), dtype=i32, device=dev)
    up[:, -1] = NEG + GAP
    moves = torch.empty((T, B, BW // 16), dtype=i32, device=dev)
    ends = torch.empty((T, B), dtype=i32, device=dev)
    for r in range(T):
        k = slice(r + 1, r + 1 + BW)
        same = torch.eq(fch[:, k], c8[:, r : r + 1])
        diag = torch.add(prev, same, alpha=MATCH - MISMATCH).add_(MISMATCH)
        torch.add(prev[:, 1:], GAP, out=up[:, :-1])
        e = torch.maximum(diag, up)  # ties: diag
        mv = torch.gt(up, diag).view(u8)
        # free consensus prefix: column j == 0 restarts at 0, before the
        # closure
        u0 = half - 1 - r + r0l
        ok0 = (u0 >= 0) & (u0 < BW)
        u0 = u0.clamp(0, BW - 1)
        e[rows, u0] = torch.where(ok0, 0, e[rows, u0])
        mv[rows, u0] = torch.where(ok0, 1, mv[rows, u0]).to(u8)
        # left closure within the band: cummax(e - u*GAP) + u*GAP
        closed = torch.cummax(e + u4, dim=1).values.sub_(u4)
        left = torch.gt(closed, e)
        cur = torch.maximum(closed, e).clamp_(lo[:, k], hi[:, k])
        mv = torch.maximum(mv, left.view(u8) << 1)
        # the end score: the lane of column q_len on a consensus row, every
        # other lane NEG
        uq = qll + half - 1 - r + r0l
        okq = (uq >= 0) & (uq < BW) & (r < tll)
        ends[r] = torch.where(okq, cur[rows, uq.clamp(0, BW - 1)], NEG).clamp_(min=NEG)
        # lane 16w + i at bits 2i of word w: four lanes a byte, four bytes a
        # little-endian word
        x = mv.view(B, BW // 2, 2)
        y = (x[:, :, 0] | (x[:, :, 1] << 2)).view(B, BW // 4, 2)
        moves[r] = (y[:, :, 0] | (y[:, :, 1] << 4)).view(i32)
        prev = cur
    return moves, ends, (q_lens * GAP).to(i32)


def mask_walk_votes_plain(moves, end_scores, row0_score, fw_sh, q_lens, r0, T: int, BW: int):
    """The traceback as a reverse row walk, one position per fragment.

    Per fragment: the walk starts at row 0 when row0_score >= the best end
    score, else one row below the first row holding it, at the lane of
    column q_len (no walk when that lane is outside the band).  Per row r
    from T down to 1: an insertion vote from the byte at the walker's lane p
    when its move is left and j >= 1; then the walker slides to the highest
    lane <= p whose move is not left and whose j >= 1 (none: no vote, the
    walk ends), votes there (diag: its base, up: a deletion, both with its
    weight), and moves on (diag: the same lane, up: the next one), ending
    once the next column would be j <= 1 after a diag or the lane leaves the
    band.  Row 0 gives one more insertion vote at the walker's lane when
    j >= 1.  Returns (votes [B, T], ins [B, T+1]) int32, packed as raven_tpu
    packs them: a vote 1 | col<<1 | w<<4 (col 0-3 base, 4 deletion), an
    insertion 1 | base<<1 | w<<3, 0 where nothing was cast."""
    B = q_lens.shape[0]
    dev = q_lens.device
    i32, i64 = torch.int32, torch.int64
    half = BW // 2
    ends = end_scores.to(i64)
    best, best_r = ends.max(dim=0).values, ends.argmax(dim=0)  # ties: the first best row
    t0 = torch.where(row0_score.to(i64) >= best, 0, best_r + 1)
    ql = q_lens.to(i64)
    rz = r0.to(i64)
    fw = fw_sh.to(i64)
    # lane u's key u + 1, in the narrowest type that holds BW
    kt = torch.int16 if BW < (1 << 15) else i32
    u1 = torch.arange(1, BW + 1, dtype=kt, device=dev)[None, :]
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    bidx = torch.arange(B, device=dev)
    p = torch.full((B,), -1, dtype=i64, device=dev)  # the walker's lane, -1: none
    votes = torch.zeros((B, T), dtype=i32, device=dev)
    ins = torch.zeros((B, T + 1), dtype=i32, device=dev)
    for r in range(T, 0, -1):
        u_init = ql + half + rz - r
        p = torch.where((t0 == r) & (u_init >= 0) & (u_init < BW), u_init, p)
        # the row's moves: four lanes a byte of the little-endian words
        mv = ((moves[r - 1].view(torch.uint8)[:, :, None] >> shifts) & 3).view(B, BW)
        fw_row = fw[:, r : r + BW]
        ulo = 1 + half + rz - r  # the lowest lane with j >= 1
        pc = p.clamp(min=0)
        has_ins = (p >= 0) & (mv[bidx, pc] == 2) & (pc >= ulo)
        ins[:, r] = torch.where(has_ins, 1 | (fw_row[bidx, pc] << 1), 0).to(i32)
        # the highest lane <= p whose move is not left (keys of the others
        # 0), if it is not below ulo
        key = (mv != 2).to(kt).mul_(u1)
        key.masked_fill_(u1 > (p + 1)[:, None].to(kt), 0)
        q = key.amax(dim=1).to(i64) - 1
        q = torch.where(q >= ulo, q, -1)
        qc = q.clamp(min=0)
        mv_q = mv[bidx, qc].to(i64)
        fw_q = fw_row[bidx, qc]
        col = torch.where(mv_q == 0, fw_q & 3, 4)
        votes[:, r - 1] = torch.where(q >= 0, 1 | (col << 1) | ((fw_q >> 2) << 4), 0).to(i32)
        nxt = torch.where(mv_q == 0, qc, qc + 1)
        p = torch.where((q >= 0) & (nxt < BW) & (nxt + r - half - rz > 1), nxt, -1)
    u_init = ql + half + rz
    p = torch.where((t0 == 0) & (u_init >= 0) & (u_init < BW), u_init, p)
    ok = (p >= 0) & (p - half - rz >= 1)
    ins[:, 0] = torch.where(ok, 1 | (fw[bidx, p.clamp(min=0)] << 1), 0).to(i32)
    return votes, ins


def vote_tables(votes, ins, win_idx, NWIN: int):
    """Sum per-fragment vote rows into the per-window tables with integer
    index_add_.  votes [B, T], ins [B, T+1], win_idx [B] int32.  Returns
    (base_votes [NWIN, T, 5], ins_raw [NWIN, T+1, 4], cover [NWIN, T])
    int32; ins_raw is keyed by raw junction row (canonicalize_ins moves it
    to the homopolymer run starts).  An entry that carries no vote adds 0 at
    its own cell: one dump slot for all of them would put millions of
    atomic adds on one address."""
    B, T = votes.shape
    dev = votes.device
    w = win_idx.to(torch.int64)[:, None]
    col = ((votes >> 1) & 7).to(torch.int64)
    has = ((votes & 1) != 0) & (col <= 4)
    cell = w * T + torch.arange(T, device=dev)[None, :]
    base = torch.zeros(NWIN * T * 5, dtype=torch.int32, device=dev)
    base.index_add_(
        0, (cell * 5 + col.clamp(max=4)).reshape(-1),
        torch.where(has, votes >> 4, 0).reshape(-1),
    )
    cover = torch.zeros(NWIN * T, dtype=torch.int32, device=dev)
    cover.index_add_(0, cell.reshape(-1), has.to(torch.int32).reshape(-1))
    junction = w * (T + 1) + torch.arange(T + 1, device=dev)[None, :]
    ins_raw = torch.zeros(NWIN * (T + 1) * 4, dtype=torch.int32, device=dev)
    ins_raw.index_add_(
        0, (junction * 4 + ((ins >> 1) & 3)).reshape(-1),
        torch.where((ins & 1) != 0, ins >> 3, 0).reshape(-1),
    )
    return base.view(NWIN, T, 5), ins_raw.view(NWIN, T + 1, 4), cover.view(NWIN, T)


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


def check_kernel_shape(T: int, BW: int):
    """Raise ValueError on a shape the card kernels do not take: BW not a
    multiple of 16 (raven_tpu packs a row's moves in BW / 16 words), BW
    above KERNEL_MAX_BW (K3's closure adds 64 a strip of 16 lanes to int32
    values), or T < 1."""
    if BW % 16 or not 16 <= BW <= KERNEL_MAX_BW or T < 1:
        raise ValueError(
            f"the band kernels take BW a multiple of 16 from 16 to {KERNEL_MAX_BW} (K3's "
            f"closure scan in int32) and T >= 1, got BW={BW}, T={T}"
        )


def _round16(x: int) -> int:
    return (x + 15) & ~15


def launch_plan(T: int, BW: int) -> tuple[tuple[str, int], tuple[str, int]]:
    """K3's and K4's routes for [T, BW], each (route, fragments a block).
    K3: ("band_forward", 8 up to BW 256, else 4) while BW <= STRIP_MAX_BW and
    a block's fragments (round16(T + BW + 1) + round16(T) bytes each) fit
    its shared memory (at BW 256, T <= 14,399), else ("band_forward_wide",
    1).  K4: ("mask_walk_votes", 16) while BW <= STRIP_MAX_BW and 16 times
    2 * 32 * BW / 4 + round16(T + BW + 1) bytes fit beside its best-row
    tables (at BW 256, T <= 10,143; at 512, T <= 5,791), else
    ("mask_walk_votes_direct", 4).  Past WIDE_MAX_BW, K3 takes
    ("band_forward_global", 1).  Raises as check_kernel_shape."""
    check_kernel_shape(T, BW)
    fwd, walk = ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)
    if BW > WIDE_MAX_BW:
        fwd = ("band_forward_global", 1)
    if BW <= STRIP_MAX_BW:
        n = 8 if BW <= 256 else 4
        if n * (_round16(T + BW + 1) + _round16(T)) <= SMEM_BYTES:
            fwd = ("band_forward", n)
        walk_bytes = 2 * 32 * (BW // 4) + _round16(T + BW + 1)
        if 16 * walk_bytes + WALK_STATIC_BYTES <= SMEM_BYTES:
            walk = ("mask_walk_votes", 16)
    return fwd, walk


def pack_plan(B: int, T: int, BW: int) -> tuple[int, int]:
    """band_pack's launch for B rows at [T, BW]: (blocks, threads a block),
    a thread PACK_BYTES consecutive bytes of the [B, T + BW + 1] output.
    Raises as check_kernel_shape (its rows feed K3 and K4), and ValueError
    past a grid's 2^31 - 1 blocks or a row of 2^31 bytes."""
    check_kernel_shape(T, BW)
    SW = T + BW + 1
    words = -(-B * SW // PACK_BYTES)
    blocks = -(-words // PACK_THREADS)
    if SW > 0x7FFFFFFF or blocks > 0x7FFFFFFF:
        raise ValueError(f"band_pack takes rows of at most 2^31 - 1 bytes and grids of at "
                         f"most 2^31 - 1 blocks, got B={B}, T={T}, BW={BW}")
    return blocks, PACK_THREADS


_FNS = None


def _fns():
    """The library and its launchers by route, typed once per process."""
    global _FNS
    if _FNS is None:
        from raven_tpu_torch import csrc

        lib = csrc.load("band")
        fwd = lib.raven_band_forward_launch
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        walk = lib.raven_band_walk_launch
        walk.restype = ctypes.c_int
        walk.argtypes = fwd.argtypes
        fns = {"band_forward": fwd, "mask_walk_votes": walk}
        for route, name in (("band_forward_wide", "raven_band_forward_wide_launch"),
                            ("mask_walk_votes_direct", "raven_band_walk_direct_launch")):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, fwd.argtypes
            fns[route] = fn
        fn = lib.raven_band_forward_global_launch  # with the previous row's scratch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + fwd.argtypes[8:]
        fns["band_forward_global"] = fn
        fn = lib.raven_band_pack_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        fns["band_pack"] = fn
        _FNS = lib, fns
    return _FNS


def _forward_kernel(cw, t_lens, fw_sh, q_lens, r0, T: int, BW: int):
    from raven_tpu_torch import csrc

    B = cw.shape[0]
    i32 = torch.int32
    (route, per_block), _ = launch_plan(T, BW)
    _check((
        ("cw", cw, i32, (B, T)), ("t_lens", t_lens, i32, (B,)),
        ("fw_sh", fw_sh, torch.uint8, (B, T + BW + 1)), ("q_lens", q_lens, i32, (B,)),
        ("r0", r0, i32, (B,)),
    ), cw.device)
    dev = cw.device
    moves = torch.empty((T, B, BW // 16), dtype=i32, device=dev)
    ends = torch.empty((T, B), dtype=i32, device=dev)
    row0 = torch.empty(B, dtype=i32, device=dev)
    if B == 0:
        return moves, ends, row0
    lib, fns = _fns()
    ptrs = [x.data_ptr() for x in (cw, t_lens, fw_sh, q_lens, r0, moves, ends, row0)]
    if route == "band_forward_global":  # each fragment's previous row
        prev = torch.empty(B * BW, dtype=i32, device=dev)
        ptrs.append(prev.data_ptr())
    # the tensors' card is current for the launch and its shared-memory
    # limit, and the launch goes on that card's stream
    with torch.cuda.device(dev):
        err = fns[route](*ptrs, B, T, BW, torch.cuda.current_stream(dev).cuda_stream,
                         per_block)
    csrc.check(lib, err, "banded forward kernel launch")
    LAUNCHES["band_forward"] += 1
    ROUTE_LAUNCHES[route] += 1
    return moves, ends, row0


def _walk_kernel(moves, end_scores, row0_score, fw_sh, q_lens, r0, T: int, BW: int):
    from raven_tpu_torch import csrc

    B = q_lens.shape[0]
    i32 = torch.int32
    _, (route, per_block) = launch_plan(T, BW)
    _check((
        ("moves", moves, i32, (T, B, BW // 16)), ("end_scores", end_scores, i32, (T, B)),
        ("row0_score", row0_score, i32, (B,)),
        ("fw_sh", fw_sh, torch.uint8, (B, T + BW + 1)), ("q_lens", q_lens, i32, (B,)),
        ("r0", r0, i32, (B,)),
    ), q_lens.device)
    dev = q_lens.device
    votes = torch.empty((B, T), dtype=i32, device=dev)
    ins = torch.empty((B, T + 1), dtype=i32, device=dev)
    if B == 0:
        return votes, ins
    lib, fns = _fns()
    with torch.cuda.device(dev):
        err = fns[route](
            moves.data_ptr(), end_scores.data_ptr(), row0_score.data_ptr(), fw_sh.data_ptr(),
            q_lens.data_ptr(), r0.data_ptr(), votes.data_ptr(), ins.data_ptr(), B, T, BW,
            torch.cuda.current_stream(dev).cuda_stream, per_block,
        )
    csrc.check(lib, err, "band walk kernel launch")
    LAUNCHES["mask_walk_votes"] += 1
    ROUTE_LAUNCHES[route] += 1
    return votes, ins


def _pack_kernel(bases, wts, src, q_lens, r0, T: int, BW: int):
    from raven_tpu_torch import csrc

    B = q_lens.shape[0]
    N = bases.shape[0]
    _, threads = pack_plan(B, T, BW)
    _check((
        ("bases", bases, torch.uint8, (N,)), ("src", src, torch.int64, (B,)),
        ("q_lens", q_lens, torch.int32, (B,)), ("r0", r0, torch.int32, (B,)),
    ) + ((("wts", wts, torch.uint8, (N,)),) if wts is not None else ()), q_lens.device)
    dev = q_lens.device
    out = torch.empty((B, T + BW + 1), dtype=torch.uint8, device=dev)  # every byte written
    if B == 0:
        return out
    lib, fns = _fns()
    with torch.cuda.device(dev):
        err = fns["band_pack"](
            bases.data_ptr(), wts.data_ptr() if wts is not None else None, src.data_ptr(),
            q_lens.data_ptr(), r0.data_ptr(), out.data_ptr(), B, T, BW,
            torch.cuda.current_stream(dev).cuda_stream, threads,
        )
    csrc.check(lib, err, "band pack kernel launch")
    LAUNCHES["band_pack"] += 1
    ROUTE_LAUNCHES["band_pack"] += 1
    return out


def band_pack(bases, wts, src, q_lens, r0, T: int, BW: int):
    """band_pack on a CUDA tensor, its plain version on a CPU tensor:
    fw_sh [B, T + BW + 1] uint8 (see band_pack_plain)."""
    if q_lens.device.type == "cuda":
        return _pack_kernel(bases, wts, src, q_lens, r0, T, BW)
    if q_lens.device.type == "cpu":
        return band_pack_plain(bases, wts, src, q_lens, r0, T, BW)
    raise ValueError(f"no band pack kernel for device {q_lens.device}")


def band_forward(cw, t_lens, fw_sh, q_lens, r0, T: int, BW: int):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if cw.device.type == "cuda":
        return _forward_kernel(cw, t_lens, fw_sh, q_lens, r0, T, BW)
    if cw.device.type == "cpu":
        return band_forward_plain(cw, t_lens, fw_sh, q_lens, r0, T, BW)
    raise ValueError(f"no banded forward kernel for device {cw.device}")


def mask_walk_votes(moves, end_scores, row0_score, fw_sh, q_lens, r0, T: int, BW: int):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if q_lens.device.type == "cuda":
        return _walk_kernel(moves, end_scores, row0_score, fw_sh, q_lens, r0, T, BW)
    if q_lens.device.type == "cpu":
        return mask_walk_votes_plain(moves, end_scores, row0_score, fw_sh, q_lens, r0, T, BW)
    raise ValueError(f"no band walk kernel for device {q_lens.device}")


def band_votes(moves, end_scores, row0_score, fw_sh, q_lens, r0, win_idx, T: int, BW: int,
               NWIN: int):
    """The walk and the per-window sums: raven_tpu's mask_walk_votes.
    Returns (base_votes [NWIN, T, 5], ins_raw [NWIN, T+1, 4], cover [NWIN,
    T]) int32."""
    votes, ins = mask_walk_votes(moves, end_scores, row0_score, fw_sh, q_lens, r0, T, BW)
    return vote_tables(votes, ins, win_idx, NWIN)
