"""Window-consensus votes: the CUDA kernel K2 and its plain PyTorch version.

`votes_primitives(cw, tlens, frags, qlens, wts)` is the port of the TPU
kernel raven_tpu/ops/pallas_consensus.py::pallas_votes_primitives.  On a
CUDA tensor it launches the hand-written kernel in
raven_tpu_torch/csrc/consensus.cu (see the note there for what it computes,
what bounds it and how the design answers that) or raises; on a CPU tensor
it runs `votes_primitives_plain`, the same function in torch ops.  Both
return (col_sym, col_w) [B, T] and (ins_b, ins_w) [B, T+1], int32,
bit-identical to the TPU kernel's outputs (whose insertion tables are
[B, TP] with TP = T+1 rounded up to 128; the columns past T+1 are never
written there).

`votes_from_primitives` is the epilogue (integer scatter-adds into the
per-window tables), `fused_votes` the drop-in for
raven_tpu.ops.consensus_device.fused_votes_kernel(band=0) and
`fused_votes_pallas` the one for raven_tpu's fused_votes_pallas.  The two
raven_tpu functions pick the walk's start row by different rules, which
part once a fragment's end values all fall below NEG (q_len * |GAP| >
2^20): each port function takes the rule of the function it stands for
(votes_primitives_plain's `argmax`).

`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel, and `ROUTE_LAUNCHES` counts them per route:
`launch_plan` picks, from the shape, the 16-bit pair route
("votes_primitives", two fragments a warp) or the int32 route
("votes_primitives_i32", one a warp) past its limits.
"""

from __future__ import annotations

import ctypes

import torch

from raven_tpu_torch.csrc import SMEM_BYTES

MATCH, MISMATCH, GAP = 3, -5, -4
NEG = -(1 << 20)
LAUNCHES = 0
ROUTE_LAUNCHES = {"votes_primitives": 0, "votes_primitives_i32": 0}
PAIR_MAX_Q = 1024  # the pair route's column tiles: four of 256
PAIR_BIAS = 0xC000  # the pair route's values D - 3r + 0xC000 lie in 16 bits
# the int32 route's values and positions lie within 4 (T + Q) + 1024 of 0
I32_MAX_TQ = ((1 << 31) - 1 - 1024) // 4
RUN_WINDOW = 64  # the plain walk's cells of a left run a step
BOX_WORDS = 64 * 8  # the pair route's traceback box


def votes_primitives_plain(cw, tlens, frags, qlens, wts, argmax: bool = False):
    """cw [B, T] int32 window consensus per fragment (pad < 0), tlens [B],
    frags / wts [B, Q] int32 (frags pad -1, weights 0-255), qlens [B].
    Returns (col_sym, col_w [B, T], ins_b, ins_w [B, T+1]) int32.

    The forward is a loop over the T rows of [B, Q] tensors with a row-wise
    cummax for the left closure; the traceback walks all B fragments in
    lockstep and the walk's moves turn into vote primitives as raven_tpu's
    _votes_from_paths turns them.  A step of the walk takes one diag or up
    move, or a whole run of left moves up to RUN_WINDOW columns at a time
    (a run casts one insertion, at its first move), so a walk takes about
    two steps a consensus row however long its fragment is.  Rows at or
    past max(tlens) and columns past max(qlens) never reach an output, so
    they are not computed.

    The walk's start row: with argmax False, the Pallas kernel's rule (the
    first active row whose end value exceeds NEG and is the greatest, row 0
    when none does); with argmax True, raven_tpu's nw_moves_kernel and
    traceback_kernel's (jnp.argmax over every row's end value, NEG on the
    rows at or past tlen, so once every end value is below NEG the first
    such row wins, and a walk that starts there reads move 3 and casts
    nothing).  The two part only where q_len * |GAP| > 2^20."""
    B, T = cw.shape
    Q = frags.shape[1]
    dev = cw.device
    i32, i64 = torch.int32, torch.int64
    tl = tlens.to(i64).clamp(0, T)
    ql = qlens.to(i64).clamp(0, Q)
    if B == 0:
        return _decode(torch.zeros((0, T), dtype=i32, device=dev),
                       torch.zeros((0, T + 1), dtype=i32, device=dev))
    Te = max(int(tl.max()), 1)
    Qe = max(int(ql.max()), 1)
    # DP values lie within +-4 (T + Q): int16 holds them at the consensus
    # shapes and halves the memory traffic of every row op
    vt = torch.int16 if 8 * (T + Q) < (1 << 15) else i32
    f = frags[:, :Qe].to(vt)
    c = cw.to(vt)
    jg = (torch.arange(1, Qe + 1, dtype=vt, device=dev) * GAP)[None, :]
    rows = torch.arange(B, device=dev)

    # forward: moves 0 diag, 1 up, 2 left; the value at column q_len per
    # row.  Integer arithmetic only (no bool tensors, no where): the
    # substitution score is MATCH - 8 min(|f - c|, 1), the move
    # max(up > diag, 2 (closed > e)), each comparison a clamp of a
    # difference to [0, 1].
    moves = torch.empty((Te, B, Qe), dtype=torch.int8, device=dev)
    ends = torch.empty((Te, B), dtype=i32, device=dev)
    prev = jg.expand(B, Qe).contiguous()
    diag = torch.empty((B, Qe), dtype=vt, device=dev)
    qcol = (ql - 1).clamp(min=0)
    for r in range(Te):
        sub = MATCH - (MATCH - MISMATCH) * (f - c[:, r : r + 1]).abs_().clamp_(max=1)
        diag[:, 0] = sub[:, 0]  # D[r-1][0] = 0
        torch.add(prev[:, :-1], sub[:, 1:], out=diag[:, 1:])
        up = prev + GAP
        e = torch.maximum(diag, up)
        closed = torch.cummax(e - jg, dim=1).values.clamp_(min=0).add_(jg)
        moves[r] = torch.maximum(
            (up - diag).clamp_(0, 1), (closed - e).clamp_(0, 1).mul_(2)
        )
        prev = torch.maximum(closed, e)
        ends[r] = prev[rows, qcol]
    # the best end over the active rows, the first maximum row winning
    active = (torch.arange(Te, device=dev)[:, None] < tl[None, :]) & (ql > 0)
    ends = torch.where(active, ends, NEG)
    if argmax and Te < T:
        # the rows past every consensus: NEG for all, the first standing
        # for them all
        ends = torch.cat([ends, torch.full((1, B), NEG, dtype=i32, device=dev)])
    best_val, best_r = ends.max(dim=0)  # ties: the first maximal row
    if not argmax:
        best_r = torch.where(best_val > NEG, best_r, 0)
        best_val = best_val.clamp(min=NEG)
    t = torch.where(ql * GAP >= best_val, 0, best_r + 1)
    j = ql.clone()
    if argmax:
        # move 3 on a row past the consensus: no walk (t 0 keeps the walk's
        # gather inside `moves`, whose rows end at Te)
        past = t > tl
        j = torch.where(past, 0, j)
        t = torch.where(past, 0, t)

    # the walk in lockstep.  A step looks at the run of up to W cells
    # from (t, j) leftwards on the walker's row: the first that is column 0
    # or holds another move than left ends it (every cell of row 0 is left)
    W = min(RUN_WINDOW, Qe + 1)
    kk = torch.arange(W, device=dev)
    mflat = moves.reshape(-1)
    pk = (frags.to(i64).clamp(0, 3) | (wts.to(i64) << 2)).reshape(-1)
    row_q = rows * Q
    in_run = torch.zeros(B, dtype=torch.bool, device=dev)
    hist_t, hist_j, hist_kind = [], [], []  # kind 0 diag, 1 up, 2 insertion, 3 none
    while True:
        walking = j > 0
        if not bool(walking.any()):
            break
        cols = j[:, None] - kk[None, :]  # the run's cells, j down to j - W + 1
        base = ((t - 1).clamp(min=0) * B + rows) * Qe
        mv = mflat[(base[:, None] + (cols - 1).clamp(0, Qe - 1)).reshape(-1)].view(B, W)
        mv = torch.where(t[:, None] > 0, mv.to(i64), 2)
        stop = (cols <= 0) | (mv != 2)
        k = stop.to(torch.int8).argmax(dim=1)  # the first stop; 0 when none
        found = stop.any(dim=1)
        here = mv[:, 0]
        step_col = walking & (here != 2)
        step_ins = walking & (here == 2) & ~in_run
        hist_t.append(t)
        hist_j.append(j)
        hist_kind.append(torch.where(step_col, here, torch.where(step_ins, 2, 3)))
        left = walking & (here == 2)
        t = t - step_col.to(i64)
        j = j - (step_col & (here == 0)).to(i64) - torch.where(left, torch.where(found, k, W), 0)
        in_run = left & ~found
    if not hist_t:
        return _decode(torch.zeros((B, T), dtype=i32, device=dev),
                       torch.zeros((B, T + 1), dtype=i32, device=dev))
    hist_t, hist_j, kind = (torch.stack(h) for h in (hist_t, hist_j, hist_kind))
    hist_pk = pk[row_q + (hist_j - 1).clamp(min=0)]

    # vote primitives: a column vote per diag/up move at row t-1, an
    # insertion where a run of left moves starts (in walk order); every
    # (fragment, row) gets at most one of each, the rest lands in a dump
    # slot
    fb = hist_pk & 3
    fw = hist_pk >> 2
    diag_up = kind <= 1
    sym = torch.where(kind == 0, fb, 4)
    is_ins = kind == 2
    col_pack = torch.zeros(B * (T + 1), dtype=i32, device=dev)
    col_pack[rows * (T + 1) + torch.where(diag_up, hist_t - 1, T)] = torch.where(
        diag_up, 1 | (sym << 1) | (fw << 4), 0
    ).to(i32)
    ins_pack = torch.zeros(B * (T + 2), dtype=i32, device=dev)
    ins_pack[rows * (T + 2) + torch.where(is_ins, hist_t, T + 1)] = torch.where(
        is_ins, 1 | (fb << 1) | (fw << 3), 0
    ).to(i32)
    return _decode(
        col_pack.reshape(B, T + 1)[:, :T], ins_pack.reshape(B, T + 2)[:, : T + 1]
    )


def _decode(col_pack, ins_pack):
    """The TPU wrapper's decoding of the packed primitives
    (pallas_consensus.py:297-302)."""
    col_has = (col_pack & 1) != 0
    col_sym = torch.where(col_has, (col_pack >> 1) & 7, 5).to(torch.int32)
    col_w = torch.where(col_has, col_pack >> 4, 0).to(torch.int32)
    ins_has = (ins_pack & 1) != 0
    ins_b = torch.where(ins_has, (ins_pack >> 1) & 3, -1).to(torch.int32)
    ins_w = torch.where(ins_has, ins_pack >> 3, 0).to(torch.int32)
    return col_sym, col_w, ins_b, ins_w


def _check(cw, tlens, frags, qlens, wts):
    if cw.dim() != 2 or frags.dim() != 2 or wts.shape != frags.shape:
        raise TypeError(
            f"cw must be [B, T] and frags, wts [B, Q], got {tuple(cw.shape)}, "
            f"{tuple(frags.shape)}, {tuple(wts.shape)}"
        )
    B = cw.shape[0]
    for name, x, shape in (
        ("cw", cw, (B, cw.shape[1])), ("tlens", tlens, (B,)),
        ("frags", frags, (B, frags.shape[1])), ("qlens", qlens, (B,)),
        ("wts", wts, (B, frags.shape[1])),
    ):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise TypeError(f"{name} must be {list(shape)} int32, got {x.dtype} {tuple(x.shape)}")
        if x.device != cw.device:
            raise ValueError("all inputs must lie on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_plan(T: int, Q: int) -> tuple[str, int]:
    """K2's route for [T, Q] and its fragments a block: ("votes_primitives",
    2), the 16-bit pair route, while Q <= PAIR_MAX_Q, 4Q + 3T + 8 <=
    0xC000 and a warp's shared memory (max(2T + 97, 2 boxes) + 2Q + 4T + 2
    words; at Q 768, T <= 9,412) fits a block's; else
    ("votes_primitives_i32", 1), which keeps nothing of T or Q in shared
    memory.  Raises ValueError below T, Q = 1 and past T + Q = I32_MAX_TQ,
    where the int32 route's values would leave int32."""
    if T < 1 or Q < 1:
        raise ValueError(f"K2 takes T >= 1 and Q >= 1, got T={T}, Q={Q}")
    if T + Q > I32_MAX_TQ:
        raise ValueError(
            f"K2 takes T + Q up to {I32_MAX_TQ}, got T={T}, Q={Q}: its DP values and "
            f"positions, within 4 (T + Q) + 1024 of 0, would leave int32")
    words = max(2 * T + 97, 2 * BOX_WORDS) + 2 * Q + 4 * T + 2
    if Q <= PAIR_MAX_Q and 4 * Q + 3 * T + 8 <= PAIR_BIAS and 4 * words <= SMEM_BYTES:
        return "votes_primitives", 2
    return "votes_primitives_i32", 1


def i32_moves_words(B: int, T: int, Q: int) -> int:
    """The int32 route's move scratch in 32-bit words: a 16-bit word a
    lane and step, T + 31 steps a tile of 256 columns
    (consensus.cu's votes_primitives_i32_kernel)."""
    return B * -(-Q // 256) * (T + 31) * 16


_FNS = None


def _fns():
    """The launcher's C functions, typed once per process."""
    global _FNS
    if _FNS is None:
        from raven_tpu_torch import csrc

        lib = csrc.load("consensus")
        words = lib.raven_votes_moves_words
        words.restype = ctypes.c_longlong
        words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        fn = lib.raven_votes_primitives_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        fn_i32 = lib.raven_votes_primitives_i32_launch
        fn_i32.restype = ctypes.c_int
        fn_i32.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int,
        ]
        _FNS = lib, words, fn, fn_i32
    return _FNS


def _kernel(cw, tlens, frags, qlens, wts, argmax: bool = False):
    """K2 on the card; `argmax` picks the walk's start row as
    votes_primitives_plain's does (the pair route's shapes never reach
    NEG, where the two rules part, so only the int32 route takes it)."""
    global LAUNCHES
    from raven_tpu_torch import csrc

    _check(cw, tlens, frags, qlens, wts)
    B, T = cw.shape
    Q = frags.shape[1]
    route, per_block = launch_plan(T, Q)
    dev = cw.device
    col_sym = torch.empty((B, T), dtype=torch.int32, device=dev)
    col_w = torch.empty((B, T), dtype=torch.int32, device=dev)
    ins_b = torch.empty((B, T + 1), dtype=torch.int32, device=dev)
    ins_w = torch.empty((B, T + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return col_sym, col_w, ins_b, ins_w
    lib, words, fn, fn_i32 = _fns()
    outs = [x.data_ptr() for x in (col_sym, col_w, ins_b, ins_w)]
    ins = [x.data_ptr() for x in (cw, tlens, frags, qlens, wts)]
    if route == "votes_primitives":
        moves = torch.empty(words(B, T, Q), dtype=torch.int32, device=dev)
        ptrs, rule = [*ins, moves.data_ptr(), *outs], []
    else:  # the moves' and the row ends' scratch
        moves = torch.empty(i32_moves_words(B, T, Q), dtype=torch.int32, device=dev)
        bnd = torch.empty(B * (T + 1), dtype=torch.int32, device=dev)
        fn, ptrs = fn_i32, [*ins, moves.data_ptr(), bnd.data_ptr(), *outs]
        rule = [int(argmax)]
    # the tensors' card is current for the launch and its shared-memory
    # limit, and the launch goes on that card's stream
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, T, Q, torch.cuda.current_stream(dev).cuda_stream, per_block, *rule)
    csrc.check(lib, err, "window consensus kernel launch")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return col_sym, col_w, ins_b, ins_w


def votes_primitives(cw, tlens, frags, qlens, wts):
    """K2 on a CUDA tensor, its plain version on a CPU tensor, with the
    Pallas kernel's start row (raven_tpu's pallas_votes_primitives)."""
    return _votes(cw, tlens, frags, qlens, wts, False)


def _votes(cw, tlens, frags, qlens, wts, argmax: bool):
    if cw.device.type == "cuda":
        return _kernel(cw, tlens, frags, qlens, wts, argmax)
    if cw.device.type == "cpu":
        return votes_primitives_plain(cw, tlens, frags, qlens, wts, argmax)
    raise ValueError(f"no window consensus kernel for device {cw.device}")


_ARANGES: dict = {}


def _arange(n: int, device) -> torch.Tensor:
    """torch.arange(n) on `device`, made once per process."""
    key = (n, str(device))
    if key not in _ARANGES:
        _ARANGES[key] = torch.arange(n, device=device)
    return _ARANGES[key]


def votes_from_primitives(col_sym, col_w, ins_b, ins_w, win_idx, cons_runs, T, NWIN):
    """Aggregate per-fragment primitives into the per-window vote tables
    (raven_tpu/ops/pallas_consensus.py::votes_from_primitives) with integer
    index_add_.  An entry that carries no vote adds 0 at its own (clamped)
    cell: one dump slot for all of them would put about a million atomic
    adds on one address a chunk.  The call is a short run of small ops whose
    launches outlast their device work on a card, so it keeps them few: the
    index arithmetic in adds with alpha, one zero fill for the three tables,
    the junction map read by take.  Returns (base_votes [NWIN, T, 5],
    ins_votes [NWIN, T+1, 4], cover [NWIN, T]) int32."""
    dev = col_sym.device
    w = win_idx.to(torch.int64)[:, None]
    n_base, n_cell = NWIN * T * 5, NWIN * T
    tables = torch.zeros(n_base + n_cell + NWIN * (T + 1) * 4, dtype=torch.int32, device=dev)
    base = tables[:n_base]
    cover = tables[n_base : n_base + n_cell]
    ins = tables[n_base + n_cell :]
    cell = torch.add(_arange(T, dev), w, alpha=T)  # w * T + t
    valid = col_sym < 5
    base.index_add_(
        0, torch.add(col_sym.clamp(0, 4), cell, alpha=5).view(-1),
        torch.where(valid, col_w, 0).view(-1),
    )
    cover.index_add_(0, cell.view(-1), valid.to(torch.int32).view(-1))
    fb = ins_b.clamp(0, 3)
    jrow = torch.add(_arange(T + 1, dev), w, alpha=T + 1)  # w * (T + 1) + t
    junction = cons_runs.reshape(-1).take(torch.add(fb, jrow, alpha=4))
    ins.index_add_(
        0, torch.add(fb, torch.add(junction, w, alpha=T + 1), alpha=4).view(-1),
        torch.where(ins_b >= 0, ins_w, 0).view(-1),
    )
    return base.view(NWIN, T, 5), ins.view(NWIN, T + 1, 4), cover.view(NWIN, T)


def fused_votes(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, T, Q, NWIN):
    """Vote tables of one fragment chunk: the drop-in for
    raven_tpu.ops.consensus_device.fused_votes_kernel(band=0), through K2
    on the card with that function's start row (jnp.argmax over the end
    values).  cons_arr [NWIN, T] (pad < 0), cons_lens [NWIN], cons_runs
    [NWIN, T+1, 4], frags / wts [B, Q], q_lens, win_idx [B], all int32 on
    one device.  Returns (base_votes [NWIN, T, 5], ins_votes [NWIN, T+1,
    4], cover [NWIN, T]) int32."""
    return _fused(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, T, Q, NWIN, True)


def fused_votes_pallas(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, T, Q,
                       NWIN):
    """fused_votes with the Pallas kernel's start row: the drop-in for
    raven_tpu.ops.pallas_consensus.fused_votes_pallas, which raven_tpu's
    engine takes with RAVEN_TPU_PALLAS_CONSENSUS=1 (the port's
    consensus_device.PALLAS_CONSENSUS)."""
    return _fused(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, T, Q, NWIN,
                  False)


def _fused(cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, T, Q, NWIN, argmax):
    if cons_arr.shape != (NWIN, T) or frags.shape[1] != Q:
        raise ValueError(
            f"cons_arr {tuple(cons_arr.shape)} / frags {tuple(frags.shape)} do "
            f"not match NWIN={NWIN}, T={T}, Q={Q}"
        )
    wi = win_idx.to(torch.int64)
    cw = cons_arr[wi].contiguous()
    cwl = cons_lens[wi].contiguous()
    col_sym, col_w, ins_b, ins_w = _votes(cw, cwl, frags, q_lens, wts, argmax)
    return votes_from_primitives(col_sym, col_w, ins_b, ins_w, win_idx, cons_runs, T, NWIN)
