"""Plain reference of the shift-banded window consensus, window by window.

The semantics are raven_tpu_torch/ops/consensus_band.py's with the plain
versions of its forward and walk (ops/band_cuda.py), copied and frozen
here; nothing of the program is imported.  Each window's fragments align
to its working consensus in a slope-1 band of `bw` lanes placed by the
fragment's span start (scores 3/-5/-4, a free consensus prefix and
suffix); a reverse row walk turns each alignment into votes for a base or
a deletion per consensus row and for an insertion per junction; the
insertion votes move to the start of their homopolymer run; the consensus
is rebuilt from the votes (an insertion once its weight clears a quarter
of the adjacent column's, a column's heaviest base, the old base when
unvoted, nothing when the deletion wins), ITERATIONS times.  Consensus
rows are cut to T_PAD bases, fragments to Q_PAD, span starts clipped to
[0, T_PAD - 1].  The fragments of all windows run as one batch in
plain torch operations on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

# the round's settings: Polisher.CONSENSUS_ITERS and the engine's default
# t_pad, q_pad and bw when this benchmark was written
ITERATIONS = 4
T_PAD = 640
Q_PAD = 768
BW = 256
# fragments a block: its moves take T_PAD x BW bytes a fragment
BLOCK_ROWS = 1 << 17
NEG = -(1 << 20)
MATCH, MISMATCH, GAP = 3, -5, -4
WCAP = 63


def pack(windows, t_pad: int, q_pad: int, bw: int):
    """The batch of every window's fragments: consensus [NWIN, t_pad]
    (-1 past its end), lengths, packed fragments (base | weight << 2, the
    weight 1 without qualities, at most WCAP) stored from column r0 + bw //
    2 + 1 of a [B, t_pad + bw + 1] row, fragment lengths (cut to q_pad),
    span starts (clipped to [0, t_pad - 1]), windows."""
    sw = t_pad + bw + 1
    half = bw // 2 + 1
    nwin = len(windows)
    cons = np.full((nwin, t_pad), -1, np.int32)
    lens = np.zeros(nwin, np.int32)
    for wi, w in enumerate(windows):
        bb = np.asarray(w[0], np.uint8)[:t_pad]
        cons[wi, :bb.size] = bb
        lens[wi] = bb.size
    frags = [np.asarray(f, np.uint8)[:q_pad] for w in windows for f in w[1]]
    wts = [np.ones(f.size, np.uint8) if w[2] is None else np.asarray(w[2][i])[:q_pad]
           for w in windows for i, f in enumerate(w[1])]
    q_lens = np.array([f.size for f in frags], np.int64)
    spans = [w[3] if w[3] is not None else [(0, len(w[0]))] * len(w[1]) for w in windows]
    r0 = np.clip([s[0] for sp in spans for s in sp], 0, t_pad - 1).astype(np.int64)
    win = np.repeat(np.arange(nwin), [len(w[1]) for w in windows])
    B = len(frags)
    n = np.minimum(q_lens, np.maximum(sw - r0 - half, 0))
    first = np.cumsum(n) - n
    row = np.repeat(np.arange(B), n)
    local = np.arange(int(n.sum())) - np.repeat(first, n)
    src_start = np.cumsum(q_lens) - q_lens
    src = np.repeat(src_start, n) + local
    codes = np.concatenate(frags) if B else np.zeros(0, np.uint8)
    weight = np.minimum(np.concatenate(wts), WCAP).astype(np.uint8) if B else codes
    rows = np.zeros((B, sw), np.uint8)
    rows[row, np.repeat(r0 + half, n) + local] = codes[src] | (weight[src] << 2)
    return (cons, lens, rows, q_lens.astype(np.int32), r0.astype(np.int32), win.astype(np.int64))


def forward(cw, t_lens, fw_sh, q_lens, r0, T: int, BW: int):
    """Banded NW forward, one step per consensus row over [B, BW]: lane u
    of row r is fragment column r + u - BW/2 - r0.  Returns (moves [T, B,
    BW] uint8: 0 diag, 1 up or the free column 0, 2 left; end scores [T,
    B], the score at column q_len on a consensus row, else NEG; the row-0
    score)."""
    B = cw.shape[0]
    dev = cw.device
    i32 = torch.int32
    half = BW // 2
    jk = torch.arange(T + BW + 1, dtype=i32, device=dev)[None, :] - half - r0[:, None]
    outside = (jk < 0) | (jk > q_lens[:, None])
    lo = torch.where(outside, NEG, torch.iinfo(i32).min).to(i32)
    hi = torch.where(outside, NEG, torch.iinfo(i32).max).to(i32)
    prev = torch.where(outside[:, :BW], NEG, jk[:, :BW] * GAP).to(i32)
    u4 = torch.arange(BW, dtype=i32, device=dev)[None, :] * -GAP
    fch = (fw_sh & 3).to(torch.int8)
    c8 = cw.clamp(-1, 4).to(torch.int8)
    rows = torch.arange(B, device=dev)
    r0l, qll, tll = r0.long(), q_lens.long(), t_lens.long()
    up = torch.empty((B, BW), dtype=i32, device=dev)
    up[:, -1] = NEG + GAP
    moves = torch.empty((T, B, BW), dtype=torch.uint8, device=dev)
    ends = torch.empty((T, B), dtype=i32, device=dev)
    for r in range(T):
        k = slice(r + 1, r + 1 + BW)
        same = torch.eq(fch[:, k], c8[:, r: r + 1])
        diag = torch.add(prev, same, alpha=MATCH - MISMATCH).add_(MISMATCH)
        torch.add(prev[:, 1:], GAP, out=up[:, :-1])
        e = torch.maximum(diag, up)
        mv = torch.gt(up, diag).to(torch.uint8)
        u0 = half - 1 - r + r0l
        ok0 = (u0 >= 0) & (u0 < BW)
        u0 = u0.clamp(0, BW - 1)
        e[rows, u0] = torch.where(ok0, 0, e[rows, u0])
        mv[rows, u0] = torch.where(ok0, 1, mv[rows, u0]).to(torch.uint8)
        closed = torch.cummax(e + u4, dim=1).values.sub_(u4)
        left = torch.gt(closed, e)
        cur = torch.maximum(closed, e).clamp_(lo[:, k], hi[:, k])
        moves[r] = torch.maximum(mv, left.to(torch.uint8) << 1)
        uq = qll + half - 1 - r + r0l
        okq = (uq >= 0) & (uq < BW) & (r < tll)
        ends[r] = torch.where(okq, cur[rows, uq.clamp(0, BW - 1)], NEG).clamp_(min=NEG)
        prev = cur
    return moves, ends, (q_lens * GAP).to(i32)


def walk(moves, ends, row0, fw_sh, q_lens, r0, T: int, BW: int):
    """The reverse row walk from one row below the first best end row (row
    0 when the row-0 score is at least the best).  Returns (votes [B, T],
    ins [B, T+1]) int32: a vote 1 | col << 1 | w << 4 (col 0-3 a base, 4 a
    deletion), an insertion 1 | base << 1 | w << 3, 0 where none."""
    B = q_lens.shape[0]
    dev = q_lens.device
    i32, i64 = torch.int32, torch.int64
    half = BW // 2
    e64 = ends.long()
    best, best_r = e64.max(dim=0).values, e64.argmax(dim=0)
    t0 = torch.where(row0.long() >= best, 0, best_r + 1)
    ql, rz, fw = q_lens.long(), r0.long(), fw_sh.long()
    kt = torch.int16 if BW < (1 << 15) else i32  # a lane's key, lane + 1
    u1 = torch.arange(1, BW + 1, dtype=kt, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    p = torch.full((B,), -1, dtype=i64, device=dev)
    votes = torch.zeros((B, T), dtype=i32, device=dev)
    ins = torch.zeros((B, T + 1), dtype=i32, device=dev)
    for r in range(T, 0, -1):
        u_init = ql + half + rz - r
        p = torch.where((t0 == r) & (u_init >= 0) & (u_init < BW), u_init, p)
        mv = moves[r - 1]
        fw_row = fw[:, r: r + BW]
        ulo = 1 + half + rz - r
        pc = p.clamp(min=0)
        has_ins = (p >= 0) & (mv[bidx, pc] == 2) & (pc >= ulo)
        ins[:, r] = torch.where(has_ins, 1 | (fw_row[bidx, pc] << 1), 0).to(i32)
        key = (mv != 2).to(kt) * u1
        key = key.masked_fill(u1 > (p + 1)[:, None].to(kt), 0)
        q = key.amax(dim=1).long() - 1
        q = torch.where(q >= ulo, q, -1)
        qc = q.clamp(min=0)
        mv_q = mv[bidx, qc].long()
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


def tables(votes, ins, win, nwin: int):
    """Per-window sums: base votes [NWIN, T, 5] by weight, raw insertion
    votes [NWIN, T+1, 4] by junction."""
    B, T = votes.shape
    dev = votes.device
    col = ((votes >> 1) & 7).long()
    has = ((votes & 1) != 0) & (col <= 4)
    bv = torch.zeros((nwin, T, 5), dtype=torch.int64, device=dev)
    wi = win[:, None].expand(B, T)
    ti = torch.arange(T, device=dev)[None, :].expand(B, T)
    bv.index_put_((wi[has], ti[has], col[has]), (votes >> 4)[has].long(), accumulate=True)
    ion = (ins & 1) != 0
    wj = win[:, None].expand(B, T + 1)
    tj = torch.arange(T + 1, device=dev)[None, :].expand(B, T + 1)
    iv = torch.zeros((nwin, T + 1, 4), dtype=torch.int64, device=dev)
    iv.index_put_((wj[ion], tj[ion], ((ins >> 1) & 3)[ion].long()), (ins >> 3)[ion].long(),
                  accumulate=True)
    return bv, iv


def canonical_insertions(iv, cons, T: int):
    """Insertion votes moved from each junction t to the start of the run
    of base b that ends at t - 1 (the junction itself when cons[t-1] is not
    b)."""
    nwin = cons.shape[0]
    dev = cons.device
    is_b = cons[:, :, None] == torch.arange(4, device=dev)
    pos = torch.arange(1, T + 1, device=dev)[None, :, None]
    starts = torch.cummax(torch.where(is_b, 0, pos), dim=1).values
    runs = torch.cat([torch.zeros((nwin, 1, 4), dtype=starts.dtype, device=dev), starts], dim=1)
    out = torch.zeros_like(iv)
    out.scatter_add_(1, runs.long(), iv)
    return out


def rebuild(cons, lens, bv, iv, T: int, insertion_ties: bool = False):
    """The next consensus of every window, as token rows (-1 past the end)
    and lengths: per junction its heaviest insertion (the first on ties)
    once its weight times 4 exceeds the adjacent column's (or equals it,
    with insertion_ties: the controls' rule), per column its
    heaviest vote (the old base when unvoted, nothing when the deletion
    wins), junction, column, junction, ..."""
    nwin = cons.shape[0]
    dev = cons.device
    L = lens.long()[:, None]
    t_idx = torch.arange(T, device=dev)[None, :]
    tj_idx = torch.arange(T + 1, device=dev)[None, :]
    ib = iv.argmax(dim=2)
    col_sum = bv.sum(dim=2)
    col_w = torch.cat([col_sum[:, :1], col_sum], dim=1)
    ins_w = iv.max(dim=2).values * 4
    ins_on = (iv.sum(dim=2) > 0) & ((ins_w >= col_w) if insertion_ties else (ins_w > col_w))
    ins_on &= tj_idx <= L
    bb = bv.argmax(dim=2)
    unvoted = col_sum == 0
    base = torch.where(unvoted, cons.long(), bb)
    base_on = (unvoted | (bb < 4)) & (t_idx < L)
    # the stream junction 0, column 0, junction 1, ..., column T-1,
    # junction T, with the tokens that are off dropped
    tok = torch.cat([torch.stack([ib[:, :T], base], dim=2).view(nwin, 2 * T), ib[:, T:]], dim=1)
    on = torch.cat([torch.stack([ins_on[:, :T], base_on], dim=2).view(nwin, 2 * T),
                    ins_on[:, T:]], dim=1)
    tok, on = tok.cpu().numpy(), on.cpu().numpy()
    out = np.full((nwin, 2 * T + 1), -1, np.int64)
    n = on.sum(axis=1)
    for w in range(nwin):
        out[w, :n[w]] = tok[w][on[w]]
    return torch.from_numpy(out).to(dev), torch.from_numpy(n).to(dev)


def _block(windows, iterations: int, insertion_ties: bool, device):
    t_pad, bw = T_PAD, BW
    cons, lens, fw, ql, r0, win = (torch.from_numpy(a).to(device)
                                   for a in pack(windows, t_pad, Q_PAD, bw))
    cons = cons.long()
    nwin = len(windows)
    T = t_pad
    for _ in range(iterations):
        # rows at or past every consensus's end hold no end score and no
        # walk: the DP stops at the longest consensus
        t_eff = max(int(lens.max()), 1)
        cw = cons[win, :t_eff].to(torch.int32).contiguous()
        moves, ends, row0 = forward(cw, lens[win].to(torch.int32), fw[:, :t_eff + bw + 1], ql, r0,
                                    t_eff, bw)
        votes, ins = walk(moves, ends, row0, fw[:, :t_eff + bw + 1], ql, r0, t_eff, bw)
        del moves
        votes = torch.nn.functional.pad(votes, (0, T - t_eff))
        ins = torch.nn.functional.pad(ins, (0, T - t_eff))
        bv, iv = tables(votes, ins, win, nwin)
        iv = canonical_insertions(iv, cons, T)
        toks, n = rebuild(cons, lens, bv, iv, T, insertion_ties)
        cons = toks[:, :T].clone()
        lens = n.clamp(max=T).to(torch.int32)
    toks, n = toks.cpu().numpy(), n.cpu().numpy()
    return [toks[w, :n[w]].astype(np.uint8) for w in range(nwin)]


def window_consensus(windows, device, iterations: int = ITERATIONS,
                     insertion_ties: bool = False):
    """Each window's consensus (uint8 numpy arrays) after `iterations`
    rounds of alignment, votes and rebuild; the windows in blocks of at
    most BLOCK_ROWS fragments.  Another iteration count and the insertion
    rule are the controls'."""
    out = []
    lo = 0
    while lo < len(windows):
        hi, rows = lo, 0
        while hi < len(windows) and (hi == lo or rows + len(windows[hi][1]) <= BLOCK_ROWS):
            rows += len(windows[hi][1])
            hi += 1
        out.extend(_block(windows[lo:hi], iterations, insertion_ties, device))
        lo = hi
    return out
