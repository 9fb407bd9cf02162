"""Batched window consensus on the device (the polisher's device path).

The port of raven_tpu/ops/consensus_device.py: every window fragment aligns
to its window's working consensus in one batched NW (scores 3/-5/-4, free
consensus prefix and suffix), the traceback turns each alignment into
per-row vote primitives, the votes sum into per-window tables on the
device, and the host rebuilds each consensus from them.  Iterations refine
the consensus against the same fragments.  Two engines: the full-NW
rectangle (kernel K2, ops/consensus_cuda.py) and, with banded=True, the
anchored banded NW whose band follows each fragment's placement on the
window (kernels K9 and K10, ops/banded_cuda.py).

Shapes are those of raven_tpu: consensus rows padded to t_pad, fragments
to q_pad, fragment rows to whole chunks, windows to a power of two.  The
host helpers homopolymer_run_map, consensus_votes and rebuild_consensus
are copies.  With a mesh the fragment chunks are dealt over its devices
and the vote tables summed on the first (raven_tpu's mesh-sharded votes);
across processes each rank runs its own devices' chunks and the sums are
all-reduced, so every rank rebuilds the same consensus.
"""

from __future__ import annotations

import numpy as np
import torch

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.ops.banded_cuda import fused_votes_banded
from raven_tpu_torch.ops.consensus_cuda import fused_votes, fused_votes_pallas
from raven_tpu_torch.parallel.mesh import local_blocks, sum_on_first

# raven_tpu's RAVEN_TPU_PALLAS_CONSENSUS=1: without a mesh, every call takes
# fused_votes_pallas (the Pallas kernel's start row), banded or not
PALLAS_CONSENSUS = False


def _pow2_of(v: int, lo: int = 128) -> int:
    c = lo
    while c < v:
        c <<= 1
    return c


def device_window_consensus(
    windows: list[tuple[np.ndarray, list[np.ndarray], list[np.ndarray] | None]],
    iterations: int = 2,
    t_pad: int = 640,
    q_pad: int = 768,
    chunk: int = 2048,
    banded: bool = False,
    mesh=None,
    device=None,
) -> list[np.ndarray]:
    """Batched consensus for many windows at once, on `device` (CUDA by
    default), or over the devices of `mesh` (raven_tpu.parallel.mesh's
    counterpart, raven_tpu_torch.parallel.mesh.Mesh).

    windows: [(backbone, fragments, weights-or-None[, spans])], spans one
    (r0, r1) placement on the backbone a fragment, (0, len(backbone)) when
    absent.  Returns one consensus array per window, token for token what
    raven_tpu's device_window_consensus returns.  Each iteration sends every
    chunk of `chunk` fragment rows through fused_votes (banded: through
    fused_votes_banded, with the anchors rescaled to the current consensus
    lengths) and sums the tables, as raven_tpu's fused_votes_scan_kernel
    (fused_votes_banded_scan_kernel) does.  With a mesh, the chunks are
    padded to a multiple of its size and dealt to its devices in contiguous
    blocks; each device sums its own chunks' tables, and the tables meet
    on the first device, summed there (raven_tpu's _votes_step_sharded:
    integer sums, so the consensus is the one device's, bit for bit).
    Across processes each rank takes its own devices' blocks and the
    local sums are all-reduced (mesh.py's sum_on_first).  With
    PALLAS_CONSENSUS and no mesh, every chunk goes through
    fused_votes_pallas instead, banded or not, as raven_tpu's engine does
    with RAVEN_TPU_PALLAS_CONSENSUS=1.
    """
    devices = mesh.devices if mesh is not None else (resolve_device(device),)
    home = mesh.first if mesh is not None else devices[0]
    # the anchored band's width (lane-aligned)
    BW = min(256, _pow2_of(q_pad))
    n_win = len(windows)
    cons = [np.asarray(w[0], np.uint8) for w in windows]
    frags_arr, w_arr, q_lens, win_of_arr, span0, span1, B_total = flatten_fragments(
        windows, q_pad, chunk * len(devices)
    )
    if B_total == 0:
        return cons
    B_pad = frags_arr.shape[0]
    NWIN = 8
    while NWIN < n_win:
        NWIN *= 2
    n_frags = np.bincount(win_of_arr[:B_total], minlength=n_win)
    bb_lens = [len(w[0]) for w in windows]

    # fragments and weights do not change between iterations: on each
    # device once, its block of rows
    blocks = (
        local_blocks(mesh, B_pad) if mesh is not None else [(home, slice(0, B_pad))]
    )
    shards = [
        (dev, rows, *(
            torch.from_numpy(a[rows]).to(dev)
            for a in (frags_arr, w_arr, q_lens, win_of_arr)
        ))
        for dev, rows in blocks
    ]

    pallas = PALLAS_CONSENSUS and mesh is None
    for _ in range(iterations):
        cons_arr, cons_lens = pad_consensus(cons, t_pad, NWIN)
        cons_runs = homopolymer_run_map(cons_arr, cons_lens)
        if banded or mesh is not None:
            # raven_tpu rescales the anchors whenever it has a mesh; only
            # the banded kernels read them
            r0, r1 = rescale_anchors(span0, span1, win_of_arr, B_total, cons_lens, bb_lens)
        tables = []
        for dev, rows, frags_dev, wts_dev, qlens_dev, winof_dev in shards:
            cons_dev, clens_dev, cruns_dev = (
                torch.from_numpy(a).to(dev) for a in (cons_arr, cons_lens, cons_runs)
            )
            if banded and not pallas:
                r0_dev, r1_dev = (torch.from_numpy(a[rows]).to(dev) for a in (r0, r1))
            bv = torch.zeros((NWIN, t_pad, 5), dtype=torch.int32, device=dev)
            iv = torch.zeros((NWIN, t_pad + 1, 4), dtype=torch.int32, device=dev)
            cv = torch.zeros((NWIN, t_pad), dtype=torch.int32, device=dev)
            for c0 in range(0, rows.stop - rows.start, chunk):
                sl = slice(c0, c0 + chunk)
                if pallas:
                    b_, i_, c_ = fused_votes_pallas(
                        cons_dev, clens_dev, cruns_dev, frags_dev[sl],
                        qlens_dev[sl], wts_dev[sl], winof_dev[sl], t_pad, q_pad,
                        NWIN,
                    )
                elif banded:
                    b_, i_, c_ = fused_votes_banded(
                        cons_dev, clens_dev, cruns_dev, frags_dev[sl],
                        qlens_dev[sl], wts_dev[sl], winof_dev[sl], r0_dev[sl],
                        r1_dev[sl], t_pad, q_pad, BW, NWIN,
                    )
                else:
                    b_, i_, c_ = fused_votes(
                        cons_dev, clens_dev, cruns_dev, frags_dev[sl],
                        qlens_dev[sl], wts_dev[sl], winof_dev[sl], t_pad, q_pad,
                        NWIN,
                    )
                bv += b_
                iv += i_
                cv += c_
            tables.append((bv, iv, cv))
        bv, iv, cv = sum_on_first(tables, home, mesh.group if mesh is not None else None)
        base_votes = bv.cpu().numpy().astype(np.int64)
        ins_votes = iv.cpu().numpy().astype(np.int64)
        cover = cv.cpu().numpy().astype(np.int64)

        cons = [
            rebuild_consensus(
                cons_arr[wi],
                int(cons_lens[wi]),
                base_votes[wi],
                ins_votes[wi],
                cover[wi],
                int(n_frags[wi]),
            )
            for wi in range(n_win)
        ]
    return cons


def flatten_fragments(windows, q_pad: int, chunk: int):
    """The fragment rows of `windows` ((backbone, fragments, weights-or-None[,
    spans]) each) in window order, cut to q_pad and padded to a whole number
    of chunks of `chunk` rows.  Returns (frags [B_pad, q_pad] int32, pad -1;
    wts [B_pad, q_pad] int32, 1 everywhere when no window has weights, else
    0 past each fragment; q_lens, win_of, span0, span1 [B_pad] int32;
    B_total, the rows that are fragments).  span0 / span1 is a fragment's
    placement on its backbone, (0, len(backbone)) without spans, span1 at
    least span0 + 1; padding rows are in window 0 with q_len 0 and (0, 1)."""
    frag_rows: list[np.ndarray] = []
    weight_rows: list[np.ndarray] = []
    win_of: list[int] = []
    span_rows: list[tuple[int, int]] = []
    any_weights = any(w[2] is not None for w in windows)
    for wi, w in enumerate(windows):
        bb, frags, wts = w[:3]
        spans = w[3] if len(w) > 3 else None
        for fi, f in enumerate(frags):
            f = np.asarray(f, np.uint8)[:q_pad]
            frag_rows.append(f)
            if any_weights:
                wrow = (
                    np.asarray(wts[fi], np.uint8)[:q_pad]
                    if wts is not None
                    else np.full(f.size, 1, np.uint8)
                )
                weight_rows.append(wrow)
            win_of.append(wi)
            span_rows.append(
                tuple(spans[fi]) if spans is not None else (0, len(bb))
            )
    B_total = len(frag_rows)
    B_pad = -(-B_total // chunk) * chunk
    win_of_arr = np.zeros(B_pad, dtype=np.int32)
    win_of_arr[:B_total] = np.array(win_of, dtype=np.int32)
    q_lens = np.zeros(B_pad, dtype=np.int32)
    q_lens[:B_total] = [f.size for f in frag_rows]
    frags_arr = np.full((B_pad, q_pad), -1, dtype=np.int32)
    for i, f in enumerate(frag_rows):
        frags_arr[i, : f.size] = f
    w_arr = np.ones((B_pad, q_pad), dtype=np.int32)
    if any_weights:
        w_arr[:] = 0
        for i, wrow in enumerate(weight_rows):
            w_arr[i, : wrow.size] = wrow
    span0 = np.zeros(B_pad, dtype=np.int32)
    span1 = np.ones(B_pad, dtype=np.int32)
    span0[:B_total] = [s[0] for s in span_rows]
    span1[:B_total] = [max(s[1], s[0] + 1) for s in span_rows]
    return frags_arr, w_arr, q_lens, win_of_arr, span0, span1, B_total


def pad_consensus(cons: list[np.ndarray], t_pad: int, NWIN: int):
    """The working consensus of each window cut to t_pad: (cons_arr [NWIN,
    t_pad] int32, pad -1; cons_lens [NWIN] int32, 0 past the windows)."""
    cons_arr = np.full((NWIN, t_pad), -1, dtype=np.int32)
    cons_lens = np.zeros(NWIN, dtype=np.int32)
    for wi, c in enumerate(cons):
        cl = min(c.size, t_pad)
        cons_arr[wi, :cl] = c[:cl]
        cons_lens[wi] = cl
    return cons_arr, cons_lens


def rescale_anchors(span0, span1, win_of, B_total: int, cons_lens, backbone_lens):
    """The banded engine's anchors for one iteration, raven_tpu's rescale:
    each fragment row's placement (span0, span1), in backbone rows, scaled
    by its window's current consensus length over its backbone's length (at
    least 1), in float64; r0 truncated, r1 truncated and at least r0 + 1.
    Padding rows past B_total get (0, 1).  Returns (r0, r1) int32."""
    orig_len = np.maximum(np.asarray(backbone_lens, dtype=np.float64), 1)
    scale = cons_lens[: orig_len.size].astype(np.float64) / orig_len
    sc = scale[win_of[:B_total]]
    r0 = np.zeros(win_of.size, dtype=np.int32)
    r1 = np.ones(win_of.size, dtype=np.int32)
    r0[:B_total] = (span0[:B_total] * sc).astype(np.int32)
    r1[:B_total] = np.maximum((span1[:B_total] * sc).astype(np.int32), r0[:B_total] + 1)
    return r0, r1


def homopolymer_run_map(cons_arr: np.ndarray, cons_lens: np.ndarray) -> np.ndarray:
    """cons_runs[w, t, b]: canonical junction index for inserting base b
    before position t — the start of the maximal run of b ending at t-1.

    Vectorized: the run start is the most recent junction whose preceding
    character differs from b (a running maximum over break positions)."""
    n_win, T = cons_arr.shape
    t_idx = np.arange(T + 1, dtype=np.int32)
    # breaks[w, t, b] = t where cons[w, t-1] != b (junction resets), else 0;
    # t = 0 is always a break
    is_b = cons_arr[:, :, None] == np.arange(4, dtype=cons_arr.dtype)
    breaks = np.where(is_b, 0, t_idx[None, 1:, None]).astype(np.int32)
    runs = np.empty((n_win, T + 1, 4), dtype=np.int32)
    runs[:, 0, :] = 0
    np.maximum.accumulate(breaks, axis=1, out=breaks)
    runs[:, 1:, :] = breaks
    return runs


def consensus_votes(
    path_t: np.ndarray,
    path_q: np.ndarray,
    path_mv: np.ndarray,
    frags: np.ndarray,
    weights: np.ndarray | None,
    win_of: np.ndarray,
    n_windows: int,
    T: int,
    cons_runs: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate alignment paths into per-column votes (host, vectorized).

    Returns (base_votes [n_windows, T, 5], ins_votes [n_windows, T+1, 4],
    cover [n_windows, T]): base_votes[..., 0:4] substitution/match weights,
    [..., 4] deletion weight; ins_votes counts the first inserted base of
    each insertion run at the junction before consensus position t.
    """
    STEPS, B = path_mv.shape
    w = (
        weights
        if weights is not None
        else np.ones(frags.shape, dtype=np.uint8)
    )
    base_votes = np.zeros((n_windows, T, 5), dtype=np.int64)
    ins_votes = np.zeros((n_windows, T + 1, 4), dtype=np.int64)
    cover = np.zeros((n_windows, T), dtype=np.int64)

    mv = path_mv.reshape(-1)
    t = path_t.reshape(-1)
    q = path_q.reshape(-1)
    frag_idx = np.broadcast_to(np.arange(B), (STEPS, B)).reshape(-1)
    win = win_of[frag_idx]

    # homopolymer canonicalization: inserting/deleting base b anywhere in a
    # run of b is one and the same edit; alignments scatter such votes
    # across the run's junctions, so votes are moved to the run start
    # (cons_runs[w, t, b] = canonical junction for inserting b before t)
    if cons_runs is None:
        cons_runs = np.broadcast_to(
            np.arange(T + 1, dtype=np.int32)[None, :, None],
            (n_windows, T + 1, 4),
        )

    # diagonal: fragment base q-1 votes at consensus position t-1
    sel = mv == 0
    if sel.any():
        fb = frags[frag_idx[sel], q[sel] - 1]
        fw = w[frag_idx[sel], q[sel] - 1].astype(np.int64)
        np.add.at(base_votes, (win[sel], t[sel] - 1, fb), fw)
        np.add.at(cover, (win[sel], t[sel] - 1), 1)
    # up: deletion at consensus position t-1; weight proxied by the quality
    # of the last consumed fragment base
    sel = mv == 1
    if sel.any():
        fw = w[frag_idx[sel], np.clip(q[sel] - 1, 0, None)].astype(np.int64)
        np.add.at(base_votes, (win[sel], t[sel] - 1, 4), fw)
        np.add.at(cover, (win[sel], t[sel] - 1), 1)
    # left: insertion of fragment base q-1 at junction before position t;
    # only the first base of each run votes (longer runs are rare and
    # resolved over refinement iterations)
    sel = mv == 2
    if sel.any():
        prev_mv = np.concatenate(
            [np.full((1, B), 3, path_mv.dtype), path_mv[:-1]]
        ).reshape(-1)
        first = sel & (prev_mv != 2)  # reverse-order: run boundary
        fb = frags[frag_idx[first], q[first] - 1]
        fw = w[frag_idx[first], q[first] - 1].astype(np.int64)
        junction = cons_runs[win[first], t[first], fb]
        np.add.at(ins_votes, (win[first], junction, fb), fw)
    return base_votes, ins_votes, cover


def rebuild_consensus(
    cons: np.ndarray,
    cons_len: int,
    base_votes: np.ndarray,
    ins_votes: np.ndarray,
    cover: np.ndarray,
    num_fragments: int,
) -> np.ndarray:
    """One window's consensus update from votes (host, vectorized).

    Per junction t: adopt an insertion once its weight clears a quarter of
    the adjacent column weight (alignment ambiguity splits insertion votes
    across neighbouring junctions, so a majority rule starves real
    insertions; noise support sits far below 25%).  Per column t: emit the
    argmax base, the original base when unvoted, nothing when the deletion
    slot wins.  Output interleaves [ins_0, base_0, ins_1, base_1, ...]."""
    L = cons_len
    iv = ins_votes[: L + 1]  # [L+1, 4]
    bv = base_votes[:L]  # [L, 5]
    iv_sum = iv.sum(axis=1)
    ib = np.argmax(iv, axis=1)
    # adjacent column weight: base_votes[t-1] for t>0, base_votes[0] at t=0
    col_w = np.empty(L + 1, dtype=np.int64)
    bv_sums = bv.sum(axis=1)
    if L > 0:
        col_w[0] = bv_sums[0]
        col_w[1:] = bv_sums
    else:
        col_w[0] = base_votes[0].sum()
    ins_on = (iv_sum > 0) & (iv[np.arange(L + 1), ib] * 4 > col_w)

    bb = np.argmax(bv, axis=1) if L else np.zeros(0, np.int64)
    unvoted = bv_sums == 0
    base_sym = np.where(unvoted, cons[:L], bb).astype(np.int64)
    base_on = unvoted | (bb < 4)

    # interleave: slot 2t = insertion at junction t, slot 2t+1 = column t
    toks = np.zeros(2 * L + 1, dtype=np.int64)
    on = np.zeros(2 * L + 1, dtype=bool)
    toks[0::2] = ib
    on[0::2] = ins_on
    toks[1::2] = base_sym
    on[1::2] = base_on
    return toks[on].astype(np.uint8)
