"""Anchor chaining: minimizer matches -> overlap coordinates.

Replacement for the `ram` dependency's chaining stage (the Map
call sites are reference construct.cc:62, 377-381 and assemble.cc:757,780).
Semantics follow the minimap/ram family:

  * matches are grouped by (target id, relative strand) and banded by
    diagonal: a group is a maximal run of diagonal-sorted matches whose
    consecutive diagonals differ by <= DIAGONAL_BAND;
  * each group with >= MIN_MATCHES anchors is chained by a longest
    (strictly) monotonic subsequence over target positions after sorting by
    query position — increasing for same-strand, decreasing for opposite;
  * chains are split where consecutive anchors jump more than MAX_GAP on
    either sequence, and sub-chains shorter than MIN_MATCHES anchors or
    MIN_SPAN bases are dropped.

The monotonic-subsequence step dispatches to the native C++ engine
(raven_tpu_torch/native/chain.cc) for large anchor sets; this module is the host
orchestration + numpy/bisect reference.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

import numpy as np

from raven_tpu_torch.overlap.types import OVERLAP_DTYPE, make_overlaps

DIAGONAL_BAND = 500
MIN_MATCHES = 4
MAX_GAP = 10000
MIN_SPAN = 100

_CHAIN_FN = None
_CHAIN_TRIED = False
_BATCH_FN = None
_BATCH_TRIED = False


def _native_chain_batch():
    global _BATCH_FN, _BATCH_TRIED
    if _BATCH_FN is not None or _BATCH_TRIED:
        return _BATCH_FN
    _BATCH_TRIED = True
    import ctypes

    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.raven_chain_batch
    except AttributeError:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn.restype = None
    fn.argtypes = [
        i64p, ctypes.c_longlong,
        u32p, u8p, i64p, i64p, ctypes.c_int, ctypes.c_int,
        i64p, i64p,
        u32p, u32p, u32p, u32p, u32p, u32p, u8p,
        i64p, i64p, i64p, i64p,
    ]
    _BATCH_FN = fn
    return fn


def _native_chain():
    global _CHAIN_FN, _CHAIN_TRIED
    if _CHAIN_FN is not None or _CHAIN_TRIED:
        return _CHAIN_FN
    _CHAIN_TRIED = True
    import ctypes

    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.raven_chain_anchors
    except AttributeError:
        return None
    fn.restype = ctypes.c_longlong
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [
        u32p, u8p, i64p, i64p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_uint32,
        u32p, u32p, u32p, u32p, u32p, u32p, u8p, ctypes.c_longlong,
        i64p, i64p, i64p, ctypes.c_longlong,
    ]
    _CHAIN_FN = fn
    return fn


def _chain_native(lhs_id, tid, same, qpos, tpos, k, anchors_out=None):
    """C++ chaining core; returns structured overlaps or None."""
    import ctypes

    fn = _native_chain()
    if fn is None:
        return None
    n = tid.size
    cap = max(64, n // MIN_MATCHES + 8)
    tid_c = np.ascontiguousarray(tid, dtype=np.uint32)
    same_c = np.ascontiguousarray(same, dtype=np.uint8)
    q_c = np.ascontiguousarray(qpos, dtype=np.int64)
    t_c = np.ascontiguousarray(tpos, dtype=np.int64)
    out = {
        name: np.zeros(cap, dtype=np.uint32)
        for name in ("lhs_begin", "lhs_end", "rhs_id", "rhs_begin", "rhs_end", "score")
    }
    strand = np.zeros(cap, dtype=np.uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    if anchors_out is not None:
        anchor_cap = n + 8
        aq = np.zeros(anchor_cap, dtype=np.int64)
        at = np.zeros(anchor_cap, dtype=np.int64)
        aend = np.zeros(cap, dtype=np.int64)
        aq_p = aq.ctypes.data_as(i64p)
        at_p = at.ctypes.data_as(i64p)
        aend_p = aend.ctypes.data_as(i64p)
    else:
        anchor_cap = 0
        aq_p = at_p = aend_p = ctypes.cast(None, i64p)
    m = fn(
        tid_c.ctypes.data_as(u32p),
        same_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        q_c.ctypes.data_as(i64p),
        t_c.ctypes.data_as(i64p),
        n,
        k,
        np.uint32(lhs_id),
        out["lhs_begin"].ctypes.data_as(u32p),
        out["lhs_end"].ctypes.data_as(u32p),
        out["rhs_id"].ctypes.data_as(u32p),
        out["rhs_begin"].ctypes.data_as(u32p),
        out["rhs_end"].ctypes.data_as(u32p),
        out["score"].ctypes.data_as(u32p),
        strand.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
        aq_p,
        at_p,
        aend_p,
        anchor_cap,
    )
    if m < 0:
        return None  # capacity overflow; caller falls back
    res = np.zeros(m, dtype=OVERLAP_DTYPE)
    res["lhs_id"] = lhs_id
    for name in ("lhs_begin", "lhs_end", "rhs_id", "rhs_begin", "rhs_end", "score"):
        res[name] = out[name][:m]
    res["strand"] = strand[:m]
    if anchors_out is not None:
        start = 0
        for i in range(m):
            end = int(aend[i])
            anchors_out.append((aq[start:end].copy(), at[start:end].copy()))
            start = end
    return res


def chain_batch(
    uniq: np.ndarray,
    bounds: np.ndarray,
    tid: np.ndarray,
    same: np.ndarray,
    qpos: np.ndarray,
    tpos: np.ndarray,
    k: int,
    out: dict[int, np.ndarray],
    anchors_out: dict | None = None,
    workers: int = 1,
) -> bool:
    """Chain every read of a batch in ONE native call (C++ worker threads
    over reads).  The per-read dispatch path pays Python slicing and array
    conversion under the GIL for each of thousands of reads; here the
    matches go down pre-sorted by query (read r's matches at
    [bounds[r], bounds[r+1])) and come back as flat overlap columns plus
    per-read counts.  Fills `out` (and `anchors_out`); returns False when
    the native library is unavailable (caller falls back)."""
    fn = _native_chain_batch()
    if fn is None:
        return False
    import ctypes

    from raven_tpu_torch.config import worker_count

    R = int(uniq.size)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    nr = np.diff(bounds)
    tid_c = np.ascontiguousarray(tid, dtype=np.uint32)
    same_c = np.ascontiguousarray(same, dtype=np.uint8)
    q_c = np.ascontiguousarray(qpos, dtype=np.int64)
    t_c = np.ascontiguousarray(tpos, dtype=np.int64)

    ocap = np.maximum(64, nr // MIN_MATCHES + 8)
    out_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(ocap, out=out_off[1:])
    total_cap = int(out_off[-1])
    names = ("lhs_begin", "lhs_end", "rhs_id", "rhs_begin", "rhs_end", "score")
    cols = {n_: np.zeros(total_cap, dtype=np.uint32) for n_ in names}
    strand = np.zeros(total_cap, dtype=np.uint8)
    counts = np.zeros(R, dtype=np.int64)

    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    null64 = ctypes.cast(None, i64p)
    if anchors_out is not None:
        acap = nr + 8
        aout_off = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(acap, out=aout_off[1:])
        aq = np.zeros(int(aout_off[-1]), dtype=np.int64)
        at = np.zeros(int(aout_off[-1]), dtype=np.int64)
        aend = np.zeros(total_cap, dtype=np.int64)
        aout_off_p = aout_off.ctypes.data_as(i64p)
        aq_p = aq.ctypes.data_as(i64p)
        at_p = at.ctypes.data_as(i64p)
        aend_p = aend.ctypes.data_as(i64p)
    else:
        aout_off_p = aq_p = at_p = aend_p = null64

    fn(
        bounds.ctypes.data_as(i64p),
        R,
        tid_c.ctypes.data_as(u32p),
        same_c.ctypes.data_as(u8p),
        q_c.ctypes.data_as(i64p),
        t_c.ctypes.data_as(i64p),
        k,
        max(1, workers or worker_count()),
        out_off.ctypes.data_as(i64p),
        aout_off_p,
        *(cols[n_].ctypes.data_as(u32p) for n_ in names),
        strand.ctypes.data_as(u8p),
        aq_p,
        at_p,
        aend_p,
        counts.ctypes.data_as(i64p),
    )

    # vectorized assembly: one big structured array split into per-read
    # views (the overlap sets are identical to the per-read path's)
    m = np.maximum(counts, 0)
    total_m = int(m.sum())
    starts_rep = np.repeat(np.cumsum(m) - m, m)
    sel = np.arange(total_m, dtype=np.int64) - starts_rep + np.repeat(
        out_off[:-1], m
    )
    big = np.zeros(total_m, dtype=OVERLAP_DTYPE)
    big["lhs_id"] = np.repeat(uniq, m)
    for n_ in names:
        big[n_] = cols[n_][sel]
    big["strand"] = strand[sel]
    pieces = np.split(big, np.cumsum(m)[:-1]) if R else []
    for r in range(R):
        u = int(uniq[r])
        if counts[r] < 0:  # capacity overflow: unbounded per-read fallback
            s0, s1 = int(bounds[r]), int(bounds[r + 1])
            per_read_anchors = [] if anchors_out is not None else None
            out[u] = chain_matches(
                u,
                tid_c[s0:s1],
                same_c[s0:s1],
                q_c[s0:s1],
                t_c[s0:s1],
                k,
                anchors_out=per_read_anchors,
            )
            if anchors_out is not None:
                anchors_out[u] = per_read_anchors
            continue
        out[u] = pieces[r]
        if anchors_out is not None:
            ends = aend[int(out_off[r]) : int(out_off[r]) + int(counts[r])]
            a0 = int(aout_off[r])
            alist = []
            for oi in range(int(counts[r])):
                a1 = int(ends[oi])
                alist.append((aq[a0:a1].copy(), at[a0:a1].copy()))
                a0 = a1
            anchors_out[u] = alist
    return True


def _lis_indices(values: np.ndarray, increasing: bool) -> np.ndarray:
    """Indices of one longest strictly monotonic subsequence (patience)."""
    v = values if increasing else -values.astype(np.int64)
    tails: list[int] = []  # value of smallest tail of LIS with length i+1
    tails_idx: list[int] = []
    prev = np.full(v.size, -1, dtype=np.int64)
    for i, x in enumerate(v):
        j = bisect_left(tails, x)
        if j == len(tails):
            tails.append(x)
            tails_idx.append(i)
        else:
            tails[j] = x
            tails_idx[j] = i
        prev[i] = tails_idx[j - 1] if j > 0 else -1
    # backtrack
    out = []
    i = tails_idx[-1] if tails_idx else -1
    while i != -1:
        out.append(i)
        i = prev[i]
    return np.array(out[::-1], dtype=np.int64)


def chain_matches(
    lhs_id: int,
    tid: np.ndarray,
    same: np.ndarray,
    qpos: np.ndarray,
    tpos: np.ndarray,
    k: int,
    anchors_out: list | None = None,
) -> np.ndarray:
    """Chain raw matches into overlaps. Arrays are parallel; returns a
    structured overlap array (types.OVERLAP_DTYPE).

    When `anchors_out` is a list, it receives one (qpos, tpos) int64 array
    pair per emitted overlap (the chain's anchors, query-sorted) — consumed
    by the polisher's window breakpoint interpolation."""
    if tid.size == 0:
        return np.zeros(0, dtype=OVERLAP_DTYPE)

    qpos = qpos.astype(np.int64)
    tpos = tpos.astype(np.int64)

    if tid.size >= 32:
        native = _chain_native(
            lhs_id, tid, same, qpos, tpos, k, anchors_out=anchors_out
        )
        if native is not None:
            return native

    diag = np.where(same.astype(bool), tpos - qpos, tpos + qpos)

    # sort by (tid, same, diagonal)
    order = np.lexsort((diag, same, tid))
    tid, same, qpos, tpos, diag = (
        tid[order],
        same[order],
        qpos[order],
        tpos[order],
        diag[order],
    )

    # group boundaries: new (tid, same) or diagonal jump > band
    new_key = np.empty(tid.size, dtype=bool)
    new_key[0] = True
    new_key[1:] = (
        (tid[1:] != tid[:-1])
        | (same[1:] != same[:-1])
        | (np.diff(diag) > DIAGONAL_BAND)
    )
    group_starts = np.nonzero(new_key)[0]
    group_ends = np.append(group_starts[1:], tid.size)

    out = []
    for gs, ge in zip(group_starts, group_ends):
        if ge - gs < MIN_MATCHES:
            continue
        g_same = bool(same[gs])
        gq = qpos[gs:ge]
        gt = tpos[gs:ge]
        # sort anchors by (qpos, tpos) and chain over tpos
        sub = np.lexsort((gt, gq))
        gq, gt = gq[sub], gt[sub]
        keep = _lis_indices(gt, increasing=g_same)
        if keep.size < MIN_MATCHES:
            continue
        cq, ct = gq[keep], gt[keep]
        # split on large gaps (query or target)
        gaps = np.maximum(np.abs(np.diff(cq)), np.abs(np.diff(ct)))
        cuts = np.nonzero(gaps > MAX_GAP)[0] + 1
        for piece_q, piece_t in zip(np.split(cq, cuts), np.split(ct, cuts)):
            if piece_q.size < MIN_MATCHES:
                continue
            lhs_begin = int(piece_q[0])
            lhs_end = int(piece_q[-1]) + k
            t_lo = int(piece_t.min())
            t_hi = int(piece_t.max()) + k
            if lhs_end - lhs_begin < MIN_SPAN or t_hi - t_lo < MIN_SPAN:
                continue
            if anchors_out is not None:
                anchors_out.append((piece_q.copy(), piece_t.copy()))
            out.append(
                (
                    lhs_id,
                    lhs_begin,
                    lhs_end,
                    int(tid[gs]),
                    t_lo,
                    t_hi,
                    piece_q.size,
                    1 if g_same else 0,
                )
            )
    if not out:
        return np.zeros(0, dtype=OVERLAP_DTYPE)
    arr = np.array(out, dtype=np.int64).T
    return make_overlaps(*arr)


def _chain_python_for_test(lhs_id, tid, same, qpos, tpos, k, anchors_out):
    """Force the pure-python chain path (test oracle)."""
    global _CHAIN_FN, _CHAIN_TRIED
    saved = (_CHAIN_FN, _CHAIN_TRIED)
    _CHAIN_FN, _CHAIN_TRIED = None, True
    try:
        return chain_matches(lhs_id, tid, same, qpos, tpos, k, anchors_out)
    finally:
        _CHAIN_FN, _CHAIN_TRIED = saved
