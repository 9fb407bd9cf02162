"""Batched semi-global alignment DP for window breakpoint finding.

The polisher must know, for every 500-base target window, which query
(read) interval maps onto it.  The reference's racon dependency runs one
whole-overlap edlib alignment per read and walks the path; the TPU-native
re-design aligns window-sized pieces progressively — each piece is a small
global-in-target / free-end-in-query edit-distance DP, batched across all
active overlaps, so the hot loop is a rectangular wavefront ideal for
vectorization (numpy here, torch on the device in
raven_tpu_torch.ops.dp_device).  A copy of raven_tpu/ops/align_dp.py.
"""

from __future__ import annotations

import numpy as np

BIG = np.int32(1 << 20)


def batched_piece_align(
    targets: np.ndarray,
    t_lens: np.ndarray,
    queries: np.ndarray,
    q_lens: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Align each target piece (consumed fully) against a query prefix with a
    free end; returns (best_dist[B], q_end[B]).

    targets: [B, T] uint8 codes (padded);  queries: [B, Q] uint8 (padded).
    """
    B, T = targets.shape
    Q = queries.shape[1]
    idx = np.arange(Q + 1, dtype=np.int32)

    prev = np.broadcast_to(idx, (B, Q + 1)).astype(np.int32).copy()  # D[0][:]
    result = np.full((B, Q + 1), BIG, dtype=np.int32)
    done0 = t_lens == 0
    if done0.any():
        result[done0] = prev[done0]

    for r in range(T):
        sub = prev[:, :-1] + (queries != targets[:, r : r + 1])
        e = np.empty((B, Q + 1), dtype=np.int32)
        e[:, 0] = r + 1
        e[:, 1:] = np.minimum(sub, prev[:, 1:] + 1)
        # horizontal closure: D[j] = min_k<=j (E[k] + j - k)
        prev = np.minimum.accumulate(e - idx, axis=1) + idx
        hit = t_lens == r + 1
        if hit.any():
            result[hit] = prev[hit]

    # mask query positions beyond each query's length
    mask = idx[None, :] > q_lens[:, None]
    result = np.where(mask, BIG, result)
    q_end = np.argmin(result, axis=1).astype(np.int64)
    best = result[np.arange(B), q_end]
    return best.astype(np.int64), q_end


def batched_infix_align(
    targets: np.ndarray,
    t_lens: np.ndarray,
    queries: np.ndarray,
    q_lens: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Infix alignment: target consumed fully, query start AND end free.

    Returns (best_dist[B], q_start[B], q_end[B]).  The start column is
    propagated through the DP packed with the score into one int64 key
    (score-major), so ties resolve to the smallest start.
    """
    B, T = targets.shape
    Q = queries.shape[1]
    if T + Q >= 4096 or Q + 1 >= (1 << 18):
        dtype = np.int64
        OFFSET = np.int64(1 << 24)
        SHIFT = np.int64(25)
    else:
        dtype = np.int32
        OFFSET = np.int32(4096)
        SHIFT = np.int32(13)
    idx = np.arange(Q + 1, dtype=dtype)

    def pack(val, start):
        return ((val.astype(dtype) + OFFSET) << SHIFT) | start.astype(dtype)

    def unpack(key):
        return (key >> SHIFT) - OFFSET, key & ((dtype(1) << SHIFT) - dtype(1))

    # row 0: D = 0 everywhere, start = own column
    prev_v = np.zeros((B, Q + 1), dtype=dtype)
    prev_s = np.broadcast_to(idx, (B, Q + 1)).copy()
    res_v = np.full((B, Q + 1), dtype(BIG), dtype=dtype)
    res_s = np.zeros((B, Q + 1), dtype=dtype)
    done0 = t_lens == 0
    if done0.any():
        res_v[done0] = prev_v[done0]
        res_s[done0] = prev_s[done0]

    for r in range(T):
        sub_v = prev_v[:, :-1] + (queries != targets[:, r : r + 1])
        up_v = prev_v[:, 1:] + 1
        # prefer diagonal on ties (anchored paths)
        take_up = up_v < sub_v
        e_v = np.where(take_up, up_v, sub_v)
        e_s = np.where(take_up, prev_s[:, 1:], prev_s[:, :-1])
        cur_v = np.empty((B, Q + 1), dtype=dtype)
        cur_s = np.empty((B, Q + 1), dtype=dtype)
        cur_v[:, 0] = prev_v[:, 0] + 1
        cur_s[:, 0] = prev_s[:, 0]
        cur_v[:, 1:] = e_v
        cur_s[:, 1:] = e_s
        # horizontal closure with start propagation via packed keys
        key = pack(cur_v - idx, cur_s)
        key = np.minimum.accumulate(key, axis=1)
        kv, ks = unpack(key)
        cur_v = kv + idx
        cur_s = ks
        prev_v, prev_s = cur_v, cur_s
        hit = t_lens == r + 1
        if hit.any():
            res_v[hit] = cur_v[hit]
            res_s[hit] = cur_s[hit]

    mask = idx[None, :] > q_lens[:, None]
    res_v = np.where(mask, dtype(BIG), res_v)
    q_end = np.argmin(res_v, axis=1).astype(np.int64)
    rows = np.arange(B)
    return res_v[rows, q_end], res_s[rows, q_end], q_end


def batched_forward_rows(
    targets: np.ndarray,
    queries: np.ndarray,
    rows_needed: np.ndarray,
) -> np.ndarray:
    """Global edit-distance DP, capturing row `rows_needed[b]` per job.

    targets: [B, T] uint8 (row r consumed at step r); queries: [B, Q]
    uint8 padded with a never-matching byte.  Returns [B, Q + 1] int32 —
    the DP row after consuming rows_needed[b] target characters, where
    D[0] = iota (global start at (0, 0)).
    """
    B, T = targets.shape
    Q = queries.shape[1]
    idx = np.arange(Q + 1, dtype=np.int32)
    prev = np.broadcast_to(idx, (B, Q + 1)).astype(np.int32).copy()
    out = np.empty((B, Q + 1), dtype=np.int32)
    hit = rows_needed == 0
    if hit.any():
        out[hit] = prev[hit]
    for r in range(int(rows_needed.max(initial=0))):
        sub = prev[:, :-1] + (queries[:, :Q] != targets[:, r : r + 1])
        e = np.empty((B, Q + 1), dtype=np.int32)
        e[:, 0] = r + 1
        e[:, 1:] = np.minimum(sub, prev[:, 1:] + 1)
        prev = np.minimum.accumulate(e - idx, axis=1) + idx
        hit = rows_needed == r + 1
        if hit.any():
            out[hit] = prev[hit]
    return out


def batched_boundary_crossings(
    targets: np.ndarray,
    t_lens: np.ndarray,
    queries: np.ndarray,
    q_lens: np.ndarray,
    crosses: np.ndarray,
) -> np.ndarray:
    """Exact alignment-path crossings (racon break-point analog).

    For each job b, the optimal global alignment of
    targets[b, :t_lens[b]] vs queries[b, :q_lens[b]] crosses target row
    crosses[b] at some query column j: returns that j (the split
    minimizing forward + backward cost; ties resolve to the smallest j).
    This needs only two DP row sweeps — no traceback matrix — so jobs
    batch rectangularly (the reference's racon walks a full edlib path
    per overlap instead).
    """
    B, T = targets.shape
    Q = queries.shape[1]
    idx = np.arange(Q + 1, dtype=np.int32)
    fwd = batched_forward_rows(targets, queries, crosses)

    # backward: reverse target/query within their lengths
    rt = np.full_like(targets, 255)
    rq = np.full_like(queries, 254)  # distinct pads never match each other
    rows = np.arange(B)
    for b in range(B):  # cheap relative to the DP sweeps
        tl, ql = int(t_lens[b]), int(q_lens[b])
        rt[b, :tl] = targets[b, :tl][::-1]
        rq[b, :ql] = queries[b, :ql][::-1]
    bwd = batched_forward_rows(rt, rq, t_lens - crosses)

    # align: total[j] = fwd[j] + bwd[q_len - j]
    j2 = q_lens[:, None].astype(np.int64) - idx[None, :]
    valid = j2 >= 0
    j2 = np.clip(j2, 0, Q)
    total = np.where(valid, fwd + bwd[rows[:, None], j2], BIG)
    return np.argmin(total, axis=1).astype(np.int64)  # ties -> smallest j


_CROSS_FN = None
_CROSS_TRIED = False


def _native_cross():
    global _CROSS_FN, _CROSS_TRIED
    if _CROSS_FN is not None or _CROSS_TRIED:
        return _CROSS_FN
    _CROSS_TRIED = True
    import ctypes

    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    fn = lib.raven_boundary_crossings
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn.restype = None
    fn.argtypes = [
        u8p, i64p, i64p, u8p, i64p, i64p, i64p,
        ctypes.c_longlong, ctypes.c_int, i64p,
    ]
    _CROSS_FN = fn
    return fn


def native_boundary_crossings(
    targets: np.ndarray,
    t_lens: np.ndarray,
    queries: np.ndarray,
    q_lens: np.ndarray,
    crosses: np.ndarray,
) -> np.ndarray | None:
    """C++ threaded batched_boundary_crossings; None without a toolchain."""
    fn = _native_cross()
    if fn is None:
        return None
    import ctypes

    from raven_tpu_torch.config import worker_count

    B = targets.shape[0]
    t_lens = np.ascontiguousarray(t_lens, dtype=np.int64)
    q_lens = np.ascontiguousarray(q_lens, dtype=np.int64)
    crosses = np.ascontiguousarray(crosses, dtype=np.int64)
    # pack rows end to end (rows may be padded; copy only the live parts)
    t_off = np.zeros(B, dtype=np.int64)
    np.cumsum(t_lens[:-1], out=t_off[1:])
    q_off = np.zeros(B, dtype=np.int64)
    np.cumsum(q_lens[:-1], out=q_off[1:])
    tgt_flat = np.empty(int(t_lens.sum()), dtype=np.uint8)
    qry_flat = np.empty(int(q_lens.sum()), dtype=np.uint8)
    for b in range(B):
        tgt_flat[t_off[b] : t_off[b] + t_lens[b]] = targets[b, : t_lens[b]]
        qry_flat[q_off[b] : q_off[b] + q_lens[b]] = queries[b, : q_lens[b]]
    out = np.zeros(B, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn(
        tgt_flat.ctypes.data_as(u8p),
        t_off.ctypes.data_as(i64p),
        t_lens.ctypes.data_as(i64p),
        qry_flat.ctypes.data_as(u8p),
        q_off.ctypes.data_as(i64p),
        q_lens.ctypes.data_as(i64p),
        crosses.ctypes.data_as(i64p),
        B,
        worker_count(),
        out.ctypes.data_as(i64p),
    )
    return out


def find_window_breakpoints(
    query: np.ndarray,
    target: np.ndarray,
    t_begin: int,
    t_end: int,
    window_len: int,
) -> list[tuple[int, int, int, int]]:
    """Single-overlap reference implementation (unbatched) used by tests.

    Returns [(window_id, window_rel_begin, q_begin, q_end)] with q
    coordinates relative to the oriented query segment.
    """
    frags = []
    qcur = 0
    t = t_begin
    qn = query.size
    while t < t_end and qcur < qn:
        t_next = min(((t // window_len) + 1) * window_len, t_end)
        piece = t_next - t
        slack = max(64, int(0.35 * piece))
        q_take = min(piece + slack, qn - qcur)
        tgt = target[t:t_next][None, :].astype(np.uint8)
        qry = query[qcur : qcur + q_take][None, :].astype(np.uint8)
        _, q_end = batched_piece_align(
            tgt,
            np.array([piece]),
            qry,
            np.array([q_take]),
        )
        qe = qcur + int(q_end[0])
        frags.append((t // window_len, t % window_len, qcur, qe))
        qcur = qe
        t = t_next
    return frags
