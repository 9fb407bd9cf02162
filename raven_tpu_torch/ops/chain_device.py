"""Device anchor chaining: minimizer matches -> overlap coordinates.

The torch port of raven_tpu/ops/chain_device.py.  Semantics are exactly
raven_tpu_torch/overlap/chain.py (the ram replacement):

  * matches are grouped by (query, target, relative strand) and banded by
    diagonal (consecutive sorted diagonals differ by <= DIAGONAL_BAND);
  * each group with >= MIN_MATCHES anchors is chained by one longest
    strictly monotonic subsequence over target positions after sorting by
    (query, target) position — the backtrack ties match the host patience
    algorithm's exactly (prev = top of the previous pile at insert time);
  * chains split where consecutive anchors jump more than MAX_GAP on
    either sequence; sub-chains shorter than MIN_MATCHES anchors or
    MIN_SPAN bases are dropped.

Formulation: one global sort forms the groups; group descriptors are
bucketed by size (8..2048) and each bucket runs a batched patience LIS
over [n_groups, G] matrices (`_lis_keep`, a Python loop over the G
columns, one small kernel per step: correct, and the target of a hand
kernel later).  Groups larger than the top bucket are chained per group
on the host and merged back by group rank.

Output overlaps are ordered by (group rank, piece), which reproduces the
host emission order, so per-read overlap arrays are byte-identical to
chain.py's.
"""

from __future__ import annotations

import numpy as np
import torch

from raven_tpu_torch.overlap.types import OVERLAP_DTYPE
from raven_tpu_torch.utils import trace

DIAGONAL_BAND = 500
MIN_MATCHES = 4
MAX_GAP = 10000
MIN_SPAN = 100

BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
I32_INF = 2**31 - 1
_I64_MAX = 2**63 - 1


def _prepare_core(q_id, q_pos, t_id, t_pos, same):
    """Group formation + descriptors.

    Flat int match columns on the device (rows with q_id < 0 are padding
    and dropped).  Returns (anchors, descs): anchors = (qs, ts, same_s, qp,
    tp) sorted by (query, target, strand, diagonal); descs = (start, size)
    of every group with >= MIN_MATCHES anchors, in emission order."""
    q_id, q_pos, t_id, t_pos, same = (
        a.to(torch.int64) for a in (q_id, q_pos, t_id, t_pos, same)
    )
    real = q_id >= 0
    if not bool(real.all()):
        q_id, q_pos, t_id, t_pos, same = (
            a[real] for a in (q_id, q_pos, t_id, t_pos, same)
        )
    same = (same != 0).to(torch.int64)
    diag = torch.where(same != 0, t_pos - q_pos, t_pos + q_pos)
    # stable sorts, least significant key first: (same, diagonal), then
    # (query, target); the position columns ride along as payload
    order = torch.argsort((same << 32) | (diag + (1 << 30)), stable=True)
    qt = (q_id << 32) | t_id
    order = order[torch.argsort(qt[order], stable=True)]
    qs, ts, same_s, qp, tp, ds = (
        a[order] for a in (q_id, t_id, same, q_pos, t_pos, diag)
    )
    n = qs.numel()
    newg = torch.ones(n, dtype=torch.bool, device=qs.device)
    if n > 1:
        newg[1:] = (
            (qs[1:] != qs[:-1])
            | (ts[1:] != ts[:-1])
            | (same_s[1:] != same_s[:-1])
            | (ds[1:] - ds[:-1] > DIAGONAL_BAND)
        )
    gstart = torch.nonzero(newg).squeeze(1)
    gsize = torch.diff(
        gstart, append=torch.tensor([n], dtype=gstart.dtype, device=qs.device)
    )
    big = gsize >= MIN_MATCHES
    return (qs, ts, same_s, qp, tp), (gstart[big], gsize[big])


def _lis_keep(vals, size, G):
    """Patience LIS + backtrack over one bucket's [n_g, G] rows of
    strictly-increasing targets; returns the keep mask [n_g, G] matching
    the host patience algorithm's backtrack choices exactly."""
    n_g = vals.shape[0]
    dev = vals.device
    rows = torch.arange(n_g, device=dev)
    tails = torch.full((n_g, G), I32_INF, dtype=torch.int64, device=dev)
    tidx = torch.zeros((n_g, G), dtype=torch.int64, device=dev)
    prev = torch.full((n_g, G), -1, dtype=torch.int64, device=dev)
    for j in range(int(size.max())):
        x = vals[:, j].contiguous()
        act = j < size
        # tails stays strictly increasing (then I32_INF): the pile of x is
        # the count of tails below it
        p = torch.searchsorted(tails, x[:, None]).squeeze(1)
        # prev = top of pile p-1 at insert time (the update at pile p
        # leaves it alone)
        top_prev = tidx[rows, (p - 1).clamp(min=0)]
        prev[:, j] = torch.where((p > 0) & act, top_prev, -1)
        tails[rows, p] = torch.where(act, x, tails[rows, p])
        tidx[rows, p] = torch.where(act, j, tidx[rows, p])
    L = (tails < I32_INF).sum(dim=1)
    cur = torch.where(L > 0, tidx[rows, (L - 1).clamp(min=0)], -1)
    keep = torch.zeros((n_g, G), dtype=torch.bool, device=dev)
    for _ in range(int(L.max()) if n_g else 0):
        on = cur >= 0
        cc = cur.clamp(min=0)
        keep[rows, cc] |= on
        cur = torch.where(on, prev[rows, cc], -1)
    return keep


def _bucket_overlaps(anchors, st, sz, G, kmer):
    """One size bucket: gather members, LIS, gap-split, emit pieces.
    Returns the emitted columns (gid, piece, qid, tid, lhs_b, lhs_e, rhs_b,
    rhs_e, cnt, same), each flat int64."""
    qs, ts, same_s, qp, tp = anchors
    dev = qs.device
    n_g = st.numel()
    cols = torch.arange(G, device=dev)
    in_row = cols[None, :] < sz[:, None]
    mem = (st[:, None] + cols[None, :]).clamp(max=qs.numel() - 1)
    q = qp[mem]
    t = tp[mem]
    qid_g, tid_g, same_g = qs[st], ts[st], same_s[st]

    # the LIS needs (q, t) order; the global sort gave diagonal order
    ck = torch.where(in_row, (q << 32) | t, _I64_MAX)
    perm = torch.argsort(ck, dim=1)
    q = torch.gather(q, 1, perm)
    t = torch.gather(t, 1, perm)
    vals = torch.where(same_g[:, None] != 0, t, -t)
    keep = _lis_keep(vals, sz, G)

    # compact kept anchors left, preserving index order
    perm = torch.argsort(torch.where(keep, cols, G + cols), dim=1)
    qc = torch.gather(q, 1, perm)
    tc = torch.gather(t, 1, perm)
    L = keep.sum(dim=1)
    jpos = cols[None, :].expand(n_g, G)
    in_chain = jpos < L[:, None]

    gap = torch.maximum(
        (qc[:, 1:] - qc[:, :-1]).abs(), (tc[:, 1:] - tc[:, :-1]).abs()
    )
    cut = torch.cat(
        [torch.zeros((n_g, 1), dtype=torch.bool, device=dev), gap > MAX_GAP],
        dim=1,
    )
    newp = (jpos == 0) | cut
    piece = torch.cumsum(newp.to(torch.int64), dim=1) - 1
    ps = torch.cummax(torch.where(newp, jpos, -1), dim=1).values
    cnt = jpos - ps + 1
    q_first = torch.gather(qc, 1, ps.clamp(0, G - 1))

    # target span of each piece over its chain members
    seg = (torch.arange(n_g, device=dev)[:, None] * G + piece).reshape(-1)
    member = in_chain.reshape(-1)
    t_flat = tc.reshape(-1)
    t_min = torch.full((n_g * G,), _I64_MAX, dtype=torch.int64, device=dev)
    t_max = torch.full((n_g * G,), -_I64_MAX, dtype=torch.int64, device=dev)
    t_min.scatter_reduce_(0, seg[member], t_flat[member], "amin")
    t_max.scatter_reduce_(0, seg[member], t_flat[member], "amax")
    t_min = t_min[seg].reshape(n_g, G)
    t_max = t_max[seg].reshape(n_g, G)

    nxt_cut = torch.cat(
        [cut[:, 1:], torch.ones((n_g, 1), dtype=torch.bool, device=dev)], dim=1
    )
    is_end = in_chain & (nxt_cut | (jpos == L[:, None] - 1))
    lhs_e = qc + kmer
    rhs_e = t_max + kmer
    emit = (
        is_end
        & (cnt >= MIN_MATCHES)
        & (lhs_e - q_first >= MIN_SPAN)
        & (rhs_e - t_min >= MIN_SPAN)
    )
    r, c = torch.nonzero(emit, as_tuple=True)
    return (
        st[r], piece[r, c], qid_g[r], tid_g[r], q_first[r, c], lhs_e[r, c],
        t_min[r, c], rhs_e[r, c], cnt[r, c], same_g[r],
    )


def chain_oversize_groups_host(anchors, st, sz, k):
    """Host-chain the groups larger than the top LIS bucket with the host
    chain oracle, one group at a time.  Returns (overlap rows
    [OVERLAP_DTYPE], gid per row), merged into the device emission stream
    by gid."""
    from raven_tpu_torch.overlap.chain import chain_matches

    qs, ts, same_s, qp, tp = (a.cpu().numpy() for a in anchors)
    rows: list[np.ndarray] = []
    gids: list[np.ndarray] = []
    for s, z in zip(st.tolist(), sz.tolist()):
        sl = slice(s, s + z)
        ovl = chain_matches(
            int(qs[s]),
            ts[sl].astype(np.uint32),
            same_s[sl].astype(np.uint8),
            qp[sl].astype(np.int64),
            tp[sl].astype(np.int64),
            int(k),
        )
        if ovl.size:
            rows.append(ovl)
            gids.append(np.full(ovl.size, s, dtype=np.int64))
    if not rows:
        return np.zeros(0, dtype=OVERLAP_DTYPE), np.zeros(0, dtype=np.int64)
    return np.concatenate(rows), np.concatenate(gids)


def _assemble_overlaps(cols, host_rows=None, host_gids=None):
    """Build the {read_id: overlaps} dict from the emission-ordered device
    columns (gid, qid, tid, lhs_b, lhs_e, rhs_b, rhs_e, cnt, same), brought
    to the host, merging host-chained oversize groups at their gid rank."""
    gid, qid, tid, lhs_b, lhs_e, rhs_b, rhs_e, cnt, same = (c.cpu().numpy() for c in cols)
    big = np.zeros(gid.size, dtype=OVERLAP_DTYPE)
    big["lhs_id"] = qid
    big["lhs_begin"] = lhs_b
    big["lhs_end"] = lhs_e
    big["rhs_id"] = tid
    big["rhs_begin"] = rhs_b
    big["rhs_end"] = rhs_e
    big["score"] = cnt
    big["strand"] = same
    if host_rows is not None and host_rows.size:
        big = np.concatenate([big, host_rows])
        gid = np.concatenate([gid, host_gids])
        big = big[np.argsort(gid, kind="stable")]
    out: dict[int, np.ndarray] = {}
    uniq, starts = np.unique(big["lhs_id"], return_index=True)
    for u, piece in zip(uniq, np.split(big, starts[1:])):
        out[int(u)] = piece
    return out


def chain_from_prepared(prepared, k):
    """Finish chaining from `_prepare_core` outputs on the device: size
    bucketing, the per-bucket LIS, the (gid, piece) emission sort.  Returns
    _assemble_overlaps's arguments: the emitted columns on the device and
    the host-chained oversize groups' rows and gids (None for none)."""
    anchors, (gstart, gsize) = prepared
    dev = gstart.device
    bidx = torch.bucketize(gsize, torch.tensor(BUCKETS, device=dev))
    over = bidx == len(BUCKETS)
    host_rows = host_gids = None
    if bool(over.any()):
        host_rows, host_gids = chain_oversize_groups_host(
            anchors, gstart[over], gsize[over], k
        )
    parts = []
    for b_i, G in enumerate(BUCKETS):
        sel = bidx == b_i
        if not bool(sel.any()):
            continue
        parts.append(
            _bucket_overlaps(anchors, gstart[sel], gsize[sel], G, int(k))
        )
    if parts:
        cat = [torch.cat([p[c] for p in parts]) for c in range(10)]
        # emission order: group rank (its start in the global sort), piece
        order = torch.argsort((cat[0] << 16) | cat[1])
        cols = [c[order] for i, c in enumerate(cat) if i != 1]
    else:
        cols = [torch.zeros(0, dtype=torch.int64, device=dev)] * 9
    return cols, host_rows, host_gids


def chain_matches_device(q_id, q_pos, t_id, t_pos, same, k):
    """Chain flat device match columns into overlaps on their device.

    Inputs are int tensors (padded rows: q_id < 0).  Returns a dict
    {read_id: structured overlap array} identical to the host
    chain_per_read result.  The device work is the span "index.chain",
    the overlaps' return and split by read "index.unpack" {overlaps}."""
    if q_id.numel() == 0:
        return {}
    with trace.span("index.chain"):
        chained = chain_from_prepared(_prepare_core(q_id, q_pos, t_id, t_pos, same), k)
    with trace.span("index.unpack") as s:
        out = _assemble_overlaps(*chained)
        s["overlaps"] = sum(int(v.size) for v in out.values())
    return out
