"""Plain reference of the construct's all-vs-all overlap pass, read by read.

The semantics are raven_tpu_torch's host overlap path (overlap/minimizer.py,
overlap/engine.py::map, overlap/chain.py's numpy chaining, the stage -5
driver in graph/construct.py), copied and frozen here; nothing of the
program is imported.  For a read r the pass's answer is r's overlap list
after the cap and r's pile coverage:

- every read's (k, w) minimizer sketch (robust winnowing, ties kept,
  strand-ambiguous k-mers skipped) indexes the whole read set; a query
  uses its minhash subset (the floor(len / k) smallest hashes, earliest
  positions first on ties); a hash seen more often than the occurrence
  threshold (ram's Filter at `freq`) is skipped;
- a pair (q, t) is mapped from the lower id, q < t: the matches of q's
  query sketch against t's index entries are chained per relative strand
  (diagonal bands, a strictly monotonic chain, cut at long gaps);
- r's list holds its overlaps as the query and, reversed, as the target;
  the pass keeps the MAX_NUM_OVERLAPS longest; the pile adds one layer
  for every overlap of the whole list, before the cap.

The sketch runs as plain torch operations on the device the caller gives
(every read, for the index and the filter), the chaining in numpy on the
host for the sampled reads only.
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np
import torch

# the stage -5 pass's settings, OverlapPhaseCfg's defaults when this
# benchmark was written: k-mer length, winnowing window, ram's filter
# share, the cap on a read's list
KMER_LEN = 15
WINDOW_LEN = 5
FREQ = 0.001
MAX_NUM_OVERLAPS = 32
DIAGONAL_BAND = 500
MIN_MATCHES = 4
MAX_GAP = 10000
MIN_SPAN = 100
K_PSS = 4  # a pile bin holds 16 bases
UINT16_MAX = 65535
INF = 1 << 62
CHUNK_BASES = 1 << 26

OVERLAP_DTYPE = np.dtype([
    ("lhs_id", np.uint32), ("lhs_begin", np.uint32), ("lhs_end", np.uint32),
    ("rhs_id", np.uint32), ("rhs_begin", np.uint32), ("rhs_end", np.uint32),
    ("score", np.uint32), ("strand", np.uint8),
])


def hash_mix(key, mask: int):
    """The invertible masked integer hash, on int64 tensors (the low 2k
    bits are those of the uint64 arithmetic)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _sketch_chunk(codes, lengths, k: int, w: int):
    """(hash, read, pos, strand) of the minimizers of consecutive reads
    whose codes are concatenated in `codes` (uint8, device)."""
    dev = codes.device
    n = codes.numel()
    lens = torch.as_tensor(lengths, device=dev)
    rid = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    local = torch.arange(n, device=dev) - first[rid]
    c = codes.to(torch.int64)
    m = n - k + 1
    if m <= 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        return e, e, e, e.bool()
    fk = torch.zeros(m, dtype=torch.int64, device=dev)
    rk = torch.zeros(m, dtype=torch.int64, device=dev)
    for i in range(k):
        fk = (fk << 2) | c[i: i + m]
    for i in range(k - 1, -1, -1):
        rk = (rk << 2) | (c[i: i + m] ^ 3)
    rid, local, L = rid[:m], local[:m], lens[rid[:m]]
    valid = (local <= L - k) & (L >= k + w - 1)
    ambiguous = fk == rk
    strand = fk <= rk
    h = hash_mix(torch.minimum(fk, rk), (1 << (2 * k)) - 1)
    hw = torch.where(ambiguous | ~valid, INF, h)
    # window minima over w positions; a window that leaves its read is 0
    nw = m - w + 1
    wmin = hw[:nw].clone()
    for i in range(1, w):
        wmin = torch.minimum(wmin, hw[i: i + nw])
    wmin = torch.where(local[:nw] <= L[:nw] - k - w + 1, wmin, 0)
    pad = torch.cat([torch.zeros(w - 1, dtype=torch.int64, device=dev), wmin,
                     torch.zeros(w - 1, dtype=torch.int64, device=dev)])
    cover = pad[:m].clone()
    for i in range(1, w):
        cover = torch.maximum(cover, pad[i: i + m])
    keep = torch.nonzero((cover == hw) & valid & ~ambiguous & (hw != INF)).squeeze(1)
    return h[keep], rid[keep], local[keep], strand[keep]


def sketch_all(codes: np.ndarray, lengths: np.ndarray, k: int, w: int, device):
    """Every read's sketch, read by read in position order: (hash, read,
    pos, strand) tensors on `device`."""
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    ends = starts + lengths
    parts = []
    lo = 0
    n = lengths.size
    while lo < n:
        hi = max(lo + 1, int(np.searchsorted(ends, starts[lo] + CHUNK_BASES, side="right")))
        chunk = torch.from_numpy(codes[starts[lo]: ends[hi - 1]]).to(device)
        h, r, p, s = _sketch_chunk(chunk, lengths[lo:hi], k, w)
        parts.append((h, r + lo, p, s))
        lo = hi
    return tuple(torch.cat([pt[j] for pt in parts]) for j in range(4))


def minhash_flags(h, rid, budget):
    """Whether each entry is among its read's budget smallest hashes,
    earliest positions first on ties (entries in read and position order)."""
    if h.numel() == 0:
        return h.bool()
    order = torch.sort(rid * (1 << 31) + h, stable=True).indices
    srid = rid[order]
    first = torch.searchsorted(srid, srid, right=False)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=h.device) - first
    return rank < budget[rid]


class Index:
    """The whole read set's sketch sorted by hash, and the filter's
    occurrence threshold."""

    def __init__(self, codes, lengths, k: int, w: int, freq: float, device, budget_div: int = 1):
        self.k = k
        h, r, p, s = sketch_all(codes, lengths, k, w, device)
        budget = torch.as_tensor(lengths, device=device) // (k * budget_div)
        f = minhash_flags(h, r, budget)
        order = torch.sort(h, stable=True).indices
        self.h, self.r, self.p, self.s, self.f = h[order], r[order], p[order], s[order], f[order]
        _, counts = torch.unique_consecutive(self.h, return_counts=True)
        if freq <= 0 or counts.numel() == 0:
            self.occ = INF
        else:
            cs = torch.sort(counts).values
            idx = min(int((1.0 - freq) * cs.numel()), cs.numel() - 1)
            self.occ = int(cs[idx])
        # each read's own entries, for the reads the check samples
        self.by_read = torch.sort(self.r, stable=True).indices
        self.r_sorted = self.r[self.by_read]

    def _entries(self, read: int):
        lo = int(torch.searchsorted(self.r_sorted, read))
        hi = int(torch.searchsorted(self.r_sorted, read, right=True))
        return self.by_read[lo:hi]

    def _expand(self, qh):
        """For each hash of qh: the index range of its entries if usable."""
        lo = torch.searchsorted(self.h, qh)
        hi = torch.searchsorted(self.h, qh, right=True)
        cnt = hi - lo
        cnt = torch.where((cnt > 0) & (cnt <= self.occ), cnt, 0)
        src = torch.repeat_interleave(torch.arange(qh.numel(), device=qh.device), cnt)
        flat = torch.arange(src.numel(), device=qh.device) - (torch.cumsum(cnt, 0) - cnt)[src] + lo[src]
        return src, flat

    def matches(self, read: int):
        """The raw matches of every pair that holds `read`: as the query
        (its minhash entries against targets of higher id) and as the target
        (lower ids' minhash entries against its entries).  Returns two numpy
        tuples (q, t, qpos, tpos, same)."""
        e = self._entries(read)
        out = []
        for as_query in (True, False):
            sel = e[self.f[e]] if as_query else e
            src, flat = self._expand(self.h[sel])
            other = self.r[flat]
            keep = (other > read) if as_query else ((other < read) & self.f[flat])
            src, flat = src[keep], flat[keep]
            mine, theirs = sel[src], flat
            q, t = (mine, theirs) if as_query else (theirs, mine)
            same = self.s[q] == self.s[t]
            out.append(tuple(x.cpu().numpy() for x in (self.r[q], self.r[t], self.p[q], self.p[t], same)))
        return out


def _lis_indices(values: np.ndarray, increasing: bool) -> np.ndarray:
    """Indices of one longest strictly monotonic subsequence (patience)."""
    v = values if increasing else -values.astype(np.int64)
    tails: list[int] = []
    tails_idx: list[int] = []
    prev = np.full(v.size, -1, dtype=np.int64)
    for i, x in enumerate(v.tolist()):
        j = bisect_left(tails, x)
        if j == len(tails):
            tails.append(x)
            tails_idx.append(i)
        else:
            tails[j] = x
            tails_idx[j] = i
        prev[i] = tails_idx[j - 1] if j > 0 else -1
    out = []
    i = tails_idx[-1] if tails_idx else -1
    while i != -1:
        out.append(i)
        i = prev[i]
    return np.array(out[::-1], dtype=np.int64)


def chain(lhs_id: int, tid, same, qpos, tpos, k: int) -> list:
    """One query's matches chained into overlaps, as tuples (lhs_id,
    lhs_begin, lhs_end, rhs_id, rhs_begin, rhs_end, score, strand)."""
    if tid.size == 0:
        return []
    qpos = qpos.astype(np.int64)
    tpos = tpos.astype(np.int64)
    diag = np.where(same.astype(bool), tpos - qpos, tpos + qpos)
    order = np.lexsort((diag, same, tid))
    tid, same, qpos, tpos, diag = tid[order], same[order], qpos[order], tpos[order], diag[order]
    new_key = np.empty(tid.size, dtype=bool)
    new_key[0] = True
    new_key[1:] = (tid[1:] != tid[:-1]) | (same[1:] != same[:-1]) | (np.diff(diag) > DIAGONAL_BAND)
    starts = np.nonzero(new_key)[0]
    ends = np.append(starts[1:], tid.size)
    out = []
    for gs, ge in zip(starts, ends):
        if ge - gs < MIN_MATCHES:
            continue
        g_same = bool(same[gs])
        gq, gt = qpos[gs:ge], tpos[gs:ge]
        sub = np.lexsort((gt, gq))
        gq, gt = gq[sub], gt[sub]
        keep = _lis_indices(gt, increasing=g_same)
        if keep.size < MIN_MATCHES:
            continue
        cq, ct = gq[keep], gt[keep]
        gaps = np.maximum(np.abs(np.diff(cq)), np.abs(np.diff(ct)))
        cuts = np.nonzero(gaps > MAX_GAP)[0] + 1
        for pq, pt in zip(np.split(cq, cuts), np.split(ct, cuts)):
            if pq.size < MIN_MATCHES:
                continue
            lb, le = int(pq[0]), int(pq[-1]) + k
            tl, th = int(pt.min()), int(pt.max()) + k
            if le - lb < MIN_SPAN or th - tl < MIN_SPAN:
                continue
            out.append((lhs_id, lb, le, int(tid[gs]), tl, th, int(pq.size), 1 if g_same else 0))
    return out


def read_overlaps(index: Index, read: int) -> np.ndarray:
    """Every overlap of `read`, as the lhs, before the cap."""
    (q, t, qp, tp, sm), (q2, t2, qp2, tp2, sm2) = index.matches(read)
    rows = chain(read, t, sm, qp, tp, index.k)
    order = np.argsort(q2, kind="stable")
    q2, t2, qp2, tp2, sm2 = q2[order], t2[order], qp2[order], tp2[order], sm2[order]
    cut = np.flatnonzero(np.diff(q2)) + 1
    for a, b, c, d, e in zip(*(np.split(x, cut) for x in (q2, t2, sm2, qp2, tp2))):
        if a.size == 0:
            continue
        for o in chain(int(a[0]), b, c, d, e, index.k):
            # reversed: the read becomes the lhs
            rows.append((o[3], o[4], o[5], o[0], o[1], o[2], o[6], o[7]))
    out = np.zeros(len(rows), dtype=OVERLAP_DTYPE)
    for j, name in enumerate(OVERLAP_DTYPE.names):
        out[name] = [r[j] for r in rows]
    return out


def overlap_length(o: np.ndarray) -> np.ndarray:
    lhs = o["lhs_end"].astype(np.int64) - o["lhs_begin"]
    rhs = o["rhs_end"].astype(np.int64) - o["rhs_begin"]
    return np.maximum(lhs, rhs)


def pile_row(length: int, ovl: np.ndarray) -> np.ndarray:
    """The read's coverage bins after one layer per overlap (pile.cc's
    boundary sweep: bins [(begin >> 4) + 1, (end >> 4) - 1))."""
    nb = int(length) >> K_PSS
    diff = np.zeros(nb + 1, dtype=np.int64)
    b = (ovl["lhs_begin"].astype(np.int64) >> K_PSS) + 1
    e = (ovl["lhs_end"].astype(np.int64) >> K_PSS) - 1
    v = e > b
    np.add.at(diff, b[v], 1)
    np.add.at(diff, e[v], -1)
    return np.clip(np.cumsum(diff[:-1]), 0, UINT16_MAX).astype(np.uint16)


def _key(o: np.ndarray) -> list:
    return sorted(tuple(int(x) for x in row) for row in o.tolist())


def capped_matches(got: np.ndarray, full: np.ndarray, cap: int) -> bool:
    """Whether `got` is the cap longest of `full`: equal when full holds no
    more than cap overlaps; else cap of them, holding every overlap longer
    than the cap-th longest and others only of that length (the order that
    breaks ties is the program's)."""
    if full.size <= cap:
        return _key(got) == _key(full)
    if got.size != cap:
        return False
    lens = overlap_length(full)
    edge = int(np.sort(lens)[::-1][cap - 1])
    must = _key(full[lens > edge])
    tied = _key(full[lens == edge])
    g_lens = overlap_length(got)
    if _key(got[g_lens > edge]) != must:
        return False
    rest = _key(got[g_lens == edge])
    if (g_lens < edge).any() or len(rest) != cap - len(must):
        return False
    pool = list(tied)
    for r in rest:
        if r not in pool:
            return False
        pool.remove(r)
    return True
