"""Device-resident minimizer index + self-join mapping (the port's
production overlap path).

The torch port of raven_tpu/overlap/device_index.py's DeviceIndex, the
accelerator implementation of the construct phase's hot loop — the
reference's ram Minimize/Filter/Map fan-out (construct.cc:42-44, 57-113):

  * build: the reads are tiled into fixed-width halo'd segment rows on the
    host (2-bit packed), uploaded chunk by chunk, sketched by kernel K1
    (ops/sketch_cuda.py), compacted to their minimizers, flagged with
    minhash ("micromizer") membership and key-sorted on the device;
  * filter: the occurrence threshold is ram Filter's quantile over the
    run lengths of equal keys;
  * join: every candidate pair lies within a run of equal keys, so the
    all-vs-all mapping is, for each distance d <= MAX_D, one shifted
    equality compare over the count-sorted usable entries (the self-join
    formulation of overlap/selfjoin.py);
  * chain: the match columns stay on the device and are chained there
    (ops/chain_device.py), CHAIN_MATCHES at a time in runs of whole
    query reads; only the overlap columns come back;
  * foreign queries: reads outside the build set (an earlier index
    batch's, in the construct's later batches) are sketched on the device
    by K1 and looked up in the key-sorted columns (`foreign_join`), their
    hits expanded in chunks and chained the same way.

Results equal the host path's (overlap/minimizer.py, selfjoin.py,
chain.py) exactly.  The capacity limits of the JAX reference are kept, and
each makes `build` or `distance_join` return None (the engine then
declines to the host path loudly): 2k > 30, a sketch chunk denser than the
per-chunk capacity, more than 2^28 entries, occurrence above MAX_D + 1,
pair codes beyond SAFE_JOIN_ENTRIES, too-frequent entries beyond an eighth
of the index.

`PartitionedIndex` carries an index of more than 2^28 entries, up to
MAX_TOTAL_ENTRIES: DeviceIndex parts over disjoint hash ranges, each held
to the limits above (raven_tpu's PartitionedIndex).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raven_tpu_torch.ops.sketch import (
    UINT32_INF,
    segment_reads_packed,
    sketch_segments,
    unpack_codes,
)
from raven_tpu_torch.utils import trace

SEG_WIDTH = 2048
# distance cap of the join; occurrence > MAX_D + 1 declines to the host
MAX_D = 40
# the reference packs pairs as uint32 codes gidx*(MAX_D+1)+d; joins over
# more usable entries than this decline there, so they decline here too
SAFE_JOIN_ENTRIES = (0xFFFFFFFE - MAX_D) // (MAX_D + 1) + 1
MAX_ENTRIES = 1 << 28  # the largest single index the reference sorts
MAX_MATCHES = 1 << 30
# matches chained in one device call (ops/chain_device.py takes ~150 bytes
# a match at its peak): a larger set is chained in read-aligned chunks
CHAIN_MATCHES = 1 << 27
# foreign-query matches expanded at once (~40 bytes a match in flight)
EXPAND_MATCHES = 1 << 26
# raven_tpu's PartitionedIndex (raven_tpu/overlap/device_index.py:1239-1242):
# a part's target fill, 3/4 of MAX_ENTRIES, and the partitioned ceiling
PART_TARGET = 3 << 26
MAX_TOTAL_ENTRIES = 3 << 28
HASH_SPACE = 1 << 30  # sketch hashes are below it (ops/sketch.py)
# the build's hash histogram: bins of 2^14 hashes, where balanced_splits cuts
HIST_SHIFT = 14

# packed position column: pos | strand << 29 | flag << 30  (pos < 2^29)
_STRAND_BIT = 29
_FLAG_BIT = 30
_POS_MASK = (1 << _STRAND_BIT) - 1

_RHBINS = 4096  # run-length histogram bins


def _pow2_at_least(n: int, lo: int, hi: int) -> int:
    c = lo
    while c < n and c < hi:
        c <<= 1
    return c


def _quarter_at_least(n: int, lo: int, hi: int) -> int:
    """Smallest m * 2^k >= n with m in {4,5,6,7} (quarter-pow2 steps),
    clamped to [lo, hi]; plain pow2 below 2^16 (the reference's index
    bucket sizes, which set its capacity limits)."""
    if n <= lo or n < (1 << 16):
        return _pow2_at_least(n, lo, hi)
    k = max((n - 1).bit_length() - 3, 14)
    c = ((n + (1 << k) - 1) >> k) << k
    return max(lo, min(c, hi))


def _capacity(n: int) -> int:
    """The reference's padded index length for `n` entries."""
    return _quarter_at_least(max(int(n), 1), 1 << 12, MAX_ENTRIES)


def range_splits(n: int) -> list[int]:
    """The hashes that cut the hash space into `n` ranges."""
    return [HASH_SPACE * h // n for h in range(1, n)]


def balanced_splits(hist: torch.Tensor, n: int) -> list[int]:
    """Hashes at bin edges of the build's histogram (bins of 2^HIST_SHIFT
    hashes) that cut its entries into up to `n` ranges as even as the bins
    allow.  Minimizers are window minima, so their hashes crowd the low end
    of the hash space (two thirds of them below a quarter of it): equal
    ranges leave the first part several times the others'."""
    cum = torch.cumsum(hist, 0)
    total = int(cum[-1])
    at = torch.searchsorted(cum, torch.tensor([total * i // n for i in range(1, n)],
                                              dtype=cum.dtype, device=cum.device))
    edges = sorted({min(int(b) + 1, hist.numel()) << HIST_SHIFT for b in at.tolist()})
    return [e for e in edges if e < HASH_SPACE]


def range_cuts(key: torch.Tensor, splits) -> list[int]:
    """Where the key-sorted column `key` crosses each of the hashes
    `splits`: n + 1 offsets, one range between each two."""
    at = torch.searchsorted(key, torch.tensor(splits, dtype=key.dtype, device=key.device))
    return [0, *at.tolist(), key.numel()]


def _sketch_chunks(readset, ids, k, w, device, capped=True):
    """The sketch of `ids` on `device`, one chunk of read-aligned segment
    rows (ops/sketch.py CHUNK_ALIGN) at a time: yields (key int64, rid
    int32, pos1 int64: position << 1 | strand) of each chunk's kept
    minimizers, reads and positions ascending; a read never spans two
    chunks.  With `capped`, a chunk whose minimizers exceed the
    reference's largest per-chunk capacity (density 0.45) yields None and
    ends the sketch, as the build declines there."""
    packed, eff, rids, base, clo, chi = segment_reads_packed(
        readset, ids, k, w, width=SEG_WIDTH
    )
    S = packed.shape[0]
    chunk = _pow2_at_least(S, 256, 8192)
    cap = max(4096, int(chunk * SEG_WIDTH * 0.45) // 4096 * 4096)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        codes = unpack_codes(torch.from_numpy(packed[sl]).to(device))
        meta = [
            torch.from_numpy(a[sl]).to(device)
            for a in (eff, rids, base, clo, chi)
        ]
        key, rid, gpos, sb = sketch_segments(codes, *meta, k, w)
        sel = torch.nonzero(key != UINT32_INF).squeeze(1)
        if capped and sel.numel() > cap:
            yield None
            return
        yield key[sel], rid[sel], (gpos[sel].to(torch.int64) << 1) | sb[sel]


def _minhash_flags(key, rid, pos1, budget):
    """The minhash subset (minimizer.py's semantics): whether each entry is
    among its read's budget[read] = len // k smallest by (hash, position).
    The entries hold their reads whole (a chunk of _sketch_chunks)."""
    order = torch.argsort((key << 30) | pos1, stable=True)
    order = order[torch.argsort(rid[order], stable=True)]
    r_s = rid[order]
    # rank within the read: minus the start of its run of equal rids (a
    # 1-D cummax here ran as one serial scan on the card)
    rank = torch.arange(key.numel(), device=key.device) - torch.searchsorted(r_s, r_s)
    flag = torch.empty(key.numel(), dtype=torch.bool, device=key.device)
    flag[order] = rank < budget[r_s.to(torch.int64)]
    return flag


def _read_budget(readset, k, device):
    """Each read's minhash budget, len // k, by read id, on `device`."""
    return torch.from_numpy(np.asarray(readset.lengths, dtype=np.int64) // k).to(device)


def _build_columns(readset, ids, k, w, minhash, with_flags, device, splits=(),
                   balance=False):
    """The sketch of `ids` as key-sorted index columns: (key, rid, packed
    int32 [N], need_flags, counts, splits), or None past a capacity limit.
    The ascending hashes `splits` cut the hash space into ranges (a part
    each); `counts` holds each range's entries before the minhash cut, at
    most MAX_ENTRIES.  With `balance`, ranges that would pass MAX_ENTRIES
    or the self-join's SAFE_JOIN_ENTRIES are cut anew by balanced_splits,
    into as many as hold every range within both, and the splits returned
    are those.  The minhash flags are taken a chunk at a time, and each
    chunk is packed to 12 bytes an entry before the next is sketched, so
    the build holds little more than the columns."""
    if 2 * k > 30:
        return None
    device = torch.device(device)
    ids = np.asarray(ids, dtype=np.int64)
    need_flags = bool(minhash or with_flags)
    budget = _read_budget(readset, k, device) if need_flags else None
    bounds = torch.tensor(splits, dtype=torch.int64, device=device)
    counts = torch.zeros(len(splits) + 1, dtype=torch.int64, device=device)
    hist = torch.zeros(HASH_SPACE >> HIST_SHIFT, dtype=torch.int64, device=device)
    keys, rid_parts, packed_parts = [], [], []
    for chunk in _sketch_chunks(readset, ids, k, w, device):
        if chunk is None:
            return None
        key, rid, pos1 = chunk
        counts += torch.bincount(torch.bucketize(key, bounds, right=True),
                                 minlength=len(splits) + 1)
        if balance:
            hist += torch.bincount(key >> HIST_SHIFT, minlength=hist.numel())
        packed_col = (pos1 >> 1) | ((pos1 & 1) << _STRAND_BIT)
        if need_flags:
            flag = _minhash_flags(key, rid, pos1, budget)
            packed_col |= flag.to(torch.int64) << _FLAG_BIT
            if minhash:
                key, rid, packed_col = key[flag], rid[flag], packed_col[flag]
        keys.append(key.to(torch.int32))
        rid_parts.append(rid.to(torch.int32))
        packed_parts.append(packed_col.to(torch.int32))
    if not keys:
        return None
    counts = counts.tolist()
    if balance and max(counts) > min(MAX_ENTRIES, SAFE_JOIN_ENTRIES):
        # a tenth of room for the histogram's grain
        n = max(len(counts), math.ceil(sum(counts) / (0.9 * min(MAX_ENTRIES, SAFE_JOIN_ENTRIES))))
        splits = balanced_splits(hist, n)
        edges = [0, *(s >> HIST_SHIFT for s in splits), hist.numel()]
        cum = torch.cumsum(hist, 0).tolist()
        counts = [(cum[b - 1] if b else 0) - (cum[a - 1] if a else 0)
                  for a, b in zip(edges, edges[1:])]
    if max(counts) > MAX_ENTRIES:
        return None
    key = torch.cat(keys)
    del keys
    key, order = torch.sort(key, stable=True)
    rid = torch.cat(rid_parts)[order]
    del rid_parts
    packed = torch.cat(packed_parts)[order]
    return key, rid, packed, need_flags, counts, list(splits)


class DeviceIndex:
    """Device-resident minimizer index (see module docstring).

    Columns, key-sorted: key int32 (hash < 2^30), rid int32, packed int32
    (pos | strand << 29 | flag << 30)."""

    # reads outside the build set are mapped on the index's device
    # (join_foreign)
    joins_foreign = True

    def __init__(self, key, rid, packed, has_flags, k, w, capacity=None):
        self._key = key
        self._rid = rid
        self._packed = packed
        self._run_len = None  # [R] int64 run lengths (lazy)
        self._counts = None  # [N] int64 run length per entry (lazy)
        # (occurrence, key, rid, packed, counts) of the count-sorted join
        # table, cached per occurrence
        self._jcache = None
        self.n_entries = int(key.numel())
        self.has_flags = has_flags
        self.k = k
        self.w = w
        # the reference's padded index length (its too-frequent list is
        # capped at an eighth of it)
        self.capacity = int(capacity if capacity is not None else self.n_entries)

    @property
    def device(self) -> torch.device:
        return self._key.device

    # ----------------------------------------------------------------- build
    @classmethod
    def build(cls, readset, ids, k, w, minhash, with_flags, device):
        cols = _build_columns(readset, ids, k, w, minhash, with_flags, device)
        if cols is None:
            return None
        key, rid, packed, need_flags, (count,), _ = cols
        return cls(key, rid, packed, need_flags, k, w, _capacity(count))

    @classmethod
    def from_host(cls, key, rid, packed, n_entries, has_flags, k, w, device):
        """Wrap numpy index columns (key-sorted, as a JAX-built
        raven_tpu DeviceIndex holds them: key uint32, rid int32, packed
        int32, padded past n_entries) as a device index."""
        n = int(n_entries)
        col = lambda a: torch.from_numpy(  # noqa: E731
            np.asarray(a)[:n].astype(np.int32)
        ).to(device)
        return cls(
            col(np.asarray(key).astype(np.int64)), col(rid), col(packed),
            bool(has_flags), k, w, capacity=len(key),
        )

    # ---------------------------------------------------------------- filter
    def _ensure_counts(self):
        if self._counts is None:
            _, run_len = torch.unique_consecutive(
                self._key, return_counts=True
            )
            self._run_len = run_len.to(torch.int64)
            self._counts = torch.repeat_interleave(self._run_len, self._run_len)

    def occurrence_for(self, frequency: float) -> int:
        """ram Filter: the run length at quantile (1 - frequency) of the
        distinct keys' run lengths."""
        if frequency <= 0 or self.n_entries == 0:
            return np.iinfo(np.int64).max
        self._ensure_counts()
        n_runs = self._run_len.numel()
        # exact host-filter index semantics (engine.filter), float64 on host
        target = min(int((1.0 - frequency) * n_runs), n_runs - 1)
        return int(torch.sort(self._run_len).values[target])

    # ------------------------------------------------------------------ join
    def _join_table(self, occurrence: int):
        """Count-sorted compaction of the join-usable entries (run length
        in [2, occurrence]): sorted by (count, key), so runs stay
        contiguous and distance d only needs entries of runs longer than d.
        None when the table exceeds the reference's pair-code domain."""
        if self._jcache is None or self._jcache[0] != occurrence:
            usable = (self._counts >= 2) & (self._counts <= occurrence)
            sel = torch.nonzero(usable).squeeze(1)
            n_usable = sel.numel()
            if n_usable > SAFE_JOIN_ENTRIES or n_usable > (1 << 27):
                return None
            cnt = self._counts[sel]
            sel = sel[
                torch.argsort((cnt << 32) | self._key[sel].to(torch.int64))
            ]
            self._jcache = (
                occurrence, self._key[sel], self._rid[sel],
                self._packed[sel], self._counts[sel],
            )
        return self._jcache[1:]

    def distance_join(
        self,
        occurrence: int,
        batch: np.ndarray,
        need_flags: bool,
        filtered_out: dict | None = None,
        chain_k: int | None = None,
    ):
        """Self-join matches (q_id, q_pos, t_id, t_pos, same) as numpy
        arrays, exactly the host selfjoin.distance_join contract (as a set:
        the order differs); None on a capacity decline.

        With chain_k set, chaining runs on the device too and the return
        value is the {read_id: overlaps} dict instead."""
        cols = self.join_columns(occurrence, batch, need_flags, filtered_out)
        return None if cols is None else _finish_join(cols, chain_k)

    @trace.spanned("index.join")
    def join_columns(self, occurrence: int, batch: np.ndarray, need_flags: bool,
                     filtered_out: dict | None = None):
        """distance_join's match columns, left on the device; None on a
        capacity decline."""
        if occurrence > MAX_D + 1:
            return None
        if need_flags and not self.has_flags:
            return None
        self._ensure_counts()
        table = self._join_table(occurrence)
        if table is None:
            return None
        jkey, jrid, jpacked, jcounts = table
        dev = self.device
        maxd = min(MAX_D, max(occurrence - 1, 1))
        batch_tbl = torch.from_numpy(np.asarray(batch, dtype=bool)).to(dev)
        inb = batch_tbl[jrid.to(torch.int64)]
        n = jkey.numel()

        later, earlier = [], []
        for d in range(1, maxd + 1):
            # a run of length c pairs entries at distances < c: distance d
            # only scans the suffix of runs longer than d
            start = int(torch.searchsorted(jcounts, d, right=True))
            if start + d >= n:
                break
            a = torch.arange(start + d, n, device=dev)
            b = a - d
            ra, rb = jrid[a], jrid[b]
            a_is_q = ra < rb
            mask = (jkey[a] == jkey[b]) & (ra != rb)
            mask &= torch.where(a_is_q, inb[a], inb[b])
            if need_flags:
                qp = torch.where(a_is_q, jpacked[a], jpacked[b])
                mask &= ((qp >> _FLAG_BIT) & 1) == 1
            hit = torch.nonzero(mask).squeeze(1)
            later.append(a[hit])
            earlier.append(b[hit])
        a = torch.cat(later) if later else torch.zeros(0, dtype=torch.int64, device=dev)
        b = torch.cat(earlier) if earlier else a
        if a.numel() > MAX_MATCHES:
            return None

        ra, rb = jrid[a], jrid[b]
        pa, pb = jpacked[a], jpacked[b]
        a_is_q = ra < rb
        q_id = torch.minimum(ra, rb)
        t_id = torch.maximum(ra, rb)
        q_packed = torch.where(a_is_q, pa, pb)
        t_packed = torch.where(a_is_q, pb, pa)
        same = ((q_packed >> _STRAND_BIT) & 1) == ((t_packed >> _STRAND_BIT) & 1)
        cols = (
            q_id, q_packed & _POS_MASK, t_id, t_packed & _POS_MASK,
            same.to(torch.uint8),
        )

        if filtered_out is not None:
            # query-side entries of too-frequent runs (feed Pile.AddKmers,
            # reference construct.cc:377-383)
            mask = (self._counts > occurrence) & batch_tbl[
                self._rid.to(torch.int64)
            ]
            if need_flags:
                mask &= ((self._packed >> _FLAG_BIT) & 1) == 1
            sel = torch.nonzero(mask).squeeze(1)
            if sel.numel() > max(1 << 12, self.capacity >> 3):
                return None
            f_rid = self._rid[sel].cpu().numpy()
            f_pos = (self._packed[sel] & _POS_MASK).cpu().numpy()
            for r, p in zip(f_rid.tolist(), f_pos.tolist()):
                filtered_out.setdefault(int(r), []).append(int(p))
        return cols

    def join_foreign(self, readset, ids, occurrence: int, minhash: bool, avoid_equal: bool,
                     avoid_symmetric: bool, filtered_out: dict | None = None,
                     chain_k: int | None = None):
        """foreign_join over this index: the reads `ids`, none of them in
        its build set, mapped as the host route maps them."""
        return foreign_join([self], readset, ids, self.k, self.w, occurrence, minhash,
                            avoid_equal, avoid_symmetric, filtered_out, chain_k)

    # ------------------------------------------------------------ run stats
    def run_hist(self) -> np.ndarray:
        """Clipped run-length histogram [_RHBINS] (bin 0 always 0)."""
        self._ensure_counts()
        h = torch.bincount(
            self._run_len.clamp(0, _RHBINS - 1), minlength=_RHBINS
        )
        h[0] = 0
        return h.cpu().numpy().astype(np.int64)

    def le_count(self, t: int) -> int:
        """#distinct runs with length <= t."""
        self._ensure_counts()
        return int((self._run_len <= t).sum())

    # ------------------------------------------------------------- host view
    def to_host(self):
        """Host columns (hash-sorted) for generic lookup callers:
        (hashes u64, ids u32, pos u32, strand u8, flags|None)."""
        key = self._key.cpu().numpy().astype(np.uint64)
        rid = self._rid.cpu().numpy().astype(np.uint32)
        packed = self._packed.cpu().numpy()
        pos = (packed & _POS_MASK).astype(np.uint32)
        strand = ((packed >> _STRAND_BIT) & 1).astype(np.uint8)
        flags = (
            ((packed >> _FLAG_BIT) & 1).astype(bool) if self.has_flags else None
        )
        return key, rid, pos, strand, flags


def chain_in_chunks(cols, k, out: dict | None = None) -> dict:
    """Chain device match columns (q_id, q_pos, t_id, t_pos, same) into
    {read_id: overlaps} (ops/chain_device.py), at most CHAIN_MATCHES
    matches a call: the queries cut into runs of whole reads, so each
    read's overlaps are those of one call over all its matches."""
    from raven_tpu_torch.ops.chain_device import chain_matches_device

    out = {} if out is None else out
    q_id = cols[0]
    if q_id.numel() <= CHAIN_MATCHES:
        out.update(chain_matches_device(*cols, k))
        return out
    q = q_id
    csum = torch.cumsum(torch.bincount(q.clamp(min=0)), 0)
    n_reads = csum.numel()
    lo = 0
    while lo < n_reads:
        base = int(csum[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(csum, base + CHAIN_MATCHES, right=True)))
        sel = torch.nonzero((q >= lo) & (q < hi)).squeeze(1)
        if sel.numel():
            out.update(chain_matches_device(*(c[sel] for c in cols), k))
        lo = hi
    return out


def _finish_join(cols, chain_k):
    """Match columns to distance_join's result: chained on the device into
    {read_id: overlaps} with chain_k set, else numpy columns."""
    if chain_k is not None:
        return chain_in_chunks(cols, chain_k)
    return _host_columns(cols)


def _host_columns(cols):
    q_id, q_pos, t_id, t_pos, same = (c.cpu().numpy() for c in cols)
    return (
        q_id.astype(np.int64), q_pos.astype(np.int64),
        t_id.astype(np.int64), t_pos.astype(np.int64),
        same.astype(np.uint8),
    )


def _expand_hits(part, lo, cnt, q_rid, q_pos1, avoid_equal, avoid_symmetric):
    """The matches of query entries against one index's key-sorted
    columns: entry j hits part's entries lo[j] .. lo[j] + cnt[j] - 1.
    Yields match columns (q_id, q_pos, t_id, t_pos int32, same uint8) of
    at most EXPAND_MATCHES hits each, query entries in order, the hits on
    the query read itself (avoid_equal) or on lower ids (avoid_symmetric)
    left out, as the host route's map leaves them."""
    dev = cnt.device
    csum = torch.cumsum(cnt, 0)
    n = cnt.numel()
    start = 0
    while start < n:
        base = int(csum[start - 1]) if start else 0
        end = max(start + 1, int(torch.searchsorted(csum, base + EXPAND_MATCHES, right=True)))
        c = cnt[start:end]
        src = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
        flat = (torch.arange(src.numel(), device=dev) - (torch.cumsum(c, 0) - c)[src]
                + lo[start:end][src])
        t_id = part._rid[flat]
        q_id = q_rid[start:end][src]
        keep = torch.ones(src.numel(), dtype=torch.bool, device=dev)
        if avoid_equal:
            keep &= t_id != q_id
        if avoid_symmetric:
            keep &= t_id > q_id
        sel = torch.nonzero(keep).squeeze(1)
        t_packed = part._packed[flat[sel]]
        q_p1 = q_pos1[start:end][src[sel]]
        same = (q_p1 & 1) == ((t_packed >> _STRAND_BIT) & 1)
        yield (q_id[sel], (q_p1 >> 1).to(torch.int32), t_id[sel], t_packed & _POS_MASK,
               same.to(torch.uint8))
        start = end


def foreign_join(parts, readset, ids, k, w, occurrence, minhash, avoid_equal,
                 avoid_symmetric, filtered_out=None, chain_k=None):
    """Map query reads that lie outside the index's build set (foreign
    queries) against key-sorted index parts on one device, with the host
    route's results (MinimizerIndex.map_many past its self-join).

    The queries are sketched on the index's device by K1 a read-aligned
    chunk at a time (the build's path), cut to their minhash subset under
    `minhash`; each entry's run of equal keys is found in every part by
    binary search; runs longer than `occurrence` are skipped, and with
    `filtered_out` given the query positions that hit them land there
    (each read's ascending); the other runs' hits are expanded in chunks
    of EXPAND_MATCHES and chained, at CHAIN_MATCHES or more matches
    at a time, on the device (chain_k set: returns {read_id: overlaps})
    or handed back as numpy match columns (chain_k None).  The span
    "index.join_foreign" counts the reads, bases, query entries and
    matches."""
    dev = parts[0].device
    ids = np.asarray(ids, dtype=np.int64)
    out: dict = {}
    host_cols: list = []
    pending: list = []
    f_rid, f_pos = [], []
    with trace.span("index.join_foreign", reads=int(ids.size),
                    bases=int(np.asarray(readset.lengths)[ids].sum())) as s:
        n_entries = n_matches = n_pending = 0

        def flush():
            cols = tuple(torch.cat(c) for c in zip(*pending))
            pending.clear()
            if chain_k is not None:
                chain_in_chunks(cols, chain_k, out)
            else:
                host_cols.append(_host_columns(cols))

        budget = _read_budget(readset, k, dev) if minhash else None
        for key, rid, pos1 in _sketch_chunks(readset, ids, k, w, dev, capped=False):
            if minhash:
                flag = _minhash_flags(key, rid, pos1, budget)
                key, rid, pos1 = key[flag], rid[flag], pos1[flag]
            n_entries += key.numel()
            qkey = key.to(torch.int32)
            for p in parts:
                lo = torch.searchsorted(p._key, qkey)
                cnt = torch.searchsorted(p._key, qkey, right=True) - lo
                if filtered_out is not None:
                    tf = torch.nonzero(cnt > occurrence).squeeze(1)
                    f_rid.append(rid[tf])
                    f_pos.append(pos1[tf] >> 1)
                use = torch.nonzero((cnt > 0) & (cnt <= occurrence)).squeeze(1)
                for cols in _expand_hits(p, lo[use], cnt[use], rid[use], pos1[use],
                                         avoid_equal, avoid_symmetric):
                    pending.append(cols)
                    n_pending += cols[0].numel()
            if n_pending >= CHAIN_MATCHES:
                n_matches += n_pending
                n_pending = 0
                flush()
        n_matches += n_pending
        if pending:
            flush()
        s["entries"] = n_entries
        s["matches"] = n_matches
    if f_rid:
        r = torch.cat(f_rid).cpu().numpy()
        q = torch.cat(f_pos).cpu().numpy()
        order = np.lexsort((q, r))
        r, q = r[order], q[order]
        cut = np.flatnonzero(np.diff(r)) + 1
        for rr, qq in zip(np.split(r, cut), np.split(q, cut)):
            if rr.size:
                filtered_out.setdefault(int(rr[0]), []).extend(qq.tolist())
    if chain_k is not None:
        return out
    if not host_cols:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, np.zeros(0, dtype=np.uint8)
    return tuple(np.concatenate(c) for c in zip(*host_cols))


class PartitionedIndex:
    """An index of more than MAX_ENTRIES entries as DeviceIndex parts over
    disjoint, ascending hash ranges: raven_tpu's PartitionedIndex
    (raven_tpu/overlap/device_index.py:1219).  A run of equal keys never
    crosses a range, so the filter's run lengths and the self-join split
    exactly: the parts join on their own and the union of their matches is
    chained (chain_in_chunks).

    raven_tpu re-sketches the reads once a part to fit a TPU's memory; here
    the reads are sketched once and the key-sorted columns cut at the
    range bounds (~13 GB at MAX_TOTAL_ENTRIES), so the minhash flags are
    the single index's.  The ranges are raven_tpu's equal ones unless one
    would hold more than MAX_ENTRIES, as the first does near the ceiling
    (minimizer hashes crowd the low end), or more than the self-join takes
    (SAFE_JOIN_ENTRIES usable entries: in a crowded range the sequencing
    errors' singleton hashes collide, so nearly every entry is usable);
    then they are cut even by the build's hash histogram
    (balanced_splits), into as many as keep each part within both.  Where
    the ranges cut changes no answer.  Each part keeps its own capacity limits, and any part's
    decline declines the whole.  Same contract as DeviceIndex
    (n_entries, has_flags, occurrence_for, distance_join, join_foreign,
    to_host)."""

    joins_foreign = True

    def __init__(self, parts, k, w, has_flags):
        self.parts = parts
        self.n_entries = sum(p.n_entries for p in parts)
        self.has_flags = has_flags
        self.k = k
        self.w = w

    @classmethod
    def build(cls, readset, ids, k, w, minhash, with_flags, device, n_parts):
        if n_parts < 2:
            return None
        cols = _build_columns(readset, ids, k, w, minhash, with_flags, device,
                              range_splits(n_parts), balance=True)
        if cols is None:
            return None
        key, rid, packed, need_flags, counts, splits = cols
        cuts = range_cuts(key, splits)
        parts = [
            DeviceIndex(key[a:b], rid[a:b], packed[a:b], need_flags, k, w, _capacity(c))
            for a, b, c in zip(cuts, cuts[1:], counts)
        ]
        return cls(parts, k, w, need_flags)

    def occurrence_for(self, frequency: float) -> int:
        """ram Filter over the run lengths of every part (DeviceIndex's),
        gathered on the first part's device."""
        if frequency <= 0 or self.n_entries == 0:
            return np.iinfo(np.int64).max
        for p in self.parts:
            p._ensure_counts()
        dev = self.parts[0].device
        run_len = torch.cat([p._run_len.to(dev) for p in self.parts])
        target = min(int((1.0 - frequency) * run_len.numel()), run_len.numel() - 1)
        return int(torch.sort(run_len).values[target])

    def distance_join(self, occurrence: int, batch: np.ndarray, need_flags: bool,
                      filtered_out: dict | None = None, chain_k: int | None = None):
        """DeviceIndex.distance_join over the parts: each joins on its own
        device, and their match columns meet on the first part's device,
        concatenated a column at a time (each part's copy freed as its
        column is joined), to be chained or returned once."""
        dev = self.parts[0].device
        parts = []
        for p in self.parts:
            cols = p.join_columns(occurrence, batch, need_flags, filtered_out)
            if cols is None:
                return None
            parts.append([c.to(dev, non_blocking=dev.type == "cuda") for c in cols])
        cols = []
        for j in range(len(parts[0])):
            cols.append(torch.cat([c[j] for c in parts]))
            for c in parts:
                c[j] = None
        del parts
        return _finish_join(tuple(cols), chain_k)

    def join_foreign(self, readset, ids, occurrence: int, minhash: bool, avoid_equal: bool,
                     avoid_symmetric: bool, filtered_out: dict | None = None,
                     chain_k: int | None = None):
        """foreign_join over the parts (one device): a query hash lies in
        one part's range, so each entry's run is that part's."""
        return foreign_join(self.parts, readset, ids, self.k, self.w, occurrence, minhash,
                            avoid_equal, avoid_symmetric, filtered_out, chain_k)

    def to_host(self):
        """The parts' host columns concatenated (the ranges ascend, so the
        result stays key-sorted)."""
        views = [p.to_host() for p in self.parts]
        cols = [np.concatenate([v[i] for v in views]) for i in range(4)]
        flags = np.concatenate([v[4] for v in views]) if self.has_flags else None
        return (*cols, flags)
