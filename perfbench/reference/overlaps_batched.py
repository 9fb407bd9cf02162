"""Plain reference of the construct's all-vs-all overlap pass when the read
set streams through the index in batches, read by read.

The pass of reference/overlaps.py, with the construct driver's streaming
(graph/construct.py's stage -5, copied and frozen here; nothing of the
program is imported):

- the reads, in read order, fill index batches of INDEX_BATCH_BASES bases:
  the read that reaches the budget closes its batch (the last read closes
  the last);
- each batch's index holds its own reads' sketches, and its occurrence
  threshold is ram's Filter over its own hashes' counts;
- every read from the first up to a batch's last is mapped against that
  batch, from the lower id (q < t): so a pair (q, t) is found against the
  batch that holds t, under that batch's threshold, whether q lies in that
  batch or in an earlier one (a foreign query);
- the rest is reference/overlaps.py's: the minhash query subset, the
  chain, the cap, the pile row.

Each batch's hashes are counted on the device one batch at a time, chunk by
chunk, and only the entries whose hash a sampled read holds are kept, so the
reference fits beside the freed program on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import overlaps as ref

# the index batch's budget in bases on a card: raven_tpu's clamp of its
# partitioned index's ceiling, 3 x 2^28 entries at ~3 bases an entry with
# ~10% headroom, int(805,306,368 x 3 x 0.9)
INDEX_BATCH_BASES = 2_174_327_193


def batch_ends(lengths: np.ndarray, budget: int) -> np.ndarray:
    """The end (one past the last read) of each index batch, in read
    order."""
    ends = []
    n = int(lengths.size)
    csum = np.cumsum(np.asarray(lengths, dtype=np.int64))
    start = 0
    while start < n:
        base = int(csum[start - 1]) if start else 0
        # the first read whose running sum from `start` reaches the budget
        i = int(np.searchsorted(csum, base + budget, side="left"))
        end = min(i + 1, n)
        ends.append(end)
        start = end
    return np.asarray(ends, dtype=np.int64)


def _reads_codes(codes, starts, lengths, reads):
    """The codes of `reads`, concatenated, and their lengths."""
    parts = [codes[starts[r]: starts[r] + lengths[r]] for r in reads]
    return np.concatenate(parts), np.asarray(lengths[reads], dtype=np.int64)


class Index:
    """The batched pass's index as the sampled reads see it: every sketch
    entry whose hash a sampled read holds, sorted by hash, with its read,
    position, strand and minhash flag, and whether its batch's filter keeps
    its hash (`usable`); and the entries of the whole read set (`entries`).

    `foreign=False` drops the pairs whose query lies in an earlier batch
    than its target (a control: the later batches map only their own
    reads); `budget_div` divides the query's minhash budget (a control)."""

    def __init__(self, codes, lengths, sample, k: int, w: int, freq: float, device,
                 budget: int = INDEX_BATCH_BASES, budget_div: int = 1, foreign: bool = True):
        self.k = k
        self.foreign = foreign
        lengths = np.asarray(lengths, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        self.ends = batch_ends(lengths, budget)
        ends_t = torch.as_tensor(self.ends, device=device)
        read_budget = torch.as_tensor(lengths, device=device) // (k * budget_div)

        # the hashes the sampled reads hold
        sample = np.asarray(sorted(sample), dtype=np.int64)
        sc, sl = _reads_codes(codes, starts, lengths, sample)
        sh = ref._sketch_chunk(torch.from_numpy(sc).to(device), sl, k, w)[0]
        wanted = torch.unique(sh)

        n_batches = self.ends.size
        counted = [[] for _ in range(n_batches)]
        kept = []
        self.entries = 0
        n = lengths.size
        ends = starts + lengths
        lo = 0
        while lo < n:
            hi = max(lo + 1, int(np.searchsorted(ends, starts[lo] + ref.CHUNK_BASES,
                                                 side="right")))
            chunk = torch.from_numpy(codes[starts[lo]: ends[hi - 1]]).to(device)
            h, r, p, s = ref._sketch_chunk(chunk, lengths[lo:hi], k, w)
            r = r + lo
            f = ref.minhash_flags(h, r, read_budget)
            b = torch.searchsorted(ends_t, r, right=True)
            self.entries += int(h.numel())
            for j in torch.unique(b).tolist():
                counted[j].append(h[b == j].to(torch.int32))
            pos = torch.searchsorted(wanted, h).clamp(max=wanted.numel() - 1)
            m = wanted[pos] == h
            kept.append((h[m], r[m], p[m], s[m], f[m], b[m]))
            lo = hi

        # each batch's filter, and its counts of the wanted hashes
        occ = []
        wanted_counts = torch.zeros((n_batches, wanted.numel()), dtype=torch.int64,
                                    device=device)
        w32 = wanted.to(torch.int32)
        for j in range(n_batches):
            parts, counted[j] = counted[j], None
            if not parts:
                occ.append(ref.INF)
                continue
            keys, counts = torch.unique_consecutive(torch.sort(torch.cat(parts)).values,
                                                    return_counts=True)
            del parts
            if freq <= 0:
                occ.append(ref.INF)
            else:
                cs = torch.sort(counts).values
                idx = min(int((1.0 - freq) * cs.numel()), cs.numel() - 1)
                occ.append(int(cs[idx]))
            at = torch.searchsorted(keys, w32).clamp(max=keys.numel() - 1)
            wanted_counts[j] = torch.where(keys[at] == w32, counts[at], 0)
        self.occ = occ
        h, r, p, s, f, b = (torch.cat([c[j] for c in kept]) for j in range(6))
        order = torch.sort(h, stable=True).indices
        self.h, self.r, self.p, self.s, self.f, self.b = (x[order] for x in (h, r, p, s, f, b))
        widx = torch.searchsorted(wanted, self.h)
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=device)
        self.usable = wanted_counts[self.b, widx] <= occ_t[self.b]
        self.by_read = torch.sort(self.r, stable=True).indices
        self.r_sorted = self.r[self.by_read]

    def _entries(self, read: int):
        lo = int(torch.searchsorted(self.r_sorted, read))
        hi = int(torch.searchsorted(self.r_sorted, read, right=True))
        return self.by_read[lo:hi]

    def _expand(self, qh):
        """For each hash of qh: the positions of its entries (every batch's)."""
        lo = torch.searchsorted(self.h, qh)
        cnt = torch.searchsorted(self.h, qh, right=True) - lo
        src = torch.repeat_interleave(torch.arange(qh.numel(), device=qh.device), cnt)
        flat = torch.arange(src.numel(), device=qh.device) - (torch.cumsum(cnt, 0) - cnt)[src] + lo[src]
        return src, flat

    def matches(self, read: int):
        """As reference/overlaps.py's Index.matches: the raw matches of
        every pair that holds `read`, as the query and as the target, each
        pair under the threshold of the batch that holds its target."""
        e = self._entries(read)
        out = []
        for as_query in (True, False):
            sel = e[self.f[e]] if as_query else e
            src, flat = self._expand(self.h[sel])
            other = self.r[flat]
            mine = sel[src]
            if as_query:
                keep = (other > read) & self.usable[flat]
            else:
                keep = (other < read) & self.f[flat] & self.usable[mine]
            if not self.foreign:
                keep &= self.b[flat] == self.b[mine]
            src, flat, mine = src[keep], flat[keep], mine[keep]
            q, t = (mine, flat) if as_query else (flat, mine)
            same = self.s[q] == self.s[t]
            out.append(tuple(x.cpu().numpy() for x in (self.r[q], self.r[t], self.p[q], self.p[t], same)))
        return out
