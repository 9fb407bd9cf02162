"""Minimizer index + all-vs-all mapping engine.

The torch port of raven_tpu/overlap/engine.py, the replacement for the
`ram` dependency's MinimizerEngine (reference use sites: construct.cc:42-44,
62, 363, 372-381; assemble.cc:753-780).  The index is a plain sorted
struct-of-arrays (hash-sorted), so lookup is binary search
(np.searchsorted) instead of a pointer hash table and candidate expansion
is a vectorized gather.  Inputs of DEVICE_MIN_BASES or more build the
device-resident index (overlap/device_index.py) on the engine's device;
smaller ones take the host path.  Where the device path cannot take an
input (a capacity limit), the engine says so on stderr, counts it in
`MinimizerIndex.host_declines` and runs the host path.

API mirrors the reference engine:
  minimize(readset, ids, minhash)  ~ ram Minimize  (construct.cc:42)
  filter(freq)                     ~ ram Filter    (construct.cc:44)
  map(readset, i, ...)             ~ ram Map       (construct.cc:62)
"""

from __future__ import annotations

import sys

import numpy as np

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.overlap import chain as chain_mod
from raven_tpu_torch.overlap.device_index import MAX_ENTRIES, DeviceIndex
from raven_tpu_torch.overlap.minimizer import minimize_read, minimize_reads
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE


def _sorted_unique(h: np.ndarray):
    """(uniq, start, count) for an ALREADY-SORTED array.

    np.unique re-sorts its input — 23 s of a 62 s host index build at
    115 Mb went into re-sorting the sorted hash column."""
    if not h.size:
        return (
            np.empty(0, h.dtype),
            np.empty(0, np.int64),
            np.empty(0, np.int64),
        )
    newrun = np.empty(h.size, dtype=bool)
    newrun[0] = True
    np.not_equal(h[1:], h[:-1], out=newrun[1:])
    start = np.flatnonzero(newrun)
    count = np.diff(np.append(start, h.size))
    return h[start], start.astype(np.int64), count.astype(np.int64)


class MinimizerIndex:
    # inputs of at least this many bases build the device index; smaller
    # ones are faster on the host (tests lower it to drive the device path)
    DEVICE_MIN_BASES = 8_000_000
    # device-path declines to the host path, over every engine in the
    # process (a run reads it to show the device path took everything)
    host_declines = 0

    def __init__(self, k: int = 15, w: int = 5, device=None):
        if not 1 <= k <= 31:
            raise ValueError("k must be in [1, 31]")
        self.k = k
        self.w = w
        self.device = resolve_device(device)
        self._hashes = np.empty(0, np.uint64)
        self._ids = np.empty(0, np.uint32)
        self._pos = np.empty(0, np.uint32)
        self._strand = np.empty(0, np.uint8)
        # distinct-hash directory for O(log n) range lookup
        self._uniq = np.empty(0, np.uint64)
        self._uniq_start = np.empty(0, np.int64)
        self._uniq_count = np.empty(0, np.int64)
        self._occurrence = np.iinfo(np.int64).max  # filter threshold
        self._build_sorted = np.empty(0, np.int64)  # index build id set
        self._selfjoin_enabled = True  # test hook: False forces legacy join
        self._minhash = False
        self._qflag = None  # per-entry minhash-subset membership
        self._device = None  # DeviceIndex when built on-accelerator

    # ------------------------------------------------------------------ build
    def minimize(
        self,
        readset,
        ids,
        minhash: bool = False,
        with_query_flags: bool = False,
    ) -> None:
        """(Re)build the index from the sketches of `ids` (ram Minimize).

        with_query_flags: precompute per-entry minhash-subset membership so
        later map_many(minhash=True) calls can run the self-join fast path
        without re-sketching (only meaningful when minhash=False here)."""
        ids = np.asarray(ids, dtype=np.int64)
        self._build_sorted = np.sort(ids)
        self._minhash = bool(minhash)
        self._qflag = None
        self._device = None
        if self._device_build(readset, ids, minhash, with_query_flags):
            return

        h, i, p, s = minimize_reads(readset, ids, self.k, self.w, minhash)
        order = np.argsort(h, kind="stable")
        if with_query_flags and not minhash:
            from raven_tpu_torch.overlap.selfjoin import minhash_flags

            # h/i are read-grouped pre-sort (minimize_reads layout)
            self._qflag = minhash_flags(h, i, readset.lengths, self.k)[order]
        self._hashes = h[order]
        self._ids = i[order]
        self._pos = p[order]
        self._strand = s[order]
        uniq, start, count = _sorted_unique(self._hashes)
        self._uniq = uniq
        self._uniq_start = start
        self._uniq_count = count
        self._occurrence = np.iinfo(np.int64).max

    @classmethod
    def _decline(cls, reason: str) -> None:
        """The device path cannot take this input: say so and count it."""
        cls.host_declines += 1
        print(
            f"[raven_tpu_torch::MinimizerEngine] device path declined, "
            f"running on the host: {reason}",
            file=sys.stderr,
        )

    def _device_build(self, readset, ids, minhash, with_query_flags) -> bool:
        """Build the index device-resident; returns False to fall through
        to the host build (inputs under DEVICE_MIN_BASES, or a decline)."""
        if ids.size == 0:
            return False
        total = int(readset.lengths[np.asarray(ids, np.int64)].sum())
        if total < self.DEVICE_MIN_BASES:
            return False
        if 2 * self.k > 30:
            self._decline(f"k={self.k}: 2k > 30 leaves the 32-bit hash domain")
            return False
        # entry estimate ~2/(w+1) per base
        est = total * 2 // (self.w + 1)
        if est > MAX_ENTRIES:
            self._decline(
                f"~{est} index entries exceed one device index "
                f"({MAX_ENTRIES}); the partitioned index is not ported"
            )
            return False
        self._device = DeviceIndex.build(
            readset, ids, self.k, self.w, minhash, with_query_flags,
            self.device,
        )
        if self._device is None:
            self._decline(
                "a sketch chunk or the entry count exceeds the device "
                "index capacity"
            )
            return False
        # host columns are materialized lazily (only non-self-join callers
        # need them; the construct pipeline never does)
        self._hashes = None
        self._ids = None
        self._pos = None
        self._strand = None
        self._qflag = None
        return True

    def _materialize_host(self) -> None:
        """Transfer the device-built index into the host columns (fallback
        for generic map()/lookup callers).

        The construct pipeline uses map_many/distance_join and never lands
        here; a generic per-read map() call forfeits the device-resident
        build, so the (one-time) transfer is logged."""
        if self._device is None or self._hashes is not None:
            return
        print(
            "[raven_tpu_torch::MinimizerEngine] materializing device index on "
            f"host ({self._device.n_entries} entries) for generic lookup",
            file=sys.stderr,
        )
        h, i, p, s, f = self._device.to_host()
        self._hashes, self._ids, self._pos, self._strand = h, i, p, s
        self._qflag = f
        uniq, start, count = _sorted_unique(h)
        self._uniq = uniq
        self._uniq_start = start
        self._uniq_count = count

    @property
    def num_minimizers(self) -> int:
        if self._device is not None and self._hashes is None:
            return self._device.n_entries
        return int(self._hashes.size)

    def filter(self, frequency: float) -> None:
        """Set the occurrence threshold that ignores the `frequency` fraction
        of most frequent minimizers (ram Filter semantics, construct.cc:44)."""
        if self._device is not None and self._hashes is None:
            self._occurrence = self._device.occurrence_for(frequency)
            return
        if frequency <= 0 or self._uniq_count.size == 0:
            self._occurrence = np.iinfo(np.int64).max
            return
        counts = np.sort(self._uniq_count)
        idx = int((1.0 - frequency) * counts.size)
        idx = min(idx, counts.size - 1)
        self._occurrence = int(counts[idx])

    # -------------------------------------------------------------- self-join
    def _selfjoin_compatible(
        self, ids, avoid_equal, avoid_symmetric, minhash
    ) -> bool:
        """The construct-phase mapping pattern: queried reads are a
        contiguous sub-range of the index's own build set, so the join runs
        entirely within the sorted index (raven_tpu_torch.overlap.selfjoin)."""
        from raven_tpu_torch.overlap.selfjoin import MAX_OCCURRENCE

        if not (avoid_equal and avoid_symmetric):
            return False
        if not self._selfjoin_enabled or self._build_sorted.size == 0:
            return False
        # every queried read must have its sketch in the index
        loc = np.searchsorted(self._build_sorted, ids)
        if (loc >= self._build_sorted.size).any() or not np.array_equal(
            self._build_sorted[np.minimum(loc, self._build_sorted.size - 1)],
            ids,
        ):
            return False
        if minhash != self._minhash:
            # only "minhash queries against a full index" is joinable, and
            # it needs the precomputed membership flags
            if not (minhash and not self._minhash):
                return False
            if self._device is None and self._qflag is None:
                return False
        occ = self._occurrence
        if occ > MAX_OCCURRENCE:
            return False
        return True

    def _map_many_selfjoin(
        self, ids, minhash, filtered_out, anchors_out, out
    ):
        """Distance-join over the sorted index (host or device); fills and
        returns `out`, or None to fall back to the generic path."""
        from raven_tpu_torch.overlap import selfjoin

        batch = np.zeros(int(self._build_sorted[-1]) + 1, dtype=bool)
        batch[np.asarray(ids, np.int64)] = True
        collect = {} if filtered_out is not None else None
        matches = None
        if self._device is not None and self._hashes is None:
            # chaining runs on device too unless the caller needs the
            # per-overlap anchors (the matches then never leave the device)
            chain_k = self.k if anchors_out is None else None
            matches = self._device.distance_join(
                int(self._occurrence),
                batch,
                need_flags=(minhash and not self._minhash),
                filtered_out=collect,
                chain_k=chain_k,
            )
            if isinstance(matches, dict):  # chained on device
                if collect:
                    for rid, plist in collect.items():
                        plist.sort()
                        filtered_out.setdefault(rid, []).extend(plist)
                out.update(matches)
                return out
            if matches is None:  # capacity decline: host self-join instead
                self._decline(
                    f"occurrence {int(self._occurrence)} or the join size "
                    "exceeds the device join's capacity"
                )
                self._materialize_host()
                collect = {} if filtered_out is not None else None
        if matches is None:
            qflag = (
                self._qflag if (minhash and not self._minhash) else None
            )
            if minhash and not self._minhash and qflag is None:
                return None
            matches = selfjoin.distance_join(
                self._hashes,
                self._ids,
                self._pos,
                self._strand,
                qflag,
                int(self._occurrence),
                batch,
                filtered_out=collect,
            )
        if collect:
            for rid, plist in collect.items():
                plist.sort()  # match the generic path's position order
                filtered_out.setdefault(rid, []).extend(plist)
        selfjoin.chain_per_read(
            *matches, self.k, out, anchors_out=anchors_out
        )
        return out

    # ------------------------------------------------------------------- map
    def sketch(self, readset, i: int, minhash: bool = False):
        return minimize_read(readset.sequence(int(i)), self.k, self.w, minhash)

    def map(
        self,
        readset,
        i: int,
        avoid_equal: bool = True,
        avoid_symmetric: bool = True,
        minhash: bool = False,
        filtered_out: list | None = None,
        query_sketch=None,
        anchors_out: list | None = None,
    ) -> np.ndarray:
        """Map read `i` against the index; returns structured overlaps.

        avoid_equal: skip hits on the query read itself.
        avoid_symmetric: skip hits with target id < query id, so each
          unordered pair is reported exactly once when every read is mapped
          (cross-batch pairs are found from the earlier read, matching the
          reference batching scheme at construct.cc:59-77).
        filtered_out: if given, receives query k-mer start positions whose
          minimizer was too frequent (consumed by Pile.AddKmers, reference
          construct.cc:377-383).
        """
        self._materialize_host()
        if query_sketch is None:
            qh, qp, qs = self.sketch(readset, i, minhash)
        else:
            qh, qp, qs = query_sketch
        if qh.size == 0 or self._hashes.size == 0:
            return np.zeros(0, dtype=OVERLAP_DTYPE)

        lo = np.searchsorted(self._hashes, qh, side="left")
        hi = np.searchsorted(self._hashes, qh, side="right")
        counts = hi - lo

        too_frequent = counts > self._occurrence
        if filtered_out is not None and too_frequent.any():
            filtered_out.extend(qp[too_frequent].tolist())

        usable = (counts > 0) & ~too_frequent
        if not usable.any():
            return np.zeros(0, dtype=OVERLAP_DTYPE)
        lo_u = lo[usable]
        cnt_u = counts[usable]
        qp_u = qp[usable]
        qs_u = qs[usable]

        # expand ranges: index positions of every hit
        total = int(cnt_u.sum())
        offsets = np.repeat(np.cumsum(cnt_u) - cnt_u, cnt_u)
        flat = np.arange(total, dtype=np.int64) - offsets + np.repeat(lo_u, cnt_u)
        tid = self._ids[flat]
        tpos = self._pos[flat]
        tstrand = self._strand[flat]
        q_pos = np.repeat(qp_u, cnt_u)
        q_strand = np.repeat(qs_u, cnt_u)

        keep = np.ones(total, dtype=bool)
        if avoid_equal:
            keep &= tid != np.uint32(i)
        if avoid_symmetric:
            keep &= tid > np.uint32(i)
        if not keep.any():
            return np.zeros(0, dtype=OVERLAP_DTYPE)
        tid = tid[keep]
        tpos = tpos[keep]
        same = (tstrand[keep] == q_strand[keep]).astype(np.uint8)
        q_pos = q_pos[keep]

        return chain_mod.chain_matches(
            i, tid, same, q_pos, tpos, self.k, anchors_out=anchors_out
        )

    def map_many(
        self,
        readset,
        ids,
        avoid_equal: bool = True,
        avoid_symmetric: bool = True,
        minhash: bool = False,
        filtered_out: dict | None = None,
        anchors_out: dict | None = None,
    ) -> dict[int, np.ndarray]:
        """Map many reads in one vectorized pass (same results as per-read
        map(), order included).

        The sketches are computed in one (process-parallel) sweep, the index
        join (searchsorted + expansion + symmetric filtering) runs over the
        whole batch at once, and only the chaining dispatches per read
        (native C++).  filtered_out: {read_id: [kmer positions]} collecting
        too-frequent minimizers per read.
        """
        ids = np.asarray(ids, dtype=np.int64)
        out: dict[int, np.ndarray] = {
            int(i): np.zeros(0, dtype=OVERLAP_DTYPE) for i in ids
        }
        if ids.size == 0 or self.num_minimizers == 0:
            return out

        if self._selfjoin_compatible(ids, avoid_equal, avoid_symmetric, minhash):
            done = self._map_many_selfjoin(
                ids, minhash, filtered_out, anchors_out, out
            )
            if done is not None:
                return done

        self._materialize_host()
        qh, qi, qp, qs = minimize_reads(readset, ids, self.k, self.w, minhash)
        if qh.size == 0:
            return out

        lo = np.searchsorted(self._hashes, qh, side="left")
        hi = np.searchsorted(self._hashes, qh, side="right")
        counts = hi - lo

        too_frequent = counts > self._occurrence
        if filtered_out is not None and too_frequent.any():
            for rid, pos in zip(qi[too_frequent], qp[too_frequent]):
                filtered_out.setdefault(int(rid), []).append(int(pos))

        usable = (counts > 0) & ~too_frequent
        if not usable.any():
            return out
        lo_u = lo[usable]
        cnt_u = counts[usable]
        qi_u = qi[usable].astype(np.int64)
        qp_u = qp[usable]
        qs_u = qs[usable]

        total = int(cnt_u.sum())
        offsets = np.repeat(np.cumsum(cnt_u) - cnt_u, cnt_u)
        flat = np.arange(total, dtype=np.int64) - offsets + np.repeat(lo_u, cnt_u)
        tid = self._ids[flat]
        tpos = self._pos[flat]
        tstrand = self._strand[flat]
        q_id = np.repeat(qi_u, cnt_u)
        q_pos = np.repeat(qp_u, cnt_u)
        q_strand = np.repeat(qs_u, cnt_u)

        keep = np.ones(total, dtype=bool)
        if avoid_equal:
            keep &= tid != q_id
        if avoid_symmetric:
            keep &= tid > q_id
        if not keep.any():
            return out
        tid = tid[keep]
        tpos = tpos[keep]
        same = (tstrand[keep] == q_strand[keep]).astype(np.uint8)
        q_pos = q_pos[keep]
        q_id = q_id[keep]

        # per-read chaining via the shared batch path (one native call,
        # C++ threads over reads; identical results to per-read map())
        from raven_tpu_torch.overlap import selfjoin

        selfjoin.chain_per_read(
            q_id, q_pos, tid, tpos, same, self.k, out,
            anchors_out=anchors_out,
        )
        return out
