"""Pile-o-gram engine: per-read coverage profiles at 1/16 resolution.

Struct-of-arrays re-design of the reference Pile (RavenLib/src/pile.cc,
include/raven/pile.h).  All reads' coverage data live in one flat uint16
array (like ReadSet), so the hot operations — layer accumulation and the
sliding-window slope sweep — are vectorized over every read at once; the small
per-read region logic (chimera/repeat classification) follows the reference
control flow exactly, constants included (see SURVEY.md §2.3).

Coordinate convention: "bins" are read positions >> K_PSS (reference
pile.h:21, kPSS = 4, i.e. 16-base bins).
"""

from __future__ import annotations

import numpy as np

K_PSS = 4  # pile resolution shift (pile.h:21)
UINT16_MAX = 65535

_W_SLOPE = 847 >> K_PSS  # slope-detection window (pile.cc:421)
_MIN_VALID_BINS = 1260 >> K_PSS  # minimal valid-region length (pile.cc:145)
_KMER_GROUP_W = 479 >> K_PSS  # repeat k-mer grouping window (pile.cc:233)
_KMER_GROUP_SIZE = 12  # groups need > 12 members (pile.cc:234)
_REPEAT_FUZZ = 420 >> K_PSS  # repeat overlap fuzz (pile.cc:326)


def _clamp_mul(data: np.ndarray, q: float) -> np.ndarray:
    """clamp(data * q) with C++ double->uint16 truncation (pile.cc:12-17)."""
    return np.minimum(data.astype(np.float64) * q, UINT16_MAX).astype(np.uint16)


def _runs_of(marks: np.ndarray) -> list[tuple[int, int]]:
    """Maximal runs of consecutive marked indices -> [(first, last)]."""
    idx = np.nonzero(marks)[0]
    if idx.size == 0:
        return []
    splits = np.nonzero(np.diff(idx) > 1)[0] + 1
    return [(int(p[0]), int(p[-1])) for p in np.split(idx, splits)]


def merge_regions(src: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of strictly-overlapping regions (reference pile.cc:373-401;
    strict inequalities: touching regions are NOT merged)."""
    dst: list[tuple[int, int]] = []
    is_merged = [False] * len(src)
    for i in range(len(src)):
        if is_merged[i]:
            continue
        lo, hi = src[i]
        changed = True
        while changed:
            changed = False
            for j in range(i + 1, len(src)):
                if is_merged[j]:
                    continue
                jlo, jhi = src[j]
                if lo < jhi and hi > jlo:
                    is_merged[j] = True
                    lo = min(lo, jlo)
                    hi = max(hi, jhi)
                    changed = True
        dst.append((lo, hi))
    return dst


def detect_slope_marks(data: np.ndarray, q: float) -> tuple[np.ndarray, np.ndarray]:
    """Part 1 of the slope sweep (reference pile.cc:432-472), vectorized.

    down[i] is set when max(data[i-w .. i-1]) > clamp(data[i] * q);
    up[i] when max(data[i+1 .. i+w]) > clamp(data[i] * q).
    """
    size = data.size
    w = _W_SLOPE
    d = _clamp_mul(data, q).astype(np.int64)
    dat = data.astype(np.int64)
    padded = np.concatenate([np.zeros(w, np.int64), dat, np.zeros(w, np.int64)])
    sw = np.lib.stride_tricks.sliding_window_view(padded, w)
    # sw[j] = padded[j:j+w] = data[j-w : j]  (with zero padding)
    left_max = sw[:size].max(axis=1)  # data[i-w .. i-1]
    right_max = sw[w + 1 : size + w + 1].max(axis=1)  # data[i+1 .. i+w]
    down = (np.arange(size) != 0) & (left_max > d)
    up = (np.arange(size) != size - 1) & (right_max > d)
    return down, up


def find_slopes(data: np.ndarray, q: float) -> list[tuple[int, int]]:
    """Coverage drop/spike regions (reference pile.cc:403-600).

    Returns regions encoded like the reference: (first << 1 | dir, last)
    where dir 0 = down-slope, 1 = up-slope.
    """
    size = data.size
    if size == 0:
        return []
    w = _W_SLOPE
    d = _clamp_mul(data, q).astype(np.int64)
    dat = data.astype(np.int64)

    down, up = detect_slope_marks(data, q)

    dst: list[tuple[int, int]] = []
    for first, last in _runs_of(down):
        dst.append((first << 1 | 0, last))
    for first, last in _runs_of(up):
        dst.append((first << 1 | 1, last))
    if not dst:
        return dst

    # -- part 2: separate overlapping slopes (reference pile.cc:484-563) ---
    while True:
        dst.sort()
        changed = False
        for i in range(len(dst) - 1):
            if dst[i][1] < (dst[i + 1][0] >> 1):
                continue
            if dst[i][0] & 1:  # up-slope overlapping the next region
                sb = dst[i][0] >> 1
                se = min(dst[i][1], dst[i + 1][1])
                # re-mark with suffix maxima over [j+1 .. se]
                found_up = False
                first_up = last_up = 0
                suffix = np.zeros(se + 2, dtype=np.int64)
                for j in range(se, sb - 1, -1):
                    suffix[j] = max(suffix[j + 1], dat[j]) if j < se else dat[j]
                for j in range(sb, se):
                    if d[j] < suffix[j + 1]:
                        if found_up:
                            if j - last_up > 1:
                                dst.append((first_up << 1 | 1, last_up))
                                first_up = j
                        else:
                            found_up = True
                            first_up = j
                        last_up = j
                if found_up:
                    dst.append((first_up << 1 | 1, last_up))
                dst[i] = (se << 1 | 1, dst[i][1])
            else:  # down-slope
                if dst[i][1] == (dst[i + 1][0] >> 1):
                    continue
                sb = max(dst[i][0] >> 1, dst[i + 1][0] >> 1)
                se = dst[i][1]
                found_down = False
                first_down = last_down = 0
                prefix = -1  # max over [sb .. j-1], empty -> no mark
                for j in range(sb, se + 1):
                    if prefix >= 0 and d[j] < prefix:
                        if found_down:
                            if j - last_down > 1:
                                dst.append((first_down << 1, last_down))
                                first_down = j
                        else:
                            found_down = True
                            first_down = j
                        last_down = j
                    prefix = max(prefix, int(dat[j]))
                if found_down:
                    dst.append((first_down << 1, last_down))
                dst[i] = (dst[i][0], sb)
            changed = True
            break
        if not changed:
            break

    # -- part 3: narrow slopes (reference pile.cc:566-597) -----------------
    for i in range(len(dst) - 1):
        if (dst[i][0] & 1) and not (dst[i + 1][0] & 1):
            sb = dst[i][1]
            se = dst[i + 1][0] >> 1
            if se - sb > w:
                continue
            max_cov = int(dat[sb + 1 : se].max()) if se > sb + 1 else 0
            valid = dst[i][0] >> 1
            for j in range(dst[i][0] >> 1, sb + 1):
                if max_cov > d[j]:
                    valid = j
            dst[i] = ((dst[i][0] >> 1) << 1 | 1, valid)
            valid = dst[i + 1][1]
            for j in range(se, dst[i + 1][1] + 1):
                if max_cov > d[j]:
                    valid = j
                    break
            dst[i + 1] = (valid << 1 | 0, dst[i + 1][1])
    return dst


def _kmer_is_complex(kmer_codes: np.ndarray, kmer_len: int) -> bool:
    """Low-complexity k-mer filter (reference pile.cc:74-115): homopolymer
    compression and two phase-offset 2-gram compressions must each keep at
    least k/2 + 1 characters."""
    threshold = kmer_len // 2 + 1
    s = kmer_codes.tolist()
    # 1) homopolymer compression
    comp = [s[0]] + [c for a, c in zip(s, s[1:]) if c != a] if s else []
    if len(comp) < threshold:
        return False
    # 2) adjacent 2-gram dedup, phase 0: [c0c1][c2c3]...
    grams = [tuple(comp[i : i + 2]) for i in range(0, len(comp), 2)]
    dedup: list[tuple] = []
    for g in grams:
        if not dedup or dedup[-1] != g:
            dedup.append(g)
    flat = [c for g in dedup for c in g]
    if len(flat) < threshold:
        return False
    # 3) 2-gram dedup, phase 1: [c0][c1c2][c3c4]...
    comp2 = flat
    grams2: list[tuple] = [(comp2[0],)] if comp2 else []
    for i in range(1, len(comp2), 2):
        grams2.append(tuple(comp2[i : i + 2]))
    dedup2: list[tuple] = []
    for g in grams2:
        if not dedup2 or dedup2[-1] != g:
            dedup2.append(g)
    flat2 = [c for g in dedup2 for c in g]
    return len(flat2) >= threshold


class Piles:
    """All piles of a read set, flat storage + per-read state."""

    def __init__(self, lengths: np.ndarray):
        lengths = np.asarray(lengths, dtype=np.int64)
        self.n = lengths.size
        self.nbins = (lengths >> K_PSS).astype(np.int64)  # data_ sizes
        self.bin_starts = np.zeros(self.n, dtype=np.int64)
        if self.n:
            np.cumsum(self.nbins[:-1], out=self.bin_starts[1:])
        self.total_bins = int(self.nbins.sum())
        self.data = np.zeros(self.total_bins, dtype=np.uint16)
        self.begin = np.zeros(self.n, dtype=np.int64)  # begin_ (bins)
        self.end = self.nbins.copy()  # end_ (bins)
        self.median = np.zeros(self.n, dtype=np.uint16)
        self.is_invalid = np.zeros(self.n, dtype=bool)
        self.is_contained = np.zeros(self.n, dtype=bool)
        self.is_chimeric = np.zeros(self.n, dtype=bool)
        self.is_repetitive = np.zeros(self.n, dtype=bool)
        self.kmers: dict[int, np.ndarray] = {}  # id -> bool[nbins+1]
        self.chimeric_regions: list[list[tuple[int, int]]] = [[] for _ in range(self.n)]
        # repetitive regions encoded (first << 1 | confirmed, last), pile.cc:314
        self.repetitive_regions: list[list[tuple[int, int]]] = [
            [] for _ in range(self.n)
        ]

    # -------------------------------------------------------------- helpers
    def row(self, i: int) -> np.ndarray:
        s = self.bin_starts[i]
        return self.data[s : s + self.nbins[i]]

    def begin_bases(self, i: int) -> int:
        return int(self.begin[i]) << K_PSS  # pile.h begin()

    def end_bases(self, i: int) -> int:
        return int(self.end[i]) << K_PSS  # pile.h end()

    def length_bases(self, i: int) -> int:
        return self.end_bases(i) - self.begin_bases(i)

    # ------------------------------------------------------------ AddLayers
    def add_layers(self, ids: np.ndarray, begins: np.ndarray, ends: np.ndarray):
        """Accumulate coverage for intervals (base coords) on reads `ids`.

        Equivalent to the reference boundary sweep (pile.cc:33-62): each
        interval covers bins [(begin>>4)+1, (end>>4)-1), saturating uint16.
        Vectorized over all intervals with a flat difference array + cumsum.
        """
        if len(ids) == 0:
            return
        ids = np.asarray(ids, dtype=np.int64)
        b = (np.asarray(begins, dtype=np.int64) >> K_PSS) + 1
        e = (np.asarray(ends, dtype=np.int64) >> K_PSS) - 1
        valid = e > b
        if not valid.any():
            return
        ids, b, e = ids[valid], b[valid], e[valid]
        base = self.bin_starts[ids]
        diff = np.zeros(self.total_bins + 1, dtype=np.int64)
        np.add.at(diff, base + b, 1)
        np.add.at(diff, base + e, -1)
        cov = np.cumsum(diff[:-1])
        acc = self.data.astype(np.int64) + cov
        np.clip(acc, 0, UINT16_MAX, out=acc)
        self.data = acc.astype(np.uint16)

    # ------------------------------------------------------------- AddKmers
    def add_kmers(self, i: int, positions: list[int], kmer_len: int, codes: np.ndarray):
        """Mark repetitive k-mer bins (reference pile.cc:64-120)."""
        if not positions:
            return
        if i not in self.kmers:
            self.kmers[i] = np.zeros(int(self.nbins[i]) + 1, dtype=bool)
        marks = self.kmers[i]
        for p in positions:
            kmer = codes[p : p + kmer_len]
            if kmer.size < kmer_len:
                continue
            if _kmer_is_complex(kmer, kmer_len):
                marks[p >> K_PSS] = True

    # ----------------------------------------------------- FindValidRegion
    def find_valid_region(self, i: int, coverage: int):
        """Longest region with coverage >= threshold (pile.cc:122-142).

        Reproduces the reference scan, including its quirk of ignoring a
        run that extends to end_ without closing.
        """
        row = self.row(i)
        lo, hi = int(self.begin[i]), int(self.end[i])
        seg = row[lo:hi] >= coverage
        best_b = best_e = 0
        for first, last in _runs_of(seg):
            if last + lo + 1 >= hi:  # run touches end_: reference never records
                continue
            if (last + 1 - first) > (best_e - best_b):
                best_b, best_e = first + lo, last + lo + 1
        self._update_valid_region(i, best_b, best_e)

    def _update_valid_region(self, i: int, begin: int, end: int):
        """Reference pile.cc:144-157."""
        if begin >= end or end - begin < _MIN_VALID_BINS:
            self.is_invalid[i] = True
            return
        row = self.row(i)
        row[int(self.begin[i]) : begin] = 0
        row[end : int(self.end[i])] = 0
        self.begin[i] = begin
        self.end[i] = end

    def clear_valid_region(self, i: int):
        self.row(i)[int(self.begin[i]) : int(self.end[i])] = 0

    def clear_invalid_region(self, i: int):
        row = self.row(i)
        row[: int(self.begin[i])] = 0
        row[int(self.end[i]) :] = 0

    # ----------------------------------------------------------- FindMedian
    def find_median(self, i: int):
        """Upper median of the valid region (pile.cc:168-172)."""
        seg = self.row(i)[int(self.begin[i]) : int(self.end[i])]
        if seg.size == 0:
            self.median[i] = 0
            return
        k = seg.size // 2
        self.median[i] = np.partition(seg, k)[k]

    # -------------------------------------------------- FindChimericRegions
    def find_chimeric_regions(self, i: int):
        """Coverage-drop pairs -> candidate chimeric regions (pile.cc:174-187)."""
        slopes = find_slopes(self.row(i), 1.82)
        if not slopes:
            return
        regions = []
        for a, b in zip(slopes, slopes[1:]):
            if not (a[0] & 1) and (b[0] & 1):
                regions.append((a[0] >> 1, b[1]))
        self.chimeric_regions[i].extend(regions)
        self.chimeric_regions[i] = merge_regions(self.chimeric_regions[i])

    def is_maybe_chimeric(self, i: int) -> bool:
        return len(self.chimeric_regions[i]) > 0

    def clear_chimeric_regions(self, i: int, median: int):
        """Keep the longest non-chimeric stretch (reference pile.cc:189-228)."""
        row = self.row(i)

        def region_is_chimeric(r: tuple[int, int]) -> bool:
            lo, hi = r
            seg = row[lo : hi + 1]
            return bool((_clamp_mul(seg, 1.82) <= median).any())

        begin = end = 0
        last = int(self.begin[i])
        unresolved: list[tuple[int, int]] = []
        for r in self.chimeric_regions[i]:
            if self.begin[i] > r[0] or self.end[i] < r[1]:
                continue
            if region_is_chimeric(r):
                if r[0] - last > end - begin:
                    begin, end = last, r[0]
                last = r[1]
            else:
                unresolved.append(r)
        if int(self.end[i]) - last > end - begin:
            begin, end = last, int(self.end[i])

        if begin != int(self.begin[i]) or end != int(self.end[i]):
            self.is_chimeric[i] = True
        self.chimeric_regions[i] = unresolved
        self._update_valid_region(i, begin, end)

    # ------------------------------------------------ FindRepetitiveRegions
    def find_repetitive_regions(self, i: int, median: int):
        """Repeat detection from k-mer groups and coverage spikes
        (reference pile.cc:230-317)."""
        regions = self.repetitive_regions[i]

        marks = self.kmers.get(i)
        if marks is not None and marks.any():
            w = _KMER_GROUP_W
            region = (0, 0)
            count = 0
            for j in np.nonzero(marks)[0]:
                j = int(j)
                if count and j - region[1] <= w:
                    region = (region[0], j)
                    count += 1
                    continue
                if count > _KMER_GROUP_SIZE:
                    regions.append(region)
                    self.is_repetitive[i] = True
                region = (j, j)
                count = 1
            if count > _KMER_GROUP_SIZE:
                regions.append(region)
                self.is_repetitive[i] = True

        slopes = find_slopes(self.row(i), 1.42)
        if slopes:
            row = self.row(i).astype(np.int64)
            lo, hi = int(self.begin[i]), int(self.end[i])

            def is_repetitive_region(b: tuple[int, int], e: tuple[int, int]) -> bool:
                if ((e[0] >> 1) + e[1]) // 2 - ((b[0] >> 1) + b[1]) // 2 > 0.84 * (
                    hi - lo
                ):
                    return False
                peak_value = min(
                    int(1.42 * max(row[b[1]], row[e[0] >> 1])), UINT16_MAX
                )
                min_value = min(int(1.42 * median), UINT16_MAX)
                seg = row[b[1] + 1 : e[0] >> 1]
                num_valid = int((seg > min_value).sum())
                found_peak = bool((seg > peak_value).any())
                if not found_peak or num_valid < 0.9 * ((e[0] >> 1) - b[1]):
                    return False
                return True

            for a in range(len(slopes) - 1):
                if not (slopes[a][0] & 1):
                    continue
                for b in range(a + 1, len(slopes)):
                    if slopes[b][0] & 1:
                        continue
                    if is_repetitive_region(slopes[a], slopes[b]):
                        first = int(
                            slopes[a][1]
                            - 0.336 * (slopes[a][1] - (slopes[a][0] >> 1))
                        )
                        second = int(
                            (slopes[b][0] >> 1)
                            + 0.336 * (slopes[b][1] - (slopes[b][0] >> 1))
                        )
                        regions.append((first, second))
                        self.is_repetitive[i] = True

        merged = merge_regions(regions)
        self.repetitive_regions[i] = [
            (max(int(self.begin[i]), lo2) << 1, min(int(self.end[i]), hi2))
            for lo2, hi2 in merged
        ]

    def update_repetitive_regions(self, i: int, begin: int, end: int):
        """Raise confidence bits given an overlap reaching a read end
        (reference pile.cc:319-342); begin/end are base coords on read i."""
        regions = self.repetitive_regions[i]
        if not regions:
            return
        b = begin >> K_PSS
        e = end >> K_PSS
        fuzz = _REPEAT_FUZZ
        offset = int(0.1 * (self.end[i] - self.begin[i]))
        lo, hi = int(self.begin[i]), int(self.end[i])
        for idx, (rf, rs) in enumerate(regions):
            if b < rs and (rf >> 1) < e:
                if (rf >> 1) < lo + offset and b - lo < hi - e:
                    if e >= rs + fuzz:
                        regions[idx] = (rf | 1, rs)
                elif rs > hi - offset and b - lo > hi - e:
                    if b + fuzz <= (rf >> 1):
                        regions[idx] = (rf | 1, rs)

    def check_repetitive_regions(self, i: int, begin: int, end: int) -> bool:
        """True if the overlap is blocked by a confirmed repeat region
        (reference pile.cc:344-369)."""
        regions = self.repetitive_regions[i]
        if not regions:
            return False
        b = begin >> K_PSS
        e = end >> K_PSS
        fuzz = _REPEAT_FUZZ
        offset = int(0.1 * (self.end[i] - self.begin[i]))
        lo, hi = int(self.begin[i]), int(self.end[i])
        for rf, rs in regions:
            if b < rs and (rf >> 1) < e:
                if (rf >> 1) < lo + offset:
                    if e < rs + fuzz and (rf & 1):
                        return True
                elif rs > hi - offset:
                    if b + fuzz > (rf >> 1) and (rf & 1):
                        return True
        return False

    def clear_repetitive_regions(self, i: int):
        self.repetitive_regions[i] = []

    # ------------------------------------------- batched repeat-region ops
    def _region_table(self):
        """Flatten per-read repetitive regions into (read, rf, rs) columns
        plus per-read CSR offsets into them (empty reads -> empty span).
        The stage -4 fixed point is O(overlaps x regions) and pure python
        in scalar form; the batched form joins the overlap sides to the
        region rows of their read and evaluates both predicates as array
        expressions (semantics oracle-tested against the scalar methods)."""
        rows_read: list[int] = []
        rows_rf: list[int] = []
        rows_rs: list[int] = []
        starts = np.zeros(self.n + 1, dtype=np.int64)
        for i in range(self.n):
            regs = self.repetitive_regions[i]
            starts[i + 1] = starts[i] + len(regs)
            for rf, rs in regs:
                rows_read.append(i)
                rows_rf.append(rf)
                rows_rs.append(rs)
        return (
            np.array(rows_read, dtype=np.int64),
            np.array(rows_rf, dtype=np.int64),
            np.array(rows_rs, dtype=np.int64),
            starts,
        )

    def _region_join(self, starts, ids):
        """Expand overlap-side rows to one row per (side, region) pair."""
        counts = (starts[ids + 1] - starts[ids]).astype(np.int64)
        total = int(counts.sum())
        side_idx = np.repeat(np.arange(ids.size, dtype=np.int64), counts)
        offsets = np.repeat(np.cumsum(counts) - counts, counts)
        reg_idx = (
            np.arange(total, dtype=np.int64) - offsets
            + np.repeat(starts[ids], counts)
        )
        return side_idx, reg_idx

    def update_repetitive_regions_batch(self, ids, begins, ends) -> None:
        """Vectorized update_repetitive_regions over many (read, begin,
        end) overlap sides at once (reference pile.cc:319-342)."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return
        r_read, r_rf, r_rs, starts = self._region_table()
        if r_read.size == 0:
            return
        side_idx, reg_idx = self._region_join(starts, ids)
        if side_idx.size == 0:
            return
        b = np.asarray(begins, dtype=np.int64)[side_idx] >> K_PSS
        e = np.asarray(ends, dtype=np.int64)[side_idx] >> K_PSS
        i = r_read[reg_idx]
        rf = r_rf[reg_idx]
        rs = r_rs[reg_idx]
        lo = self.begin[i].astype(np.int64)
        hi = self.end[i].astype(np.int64)
        offset = (0.1 * (hi - lo)).astype(np.int64)
        fuzz = _REPEAT_FUZZ

        cond0 = (b < rs) & ((rf >> 1) < e)
        first_guard = ((rf >> 1) < lo + offset) & (b - lo < hi - e)
        set1 = first_guard & (e >= rs + fuzz)
        set2 = (
            ~first_guard
            & (rs > hi - offset)
            & (b - lo > hi - e)
            & (b + fuzz <= (rf >> 1))
        )
        setbit = cond0 & (set1 | set2)
        if not setbit.any():
            return
        hit = np.zeros(r_read.size, dtype=bool)
        np.logical_or.at(hit, reg_idx[setbit], True)
        for ridx in np.nonzero(hit)[0]:
            i0 = int(r_read[ridx])
            k = int(ridx - starts[i0])
            rf0, rs0 = self.repetitive_regions[i0][k]
            self.repetitive_regions[i0][k] = (rf0 | 1, rs0)

    def check_repetitive_regions_batch(self, ids, begins, ends) -> np.ndarray:
        """Vectorized check_repetitive_regions; returns a bool per side
        (reference pile.cc:344-369)."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.zeros(ids.size, dtype=bool)
        if ids.size == 0:
            return out
        r_read, r_rf, r_rs, starts = self._region_table()
        if r_read.size == 0:
            return out
        side_idx, reg_idx = self._region_join(starts, ids)
        if side_idx.size == 0:
            return out
        b = np.asarray(begins, dtype=np.int64)[side_idx] >> K_PSS
        e = np.asarray(ends, dtype=np.int64)[side_idx] >> K_PSS
        i = r_read[reg_idx]
        rf = r_rf[reg_idx]
        rs = r_rs[reg_idx]
        lo = self.begin[i].astype(np.int64)
        hi = self.end[i].astype(np.int64)
        offset = (0.1 * (hi - lo)).astype(np.int64)
        fuzz = _REPEAT_FUZZ

        cond0 = (b < rs) & ((rf >> 1) < e)
        first_guard = (rf >> 1) < lo + offset
        blocked = cond0 & (rf & 1).astype(bool) & (
            (first_guard & (e < rs + fuzz))
            | (~first_guard & (rs > hi - offset) & (b + fuzz > (rf >> 1)))
        )
        if blocked.any():
            np.logical_or.at(out, side_idx[blocked], True)
        return out
