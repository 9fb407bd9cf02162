"""Synthetic read sets, consensus windows and the checks used on runs.

Copies of the repository's generators and metrics, so the port's checks
need nothing of raven_tpu: `synth_reads` is bench.py's overlap-stage
workload (E. coli scale, substitutions only), `simulate_reads` is
misc/reference_compare.py's ONT-like simulator (substitutions and indels)
behind the synthetic golden test, `make_windows` is bench_polish.py's bank
of 500 bp consensus windows, `overlap_digest` is bench.py's
order-independent digest of an emitted overlap set, and `contig_ed` is
misc/reference_compare.py's anchored edit distance of a contig against the
true genome; `random_genome` and `sample_reads` are tests/conftest.py's
small read simulator, which the multi-process worker's roles draw from.
"""

from __future__ import annotations

import hashlib

import numpy as np

from raven_tpu_torch.io.readset import ReadSet


def synth_reads(
    genome_size: int, coverage: float, mean_len: int, error: float,
    seed: int = 21,
) -> ReadSet:
    """bench.py::synth_reads: reads of ~mean_len drawn uniformly from a
    random genome up to `coverage`, with substitution errors only."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_size).astype(np.uint8)
    total = int(genome_size * coverage)
    reads = []
    acc = 0
    while acc < total:
        length = max(1000, int(rng.normal(mean_len, mean_len // 3)))
        length = min(length, genome_size - 1)
        s = int(rng.integers(0, genome_size - length))
        seg = genome[s : s + length].copy()
        nerr = rng.binomial(length, error)
        idx = rng.integers(0, length, size=nerr)
        seg[idx] = (seg[idx] + rng.integers(1, 4, size=nerr)) % 4
        reads.append(seg)
        acc += length
    return ReadSet.from_sequences(reads)


def random_genome(rng, n: int) -> str:
    """tests/conftest.py::random_genome: `n` uniform bases as a string."""
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def sample_reads(rng, genome: str, n_reads: int, mean_len: int, error: float = 0.0):
    """tests/conftest.py::sample_reads: reads of ~mean_len (normal, sd a
    quarter) from either strand of `genome`, with `error` substitutions;
    returns (code arrays, (start, end, reverse) placements)."""
    reads = []
    positions = []
    lookup = np.zeros(256, dtype=np.uint8)
    lookup[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    gcodes = lookup[np.frombuffer(genome.encode(), dtype=np.uint8)]
    for _ in range(n_reads):
        length = max(200, int(rng.normal(mean_len, mean_len // 4)))
        length = min(length, len(genome) - 1)
        start = int(rng.integers(0, len(genome) - length))
        codes = gcodes[start : start + length].copy()
        if error > 0:
            nerr = rng.binomial(length, error)
            idx = rng.integers(0, length, size=nerr)
            codes[idx] = (codes[idx] + rng.integers(1, 4, size=nerr)) % 4
        strand = bool(rng.integers(0, 2))
        if strand:
            codes = (codes[::-1] ^ 3).astype(np.uint8)
        reads.append(codes)
        positions.append((start, start + length, strand))
    return reads, positions


def simulate_reads(
    rng,
    genome: np.ndarray,
    coverage: float,
    mean_len: int,
    sub: float,
    ins: float,
    dele: float,
):
    """misc/reference_compare.py::simulate_reads: ONT-like reads with
    substitutions, insertions and deletions, from either strand."""
    G = genome.size
    n_reads = int(G * coverage / mean_len)
    reads = []
    for _ in range(n_reads):
        length = int(np.clip(rng.normal(mean_len, mean_len / 4), 500, G))
        start = int(rng.integers(0, G - length + 1))
        codes = genome[start : start + length]
        # deletions: keep mask
        keep = rng.random(codes.size) >= dele
        codes = codes[keep]
        # substitutions
        s = rng.random(codes.size) < sub
        codes = np.where(
            s, (codes + rng.integers(1, 4, size=codes.size)) % 4, codes
        ).astype(np.uint8)
        # insertions: random base after marked positions
        imask = rng.random(codes.size) < ins
        n_ins = int(imask.sum())
        if n_ins:
            out = np.empty(codes.size + n_ins, dtype=np.uint8)
            pos = np.nonzero(imask)[0]
            dst = pos + 1 + np.arange(n_ins)
            src_idx = np.ones(out.size, dtype=bool)
            src_idx[dst] = False
            out[src_idx] = codes
            out[dst] = rng.integers(0, 4, size=n_ins).astype(np.uint8)
            codes = out
        strand = int(rng.integers(0, 2))
        if strand:
            codes = (codes[::-1] ^ 3).astype(np.uint8)
        reads.append(codes)
    return reads


def overlap_digest(results) -> tuple[str, int]:
    """Order-independent digest of an emitted overlap set
    {read_id: structured overlaps}; returns (hex digest, overlap count)."""
    h = hashlib.sha256()
    n = 0
    for rid in sorted(results):
        arr = results[rid]
        n += arr.size
        arr = np.sort(
            arr, order=["rhs_id", "strand", "lhs_begin", "rhs_begin"]
        )
        h.update(np.int64(rid).tobytes())
        h.update(arr.tobytes())
    return h.hexdigest(), n


def make_windows(n_windows: int, window: int, coverage: int, rng, truths=None):
    """bench_polish.py::make_windows: windows of `window` random truth
    bases, each with a backbone and `coverage` fragments drawn from the
    truth with 6% deletions, 4% substitutions and 5% insertions, weights
    11.  Returns ([(backbone, fragments, weights)], total truth bases);
    each window's truth is appended to `truths` when it is a list."""
    windows = []
    total_bases = 0
    for _ in range(n_windows):
        truth = rng.integers(0, 4, window).astype(np.uint8)
        if truths is not None:
            truths.append(truth)

        def mutate():
            keep = rng.random(window) >= 0.06  # deletions
            seg = truth[keep]
            subs = rng.random(seg.size) < 0.04
            seg = np.where(
                subs, (seg + rng.integers(1, 4, seg.size)) % 4, seg
            ).astype(np.uint8)
            ins = rng.random(seg.size) < 0.05
            out = np.repeat(seg, 1 + ins.astype(np.int64))
            return out

        backbone = mutate()
        frags = [mutate() for _ in range(coverage)]
        wts = [np.full(f.size, 11, np.uint8) for f in frags]
        windows.append((backbone, frags, wts))
        total_bases += window
    return windows, total_bases


def _anchor_span(codes: np.ndarray, truth: np.ndarray, k: int = 48):
    """misc/reference_compare.py::_anchor_span: the contig's span in the
    truth from exact k-mer probes near its ends, repeat-aware.  Returns
    (consistent, [(t_start, t_end), ...])."""
    tb = truth.tobytes()
    n = codes.size

    def all_hits(o: int):
        pat = codes[o : o + k].tobytes()
        hits, p = [], tb.find(pat)
        while p >= 0 and len(hits) < 64:
            hits.append(p)
            p = tb.find(pat, p + 1)
        return hits

    def probe(region_start: int, count: int = 8, stride: int = 199):
        for i in range(count):
            o = region_start + i * stride
            if o < 0 or o + k > n:
                continue
            hits = all_hits(o)
            if hits:
                return o, hits
        return None

    head = probe(0)
    tail = probe(n - k - 8 * 199)
    if head is None or tail is None:
        return False, []
    best = None
    for ph in head[1]:
        for pt in tail[1]:
            t_start = ph - head[0]
            t_end = pt + (n - tail[0])
            span = t_end - t_start
            if span <= 0:
                continue
            dev = abs(span - n)
            if best is None or dev < best[0]:
                best = (dev, t_start, t_end)
    if best is not None and best[0] <= 0.3 * n:
        return True, [(max(0, best[1]), min(truth.size, best[2]))]
    spans = []
    for ph in head[1][:4]:
        s = max(0, ph - head[0])
        spans.append((s, min(truth.size, s + n)))
    for pt in tail[1][:4]:
        s = max(0, pt - tail[0])
        spans.append((s, min(truth.size, s + n)))
    return False, spans


def contig_ed(codes: np.ndarray, truth: np.ndarray) -> tuple[int, int]:
    """misc/reference_compare.py::contig_ed: (edit distance, aligned truth
    span) of a contig against the truth region it assembles, both
    orientations tried, with the port's edit_distance_banded."""
    from raven_tpu_torch.io.readset import reverse_complement
    from raven_tpu_torch.ops.edit_distance import edit_distance_banded

    anchored = []
    for cand in (codes, reverse_complement(codes)):
        consistent, spans = _anchor_span(cand, truth)
        if consistent:
            anchored = [(cand, sp) for sp in spans]
            break
        anchored.extend((cand, sp) for sp in spans)
    best = None
    for cand, (s, e) in anchored:
        ed = edit_distance_banded(cand, truth[s:e])
        if best is None or ed < best[0]:
            best = (int(ed), int(e - s))
    if best is not None:
        return best
    ed = min(
        edit_distance_banded(codes, truth),
        edit_distance_banded(reverse_complement(codes), truth),
    )
    return int(ed), int(truth.size)
