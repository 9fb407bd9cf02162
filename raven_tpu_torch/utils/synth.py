"""Synthetic read sets and the overlap-set digest used to check runs.

Copies of the repository's generators, so the port's checks need nothing
of raven_tpu: `synth_reads` is bench.py's overlap-stage workload (E. coli
scale, substitutions only), `simulate_reads` is misc/reference_compare.py's
ONT-like simulator (substitutions and indels) behind the synthetic golden
test, and `overlap_digest` is bench.py's order-independent digest of an
emitted overlap set.
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
