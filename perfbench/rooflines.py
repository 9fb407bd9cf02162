"""The H100's published peaks and the least time each kernel's work needs.

Frozen from chip_smoke.py's bounds, with two changes: the work is counted
from the data (the bases the reads hold, the band cells the fragments and
the consensus lengths need, the rows a walk votes on), never from padded
rows, t_pad or the kernels' own layouts; and K3 counts its operations on
the H100's 16-bit pair instructions, 4 a band cell, as K2 and K9 do.  Each
bound is the larger of the bytes over the HBM bandwidth and the integer
instructions over the issue rate; a share of the roofline is that bound
over the kernel's device time.
"""

from __future__ import annotations

import numpy as np

# H100 SXM: HBM3 3.35 TB/s (NVIDIA data sheet); integer instructions: 4
# schedulers x 32 lanes issued per SM per clock x 132 SMs x 1.98 GHz boost
# (Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
INT_INSTR_PER_S = 4 * 32 * 132 * 1.98e9
# K1 per position: 5 for the rolling forward and reverse k-mer codes, 3 for
# the canonical pick, strand and ambiguity, 2 for the window sentinel, 14
# for the hash mix (a multiply-add one IMAD), 2 (w - 1) for the two window
# passes, 2 for the keep flag
K1_BASE_INSTR = 5 + 3 + 2 + 14 + 2
# K3 per band cell on 16-bit pair instructions, which hold two cells: per
# pair the substitution score's compare and select (2), the diag add (1),
# the up add and max with its predicate (2), the left add and max with its
# predicate (2), one pack of the predicates into move bits (1)
K3_INSTR_PER_CELL = 4
# K4 per row it votes on: the move's shift and mask (2), the left test (1),
# the vote's packing (2), the next lane (1)
K4_INSTR_PER_ROW = 6


def _bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_INSTR_PER_S
    return {"seconds": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def sketch_bound(bases: int, reads: int, entries: int, w: int) -> dict:
    """K1 over reads holding `bases` bases: the codes read once at 2 bits a
    base, each read's length and offset (8 bytes), the sketch written once
    (hash, position 4 bytes each and the strand, a byte, per entry); the
    instructions per position."""
    nbytes = bases / 4 + 8 * reads + 9 * entries
    return _bound(nbytes, bases * (K1_BASE_INSTR + 2 * (w - 1)))


def band_cells(t_lens, q_lens, r0, bw: int) -> int:
    """The band cells a fragment's alignment needs: the (row, lane) pairs
    of consensus rows r < t_len whose fragment column j = r + lane - bw/2 -
    r0 lies in [0, q_len]."""
    t = np.asarray(t_lens, np.int64)
    q = np.asarray(q_lens, np.int64)
    x0 = -(bw // 2 + np.asarray(r0, np.int64))
    x1 = t - 1 + x0
    d = np.arange(bw, dtype=np.int64)[None, :]
    total = 0
    step = max(1, (1 << 24) // bw)
    for lo in range(0, t.size, step):
        sl = slice(lo, lo + step)
        n = (np.minimum(x1[sl, None], q[sl, None] - d)
             - np.maximum(x0[sl, None], -d) + 1)
        total += int(np.clip(n, 0, None).sum())
    return total


def band_forward_bound(t_lens, q_lens, r0, bw: int) -> dict:
    """K3 over fragments whose windows' consensus lengths are t_lens: the
    consensus (a byte a base) and the fragment (a byte a base) read once,
    each needed cell's 2-bit move and each row's end score (4 bytes)
    written once; K3_INSTR_PER_CELL instructions a needed cell."""
    t = np.asarray(t_lens, np.int64)
    cells = band_cells(t, q_lens, r0, bw)
    nbytes = int(t.sum()) * 5 + int(np.asarray(q_lens, np.int64).sum()) + cells / 4
    return _bound(nbytes, cells * K3_INSTR_PER_CELL)


def band_walk_bound(t_lens, q_lens, voted) -> dict:
    """K4 over fragments: each row's end score read once (the best row
    needs them all), the fragment read once, a 4-byte move word read and a
    vote and an insertion (4 bytes each) written for each row it votes on;
    K4_INSTR_PER_ROW instructions a voted row."""
    v = int(np.asarray(voted, np.int64).sum())
    nbytes = 4 * int(np.asarray(t_lens, np.int64).sum()) + int(np.asarray(q_lens).sum()) + 12 * v
    return _bound(nbytes, v * K4_INSTR_PER_ROW)
