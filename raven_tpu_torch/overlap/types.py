"""Overlap record type (struct-of-arrays biosoup::Overlap equivalent).

Reference overlap fields: biosoup::Overlap{lhs_id, lhs_begin, lhs_end, rhs_id,
rhs_begin, rhs_end, score, strand} (use sites PythonLib/src/ravenpy.cc:96-122).
`rhs_begin/rhs_end` are forward-strand coordinates on the rhs read; `strand`
is True when the reads overlap on the same strand.

Overlaps are held as numpy structured arrays so per-read stage transforms
(clipping, typing, filtering) are vectorized instead of per-object.
"""

from __future__ import annotations

import numpy as np

OVERLAP_DTYPE = np.dtype(
    [
        ("lhs_id", np.uint32),
        ("lhs_begin", np.uint32),
        ("lhs_end", np.uint32),
        ("rhs_id", np.uint32),
        ("rhs_begin", np.uint32),
        ("rhs_end", np.uint32),
        ("score", np.uint32),
        ("strand", np.uint8),
    ]
)


def empty_overlaps(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=OVERLAP_DTYPE)


def make_overlaps(
    lhs_id, lhs_begin, lhs_end, rhs_id, rhs_begin, rhs_end, score, strand
) -> np.ndarray:
    n = len(np.atleast_1d(lhs_id))
    out = np.zeros(n, dtype=OVERLAP_DTYPE)
    out["lhs_id"] = lhs_id
    out["lhs_begin"] = lhs_begin
    out["lhs_end"] = lhs_end
    out["rhs_id"] = rhs_id
    out["rhs_begin"] = rhs_begin
    out["rhs_end"] = rhs_end
    out["score"] = score
    out["strand"] = strand
    return out


def overlap_reverse(o: np.ndarray) -> np.ndarray:
    """Swap lhs and rhs (reference overlap_utils.cc:5-8), vectorized."""
    out = np.zeros(o.shape, dtype=OVERLAP_DTYPE)
    out["lhs_id"] = o["rhs_id"]
    out["lhs_begin"] = o["rhs_begin"]
    out["lhs_end"] = o["rhs_end"]
    out["rhs_id"] = o["lhs_id"]
    out["rhs_begin"] = o["lhs_begin"]
    out["rhs_end"] = o["lhs_end"]
    out["score"] = o["score"]
    out["strand"] = o["strand"]
    return out


def overlap_length(o: np.ndarray) -> np.ndarray:
    """max of lhs/rhs spans (reference overlap_utils.cc:10-12), vectorized."""
    lhs = o["lhs_end"].astype(np.int64) - o["lhs_begin"]
    rhs = o["rhs_end"].astype(np.int64) - o["rhs_begin"]
    return np.maximum(lhs, rhs)
