"""Vectorized overlap algebra against trimmed piles.

Re-designs the per-object reference functions (RavenLib/src/overlap_utils.cc)
as whole-array transforms over structured overlap arrays: clipping to valid
regions (OverlapUpdate, :14-80), dovetail classification (GetOverlapType,
:82-113), finalization into graph coordinates (OverlapFinalize, :115-133),
and connected components (:135-178, via union-find instead of BFS).
"""

from __future__ import annotations

import numpy as np

from raven_tpu_torch.pile.pile import K_PSS

MIN_CLIPPED_LEN = 84  # reference overlap_utils.cc:69-70
OVERHANG_RATIO = 0.875  # reference overlap_utils.cc:99-100


def _pile_bounds(piles, ids):
    """(begin, end) in base coordinates for pile ids."""
    b = piles.begin[ids] << K_PSS
    e = piles.end[ids] << K_PSS
    return b.astype(np.int64), e.astype(np.int64)


def overlap_update(o: np.ndarray, piles) -> tuple[np.ndarray, np.ndarray]:
    """Clip overlaps to both piles' valid regions.

    Returns (updated_overlaps, keep_mask); `updated_overlaps` has the same
    length as `o` with clipped coordinates where keep_mask is True.
    Semantics match reference overlap_utils.cc:14-80 exactly.
    """
    if o.size == 0:
        return o.copy(), np.zeros(0, dtype=bool)
    lhs_id = o["lhs_id"].astype(np.int64)
    rhs_id = o["rhs_id"].astype(np.int64)
    lb = o["lhs_begin"].astype(np.int64)
    le = o["lhs_end"].astype(np.int64)
    rb = o["rhs_begin"].astype(np.int64)
    re = o["rhs_end"].astype(np.int64)
    strand = o["strand"].astype(bool)

    pl_b, pl_e = _pile_bounds(piles, lhs_id)
    pr_b, pr_e = _pile_bounds(piles, rhs_id)

    keep = ~(piles.is_invalid[lhs_id] | piles.is_invalid[rhs_id])
    keep &= ~((lb >= pl_e) | (le <= pl_b) | (rb >= pr_e) | (re <= pr_b))

    rhs_under = np.maximum(pr_b - rb, 0)  # rhs_begin < pile begin deficit
    rhs_over = np.maximum(re - pr_e, 0)  # rhs_end past pile end excess
    lhs_under = np.maximum(pl_b - lb, 0)
    lhs_over = np.maximum(le - pl_e, 0)

    nlb = lb + np.where(strand, rhs_under, rhs_over)
    nle = le - np.where(strand, rhs_over, rhs_under)
    nrb = rb + np.where(strand, lhs_under, lhs_over)
    nre = re - np.where(strand, lhs_over, lhs_under)

    keep &= ~((nlb >= pl_e) | (nle <= pl_b) | (nrb >= pr_e) | (nre <= pr_b))

    nlb = np.maximum(nlb, pl_b)
    nle = np.minimum(nle, pl_e)
    nrb = np.maximum(nrb, pr_b)
    nre = np.minimum(nre, pr_e)

    keep &= ~(
        (nlb >= nle)
        | (nle - nlb < MIN_CLIPPED_LEN)
        | (nrb >= nre)
        | (nre - nrb < MIN_CLIPPED_LEN)
    )

    out = o.copy()
    out["lhs_begin"] = np.where(keep, nlb, lb)
    out["lhs_end"] = np.where(keep, nle, le)
    out["rhs_begin"] = np.where(keep, nrb, rb)
    out["rhs_end"] = np.where(keep, nre, re)
    return out, keep


def get_overlap_type(o: np.ndarray, piles) -> np.ndarray:
    """Classify overlaps (reference overlap_utils.cc:82-113), vectorized.

    0 internal / 1 lhs-contained / 2 rhs-contained / 3 lhs->rhs / 4 rhs->lhs.
    """
    if o.size == 0:
        return np.zeros(0, dtype=np.uint32)
    lhs_id = o["lhs_id"].astype(np.int64)
    rhs_id = o["rhs_id"].astype(np.int64)
    pl_b, pl_e = _pile_bounds(piles, lhs_id)
    pr_b, pr_e = _pile_bounds(piles, rhs_id)

    lhs_length = pl_e - pl_b
    lhs_begin = o["lhs_begin"].astype(np.int64) - pl_b
    lhs_end = o["lhs_end"].astype(np.int64) - pl_b

    rhs_length = pr_e - pr_b
    strand = o["strand"].astype(bool)
    rb_rel = o["rhs_begin"].astype(np.int64) - pr_b
    re_rel = o["rhs_end"].astype(np.int64) - pr_b
    rhs_begin = np.where(strand, rb_rel, rhs_length - re_rel)
    rhs_end = np.where(strand, re_rel, rhs_length - rb_rel)

    overhang = np.minimum(lhs_begin, rhs_begin) + np.minimum(
        lhs_length - lhs_end, rhs_length - rhs_end
    )

    t = np.full(o.size, 0, dtype=np.uint32)
    lhs_span = lhs_end - lhs_begin
    rhs_span = rhs_end - rhs_begin
    internal = (lhs_span < (lhs_span + overhang) * OVERHANG_RATIO) | (
        rhs_span < (rhs_span + overhang) * OVERHANG_RATIO
    )
    lhs_contained = (lhs_begin <= rhs_begin) & (
        lhs_length - lhs_end <= rhs_length - rhs_end
    )
    rhs_contained = (rhs_begin <= lhs_begin) & (
        rhs_length - rhs_end <= lhs_length - lhs_end
    )
    t = np.where(lhs_begin > rhs_begin, 3, 4).astype(np.uint32)
    t = np.where(rhs_contained, 2, t)
    t = np.where(lhs_contained, 1, t)
    t = np.where(internal, 0, t)
    return t


def overlap_finalize(o: np.ndarray, piles) -> tuple[np.ndarray, np.ndarray]:
    """Shift coordinates into trimmed-sequence space and orient rhs
    (reference overlap_utils.cc:115-133).  Returns (finalized, keep_mask);
    score is overwritten with the overlap type, keep = type >= 3."""
    if o.size == 0:
        return o.copy(), np.zeros(0, dtype=bool)
    t = get_overlap_type(o, piles)
    keep = t >= 3
    lhs_id = o["lhs_id"].astype(np.int64)
    rhs_id = o["rhs_id"].astype(np.int64)
    pl_b, _ = _pile_bounds(piles, lhs_id)
    pr_b, pr_e = _pile_bounds(piles, rhs_id)
    rhs_len = pr_e - pr_b

    out = o.copy()
    out["score"] = t
    out["lhs_begin"] = o["lhs_begin"].astype(np.int64) - pl_b
    out["lhs_end"] = o["lhs_end"].astype(np.int64) - pl_b
    rb = o["rhs_begin"].astype(np.int64) - pr_b
    re = o["rhs_end"].astype(np.int64) - pr_b
    strand = o["strand"].astype(bool)
    out["rhs_begin"] = np.where(strand, rb, rhs_len - re)
    out["rhs_end"] = np.where(strand, re, rhs_len - rb)
    return out, keep


def connected_components(o: np.ndarray, n_reads: int, piles) -> list[list[int]]:
    """Components over dovetail overlaps (reference overlap_utils.cc:135-178).

    Union-find replaces the BFS; membership is identical, ordering is by
    smallest read id (component medians are order-invariant).
    """
    parent = np.arange(n_reads, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    if o.size:
        t = get_overlap_type(o, piles)
        for lhs, rhs in zip(
            o["lhs_id"][t > 2].tolist(), o["rhs_id"][t > 2].tolist()
        ):
            ra, rb = find(int(lhs)), find(int(rhs))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    groups: dict[int, list[int]] = {}
    for i in range(n_reads):
        if piles.is_invalid[i]:
            continue
        groups.setdefault(find(i), []).append(i)
    return [groups[k] for k in sorted(groups)]
