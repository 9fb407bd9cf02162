"""Self-join overlap candidate generation over a sorted minimizer index.

The construct phase's mapping is always a *self-join*: the queried reads are
exactly the reads the index was built from (reference construct.cc:57-77 maps
reads [0, index_end) against the index of the same batch).  That structure
makes the generic per-query lookup (binary search per minimizer — the
reference ram engine's hash-table probe) unnecessary: after the index sort,
every candidate pair lies *within a run of equal hashes*, so the whole join
is, for each distance d in [1, occurrence], one shifted equality compare of
the sorted hash array against itself — pure elementwise sweeps with perfect
locality, no searches and no gathers.  The formulation is chosen because it
is also directly expressible on an accelerator (shifted compares vectorize;
no dynamic gathers); this module is the host implementation and the shared
reconstruction/chaining code.

Minhash ("micromizer", -M) query semantics (reference construct.cc:62 maps
with minhash=true even when the index is unfiltered): instead of
re-sketching every query read with minhash selection, each index entry
carries a precomputed flag saying whether it belongs to its read's minhash
subset (the floor(len/k) smallest hashes, ties broken by position —
minimizer.py:102-109); a pair is emitted iff the flag of its query side
(the smaller read id, since avoid_symmetric keeps t_id > q_id) is set.
"""

from __future__ import annotations

import numpy as np

from raven_tpu_torch.overlap import chain as chain_mod
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE

# distance-join is used when the occurrence threshold is at most this; a
# larger threshold (e.g. freq=0 disabling filtering) falls back to the
# generic lookup join
MAX_OCCURRENCE = 128


def minhash_flags(
    h: np.ndarray, ids: np.ndarray, lengths: np.ndarray, k: int
) -> np.ndarray:
    """Per-entry minhash-subset membership flags.

    h/ids are read-grouped (each read's sketch contiguous, position order —
    the layout minimize_reads returns).  Reproduces minimizer.py:102-109
    exactly: keep the floor(read_len / k) smallest hashes of the read's
    sketch, ties broken by position (stable argsort).
    """
    n = h.size
    flags = np.ones(n, dtype=bool)
    if n == 0:
        return flags
    # read boundaries in the grouped layout
    starts = np.nonzero(np.concatenate([[True], ids[1:] != ids[:-1]]))[0]
    bounds = np.append(starts, n)
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        budget = int(lengths[int(ids[s0])]) // k
        m = s1 - s0
        if m <= budget:
            continue
        if budget <= 0:
            flags[s0:s1] = False
            continue
        hr = h[s0:s1]
        # threshold = budget-th smallest; among equals, earliest positions win
        part = np.partition(hr, budget - 1)
        thr = part[budget - 1]
        less = hr < thr
        n_less = int(less.sum())
        fl = less
        need = budget - n_less
        if need > 0:
            eq_idx = np.nonzero(hr == thr)[0][:need]
            fl = less.copy()
            fl[eq_idx] = True
        flags[s0:s1] = fl
    return flags


def distance_join(
    hashes: np.ndarray,
    ids: np.ndarray,
    pos: np.ndarray,
    strand: np.ndarray,
    qflag: np.ndarray | None,
    occurrence: int,
    batch: np.ndarray,
    filtered_out: dict | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Emit candidate matches from a hash-sorted entry table.

    Arrays are the sorted index columns.  A pair of entries (i, j = i - d)
    within one hash run is emitted as (q = smaller id, t = larger id) iff
    the run length is <= occurrence, the ids differ, q's id is in the map
    batch (`batch` is a bool table indexed by read id), and qflag[q]
    (minhash membership) holds.

    Returns (q_id, q_pos, t_id, t_pos, same_strand) int64/uint8 arrays.
    filtered_out, if given, collects {read_id: [pos, ...]} for query-side
    entries of too-frequent runs (reference construct.cc:377-383 semantics).
    """
    n = hashes.size
    empty = (
        np.empty(0, np.int64),
        np.empty(0, np.int64),
        np.empty(0, np.int64),
        np.empty(0, np.int64),
        np.empty(0, np.uint8),
    )
    if n == 0:
        return empty

    # run lengths per entry
    newrun = np.concatenate([[True], hashes[1:] != hashes[:-1]])
    run_id = np.cumsum(newrun) - 1
    run_sizes = np.bincount(run_id)
    count = run_sizes[run_id]
    countok = count <= occurrence

    if filtered_out is not None:
        too = ~countok
        if qflag is not None:
            too &= qflag
        too &= batch[ids]
        for rid, p in zip(ids[too].tolist(), pos[too].tolist()):
            filtered_out.setdefault(int(rid), []).append(int(p))

    max_d = int(count.max(initial=0))
    max_d = min(max_d - 1, occurrence - 1)
    outs = []
    for d in range(1, max_d + 1):
        eq = hashes[d:] == hashes[:-d]
        m = eq & countok[d:]
        ii = np.nonzero(m)[0] + d
        if ii.size == 0:
            continue
        jj = ii - d
        id_i = ids[ii].astype(np.int64)
        id_j = ids[jj].astype(np.int64)
        neq = id_i != id_j
        ii, jj, id_i, id_j = ii[neq], jj[neq], id_i[neq], id_j[neq]
        i_is_q = id_i < id_j
        q_idx = np.where(i_is_q, ii, jj)
        t_idx = np.where(i_is_q, jj, ii)
        q_id = np.where(i_is_q, id_i, id_j)
        keep = batch[q_id]
        if qflag is not None:
            keep &= qflag[q_idx]
        if not keep.any():
            continue
        q_idx, t_idx, q_id = q_idx[keep], t_idx[keep], q_id[keep]
        outs.append(
            (
                q_id,
                pos[q_idx].astype(np.int64),
                ids[t_idx].astype(np.int64),
                pos[t_idx].astype(np.int64),
                (strand[q_idx] == strand[t_idx]).astype(np.uint8),
            )
        )
    if not outs:
        return empty
    return tuple(np.concatenate([o[c] for o in outs]) for c in range(5))


def chain_per_read(
    q_id: np.ndarray,
    q_pos: np.ndarray,
    t_id: np.ndarray,
    t_pos: np.ndarray,
    same: np.ndarray,
    k: int,
    out: dict[int, np.ndarray],
    anchors_out: dict | None = None,
) -> None:
    """Group matches by query read and chain each group into overlaps,
    filling `out[read_id]` (chain output is independent of match order —
    chain_matches canonicalizes internally)."""
    if q_id.size == 0:
        return
    order = np.argsort(q_id, kind="stable")
    q_id = q_id[order]
    t_id, t_pos, same, q_pos = (
        t_id[order],
        t_pos[order],
        same[order],
        q_pos[order],
    )
    uniq, starts = np.unique(q_id, return_index=True)
    bounds = np.append(starts, q_id.size)

    import os

    from raven_tpu_torch.config import worker_count

    workers = worker_count()
    if os.environ.get("RAVEN_TPU_NO_BATCH_CHAIN") != "1":
        # one native call, C++ threads over reads (no per-read Python
        # slicing under the GIL)
        done = chain_mod.chain_batch(
            uniq,
            bounds,
            t_id.astype(np.uint32),
            same,
            q_pos,
            t_pos,
            k,
            out,
            anchors_out=anchors_out,
            workers=workers,
        )
        if done:
            return

    groups = list(zip(uniq, bounds[:-1], bounds[1:]))

    def run_group(item):
        u, s0, s1 = item
        per_read_anchors = [] if anchors_out is not None else None
        res = chain_mod.chain_matches(
            int(u),
            t_id[s0:s1].astype(np.uint32),
            same[s0:s1],
            q_pos[s0:s1],
            t_pos[s0:s1],
            k,
            anchors_out=per_read_anchors,
        )
        return int(u), res, per_read_anchors

    if (
        len(groups) >= 256
        and workers > 1
        and os.environ.get("RAVEN_TPU_NO_MP") != "1"
    ):
        # the native chain core is a ctypes call (GIL released), so plain
        # threads scale it — and they are safe after CUDA initialization,
        # where the fork pools used elsewhere are not
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as ex:
            results = list(ex.map(run_group, groups, chunksize=64))
    else:
        results = [run_group(g) for g in groups]
    for u, res, per_read_anchors in results:
        out[u] = res
        if anchors_out is not None:
            anchors_out[u] = per_read_anchors
