"""Single-device overlap-candidate metrics (METRIC/DRYRUN ONLY).

The torch port of raven_tpu/ops/overlap_step.py, under its names without
the `_kernel` suffix and in its argument order.

The PRODUCTION device overlap path is raven_tpu_torch.overlap.device_index
(exact self-join with overflow-checked capacities, digest-identical to
the host path).  The functions here serve the dry run
(raven_tpu_torch.dryrun) and quick throughput metrics:

  * overlap_candidates — sketch + sorted-index join emitting capped
    candidate matches (hits beyond `max_hits` per minimizer are DROPPED,
    no overflow signal);
  * candidate_count / join_count_filtered / join_count — candidate-pair
    COUNTS; candidate_count is knowingly approximate when one read
    repeats a hash within a bucket.

None of these may back a correctness path — anything feeding the
assembler must go through device_index / sharded_index, whose capacity
overflows are detected and fall back to the host join.

They are torch ops on the inputs' device (a CUDA tensor runs on the card,
a CPU tensor on the CPU); the sketch in overlap_candidates and
candidate_count is kernel K1, through ops/sketch.py::sketch_compact.  Keys
are int64 with UINT32_INF the largest (raven_tpu's are uint32).  Counts
are summed in int64 where raven_tpu sums in int32 and wraps past 2^31:
the two agree below 2^31 pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from raven_tpu_torch.ops.sketch import UINT32_INF, sketch_compact

_INF = int(UINT32_INF)


def _buckets(key_s, occurrence):
    """Each sorted entry's bucket [lo, hi) of equal keys, and whether it
    is a query: a kept minimizer in a bucket of at most `occurrence`."""
    lo = torch.searchsorted(key_s, key_s, right=False)
    hi = torch.searchsorted(key_s, key_s, right=True)
    return lo, hi, (key_s != _INF) & (hi - lo <= occurrence)


def overlap_candidates(codes, lengths, read_ids, k: int, w: int, capacity: int,
                       max_hits: int, occurrence: int):
    """All-vs-all candidate matches for one read batch (raven_tpu's
    overlap_candidates_kernel, :45): codes [B, L] uint8, lengths and
    read_ids [B] int32, on one device.

    Every sorted index entry is a query; it takes up to `max_hits` index
    slots from the start of its bucket.  Returns (q_id, q_pos, t_id, t_pos,
    same_strand int32, valid bool), each [min(capacity, B * L) * max_hits],
    plus the count of valid slots (t_id > q_id) as a 0-d int64 tensor."""
    # raven_tpu's key_s[:capacity] holds only B * L entries past the cells
    cap = min(capacity, codes.numel())
    key_s, ids_s, pos_s, sb_s = sketch_compact(codes, lengths, read_ids, k, w, cap)[:4]
    n = key_s.numel()
    lo, hi, q_valid = _buckets(key_s, occurrence)
    slot = lo[:, None] + torch.arange(max_hits, device=key_s.device)[None, :]
    in_range = slot < hi[:, None]
    slot = slot.clamp_(0, n - 1)  # raven_tpu's gather clamps out-of-range slots
    t_id, t_pos, t_sb = ids_s[slot], pos_s[slot], sb_s[slot]
    q_id = ids_s[:, None].expand_as(slot)
    q_pos = pos_s[:, None].expand_as(slot)
    # avoid_equal + avoid_symmetric (reference construct.cc:62)
    valid = in_range & q_valid[:, None] & (t_id > q_id)
    same = (t_sb == sb_s[:, None]).to(torch.int32)
    return (
        q_id.reshape(-1), q_pos.reshape(-1), t_id.reshape(-1), t_pos.reshape(-1),
        same.reshape(-1), valid.reshape(-1), valid.sum(),
    )


def candidate_count(codes, lengths, read_ids, k: int, w: int, capacity: int,
                    occurrence: int):
    """Pairs/s metric core (raven_tpu's candidate_count_kernel, :114): the
    sum over query entries of (bucket size - 1), halved — c (c - 1) / 2 a
    bucket when its ids are unique, an overcount when one read repeats a
    hash within a bucket, as in raven_tpu.  A 0-d int64 tensor."""
    key_s = sketch_compact(codes, lengths, read_ids, k, w, min(capacity, codes.numel()))[0]
    lo, hi, q_valid = _buckets(key_s, occurrence)
    return torch.where(q_valid, hi - lo - 1, 0).sum() // 2


def join_count_filtered(keys, blacklist, max_occurrence: int):
    """Candidate-pair count with frequent minimizers pre-filtered
    (raven_tpu's join_count_filtered_kernel, :143): keys [N] int64,
    blacklist the sorted hashes whose bucket exceeds the occurrence
    threshold, int64 on the same device.  After the sort, blacklisted keys
    and the sentinel become UINT32_INF, and the count is
    sum_{d=1..max_occurrence} #{i : key[i] == key[i-d], key[i] alive} —
    not c (c - 1) / 2 a run where a surviving run is longer than
    max_occurrence.  An empty blacklist raises TypeError, as raven_tpu's
    gather into it does when traced.  A 0-d int64 tensor."""
    if blacklist.numel() == 0:
        raise TypeError("join_count_filtered needs a non-empty blacklist "
                        "(raven_tpu's gather into an empty one is out of range)")
    key_s = torch.sort(keys).values
    at = torch.searchsorted(blacklist, key_s).clamp_(max=blacklist.numel() - 1)
    dead = (blacklist[at] == key_s) | (key_s == _INF)
    key_s = torch.where(dead, _INF, key_s)
    total = torch.zeros((), dtype=torch.int64, device=keys.device)
    for d in range(1, min(max_occurrence, key_s.numel() - 1) + 1):
        total += ((key_s[d:] == key_s[:-d]) & ~dead[d:]).sum()
    return total


def join_count(keys, ids, occurrence):
    """Sort keys [N] int64 and count candidate pairs (raven_tpu's
    join_count_kernel, :178): the sum of each entry's rank in its run of
    equal keys, c (c - 1) / 2 a run, over runs of kept keys no longer than
    `occurrence`.  `ids` is unused (pair counting needs keys only).  A 0-d
    int64 tensor."""
    del ids
    runs, c = torch.unique_consecutive(torch.sort(keys).values, return_counts=True)
    return torch.where((runs != _INF) & (c <= occurrence), c * (c - 1) // 2, 0).sum()


def estimate_occurrence(counts: np.ndarray, freq: float) -> int:
    if counts.size == 0 or freq <= 0:
        return np.iinfo(np.int64).max
    srt = np.sort(counts)
    idx = min(int((1.0 - freq) * srt.size), srt.size - 1)
    return int(srt[idx])
