"""Hash-range-sharded minimizer index over a device mesh.

The port of raven_tpu/parallel/sharded_index.py's ShardedIndex: the
multi-device analog of the reference's single-address-space hash table (ram
MinimizerEngine).  Each device of the mesh sketches its own shard of the
reads (whole reads, so each read's minhash flags are computed on its
shard, before the exchange), cuts its key-sorted columns at the hash
bounds HASH_SPACE * d / n, and sends each cut to the device that owns that
hash range; each owner merges what it receives into one DeviceIndex part.
A run of equal keys never crosses a range, so the filter's run lengths and
the self-join split exactly: each part joins on its own device, and the
match columns meet on the mesh's first device to be chained once.

The parts equal PartitionedIndex's with n parts on one device, column for
column (each owner restores the single index's order of equal keys), so
the occurrence threshold, the overlaps and their order are the single
index's.  raven_tpu instead re-shards the matches by query read and chains
on each shard; the per-read overlaps are the same either way.

A capacity limit makes `build` or `distance_join` return None, as
raven_tpu's fallbacks do; here each says so on stderr in the
[raven_tpu_torch::ShardedIndex] scope, the engine counts it in
MinimizerIndex.host_declines and takes the path raven_tpu takes then.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raven_tpu_torch.ops.sketch import segments_per_read
from raven_tpu_torch.overlap.device_index import (
    MAX_ENTRIES,
    SEG_WIDTH,
    DeviceIndex,
    PartitionedIndex,
    _build_columns,
    _capacity,
    _POS_MASK,
    range_cuts,
    range_splits,
)


def _note_decline(why: str) -> None:
    print(f"[raven_tpu_torch::ShardedIndex] device path declined: {why}", file=sys.stderr)


def assign_reads(lengths, ids: np.ndarray, k: int, w: int, n: int) -> list[np.ndarray]:
    """Whole reads to shards, in `ids` order, each to the shard with the
    fewest segment rows so far (raven_tpu's cumulative segment count; the
    first such shard on a tie).  Reads too short to sketch go nowhere."""
    segs = segments_per_read(np.asarray(lengths)[ids], k, w, SEG_WIDTH)
    loads = [0] * n
    owner = np.full(ids.size, -1, dtype=np.int64)
    for i, s in enumerate(segs.tolist()):
        if s:
            d = loads.index(min(loads))
            owner[i] = d
            loads[d] += s
    return [ids[owner == d] for d in range(n)]


class ShardedIndex(PartitionedIndex):
    """DeviceIndex parts over disjoint hash ranges, part d on the mesh's
    device d (see the module docstring).  Same contract as DeviceIndex:
    n_entries, has_flags, occurrence_for, distance_join, to_host."""

    def __init__(self, mesh, parts, k, w, has_flags):
        super().__init__(parts, k, w, has_flags)
        self.mesh = mesh

    @classmethod
    def build(cls, readset, ids, k, w, minhash, with_flags, mesh):
        """The index of `ids` over `mesh`, or None past a capacity limit."""
        if 2 * k > 30:
            return None
        n = mesh.size
        ids = np.asarray(ids, dtype=np.int64)
        need_flags = bool(minhash or with_flags)
        splits = range_splits(n)
        received = [[] for _ in range(n)]  # the cuts each owner receives
        counts = np.zeros(n, dtype=np.int64)
        for d, shard_ids in enumerate(assign_reads(readset.lengths, ids, k, w, n)):
            if shard_ids.size == 0:
                continue
            cols = _build_columns(
                readset, shard_ids, k, w, minhash, with_flags, mesh.devices[d], splits
            )
            if cols is None:
                _note_decline(
                    f"shard {d}: a sketch chunk or a hash range exceeds the "
                    "device index capacity"
                )
                return None
            key, rid, packed, _, shard_counts = cols
            counts += shard_counts
            cuts = range_cuts(key, splits)
            for o, (a, b) in enumerate(zip(cuts, cuts[1:])):
                owner = mesh.devices[o]
                received[o].append(tuple(
                    c[a:b].to(owner, non_blocking=owner.type == "cuda")
                    for c in (key, rid, packed)
                ))
        if counts.max() > MAX_ENTRIES:
            _note_decline(f"a hash range holds {counts.max()} entries, above {MAX_ENTRIES}")
            return None
        # each read's rank in `ids`: the single index orders equal keys by
        # (rank, position), as it sketched them
        rank = np.zeros(int(ids.max(initial=-1)) + 1, dtype=np.int64)
        rank[ids] = np.arange(ids.size)
        parts = []
        for o, dev in enumerate(mesh.devices):
            if received[o]:
                key, rid, packed = (torch.cat(c) for c in zip(*received[o]))
            else:
                key = rid = packed = torch.zeros(0, dtype=torch.int32, device=dev)
            tie = (torch.from_numpy(rank).to(dev)[rid.to(torch.int64)] << 29) | (
                packed & _POS_MASK
            ).to(torch.int64)
            order = torch.argsort(tie, stable=True)
            order = order[torch.argsort(key[order], stable=True)]
            parts.append(DeviceIndex(
                key[order], rid[order], packed[order], need_flags, k, w,
                _capacity(counts[o]),
            ))
        return cls(mesh, parts, k, w, need_flags)

    def distance_join(self, occurrence: int, batch: np.ndarray, need_flags: bool,
                      filtered_out: dict | None = None, chain_k: int | None = None,
                      narrow: bool = False):
        """PartitionedIndex.distance_join, the parts joining on their own
        devices; None on a capacity decline.  `narrow` is accepted for
        raven_tpu's signature and changes nothing."""
        res = super().distance_join(occurrence, batch, need_flags, filtered_out, chain_k)
        if res is None:
            _note_decline(
                f"occurrence {occurrence} or a part's join exceeds the device "
                "join's capacity"
            )
        return res
