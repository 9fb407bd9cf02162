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

Across processes (a mesh with a process group, parallel/distributed.py)
every rank holds the whole readset and computes the same read assignment;
it sketches only its own devices' shards and sends every cut through the
group's all-to-all (its own rank's too).  Each rank then holds its own
devices' parts.  What the host reads is made the same on every rank, as
raven_tpu's `replicate=True` outputs are: the range counts and every
decline flag are all-reduced (a decline on any rank declines on every
rank, so none goes to the host path alone and leaves the others waiting
in a collective), the run lengths are all-gathered for the filter, and the
match columns are all-gathered in part order onto every rank's first
device and chained there, so every rank holds the single index's
overlaps in its order.

A capacity limit makes `build` or `distance_join` return None, as
raven_tpu's fallbacks do; here each says so on stderr in the
[raven_tpu_torch::ShardedIndex] scope, the engine counts it in
MinimizerIndex.host_declines and takes the path raven_tpu takes then.

`sharded_candidate_step` is raven_tpu's jitted candidate count over the
mesh: sketch_compact on each device, fixed slots a destination, the
all-to-all, and the run-length pair sum all-reduced.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from raven_tpu_torch.ops.sketch import UINT32_INF, segments_per_read, sketch_compact
from raven_tpu_torch.overlap.device_index import (
    MAX_ENTRIES,
    SEG_WIDTH,
    DeviceIndex,
    PartitionedIndex,
    _build_columns,
    _capacity,
    _finish_join,
    _POS_MASK,
    range_cuts,
    range_splits,
)
from raven_tpu_torch.parallel.distributed import all_gather_columns, all_reduce_sum, exchange
from raven_tpu_torch.parallel.mesh import split_rows

_INF = int(UINT32_INF)


def _note(why: str, what: str = "device path declined") -> None:
    print(f"[raven_tpu_torch::ShardedIndex] {what}: {why}", file=sys.stderr)


def _any_rank(mesh, flag: bool, *counts) -> tuple[bool, list[int]]:
    """`flag` or-ed and `counts` summed over the mesh's ranks (as they are
    without a process group)."""
    if mesh.group is None:
        return flag, [int(c) for c in counts]
    t = torch.tensor([int(flag), *counts], dtype=torch.int64, device=mesh.first)
    vals = all_reduce_sum(t, mesh.group).tolist()
    return vals[0] > 0, vals[1:]


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


def _received_by_copy(mesh, sketched, splits):
    """Single controller: each cut copied to its owner; {owner: [cuts]}."""
    received = {o: [] for o in range(mesh.size)}
    for key, rid, packed in sketched.values():
        cuts = range_cuts(key, splits)
        for o, (a, b) in enumerate(zip(cuts, cuts[1:])):
            owner = mesh.devices[o]
            received[o].append(tuple(
                c[a:b].to(owner, non_blocking=owner.type == "cuda")
                for c in (key, rid, packed)
            ))
    return received


def _received_by_exchange(mesh, sketched, splits):
    """Across processes: every rank's cuts for each rank's owners, one
    block a rank (its owners' hash ranges are contiguous), through the
    all-to-all; each received entry goes to the local owner of its hash
    range.  {local owner: [cuts]}."""
    dev = mesh.first
    ranks = range(mesh.n_ranks)
    blocks = [[] for _ in ranks]
    for key, rid, packed in sketched.values():
        cuts = range_cuts(key, splits)
        for r in ranks:
            own = mesh.rank_indices(r)
            a, b = cuts[own.start], cuts[own.stop]
            blocks[r].append(tuple(c[a:b].to(dev) for c in (key, rid, packed)))
    send = [
        torch.cat([blk[i] for r in ranks for blk in blocks[r]])
        if sketched else torch.zeros(0, dtype=torch.int32, device=dev)
        for i in range(3)
    ]
    sizes = [sum(blk[0].numel() for blk in blocks[r]) for r in ranks]
    (key, rid, packed), _ = exchange(send, sizes, mesh.group)
    local = mesh.local_indices
    if len(local) == 1:
        return {local[0]: [(key, rid, packed)]}
    bounds = torch.tensor(splits, dtype=key.dtype, device=dev)
    owner = torch.bucketize(key, bounds, right=True)
    received = {}
    for o in local:
        sel = torch.nonzero(owner == o).squeeze(1)
        received[o] = [tuple(c[sel].to(mesh.devices[o]) for c in (key, rid, packed))]
    return received


class ShardedIndex(PartitionedIndex):
    """DeviceIndex parts over disjoint hash ranges, part d on the mesh's
    device d; across processes, `parts` holds this rank's devices' parts
    and `n_entries` counts every rank's (see the module docstring).  Same
    contract as DeviceIndex: n_entries, has_flags, occurrence_for,
    distance_join, to_host; reads outside the build set are mapped on the
    host (its parts span devices and processes)."""

    joins_foreign = False

    def __init__(self, mesh, parts, k, w, has_flags, n_entries=None):
        super().__init__(parts, k, w, has_flags)
        self.mesh = mesh
        if n_entries is not None:
            self.n_entries = int(n_entries)

    @classmethod
    def build(cls, readset, ids, k, w, minhash, with_flags, mesh):
        """The index of `ids` over `mesh`, or None past a capacity limit
        (on every rank when any rank meets one)."""
        if 2 * k > 30:
            return None
        n = mesh.size
        ids = np.asarray(ids, dtype=np.int64)
        need_flags = bool(minhash or with_flags)
        splits = range_splits(n)
        shards = assign_reads(readset.lengths, ids, k, w, n)
        sketched = {}  # this process's shards: (key, rid, packed)
        counts = np.zeros(n, dtype=np.int64)
        why = None
        for d in mesh.local_indices:
            if shards[d].size == 0:
                continue
            cols = _build_columns(
                readset, shards[d], k, w, minhash, with_flags, mesh.devices[d], splits
            )
            if cols is None:
                why = (f"shard {d}: a sketch chunk or a hash range exceeds the "
                       "device index capacity")
                break
            sketched[d] = cols[:3]
            counts += cols[4]
        declined, counts = _any_rank(mesh, why is not None, *counts.tolist())
        if declined:
            _note(why or "a shard of another process exceeds the device index capacity")
            return None
        if max(counts) > MAX_ENTRIES:
            _note(f"a hash range holds {max(counts)} entries, above {MAX_ENTRIES}")
            return None
        if mesh.group is None:
            received = _received_by_copy(mesh, sketched, splits)
        else:
            received = _received_by_exchange(mesh, sketched, splits)
        # each read's rank in `ids`: the single index orders equal keys by
        # (rank, position), as it sketched them; so the order in which the
        # cuts arrive does not matter
        rank = np.zeros(int(ids.max(initial=-1)) + 1, dtype=np.int64)
        rank[ids] = np.arange(ids.size)
        parts = []
        for o in mesh.local_indices:
            dev = mesh.devices[o]
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
        _, (total,) = _any_rank(mesh, False, sum(p.n_entries for p in parts))
        return cls(mesh, parts, k, w, need_flags, total)

    def occurrence_for(self, frequency: float) -> int:
        """PartitionedIndex.occurrence_for over every rank's parts: the
        run lengths all-gathered, so every rank takes the same quantile."""
        if frequency <= 0 or self.n_entries == 0:
            return np.iinfo(np.int64).max
        dev = self.mesh.first
        for p in self.parts:
            p._ensure_counts()
        (run_len,), _ = all_gather_columns(
            (torch.cat([p._run_len.to(dev) for p in self.parts]),), self.mesh.group
        )
        target = min(int((1.0 - frequency) * run_len.numel()), run_len.numel() - 1)
        return int(torch.sort(run_len).values[target])

    def distance_join(self, occurrence: int, batch: np.ndarray, need_flags: bool,
                      filtered_out: dict | None = None, chain_k: int | None = None,
                      narrow: bool = False):
        """PartitionedIndex.distance_join, the parts joining on their own
        devices; None on a capacity decline (on every rank when any part
        of any rank meets one).  `narrow` is accepted for raven_tpu's
        signature and changes nothing.

        Each rank joins its own parts; the match columns and the
        too-frequent positions are all-gathered in part order, so every
        rank chains, and fills `filtered_out`, as the single index does."""
        dev = self.mesh.first
        cols, f_rid, f_pos = [], [], []
        ok = True
        for p in self.parts:
            fo = {} if filtered_out is not None else None
            c = p.join_columns(occurrence, batch, need_flags, fo)
            if c is None:
                ok = False
                break
            cols.append([t.to(dev) for t in c])
            # the part's too-frequent positions in the order it added them
            # to the dict (replaying them below rebuilds the same dict)
            for r, ps in (fo or {}).items():
                f_rid.extend([r] * len(ps))
                f_pos.extend(ps)
        declined, _ = _any_rank(self.mesh, not ok)
        if declined:
            _note(
                f"occurrence {occurrence} or a part's join exceeds the device "
                "join's capacity"
            )
            return None
        matches, _ = all_gather_columns(
            tuple(torch.cat(c) for c in zip(*cols)), self.mesh.group
        )
        if filtered_out is not None:
            (rid, pos), _ = all_gather_columns(
                (torch.tensor(f_rid, dtype=torch.int64, device=dev),
                 torch.tensor(f_pos, dtype=torch.int64, device=dev)), self.mesh.group,
            )
            for r, q in zip(rid.tolist(), pos.tolist()):
                filtered_out.setdefault(r, []).append(q)
        return _finish_join(matches, chain_k)

    def to_host(self):
        """The parts' host columns in hash order (every rank's, gathered
        onto each rank across processes)."""
        dev = self.mesh.first
        cols, _ = all_gather_columns(
            tuple(torch.cat([getattr(p, a).to(dev) for p in self.parts])
                  for a in ("_key", "_rid", "_packed")),
            self.mesh.group,
        )
        return DeviceIndex(*cols, self.has_flags, self.k, self.w).to_host()


def sharded_candidate_step(mesh, k: int, w: int, capacity: int, occurrence: int):
    """raven_tpu's sharded candidate step (raven_tpu/parallel/
    sharded_index.py:61): returns step(codes, lengths, read_ids), the
    global count of candidate pairs (pairs of equal minimizer keys in runs
    no longer than `occurrence`) as a Python int, on every rank, with the
    index sharded by hash range over every device of the mesh (every axis
    of a 2-D mesh, in row-major order).

    The input is this rank's rows across processes, or the whole batch on
    a single-process mesh; either way split_rows deals the rows over the
    rank's devices.  Each device takes sketch_compact's keys (K1 and a
    stable key sort, cut to `capacity`), cuts at the 2^(2k) * d // n range
    edges and
    packs a fixed slot of min(capacity, 2 * capacity // n) entries for
    each destination; the slots are exchanged (copies on one process, the
    all-to-all across processes), each owner sorts what it received, and
    its run-length pair sum is all-reduced.  raven_tpu drops the entries
    past a slot or past `capacity` silently; the count here is the same,
    and the drop is said on stderr."""
    n = mesh.size
    slot = min(capacity, (2 * capacity) // n)
    edges = [d * (2 ** (2 * k) // n) for d in range(1, n)]

    def slots(codes, lengths, read_ids, dev):
        """[n, slot] keys a destination, and the real entries dropped."""
        key, _, _, _, real = sketch_compact(
            codes.to(dev), lengths.to(dev), read_ids.to(dev), k, w, capacity
        )
        real = int(real)
        at = torch.searchsorted(key, torch.tensor(edges, dtype=torch.int64, device=dev))
        starts = torch.cat([at.new_zeros(1), at, at.new_full((1,), capacity)])
        s, e = starts[:-1], starts[1:]
        idx = s[:, None] + torch.arange(slot, device=dev)[None, :]
        ok = idx < torch.minimum(e, s + slot)[:, None]
        packed = torch.where(ok, key[idx.clamp(max=capacity - 1)], _INF)
        real_e = e.clamp(max=min(real, capacity))
        over = int((real_e - s - slot).clamp(min=0).sum())
        return packed, over + max(0, real - capacity)

    def step(codes, lengths, read_ids) -> int:
        codes, lengths, read_ids = (
            (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).to(t)
            for a, t in ((codes, torch.uint8), (lengths, torch.int32), (read_ids, torch.int32))
        )
        local = mesh.local_indices
        sent, dropped = [], 0
        for sl, d in zip(split_rows(codes.shape[0], len(local)), local):
            packed, over = slots(codes[sl], lengths[sl], read_ids[sl], mesh.devices[d])
            sent.append(packed)
            dropped += over
        if mesh.group is None:
            mine = {o: torch.cat([p[o].to(mesh.devices[o]) for p in sent]) for o in local}
        else:
            ranks = range(mesh.n_ranks)
            dev = mesh.first
            buf = torch.cat([
                torch.cat([p[mesh.rank_indices(r)].to(dev).reshape(-1) for p in sent])
                for r in ranks
            ])
            sizes = [len(sent) * len(mesh.rank_indices(r)) * slot for r in ranks]
            (recv,), _ = exchange((buf,), sizes, mesh.group)
            recv = recv.view(n, len(local), slot)  # [source, local owner, slot]
            mine = {o: recv[:, j].reshape(-1).to(mesh.devices[o]) for j, o in enumerate(local)}
        pairs = 0
        for o, key in mine.items():
            keys, run = torch.unique_consecutive(torch.sort(key).values, return_counts=True)
            run = run.to(torch.int64)
            ok = (keys != _INF) & (run <= occurrence)
            pairs += int((run * (run - 1) // 2)[ok].sum())
        _, (pairs, dropped) = _any_rank(mesh, False, pairs, dropped)
        if dropped:
            _note(f"{dropped} sketch entries past a destination's slot of {slot} "
                  f"or past the capacity of {capacity} are not counted",
                  "candidate step dropped entries")
        return pairs

    return step
