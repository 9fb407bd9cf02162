"""Overlap phase: all-vs-all mapping, pile analysis, graph construction.

Phase driver with the reference's seven sub-stages and stage gating
(RavenLib/src/construct.cc), restructured around batched mapping and
vectorized overlap/pile transforms.  The reference's thread-pool fan-out
(construct.cc:57-113) becomes whole-batch array work; the byte-budget
batching of the minimizer index (4 GiB index / 1 GiB map batches,
construct.cc:35,67) is kept so genomes larger than memory stream through.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from raven_tpu_torch.config import OverlapPhaseCfg
from raven_tpu_torch.graph import overlap_utils as ou
from raven_tpu_torch.graph.graph import Graph
from raven_tpu_torch.overlap.device_index import MAX_TOTAL_ENTRIES
from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE, overlap_length, overlap_reverse
from raven_tpu_torch.pile.pile import Piles
from raven_tpu_torch.utils import stagedump

# the index batch's budget in bases: None keeps the reference's 2^32
# (construct.cc:35), clamped on a card as _index_batch_bytes says; an int is
# the caller's own budget, which wins over the clamp (raven_tpu's
# RAVEN_TPU_INDEX_BATCH_BASES).  NOTE: batch size changes which overlaps
# survive the 32-longest capping on exact length ties.
INDEX_BATCH_BYTES = None
REFERENCE_BATCH_BYTES = 1 << 32


def _index_batch_bytes(device, device_map: bool = True) -> int:
    """Effective index-batch budget for an index on `device`: the caller's
    INDEX_BATCH_BYTES when set; else the reference's 2^32 on the CPU and
    for the host index (device_map False, MinimizerIndex.DEVICE_MAP), as
    raven_tpu keeps it on a CPU backend and under RAVEN_TPU_DEVICE_MAP=0;
    else, on a card, raven_tpu's clamp to the partitioned index's ceiling
    (MAX_TOTAL_ENTRIES entries at ~3 bases each, with ~10% headroom), so
    that batch boundaries, and with them the overlaps that survive the
    32-longest cap on length ties, are raven_tpu's, and every batch stays
    on the card."""
    if INDEX_BATCH_BYTES is not None:
        return INDEX_BATCH_BYTES
    if device.type == "cpu" or not device_map:
        return REFERENCE_BATCH_BYTES
    cap = int(MAX_TOTAL_ENTRIES * 3 * 0.9)
    return min(REFERENCE_BATCH_BYTES, cap)


MAP_BATCH_BYTES = 1 << 30  # construct.cc:67
SECOND_PASS_BATCH_BYTES = 1 << 30  # construct.cc:356
VALID_REGION_COVERAGE = 4  # construct.cc:134

# Unanchored-repeat-read removal (DIVERGENCE from the reference, see
# resolve_repeat_induced_overlaps): a read lying (almost) entirely
# inside a multi-copy repeat has no coverage slope (uniform pile), so
# FindRepetitiveRegions annotates nothing, and its annotations could
# never be confirmed anyway (confirmation needs an overlap crossing
# the region FROM unique sequence, pile.cc:319-342) — so
# CheckRepetitiveRegions can never block its copy-bridging overlaps.
# What DOES mark such a read is the stage -4 repeat-k-mer trail
# (pile.cc:64-120 AddKmers): too-frequent minimizers land as pile bin
# marks, and a read with a unique anchor always keeps a ~2 kb window
# that is (near-)mark-free, while a fully-repeat read has marks spread
# across its whole valid region.  Measured on the planted-repeat
# dataset (misc/repeat_diag.py): the min 128-bin-window mark count is
# 0 at p99 over valid reads, >= 4 for every misjoin-participating
# repeat-contained read, and every false graph edge has at least one
# endpoint above the threshold.  Dropping them breaks contigs at
# repeat boundaries instead of joining across copies:
# fragmented-but-correct.  RAVEN_TPU_KEEP_UNANCHORED=1 restores the
# reference behavior.
UNANCHORED_WINDOW_BINS = 128  # 2048 bases at kPSS = 4
UNANCHORED_MAX_MARKS = 2  # stray marks tolerated inside the window
DROP_UNANCHORED = os.environ.get("RAVEN_TPU_KEEP_UNANCHORED") != "1"


def _unanchored_reads(piles) -> list[int]:
    """Reads whose every UNANCHORED_WINDOW_BINS-bin window of the valid
    region carries more than UNANCHORED_MAX_MARKS repeat-k-mer marks —
    i.e. no mark-free unique anchor anywhere (see DROP_UNANCHORED)."""
    out: list[int] = []
    win = UNANCHORED_WINDOW_BINS
    for i, km in piles.kmers.items():
        if piles.is_invalid[i]:
            continue
        lo, hi = int(piles.begin[i]), int(piles.end[i])
        if hi <= lo:
            continue
        m = km[lo:hi].astype(np.int32)
        if m.size <= win:
            mn = int(m.sum())
        else:
            c = np.cumsum(np.concatenate([[0], m]))
            mn = int((c[win:] - c[:-win]).min())
        if mn > UNANCHORED_MAX_MARKS:
            out.append(int(i))
    return out


def _log(msg: str, t0: float) -> None:
    print(
        f"[raven_tpu::Graph::Construct] {msg} {time.perf_counter() - t0:.6f}s",
        file=sys.stderr,
    )


def _concat(parts: list[np.ndarray]) -> np.ndarray:
    parts = [p for p in parts if p.size]
    if not parts:
        return np.zeros(0, dtype=OVERLAP_DTYPE)
    return np.concatenate(parts)


def find_overlaps_and_create_piles(
    index: MinimizerIndex,
    readset,
    cfg: OverlapPhaseCfg,
    piles: Piles,
    overlaps: list[np.ndarray],
) -> None:
    """Stage -5 part 1 (reference construct.cc:14-121): batched all-vs-all
    mapping, per-read layer accumulation, capping stored overlaps to the
    `max_num_overlaps` longest."""
    n = len(readset)
    lengths = readset.lengths

    batch_start = 0
    bytes_acc = 0
    batch_bytes = _index_batch_bytes(index.device, index.DEVICE_MAP)
    for i in range(n):
        bytes_acc += int(lengths[i])
        if i != n - 1 and bytes_acc < batch_bytes:
            continue
        bytes_acc = 0

        t0 = time.perf_counter()
        index.minimize(
            readset,
            np.arange(batch_start, i + 1),
            minhash=cfg.use_minhash,
            with_query_flags=not cfg.use_minhash,  # stage -5 maps minhash=True
        )
        index.filter(cfg.freq)
        _log(f"minimized {batch_start} - {i + 1} / {n}", t0)

        t0 = time.perf_counter()
        map_bytes = 0
        batch_ids: list[int] = []
        num_overlaps = [int(overlaps[k].size) for k in range(n)]
        for k in range(i + 1):
            batch_ids.append(k)
            map_bytes += int(lengths[k])
            if k != i and map_bytes < MAP_BATCH_BYTES:
                continue
            map_bytes = 0

            results = index.map_many(
                readset,
                np.array(batch_ids, dtype=np.int64),
                avoid_equal=True,
                avoid_symmetric=True,
                minhash=True,
            )
            new = _concat([results[b] for b in batch_ids])
            batch_ids = []
            touched: list[int] = []
            if new.size:
                # distribute to both endpoint lists
                rev = overlap_reverse(new)
                order_lhs = np.argsort(new["lhs_id"], kind="stable")
                order_rhs = np.argsort(rev["lhs_id"], kind="stable")
                for arr, order in ((new, order_lhs), (rev, order_rhs)):
                    srt = arr[order]
                    ids, starts = np.unique(srt["lhs_id"], return_index=True)
                    touched.extend(ids.tolist())
                    for rid, chunk in zip(
                        ids.tolist(), np.split(srt, starts[1:])
                    ):
                        overlaps[rid] = _concat([overlaps[rid], chunk])
                # accumulate coverage for the newly added overlaps
                both = _concat([new, rev])
                piles.add_layers(
                    both["lhs_id"].astype(np.int64),
                    both["lhs_begin"].astype(np.int64),
                    both["lhs_end"].astype(np.int64),
                )

            # cap stored overlaps (construct.cc:92-108); only reads that
            # received overlaps this sub-batch can have grown, so the
            # O(n)-per-sub-batch full sweep reduces to the touched set
            for rid in sorted(set(touched)):
                sz = int(overlaps[rid].size)
                if sz == 0 or sz == num_overlaps[rid]:
                    continue
                num_overlaps[rid] = min(sz, cfg.max_num_overlaps)
                if sz < cfg.max_num_overlaps:
                    continue
                lens = overlap_length(overlaps[rid])
                order = np.argsort(-lens, kind="stable")[: cfg.max_num_overlaps]
                overlaps[rid] = overlaps[rid][order]
        _log("mapped sequences", t0)
        batch_start = i + 1


def trim_and_annotate_piles(piles: Piles, overlaps: list[np.ndarray]) -> None:
    """Stage -5 part 2 (reference construct.cc:123-152)."""
    t0 = time.perf_counter()
    for i in range(piles.n):
        piles.find_valid_region(i, VALID_REGION_COVERAGE)
        if piles.is_invalid[i]:
            overlaps[i] = np.zeros(0, dtype=OVERLAP_DTYPE)
        else:
            piles.find_median(i)
            piles.find_chimeric_regions(i)
    _log("annotated piles", t0)


def resolve_contained_reads(
    piles: Piles,
    overlaps: list[np.ndarray],
    readset,
    identity: float = 0.0,
) -> None:
    """Stage -5 part 3 (reference construct.cc:154-248)."""
    t0 = time.perf_counter()
    if identity != 0:
        from raven_tpu_torch.ops.edit_distance import overlap_identity

        for i in range(piles.n):
            if overlaps[i].size == 0:
                continue
            upd, keep = ou.overlap_update(overlaps[i], piles)
            upd = upd[keep]
            scores = overlap_identity(upd, readset)
            overlaps[i] = upd[scores >= identity]
        _log("filtered overlaps", t0)
        t0 = time.perf_counter()

    for i in range(piles.n):
        if overlaps[i].size == 0:
            continue
        upd, keep = ou.overlap_update(overlaps[i], piles)
        upd = upd[keep]
        if upd.size == 0:
            overlaps[i] = upd
            continue
        t = ou.get_overlap_type(upd, piles)
        rhs_ids = upd["rhs_id"].astype(np.int64)
        lhs_contained = (t == 1) & ~np.array(
            [piles.is_maybe_chimeric(int(r)) for r in rhs_ids]
        )
        rhs_contained = (t == 2) & ~np.full(upd.size, piles.is_maybe_chimeric(i))
        if lhs_contained.any():
            piles.is_contained[i] = True
        for r in rhs_ids[rhs_contained]:
            piles.is_contained[int(r)] = True
        overlaps[i] = upd[~lhs_contained & ~rhs_contained]

    for i in range(piles.n):
        if piles.is_contained[i]:
            piles.is_invalid[i] = True
            overlaps[i] = np.zeros(0, dtype=OVERLAP_DTYPE)
    _log("removed contained sequences", t0)


def resolve_chimeric_sequences(piles: Piles, overlaps: list[np.ndarray]) -> None:
    """Stage -5 part 4 (reference construct.cc:250-314)."""
    t0 = time.perf_counter()
    medians = piles.median[piles.median != 0]
    if medians.size == 0:
        _log("removed chimeric sequences", t0)
        return
    k = medians.size // 2
    median = int(np.partition(medians, k)[k])

    for i in range(piles.n):
        if piles.is_invalid[i]:
            continue
        piles.clear_chimeric_regions(i, median)
        if piles.is_invalid[i]:
            overlaps[i] = np.zeros(0, dtype=OVERLAP_DTYPE)

    for i in range(piles.n):
        if overlaps[i].size == 0:
            continue
        upd, keep = ou.overlap_update(overlaps[i], piles)
        overlaps[i] = upd[keep]

    for i in range(piles.n):
        if overlaps[i].size == 0:
            continue
        t = ou.get_overlap_type(overlaps[i], piles)
        for o, ty in zip(overlaps[i], t):
            if ty == 1:
                piles.is_contained[int(o["lhs_id"])] = True
                piles.is_invalid[int(o["lhs_id"])] = True
            elif ty == 2:
                piles.is_contained[int(o["rhs_id"])] = True
                piles.is_invalid[int(o["rhs_id"])] = True

    for i in range(piles.n):
        overlaps[i] = np.zeros(0, dtype=OVERLAP_DTYPE)
    _log("removed chimeric sequences", t0)


def find_overlaps_and_repetitive_regions(
    index: MinimizerIndex,
    readset,
    cfg: OverlapPhaseCfg,
    piles: Piles,
) -> np.ndarray:
    """Stage -4 part 1 (reference construct.cc:316-491): second mapping pass
    over valid reads only, capturing too-frequent k-mers into piles.
    Returns the surviving dovetail overlap array (the reference's
    overlaps.back())."""
    order = sorted(
        range(len(readset)), key=lambda i: (bool(piles.is_invalid[i]), i)
    )
    s = next(
        (idx for idx, i in enumerate(order) if piles.is_invalid[i]), len(order)
    )

    kept: list[np.ndarray] = []

    def merge(ovl: np.ndarray) -> None:
        """OverlapUpdate + typing + adjacent same-pair dedup keeping the
        longer (construct.cc:430-455), vectorized: runs of equal
        (lhs, rhs) pairs collapse to the first entry attaining the run's
        maximum length (the scalar scan replaces only on strictly-longer,
        which selects exactly that element)."""
        upd, keep = ou.overlap_update(ovl, piles)
        upd = upd[keep]
        if upd.size == 0:
            return
        t = ou.get_overlap_type(upd, piles)
        piles.is_contained[upd["lhs_id"][t == 1].astype(np.int64)] = True
        piles.is_contained[upd["rhs_id"][t == 2].astype(np.int64)] = True
        dovetail = upd[t >= 3]
        n = dovetail.size
        if n == 0:
            return
        # merge() is called once per query read (all lhs_id equal), so a
        # duplicate run never spans two calls; dedup within the batch
        same_prev = (
            (dovetail["lhs_id"][1:] == dovetail["lhs_id"][:-1])
            & (dovetail["rhs_id"][1:] == dovetail["rhs_id"][:-1])
        )
        run_id = np.concatenate([[0], np.cumsum(~same_prev)])
        lens = overlap_length(dovetail)
        order = np.lexsort((np.arange(n), -lens, run_id))
        first = np.concatenate(
            [[True], run_id[order][1:] != run_id[order][:-1]]
        )
        kept.append(dovetail[np.sort(order[first])])

    bytes_acc = 0
    batch_start = 0
    for idx in range(s):
        bytes_acc += int(readset.lengths[order[idx]])
        if idx != s - 1 and bytes_acc < SECOND_PASS_BATCH_BYTES:
            continue
        bytes_acc = 0

        t0 = time.perf_counter()
        ids = np.array(order[batch_start : idx + 1], dtype=np.int64)
        index.minimize(readset, ids, minhash=False)
        _log(f"minimized {batch_start} - {idx + 1} / {s}", t0)

        t0 = time.perf_counter()
        index.filter(cfg.freq)
        all_rids = [order[k] for k in range(idx + 1)]
        filtered_map: dict[int, list] = {}
        results: dict[int, np.ndarray] = {}
        sub: list[int] = []
        sub_bytes = 0
        for pos, rid in enumerate(all_rids):  # 1 GiB map sub-batches
            sub.append(rid)
            sub_bytes += int(readset.lengths[rid])
            if pos != len(all_rids) - 1 and sub_bytes < MAP_BATCH_BYTES:
                continue
            results.update(
                index.map_many(
                    readset,
                    np.array(sub, dtype=np.int64),
                    avoid_equal=True,
                    avoid_symmetric=True,
                    minhash=False,
                    filtered_out=filtered_map,
                )
            )
            sub = []
            sub_bytes = 0
        for rid in all_rids:
            piles.add_kmers(
                rid, filtered_map.get(rid, []), cfg.kmer_len,
                readset.sequence(rid),
            )
            ovl = results[rid]
            if cfg.identity != 0 and ovl.size:
                from raven_tpu_torch.ops.edit_distance import overlap_identity

                upd, keep = ou.overlap_update(ovl, piles)
                upd = upd[keep]
                scores = overlap_identity(upd, readset)
                ovl = upd[scores >= cfg.identity]
            if ovl.size:
                merge(ovl)
        _log("mapped valid sequences", t0)
        batch_start = idx + 1

    t0 = time.perf_counter()
    for i in range(piles.n):
        if piles.is_contained[i]:
            piles.is_invalid[i] = True

    result = (
        np.concatenate(kept)
        if kept
        else np.zeros(0, dtype=OVERLAP_DTYPE)
    )
    if result.size:
        upd, keep = ou.overlap_update(result, piles)
        result = upd[keep]
    _log("updated overlaps", t0)
    return result


def resolve_repeat_induced_overlaps(
    piles: Piles, overlaps: np.ndarray, readset
) -> np.ndarray:
    """Stage -4 part 2 (reference construct.cc:493-559): fixed-point loop
    dropping overlaps blocked by confirmed repeat regions.

    DIVERGENCE (gated by DROP_UNANCHORED, on by default): reads whose
    whole valid region is blanketed by repeat-k-mer marks (no ~2 kb
    mark-free window, see _unanchored_reads) are invalidated up front —
    the reference keeps them, and because whole-read repeat regions are
    unconfirmable its check cannot stop them bridging distinct repeat
    copies (misjoins measured in misc/repeat_diag.py)."""
    t0 = time.perf_counter()
    n_unanchored = 0
    if DROP_UNANCHORED and overlaps.size:
        unanchored = _unanchored_reads(piles)
        if unanchored:
            n_unanchored = len(unanchored)
            drop = np.zeros(piles.n, dtype=bool)
            drop[np.array(unanchored, dtype=np.int64)] = True
            piles.is_invalid[np.array(unanchored, dtype=np.int64)] = True
            overlaps = overlaps[
                ~(
                    drop[overlaps["lhs_id"].astype(np.int64)]
                    | drop[overlaps["rhs_id"].astype(np.int64)]
                )
            ]
    while True:
        components = ou.connected_components(overlaps, len(readset), piles)
        for comp in components:
            meds = piles.median[np.array(comp, dtype=np.int64)]
            k = meds.size // 2
            median = int(np.partition(meds, k)[k])
            for i in comp:
                piles.find_repetitive_regions(i, median)

        # both sides of every overlap in one vectorized pass (the scalar
        # per-overlap loop is the O(overlaps x regions) hot spot at scale;
        # batch semantics oracle-tested in tests/test_pile.py)
        side_ids = np.concatenate(
            [overlaps["lhs_id"], overlaps["rhs_id"]]
        ).astype(np.int64)
        side_begins = np.concatenate(
            [overlaps["lhs_begin"], overlaps["rhs_begin"]]
        ).astype(np.int64)
        side_ends = np.concatenate(
            [overlaps["lhs_end"], overlaps["rhs_end"]]
        ).astype(np.int64)
        piles.update_repetitive_regions_batch(side_ids, side_begins, side_ends)

        blocked = piles.check_repetitive_regions_batch(
            side_ids, side_begins, side_ends
        )
        keep = ~(blocked[: overlaps.size] | blocked[overlaps.size :])
        changed = bool((~keep).any())
        overlaps = overlaps[keep]

        if not changed:
            break
        for comp in components:
            for i in comp:
                piles.clear_repetitive_regions(i)
    if n_unanchored:
        _log(f"removed {n_unanchored} unanchored repeat reads", t0)
    _log("removed false overlaps", t0)
    return overlaps


def construct_assembly_graph(
    graph: Graph, piles: Piles, overlaps: np.ndarray, readset
) -> None:
    """Stage -4 part 3 (reference construct.cc:561-648): node + RC pair per
    valid pile, edge + RC pair per dovetail overlap."""
    t0 = time.perf_counter()
    sequence_to_node = np.full(piles.n, -1, dtype=np.int64)

    for i in range(piles.n):
        if piles.is_invalid[i]:
            continue
        begin = piles.begin_bases(i)
        end = piles.end_bases(i)
        codes = readset.sequence(i, begin, end - begin)
        sequence_to_node[i] = graph.next_node_index()
        graph.new_node_pair(
            readset.names[i], codes, seq_id=i, coverage=int(piles.median[i])
        )
    _log(f"stored {sum(n is not None for n in graph.nodes)} nodes", t0)

    t0 = time.perf_counter()
    fin, keep = ou.overlap_finalize(overlaps, piles)
    fin = fin[keep]
    n_edges = 0
    for o in fin:
        lhs, rhs = int(o["lhs_id"]), int(o["rhs_id"])
        tail = graph.nodes[sequence_to_node[lhs]]
        head = graph.nodes[sequence_to_node[rhs] + 1 - int(o["strand"])]
        length = int(o["lhs_begin"]) - int(o["rhs_begin"])
        length_pair = (piles.length_bases(rhs) - int(o["rhs_end"])) - (
            piles.length_bases(lhs) - int(o["lhs_end"])
        )
        if o["score"] == 4:
            tail, head = head, tail
            length = -length
            length_pair = -length_pair
        graph.new_edge_pair(tail, head, length, length_pair)
        n_edges += 2
    _log(f"stored {n_edges} edges", t0)


def construct_graph(
    graph: Graph,
    readset,
    cfg: OverlapPhaseCfg | None = None,
    checkpoints: bool = False,
    device=None,
) -> None:
    """Full overlap phase with stage gating (reference construct.cc:650-707).
    The minimizer index runs on `device` (default CUDA, see
    raven_tpu_torch.device)."""
    cfg = cfg or OverlapPhaseCfg()
    if len(readset) == 0 or graph.stage > -4:
        return

    total_t0 = time.perf_counter()
    index = MinimizerIndex(cfg.kmer_len, cfg.window_len, device=device)

    if graph.stage == -5:
        piles = Piles(readset.lengths)
        graph.piles = piles
        overlaps: list[np.ndarray] = [
            np.zeros(0, dtype=OVERLAP_DTYPE) for _ in range(len(readset))
        ]
        find_overlaps_and_create_piles(index, readset, cfg, piles, overlaps)
        if stagedump.enabled():
            stagedump.dump(
                "construct/find_overlaps_and_create_piles",
                **stagedump.pile_stats(piles),
                **stagedump.overlap_stats(overlaps),
            )
        trim_and_annotate_piles(piles, overlaps)
        if stagedump.enabled():
            stagedump.dump(
                "construct/trim_and_annotate_piles",
                **stagedump.pile_stats(piles),
                **stagedump.overlap_stats(overlaps),
            )
        resolve_contained_reads(piles, overlaps, readset, cfg.identity)
        if stagedump.enabled():
            stagedump.dump(
                "construct/resolve_contained_reads",
                **stagedump.pile_stats(piles),
                **stagedump.overlap_stats(overlaps),
            )
        resolve_chimeric_sequences(piles, overlaps)
        if stagedump.enabled():
            stagedump.dump(
                "construct/resolve_chimeric_sequences",
                **stagedump.pile_stats(piles),
            )
        graph.stage += 1
        if checkpoints:
            from raven_tpu_torch.graph.binary import store_graph

            t0 = time.perf_counter()
            store_graph(graph)
            _log("reached checkpoint", t0)

    if graph.stage == -4:
        piles = graph.piles
        all_overlaps = find_overlaps_and_repetitive_regions(
            index, readset, cfg, piles
        )
        if stagedump.enabled():
            stagedump.dump(
                "construct/find_overlaps_and_repetitive_regions",
                **stagedump.pile_stats(piles),
                **stagedump.overlap_stats(all_overlaps),
            )
        all_overlaps = resolve_repeat_induced_overlaps(
            piles, all_overlaps, readset
        )
        if stagedump.enabled():
            stagedump.dump(
                "construct/resolve_repeat_induced_overlaps",
                **stagedump.overlap_stats(all_overlaps),
            )
        construct_assembly_graph(graph, piles, all_overlaps, readset)
        if stagedump.enabled():
            stagedump.dump(
                "construct/construct_assembly_graph",
                **stagedump.graph_stats(graph),
            )
        graph.stage += 1
        if checkpoints:
            from raven_tpu_torch.graph.binary import store_graph

            t0 = time.perf_counter()
            store_graph(graph)
            _log("reached checkpoint", t0)

    _log("", total_t0)
