"""Per-stage parity dumps (SURVEY §7 hard-part-1 mitigation).

When RAVEN_TPU_STAGE_DUMP is set to a directory, every pipeline stage
appends one JSON line to <dir>/stages.jsonl capturing compact, comparable
statistics of its outputs (counts, sums, and order-insensitive content
hashes).  Two runs of the pipeline can then be compared stage by stage with
misc/compare_stage_dumps.py, so a quality regression localizes to the first
stage whose dump diverges instead of showing up only as an edit-distance
delta on the final contig.

The dumps are cheap (hashes, not payloads) and default-off.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def enabled() -> bool:
    return bool(os.environ.get("RAVEN_TPU_STAGE_DUMP"))


def _hash_array(a: np.ndarray) -> str:
    """Order-insensitive content hash: sort the byte rows first."""
    a = np.ascontiguousarray(a)
    if a.size == 0:
        return "empty"
    flat = a.view(np.uint8).reshape(a.shape[0] if a.ndim else 1, -1)
    order = np.lexsort(flat.T[::-1])
    return hashlib.sha1(flat[order].tobytes()).hexdigest()[:16]


def dump(stage: str, **stats) -> None:
    """Append one record; values may be ints/floats/strs or numpy arrays
    (arrays are replaced by (shape, content-hash))."""
    dir_ = os.environ.get("RAVEN_TPU_STAGE_DUMP")
    if not dir_:
        return
    os.makedirs(dir_, exist_ok=True)
    rec: dict = {"stage": stage}
    for k, v in stats.items():
        if isinstance(v, np.ndarray):
            rec[k] = {"shape": list(v.shape), "hash": _hash_array(v)}
        elif isinstance(v, (np.integer,)):
            rec[k] = int(v)
        elif isinstance(v, (np.floating,)):
            rec[k] = float(v)
        else:
            rec[k] = v
    with open(os.path.join(dir_, "stages.jsonl"), "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")


def overlap_stats(overlaps) -> dict:
    """Comparable summary of an overlap array or per-read list of arrays."""
    if isinstance(overlaps, list):
        arrs = [o for o in overlaps if o is not None and o.size]
        total = int(sum(o.size for o in arrs))
        if not arrs:
            return {"n_overlaps": 0, "overlap_hash": "empty"}
        cat = np.concatenate(arrs)
    else:
        cat = overlaps
        total = int(cat.size)
    if cat.size == 0:
        return {"n_overlaps": 0, "overlap_hash": "empty"}
    key = np.stack(
        [
            cat["lhs_id"].astype(np.int64),
            cat["lhs_begin"].astype(np.int64),
            cat["lhs_end"].astype(np.int64),
            cat["rhs_id"].astype(np.int64),
            cat["rhs_begin"].astype(np.int64),
            cat["rhs_end"].astype(np.int64),
            cat["strand"].astype(np.int64),
        ],
        axis=1,
    )
    return {"n_overlaps": total, "overlap_hash": _hash_array(key)}


def pile_stats(piles) -> dict:
    n = piles.n
    return {
        "n_piles": int(n),
        "n_invalid": int(np.sum(piles.is_invalid[:n])),
        "n_contained": int(np.sum(piles.is_contained[:n])),
        "begin_hash": _hash_array(piles.begin[:n].astype(np.int64)),
        "end_hash": _hash_array(piles.end[:n].astype(np.int64)),
        "median_sum": int(np.sum(piles.median[:n])),
    }


def graph_stats(graph) -> dict:
    nodes = [n for n in graph.nodes if n is not None]
    edges = [e for e in graph.edges if e is not None]
    node_key = np.array(
        sorted((n.id, len(n.codes)) for n in nodes), dtype=np.int64
    ).reshape(-1, 2)
    edge_key = np.array(
        sorted((e.id, e.tail.id, e.head.id, e.length) for e in edges),
        dtype=np.int64,
    ).reshape(-1, 4)
    return {
        "n_nodes": len(nodes),
        "n_edges": len(edges),
        "node_hash": _hash_array(node_key),
        "edge_hash": _hash_array(edge_key),
    }
