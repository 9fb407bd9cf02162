"""Whole-graph checkpoint store/load.

Equivalent of the reference's cereal binary archive to ./raven.cereal
(RavenLib/src/binary.cc:73-96): stage + piles + nodes + edges + edge
connection table, written after every stage transition, reloaded by
`--resume`.

Format here: a single zip archive holding an `arrays.npz` member (plain
numpy arrays, loaded with ``allow_pickle=False``) and a `MANIFEST.json`
member (scalars, names, region lists) with a magic + version check on
load.  Like the reference's cereal archive this is inert data — loading an
untrusted checkpoint can not execute code (the round-2 pickle format
could).  Node/edge pair pointers and adjacency lists are rebuilt on load
exactly like the reference (binary.cc:44-65), and id factories are reset
(binary.cc:67-68).
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from raven_tpu_torch.graph.graph import Edge, Graph, Node
from raven_tpu_torch.pile.pile import Piles

CHECKPOINT_PATH = "raven_tpu.ckpt"
_MAGIC = "raven_tpu-checkpoint"
_VERSION = 2


def _concat_u8(chunks: list[np.ndarray]):
    """Pack a list of 1-D arrays into (flat, offsets) for the npz."""
    offsets = np.zeros(len(chunks) + 1, dtype=np.int64)
    for i, c in enumerate(chunks):
        offsets[i + 1] = offsets[i] + c.size
    flat = (
        np.concatenate(chunks)
        if chunks
        else np.zeros(0, dtype=np.uint8)
    )
    return flat, offsets


def _piles_state(piles: Piles | None, arrays: dict, manifest: dict) -> None:
    if piles is None:
        manifest["piles"] = None
        return
    arrays["pile_nbins"] = piles.nbins
    arrays["pile_bin_starts"] = piles.bin_starts
    arrays["pile_data"] = piles.data
    arrays["pile_begin"] = piles.begin
    arrays["pile_end"] = piles.end
    arrays["pile_median"] = piles.median
    arrays["pile_is_invalid"] = piles.is_invalid
    arrays["pile_is_contained"] = piles.is_contained
    arrays["pile_is_chimeric"] = piles.is_chimeric
    arrays["pile_is_repetitive"] = piles.is_repetitive
    kmer_ids = sorted(piles.kmers)
    kflat, koff = _concat_u8(
        [piles.kmers[i].astype(np.uint8) for i in kmer_ids]
    )
    arrays["pile_kmer_flat"] = kflat
    arrays["pile_kmer_offsets"] = koff
    manifest["piles"] = {
        "kmer_ids": kmer_ids,
        "chimeric_regions": [
            [[int(b), int(e)] for b, e in regions]
            for regions in piles.chimeric_regions
        ],
        "repetitive_regions": [
            [[int(b), int(e)] for b, e in regions]
            for regions in piles.repetitive_regions
        ],
    }


def _piles_restore(manifest, arrays) -> Piles | None:
    state = manifest["piles"]
    if state is None:
        return None
    piles = Piles.__new__(Piles)
    piles.nbins = arrays["pile_nbins"]
    piles.n = piles.nbins.size
    piles.bin_starts = arrays["pile_bin_starts"]
    piles.total_bins = int(piles.nbins.sum())
    piles.data = arrays["pile_data"]
    piles.begin = arrays["pile_begin"]
    piles.end = arrays["pile_end"]
    piles.median = arrays["pile_median"]
    piles.is_invalid = arrays["pile_is_invalid"]
    piles.is_contained = arrays["pile_is_contained"]
    piles.is_chimeric = arrays["pile_is_chimeric"]
    piles.is_repetitive = arrays["pile_is_repetitive"]
    kflat = arrays["pile_kmer_flat"]
    koff = arrays["pile_kmer_offsets"]
    piles.kmers = {
        int(i): kflat[koff[j] : koff[j + 1]].astype(bool)
        for j, i in enumerate(state["kmer_ids"])
    }
    piles.chimeric_regions = [
        [(int(b), int(e)) for b, e in regions]
        for regions in state["chimeric_regions"]
    ]
    piles.repetitive_regions = [
        [(int(b), int(e)) for b, e in regions]
        for regions in state["repetitive_regions"]
    ]
    return piles


def store_graph(graph: Graph, path: str = CHECKPOINT_PATH) -> None:
    arrays: dict[str, np.ndarray] = {}
    manifest: dict = {
        "magic": _MAGIC,
        "version": _VERSION,
        "stage": graph.stage,
        "node_next": graph._node_next,
        "edge_next": graph._edge_next,
    }
    _piles_state(graph.piles, arrays, manifest)

    nodes_state = []
    code_chunks: list[np.ndarray] = []
    for n in graph.nodes:
        if n is None:
            nodes_state.append(None)
            continue
        nodes_state.append(
            {
                "id": n.id,
                "name": n.name,
                "seq_id": n.seq_id,
                "count": n.count,
                "is_unitig": bool(n.is_unitig),
                "is_circular": bool(n.is_circular),
                "is_polished": bool(n.is_polished),
                "transitive": sorted(n.transitive),
                "color": n.color,
                "coverage": n.coverage,
                "original_names": sorted(n.original_names),
            }
        )
        code_chunks.append(np.asarray(n.codes, dtype=np.uint8))
    flat, offsets = _concat_u8(code_chunks)
    arrays["node_codes"] = flat
    arrays["node_code_offsets"] = offsets

    edges_state = []
    for e in graph.edges:
        if e is None:
            edges_state.append(None)
            continue
        edges_state.append(
            [e.id, e.length, e.weight, e.tail.id, e.head.id]
        )
    manifest["nodes"] = nodes_state
    manifest["edges"] = edges_state

    npz_buf = io.BytesIO()
    np.savez(npz_buf, **arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("MANIFEST.json", json.dumps(manifest))
        zf.writestr("arrays.npz", npz_buf.getvalue())


def load_graph(path: str = CHECKPOINT_PATH) -> Graph:
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("MANIFEST.json"))
        if manifest.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a raven_tpu checkpoint")
        if manifest.get("version") != _VERSION:
            raise ValueError(
                f"{path}: checkpoint version {manifest.get('version')} "
                f"unsupported (expected {_VERSION})"
            )
        arrays = dict(
            np.load(io.BytesIO(zf.read("arrays.npz")), allow_pickle=False)
        )

    graph = Graph()
    graph.stage = manifest["stage"]
    graph.piles = _piles_restore(manifest, arrays)

    flat = arrays["node_codes"]
    offsets = arrays["node_code_offsets"]
    ci = 0
    for ns in manifest["nodes"]:
        if ns is None:
            graph.nodes.append(None)
            continue
        codes = flat[offsets[ci] : offsets[ci + 1]]
        ci += 1
        n = Node(ns["id"], ns["name"], codes, ns["seq_id"])
        n.count = ns["count"]
        n.is_unitig = ns["is_unitig"]
        n.is_circular = ns["is_circular"]
        n.is_polished = ns["is_polished"]
        n.transitive = set(ns["transitive"])
        n.color = ns["color"]
        n.coverage = ns["coverage"]
        n.original_names = set(ns["original_names"])
        graph.nodes.append(n)

    # rebuild RC pairs (binary.cc:44-49)
    for i in range(0, len(graph.nodes) - 1, 2):
        if graph.nodes[i] is not None and graph.nodes[i + 1] is not None:
            graph.nodes[i].pair = graph.nodes[i + 1]
            graph.nodes[i + 1].pair = graph.nodes[i]

    # edges + adjacency (binary.cc:50-65)
    for es in manifest["edges"]:
        if es is None:
            graph.edges.append(None)
            continue
        eid, length, weight, tail_id, head_id = es
        tail = graph.nodes[tail_id]
        head = graph.nodes[head_id]
        e = Edge(eid, tail, head, length)
        e.weight = weight
        graph.edges.append(e)
    for i in range(0, len(graph.edges) - 1, 2):
        if graph.edges[i] is not None and graph.edges[i + 1] is not None:
            graph.edges[i].pair = graph.edges[i + 1]
            graph.edges[i + 1].pair = graph.edges[i]

    graph._node_next = manifest["node_next"]
    graph._edge_next = manifest["edge_next"]
    return graph
