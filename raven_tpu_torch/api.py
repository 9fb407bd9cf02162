"""Python API mirroring the reference's ravenpy bindings.

The port of raven_tpu/api.py, call for call.  Reference:
PythonLib/src/ravenpy.cc — whole-phase functions
(construct_graph/assemble_graph/polish_graph, :175-192), per-sub-stage
functions (:214-268), graph printers/getters/loader (:194-209), and handle
types.  Here the handles are plain Python objects (ReadSet, OverlapsHandle,
Graph) — stage functions stay composable with first-class intermediates.

Device work runs on the card unless the caller asks for the CPU: the
whole-phase functions and remove_long_edges_from_graph take `device=`
(raven_tpu_torch.device.resolve_device: CUDA by default, raising without
it), and the sub-stages that map reads run on the device of the
MinimizerIndex they are given.
"""

from __future__ import annotations

import sys

import numpy as np

from raven_tpu_torch.config import AlignCfg, DeviceCfg, OverlapPhaseCfg, PolishCfg
from raven_tpu_torch.graph import Graph
from raven_tpu_torch.graph import construct as _construct
from raven_tpu_torch.graph.assemble import (
    assemble as _assemble,
    remove_long_edges_stage,
    remove_tips_and_bubbles,
    remove_transitive_edges,
)
from raven_tpu_torch.graph.common import get_unitigs, unitig_record_name
from raven_tpu_torch.graph.repr import (
    get_csv,
    get_gfa,
    load_gfa,
    print_csv,
    print_gfa,
    print_json,
    print_unitig_gfa,
)
from raven_tpu_torch.io import ReadSet, load_sequences
from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE
from raven_tpu_torch.pile.pile import Piles

__all__ = [
    "AlignCfg",
    "DeviceCfg",
    "Graph",
    "MinimizerIndex",
    "OverlapPhaseCfg",
    "OverlapsHandle",
    "PolishCfg",
    "ReadSet",
    "assemble_graph",
    "construct_assembly_graph",
    "construct_graph",
    "find_overlaps_and_create_piles",
    "find_overlaps_and_repetitive_regions",
    "get_csv",
    "get_gfa",
    "get_unitigs",
    "graph_get_csv",
    "graph_get_gfa",
    "graph_load_gfa",
    "graph_print_csv",
    "graph_print_gfa",
    "graph_print_json",
    "graph_print_unitig_gfa",
    "graph_print_unitigs",
    "load_gfa",
    "load_sequences",
    "polish_graph",
    "remove_long_edges_from_graph",
    "remove_tips_and_bubbles_from_graph",
    "remove_transitive_edges_from_graph",
    "resolve_chimeric_sequences",
    "resolve_contained_reads",
    "resolve_repeat_induced_overlaps",
    "trim_and_annotate_piles",
]


class OverlapsHandle:
    """Per-read overlap lists (ravenpy.cc:63-68 OverlapsHandle)."""

    def __init__(self, readset: ReadSet):
        self.overlaps = [
            np.zeros(0, dtype=OVERLAP_DTYPE) for _ in range(len(readset))
        ]
        self.all_overlaps = np.zeros(0, dtype=OVERLAP_DTYPE)


# ---------------------------------------------------------------- whole-phase
def construct_graph(graph, readset, checkpoints=False, cfg=None, device=None):
    _construct.construct_graph(graph, readset, cfg, checkpoints, device=device)


def assemble_graph(graph, checkpoints=False, device=None):
    _assemble(graph, checkpoints, device=device)


def polish_graph(graph, readset, checkpoints=False, cfg=None, device=None):
    from raven_tpu_torch.polish import polish

    polish(graph, readset, cfg, checkpoints, device=device)


# ---------------------------------------------------------------- sub-stages
def find_overlaps_and_create_piles(
    index, readset, graph, overlaps_handle, freq=0.001, max_num_overlaps=32,
    use_minhash=False,
):
    cfg = OverlapPhaseCfg(
        kmer_len=index.k,
        window_len=index.w,
        freq=freq,
        max_num_overlaps=max_num_overlaps,
        use_minhash=use_minhash,
    )
    graph.piles = Piles(readset.lengths)
    _construct.find_overlaps_and_create_piles(
        index, readset, cfg, graph.piles, overlaps_handle.overlaps
    )


def trim_and_annotate_piles(graph, overlaps_handle):
    _construct.trim_and_annotate_piles(graph.piles, overlaps_handle.overlaps)


def resolve_contained_reads(graph, overlaps_handle, readset, identity=0.0):
    _construct.resolve_contained_reads(
        graph.piles, overlaps_handle.overlaps, readset, identity
    )


def resolve_chimeric_sequences(graph, overlaps_handle, readset=None):
    _construct.resolve_chimeric_sequences(graph.piles, overlaps_handle.overlaps)


def find_overlaps_and_repetitive_regions(
    index, graph, overlaps_handle, readset, freq=0.001, identity=0.0
):
    cfg = OverlapPhaseCfg(
        kmer_len=index.k, window_len=index.w, freq=freq, identity=identity
    )
    overlaps_handle.all_overlaps = _construct.find_overlaps_and_repetitive_regions(
        index, readset, cfg, graph.piles
    )


def resolve_repeat_induced_overlaps(graph, overlaps_handle, readset):
    overlaps_handle.all_overlaps = _construct.resolve_repeat_induced_overlaps(
        graph.piles, overlaps_handle.all_overlaps, readset
    )


def construct_assembly_graph(graph, overlaps_handle, readset):
    _construct.construct_assembly_graph(
        graph, graph.piles, overlaps_handle.all_overlaps, readset
    )


def remove_transitive_edges_from_graph(graph):
    return remove_transitive_edges(graph)


def remove_tips_and_bubbles_from_graph(graph):
    remove_tips_and_bubbles(graph)


def remove_long_edges_from_graph(graph, device=None):
    from raven_tpu_torch.device import resolve_device

    remove_long_edges_stage(graph, resolve_device(device))


# ---------------------------------------------------------------- printers
graph_print_csv = print_csv
graph_print_gfa = print_gfa
graph_print_unitig_gfa = print_unitig_gfa
graph_print_json = print_json
graph_get_csv = get_csv
graph_get_gfa = get_gfa
graph_load_gfa = load_gfa


def graph_print_unitigs(graph, num_polishing_rounds=0, file=sys.stdout):
    """FASTA of final unitigs to stdout (ravenpy.cc:196-204)."""
    for node in get_unitigs(graph, num_polishing_rounds > 0):
        file.write(f">{unitig_record_name(node)}\n")
        file.write(node.sequence_str() + "\n")
