"""Text graph representations: GFA / unitig GFA / CSV / JSON piles + loader.

Byte-compatible with the reference writers (RavenLib/src/graph_repr.cc):
S lines with LN/RC/dp tags, L lines with `<overlap>M`, a self-L line for
circular contigs, unitig GFA with CL color and A ancestor lines, the CSV
graph dump, the cereal-style JSON pile dump, and the GFA loader that
rebuilds a Graph at stage -3.
"""

from __future__ import annotations

import json

import numpy as np

from raven_tpu_torch.graph.graph import Edge, Graph, Node
from raven_tpu_torch.io.readset import encode


def _skip_node(n: Node | None) -> bool:
    # graph_repr.cc:14-16: skip deleted, RC twins, and isolated single reads
    return (
        n is None
        or n.is_rc
        or (n.count == 1 and n.outdegree == 0 and n.indegree == 0)
    )


def get_gfa(graph: Graph, include_dp: bool = False) -> list[str]:
    """GFA lines (reference getGfa :109-174 / PrintGfa :7-68 with dp tag)."""
    lines = []
    for n in graph.nodes:
        if _skip_node(n):
            continue
        line = f"S\t{n.name}\t{n.sequence_str()}\tLN:i:{n.length}\tRC:i:{n.count}"
        if include_dp:
            line += f"\tdp:f:{n.coverage}"
        lines.append(line)
        if n.is_circular:
            lines.append(f"L\t{n.name}\t+\t{n.name}\t+\t0M")
    for e in graph.edges:
        if e is None or e.is_rc:
            continue
        lines.append(
            "L\t{}\t{}\t{}\t{}\t{}M".format(
                e.tail.name,
                "-" if e.tail.is_rc else "+",
                e.head.name,
                "-" if e.head.is_rc else "+",
                e.tail.length - e.length,
            )
        )
    return lines


def print_gfa(graph: Graph, path: str) -> None:
    if not path:
        return
    with open(path, "w") as fh:
        for line in get_gfa(graph, include_dp=True):
            fh.write(line + "\n")


def print_unitig_gfa(graph: Graph, path: str) -> None:
    """Unitig GFA with CL color + A ancestor lines (graph_repr.cc:70-107)."""
    if not path:
        return
    with open(path, "w") as fh:
        for n in graph.nodes:
            if _skip_node(n):
                continue
            fh.write(
                f"S\t{n.name}\t{n.sequence_str()}\tLN:i:{n.length}"
                f"\tRC:i:{n.count}\tCL:z:{'blue' if n.color else 'orange'}\n"
            )
            for name in sorted(n.original_names):
                fh.write(f"A\t{name}\n")
        for e in graph.edges:
            if e is None or e.is_rc:
                continue
            fh.write(
                "L\t{}\t{}\t{}\t{}\t{}M\n".format(
                    e.tail.name,
                    "-" if e.tail.is_rc else "+",
                    e.head.name,
                    "-" if e.head.is_rc else "+",
                    e.tail.length - e.length,
                )
            )


def get_csv(
    graph: Graph,
    print_sequence_name: bool = False,
    print_pile_begin_end: bool = False,
    print_edge_similarity: bool = False,
) -> list[str]:
    """CSV rows for graph visualisation (graph_repr.cc:286-399)."""
    lines = []
    for n in graph.nodes:
        if _skip_node(n):
            continue
        line = (
            f"{n.id} [{n.id // 2}] LN:i:{n.length} RC:i:{n.count},"
            f"{n.pair.id} [{n.pair.id // 2}] LN:i:{n.pair.length}"
            f" RC:i:{n.pair.count},0,"
        )
        add_dash = True
        if print_sequence_name:
            add_dash = False
            line += f"{n.name} "
        if (
            print_pile_begin_end
            and graph.piles is not None
            and 0 <= n.seq_id < graph.piles.n
        ):
            add_dash = False
            line += (
                f"{graph.piles.begin_bases(n.seq_id)} "
                f"{graph.piles.end_bases(n.seq_id)}"
            )
        if add_dash:
            line += "-"
        lines.append(line)

    for e in graph.edges:
        if e is None:
            continue
        line = (
            f"{e.tail.id} [{e.tail.id // 2}] LN:i:{e.tail.length}"
            f" RC:i:{e.tail.count},"
            f"{e.head.id} [{e.head.id // 2}] LN:i:{e.head.length}"
            f" RC:i:{e.head.count},1,"
            f"{e.id} {e.length} {e.weight}"
        )
        if print_edge_similarity:
            from raven_tpu_torch.ops.edit_distance import edit_distance

            lhs = e.tail.codes[e.length :]
            rhs = e.head.codes[: lhs.size]
            ed = edit_distance(lhs, rhs)
            score = 1 - ed / lhs.size if lhs.size else 0.0
            line += f" {score}"
        lines.append(line)

    for n in graph.nodes:  # circular self-edges
        if n is None or not n.is_circular:
            continue
        lines.append(
            f"{n.id} [{n.id // 2}] LN:i:{n.length} RC:i:{n.count},"
            f"{n.id} [{n.id // 2}] LN:i:{n.length} RC:i:{n.count},1,-"
        )
    return lines


def print_csv(graph: Graph, path: str, *args, **kwargs) -> None:
    if not path:
        return
    with open(path, "w") as fh:
        for line in get_csv(graph, *args, **kwargs):
            fh.write(line + "\n")


def print_json(graph: Graph, path: str) -> None:
    """Pile-o-gram JSON dump consumed by misc/plotter.py
    (graph_repr.cc:401-416; cereal NVP field names preserved)."""
    if not path or graph.piles is None:
        return
    piles = graph.piles
    out = {}
    for i in range(piles.n):
        if piles.is_invalid[i]:
            continue
        out[str(i)] = {
            "id_": i,
            "begin_": int(piles.begin[i]),
            "end_": int(piles.end[i]),
            "median_": int(piles.median[i]),
            "is_invalid_": bool(piles.is_invalid[i]),
            "is_contained_": bool(piles.is_contained[i]),
            "is_chimeric_": bool(piles.is_chimeric[i]),
            "is_repetitive_": bool(piles.is_repetitive[i]),
            "data_": piles.row(i).tolist(),
            "kmers_": piles.kmers.get(i, np.zeros(0, bool)).astype(int).tolist(),
            "chimeric_regions_": [list(r) for r in piles.chimeric_regions[i]],
            "repetitive_regions_": [
                list(r) for r in piles.repetitive_regions[i]
            ],
        }
    with open(path, "w") as fh:
        json.dump(out, fh)


def load_gfa(path: str) -> Graph:
    """Rebuild a Graph from GFA at stage -3 (graph_repr.cc:435-529).

    Like the reference loader, only forward nodes/edges are created (ids all
    even), edge length is recovered from `tail_len - overlap`, and the
    self-L line restores circularity."""
    graph = Graph()
    if not path:
        return graph

    by_name: dict[str, Node] = {}
    node_id = 0
    edge_id = 0
    with open(path) as fh:
        for raw in fh:
            row = raw.rstrip("\n").split("\t")
            if not row or not row[0]:
                continue
            if row[0] == "S":
                name, seq = row[1], row[2]
                count = int(row[4][5:])  # RC:i:<n>
                n = Node(node_id, name, encode(seq))
                node_id += 2
                n.count = count
                graph.nodes.append(n)
                by_name.setdefault(name, n)
            elif row[0] == "L":
                tail_name, head_name = row[1], row[3]
                overlap = int(row[5][:-1])
                if overlap == 0 and tail_name == head_name:
                    node = by_name.get(head_name)
                    if node is not None:
                        node.is_circular = True
                    continue
                tail = by_name.get(tail_name)
                head = by_name.get(head_name)
                length = tail.length - overlap if tail is not None else 0
                e = Edge.__new__(Edge)
                e.id = edge_id
                edge_id += 2
                e.length = length
                e.weight = 0.0
                e.tail = tail
                e.head = head
                e.pair = None
                if tail is not None:
                    tail.outedges.append(e)
                if head is not None:
                    head.inedges.append(e)
                graph.edges.append(e)
            else:
                print(f"Unknown element: {raw.rstrip()}")

    graph.stage = -3
    graph._node_next = node_id
    graph._edge_next = edge_id
    return graph
