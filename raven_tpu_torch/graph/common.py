"""Graph common ops: edge deletion, unitig contraction, unitig extraction.

Reference: RavenLib/src/common.cc (RemoveEdges :5-30, CreateUnitigs :32-225,
GetUnitigs :227-252).
"""

from __future__ import annotations

import numpy as np

from raven_tpu_torch.graph.graph import Graph, Node, make_unitig_node_pair


def remove_edges(graph: Graph, indices, remove_nodes: bool = False) -> None:
    """Delete edges by id; optionally delete nodes left isolated
    (reference common.cc:5-30)."""
    indices = set(indices)
    node_indices = set()
    for i in indices:
        e = graph.edges[i]
        if e is None:
            continue
        if remove_nodes:
            node_indices.add(e.tail.id)
            node_indices.add(e.head.id)
        e.tail.outedges = [x for x in e.tail.outedges if x is not e]
        e.head.inedges = [x for x in e.head.inedges if x is not e]
    if remove_nodes:
        for i in node_indices:
            n = graph.nodes[i]
            if n is not None and n.outdegree == 0 and n.indegree == 0:
                graph.nodes[i] = None
    for i in indices:
        graph.edges[i] = None


def create_unitigs(graph: Graph, epsilon: int = 0) -> int:
    """Contract non-branching chains into unitig nodes, epsilon-trimming
    near junctions (reference common.cc:32-225)."""
    marked_edges: set[int] = set()
    unitig_marked_edges: list = []
    n_original = len(graph.nodes)
    node_updates = np.zeros(n_original, dtype=np.int64)
    is_visited = np.zeros(n_original, dtype=bool)
    created = 0

    snapshot = list(graph.nodes)  # new unitigs must not be revisited
    for it in snapshot:
        if it is None or is_visited[it.id] or it.is_junction:
            continue

        extension = 1
        is_circular = False

        begin = it
        while not begin.is_junction:  # extend left
            is_visited[begin.id] = True
            is_visited[begin.pair.id] = True
            if begin.indegree == 0 or begin.inedges[0].tail.is_junction:
                break
            begin = begin.inedges[0].tail
            extension += 1
            if begin is it:
                is_circular = True
                break

        end = it
        while not end.is_junction:  # extend right
            is_visited[end.id] = True
            is_visited[end.pair.id] = True
            if end.outdegree == 0 or end.outedges[0].head.is_junction:
                break
            end = end.outedges[0].head
            extension += 1
            if end is it:
                is_circular = True
                break

        if not is_circular and begin is end:
            continue
        if not is_circular and extension < 2 * epsilon + 2:
            continue

        if begin is not end:  # skip nodes near junctions
            for _ in range(epsilon):
                begin = begin.outedges[0].head
            for _ in range(epsilon):
                end = end.inedges[0].tail

        coverage = (begin.coverage + end.coverage) // 2
        unitig, rc_unitig = make_unitig_node_pair(graph, begin, end)
        unitig.coverage = rc_unitig.coverage = coverage
        created += 1
        unitig_marked: list = []

        if begin is end:
            unitig.original_names.add(begin.name)
            rc_unitig.original_names.add(begin.pair.name)

        if begin is not end:  # connect unitig to the graph
            if begin.indegree:
                e_in = begin.inedges[0]
                marked_edges.add(e_in.id)
                marked_edges.add(e_in.pair.id)
                unitig_marked.append(e_in)
                edge = graph.new_edge(e_in.tail, unitig, e_in.length)
                rc_edge = graph.new_edge(
                    rc_unitig,
                    e_in.pair.head,
                    e_in.pair.length + rc_unitig.length - begin.pair.length,
                )
                edge.pair = rc_edge
                rc_edge.pair = edge
            if end.outdegree:
                e_out = end.outedges[0]
                marked_edges.add(e_out.id)
                marked_edges.add(e_out.pair.id)
                unitig_marked.append(e_out)
                edge = graph.new_edge(
                    unitig, e_out.head, e_out.length + unitig.length - end.length
                )
                rc_edge = graph.new_edge(e_out.pair.tail, rc_unitig, e_out.pair.length)
                edge.pair = rc_edge
                rc_edge.pair = edge

        jt = begin
        while True:
            e = jt.outedges[0]
            marked_edges.add(e.id)
            marked_edges.add(e.pair.id)
            unitig_marked.append(e)
            # track where original nodes went (for transitive remapping)
            node_updates[jt.id & ~1] = unitig.id
            unitig.transitive |= graph.nodes[jt.id & ~1].transitive
            jt = e.head
            if jt is end:
                break

        # ancestry bookkeeping (common.cc:183-202)
        for e in unitig_marked:
            if e.head is not None:
                unitig.original_names.add(e.head.name)
            if e.tail is not None:
                unitig.original_names.add(e.tail.name)
            if e.pair is not None:
                if e.pair.head is not None:
                    rc_unitig.original_names.add(e.pair.head.name)
                if e.pair.tail is not None:
                    rc_unitig.original_names.add(e.pair.tail.name)

    remove_edges(graph, marked_edges, remove_nodes=True)

    for n in graph.live_nodes():  # remap transitive hints onto unitigs
        if n.transitive:
            n.transitive = {
                int(node_updates[j]) if j < n_original and node_updates[j] != 0 else j
                for j in n.transitive
            }

    return created


def get_unitigs(graph: Graph, drop_unpolished: bool = False) -> list[Node]:
    """Final unitig nodes; names carry LN/RC/XO tags when exported
    (reference common.cc:227-252)."""
    create_unitigs(graph)
    dst = []
    for n in graph.live_nodes():
        if n.is_rc or not n.is_unitig:
            continue
        if drop_unpolished and not n.is_polished:
            continue
        dst.append(n)
    return dst


def unitig_record_name(n: Node) -> str:
    """'name LN:i:<len> RC:i:<count> XO:i:<circular>' (common.cc:242-245)."""
    return (
        f"{n.name} LN:i:{n.length} RC:i:{n.count} XO:i:{1 if n.is_circular else 0}"
    )
