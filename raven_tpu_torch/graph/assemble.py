"""Layout phase: graph simplification to unitigs.

Reference: RavenLib/src/assemble.cc — transitive reduction (:23-73), tip
removal (:75-126), bubble popping (:128-355), force-directed long-edge
removal (:700-730), plasmid salvage (:732-795), stage driver (:857-880).
"""

from __future__ import annotations

import collections

import numpy as np

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.graph.common import create_unitigs, remove_edges
from raven_tpu_torch.graph.graph import Graph, Node
from raven_tpu_torch.graph.layout import create_force_directed_layout
from raven_tpu_torch.ops.edit_distance import edit_distance_bounded
from raven_tpu_torch.utils import trace

TRANSITIVE_EPS = 0.12  # assemble.cc:28
TIP_MAX_READS = 5  # assemble.cc:101
BUBBLE_MAX_DISTANCE = 500_000  # assemble.cc:320
BUBBLE_MIN_RATIO = 0.8  # assemble.cc:267
BUBBLE_MIN_IDENTITY = 0.8  # assemble.cc:279
LONG_EDGE_ROUNDS = 16  # assemble.cc:819
LONG_EDGE_RATIO = 2.0  # assemble.cc:715
LONG_EDGE_UNITIG_EPS = 42  # assemble.cc:818


def _stage(name: str, msg: str) -> trace.span:
    """The span of an assemble stage, which prints its stage-log line."""
    return trace.span("assemble." + name, log=f"[raven_tpu::Graph::Assemble] {msg}")


def remove_transitive_edges(graph: Graph) -> int:
    """Length-comparable transitive reduction (assemble.cc:23-73)."""
    with _stage("transitive", "removed transitive edges"):
        def is_comparable(a: float, b: float) -> bool:
            eps = TRANSITIVE_EPS
            return (b * (1 - eps) <= a <= b * (1 + eps)) or (
                a * (1 - eps) <= b <= a * (1 + eps)
            )

        candidate: dict[int, object] = {}
        marked: set[int] = set()
        for it in graph.nodes:
            if it is None:
                continue
            for jt in it.outedges:
                candidate[jt.head.id] = jt
            for jt in it.outedges:
                for kt in jt.head.outedges:
                    ce = candidate.get(kt.head.id)
                    if ce is not None and is_comparable(
                        jt.length + kt.length, ce.length
                    ):
                        marked.add(ce.id)
                        marked.add(ce.pair.id)
            for jt in it.outedges:
                candidate.pop(jt.head.id, None)

        for i in marked:  # keep hints for the force-directed layout
            if i & 1:
                lhs = graph.edges[i].tail.id & ~1
                rhs = graph.edges[i].head.id & ~1
                graph.nodes[lhs].transitive.add(rhs)
                graph.nodes[rhs].transitive.add(lhs)

        remove_edges(graph, marked)
    return len(marked) // 2


def remove_tips(graph: Graph) -> int:
    """Dead-end removal (assemble.cc:75-126)."""
    num_tips = 0
    is_visited: set[int] = set()

    for it in graph.nodes:
        if it is None or it.id in is_visited or not it.is_tip:
            continue
        is_circular = False
        num_sequences = 0

        end = it
        while not end.is_junction:
            num_sequences += end.count
            is_visited.add(end.id)
            is_visited.add(end.pair.id)
            if end.outdegree == 0 or end.outedges[0].head.is_junction:
                break
            end = end.outedges[0].head
            if end is it:
                is_circular = True
                break

        if is_circular or end.outdegree == 0 or num_sequences > TIP_MAX_READS:
            continue

        marked: set[int] = set()
        for jt in end.outedges:
            if jt.head.indegree > 1:
                marked.add(jt.id)
                marked.add(jt.pair.id)
        if len(marked) // 2 == end.outdegree:  # delete the whole tip path
            begin = it
            while begin is not end:
                marked.add(begin.outedges[0].id)
                marked.add(begin.outedges[0].pair.id)
                begin = begin.outedges[0].head
            num_tips += 1

        remove_edges(graph, marked, remove_nodes=True)

    return num_tips


def find_removable_edges(path: list[Node]) -> set[int]:
    """Edges of a bubble path that may be deleted (assemble.cc:128-197)."""
    if not path:
        return set()

    def find_edge(tail: Node, head: Node):
        for e in tail.outedges:
            if e.head is head:
                return e
        return None

    pref = -1
    for i in range(1, len(path) - 1):
        if path[i].indegree > 1:
            pref = i
            break
    suff = -1
    for i in range(1, len(path) - 1):
        if path[i].outdegree > 1:
            suff = i

    dst: set[int] = set()
    if pref == -1 and suff == -1:  # remove the whole path
        for i in range(len(path) - 1):
            e = find_edge(path[i], path[i + 1])
            dst.add(e.id)
            dst.add(e.pair.id)
        return dst

    if pref != -1 and path[pref].outdegree > 1:  # complex path
        return set()
    if suff != -1 and path[suff].indegree > 1:  # complex path
        return set()

    if pref == -1:
        rng = range(suff, len(path) - 1)
    elif suff == -1:
        rng = range(0, pref)
    elif suff < pref:
        rng = range(suff, pref)
    else:
        return set()
    for i in rng:
        e = find_edge(path[i], path[i + 1])
        dst.add(e.id)
        dst.add(e.pair.id)
    return dst


def _path_sequence(path: list[Node]) -> np.ndarray:
    """Concatenated edge labels + final node sequence (assemble.cc:225-237)."""
    parts = []
    for i in range(len(path) - 1):
        for e in path[i].outedges:
            if e.head is path[i + 1]:
                parts.append(e.label())
                break
    parts.append(path[-1].codes)
    return np.concatenate(parts)


def remove_bubbles(graph: Graph) -> int:
    """BFS bubble detection + popping (assemble.cc:199-355)."""
    distance: dict[int, int] = {}
    predecessor: dict[int, Node] = {}

    def path_extract(begin: Node, end: Node) -> list[Node]:
        dst = []
        while end is not begin:
            dst.append(end)
            end = predecessor[end.id]
        dst.append(begin)
        dst.reverse()
        return dst

    def path_is_simple(path: list[Node]) -> bool:
        if not path:
            return False
        return not any(p.is_junction for p in path[1:-1])

    def bubble_pop(lhs: list[Node], rhs: list[Node]) -> set[int]:
        if not lhs or not rhs:
            return set()
        bubble = set(id(x) for x in lhs) | set(id(x) for x in rhs)
        if len(lhs) + len(rhs) - 2 != len(bubble):
            return set()
        for it in lhs:
            if id(it.pair) in bubble:
                return set()

        if not path_is_simple(lhs) or not path_is_simple(rhs):
            if not find_removable_edges(lhs) and not find_removable_edges(rhs):
                return set()
            l_seq = _path_sequence(lhs)
            r_seq = _path_sequence(rhs)
            if min(l_seq.size, r_seq.size) < max(l_seq.size, r_seq.size) * (
                BUBBLE_MIN_RATIO
            ):
                return set()
            # the check only needs "ED <= (1 - identity) * max": banded
            # Myers with that band is exact below it and ~25x cheaper on
            # 500 kb paths than the full matrix.  The limit is the
            # largest integer ED the ORIGINAL float comparison
            # (1 - ed/mx >= identity) accepts — int(mx * (1 - id))
            # undershoots by 1 at exact-boundary sizes because
            # 1 - 0.8 == 0.19999999999999996 in binary.
            mx = max(l_seq.size, r_seq.size)
            limit = int(mx * (1 - BUBBLE_MIN_IDENTITY)) + 2
            while limit > 0 and 1 - limit / mx < BUBBLE_MIN_IDENTITY:
                limit -= 1
            ed = edit_distance_bounded(l_seq, r_seq, limit)
            if ed > limit:
                return set()

        lhs_count = sum(j.count for j in lhs)
        rhs_count = sum(j.count for j in rhs)
        marked = find_removable_edges(rhs if lhs_count > rhs_count else lhs)
        if not marked:
            marked = find_removable_edges(lhs if lhs_count > rhs_count else rhs)
        return marked

    num_bubbles = 0
    for it in graph.nodes:
        if it is None or it.outdegree < 2:
            continue

        begin = it
        end = None
        other_end = None
        que = collections.deque([begin])
        visited = [begin]
        while que and end is None:
            jt = que.popleft()
            for kt in jt.outedges:
                if kt.head is begin:  # cycle
                    continue
                if distance.get(jt.id, 0) + kt.length > BUBBLE_MAX_DISTANCE:
                    continue
                distance[kt.head.id] = distance.get(jt.id, 0) + kt.length
                visited.append(kt.head)
                que.append(kt.head)
                if predecessor.get(kt.head.id) is not None:  # found bubble
                    end = kt.head
                    other_end = jt
                    break
                predecessor[kt.head.id] = jt

        marked: set[int] = set()
        if end is not None:
            lhs = path_extract(begin, end)
            rhs = path_extract(begin, other_end)
            rhs.append(end)
            marked = bubble_pop(lhs, rhs)

        for jt in visited:
            distance.pop(jt.id, None)
            predecessor.pop(jt.id, None)

        remove_edges(graph, marked, remove_nodes=True)
        num_bubbles += 1 if marked else 0

    return num_bubbles


def remove_long_edges(
    graph: Graph, num_rounds: int = LONG_EDGE_ROUNDS, device=None
) -> int:
    """Layout-space pruning of elongated edges (assemble.cc:700-730)."""
    num_long_edges = 0
    for _ in range(num_rounds):
        create_force_directed_layout(graph, device=device)
        marked: set[int] = set()
        for it in graph.nodes:
            if it is None or it.outdegree < 2:
                continue
            for jt in it.outedges:
                for kt in it.outedges:
                    if jt is not kt and jt.weight * LONG_EDGE_RATIO < kt.weight:
                        marked.add(kt.id)
                        marked.add(kt.pair.id)
        remove_edges(graph, marked)
        num_long_edges += len(marked) // 2
        remove_tips(graph)
    return num_long_edges


class _SeqView:
    """Adapter exposing a list of code arrays with the ReadSet mapping API."""

    def __init__(self, codes_list):
        self.codes_list = codes_list
        self.lengths = np.array([c.size for c in codes_list], dtype=np.int64)

    def __len__(self):
        return len(self.codes_list)

    def sequence(self, i: int, begin: int = 0, length: int | None = None):
        c = self.codes_list[i]
        if length is None:
            length = c.size - begin
        return c[begin : begin + length]


def salvage_plasmids(graph: Graph, device=None) -> int:
    """Rescue short circular contigs that map to nothing else
    (assemble.cc:732-795); the minimizer engine runs on `device`."""
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    create_unitigs(graph)

    plasmid_nodes = [
        n
        for n in graph.live_nodes()
        if not n.is_rc and not n.is_unitig and n.is_circular
    ]
    if not plasmid_nodes:
        return 0
    plasmid_nodes.sort(key=lambda n: n.length)

    view = _SeqView([n.codes for n in plasmid_nodes])
    engine = MinimizerIndex(15, 5, device=device)
    engine.minimize(view, np.arange(len(plasmid_nodes)))
    engine.filter(0.001)
    alive = []
    for i, n in enumerate(plasmid_nodes):
        if engine.map(view, i, avoid_equal=True, avoid_symmetric=True).size == 0:
            alive.append(n)
    if not alive:
        return 0

    unitig_nodes = [n for n in graph.live_nodes() if not n.is_rc and n.is_unitig]
    if unitig_nodes:
        uview = _SeqView([n.codes for n in unitig_nodes])
        engine.minimize(uview, np.arange(len(unitig_nodes)), minhash=True)
        engine.filter(0.001)
        survivors = []
        for n in alive:
            pview = _SeqView([n.codes])
            if engine.map(pview, 0, avoid_equal=False, avoid_symmetric=False).size == 0:
                survivors.append(n)
        alive = survivors

    for n in alive:
        n.is_unitig = n.pair.is_unitig = True
        n.name = n.pair.name = "Utg" + n.name[3:]
    return len(alive)


def remove_tips_and_bubbles(graph: Graph) -> None:
    """Fixpoint of tip + bubble removal (assemble.cc:797-811)."""
    with _stage("tips_bubbles", "removed tips and bubbles"):
        while True:
            num_changes = remove_tips(graph)
            num_changes += remove_bubbles(graph)
            if num_changes == 0:
                break


def remove_long_edges_stage(graph: Graph, device=None) -> None:
    """Stage -1 (assemble.cc:813-837)."""
    with _stage("long_edges", "removed long edges"):
        create_unitigs(graph, LONG_EDGE_UNITIG_EPS)  # speed up the layout
        remove_long_edges(graph, LONG_EDGE_ROUNDS, device)

    while True:
        num_changes = remove_tips(graph)
        num_changes += remove_bubbles(graph)
        if num_changes == 0:
            break

    salvage_plasmids(graph, device)


def assemble(graph: Graph, checkpoints: bool = False, device=None) -> None:
    """Stage driver -3 -> 0 (assemble.cc:857-880).  Device work (the
    layout n-body, the plasmid engine) runs on `device` (default CUDA,
    see raven_tpu_torch.device)."""
    if graph.stage < -3 or graph.stage > -1:
        return
    device = resolve_device(device)

    def checkpoint():
        if checkpoints:
            from raven_tpu_torch.graph.binary import store_graph

            with _stage("checkpoint", "reached checkpoint"):
                store_graph(graph)

    from raven_tpu_torch.utils import stagedump

    with _stage("graph", ""):
        if graph.stage == -3:
            remove_transitive_edges(graph)
            if stagedump.enabled():
                stagedump.dump(
                    "assemble/remove_transitive_edges",
                    **stagedump.graph_stats(graph),
                )
            graph.stage += 1
            checkpoint()

        if graph.stage == -2:
            remove_tips_and_bubbles(graph)
            if stagedump.enabled():
                stagedump.dump(
                    "assemble/remove_tips_and_bubbles",
                    **stagedump.graph_stats(graph),
                )
            graph.stage += 1
            checkpoint()

        if graph.stage == -1:
            remove_long_edges_stage(graph, device)
            if stagedump.enabled():
                stagedump.dump(
                    "assemble/remove_long_edges",
                    **stagedump.graph_stats(graph),
                )
            graph.stage += 1
            checkpoint()
