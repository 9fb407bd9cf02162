"""Assembly graph data model.

Mirrors the reference's paired representation (RavenLib/include/raven/graph/
graph.h): every node/edge has a reverse-complement partner, `id & 1` marks
the RC twin, deleted elements become None slots.  Node sequences are numpy
2-bit code arrays (not strings) so they can be shipped to device kernels.
"""

from __future__ import annotations

import numpy as np

from raven_tpu_torch.config import GLOBALS
from raven_tpu_torch.io.readset import decode, reverse_complement


class Node:
    __slots__ = (
        "id",
        "name",
        "codes",
        "quals",
        "seq_id",
        "count",
        "is_unitig",
        "is_circular",
        "is_polished",
        "transitive",
        "color",
        "inedges",
        "outedges",
        "pair",
        "coverage",
        "original_names",
    )

    def __init__(self, node_id: int, name: str, codes: np.ndarray, seq_id: int = -1):
        self.id = node_id
        self.name = name
        self.codes = np.asarray(codes, dtype=np.uint8)
        self.quals = None
        self.seq_id = seq_id  # originating read id (sequence.id in reference)
        self.count = 1
        self.is_unitig = False
        self.is_circular = False
        self.is_polished = False
        self.transitive: set[int] = set()
        self.color = 0
        self.inedges: list["Edge"] = []
        self.outedges: list["Edge"] = []
        self.pair: "Node" | None = None
        self.coverage = 0
        self.original_names: set[str] = set()

    # reference graph.h:116-123
    @property
    def indegree(self) -> int:
        return len(self.inedges)

    @property
    def outdegree(self) -> int:
        return len(self.outedges)

    @property
    def is_rc(self) -> bool:
        return bool(self.id & 1)

    @property
    def is_junction(self) -> bool:
        return self.outdegree > 1 or self.indegree > 1

    @property
    def is_tip(self) -> bool:
        return self.outdegree > 0 and self.indegree == 0 and self.count < 6

    @property
    def length(self) -> int:
        return int(self.codes.size)

    def sequence_str(self) -> str:
        return decode(self.codes)


class Edge:
    __slots__ = ("id", "length", "weight", "tail", "head", "pair")

    def __init__(self, edge_id: int, tail: Node, head: Node, length: int):
        self.id = edge_id
        self.length = int(length)
        self.weight = 0.0
        self.tail = tail
        self.head = head
        self.pair: "Edge" | None = None
        tail.outedges.append(self)
        head.inedges.append(self)

    @property
    def is_rc(self) -> bool:
        return bool(self.id & 1)

    def label(self) -> np.ndarray:
        """Tail-sequence prefix of `length` codes (reference graph.h:163)."""
        return self.tail.codes[: self.length]


class Graph:
    """stage counter semantics (reference graph.h:186, SURVEY §2.3):
    -5 start, -5→-4 overlap piles, -4→-3 repeats+graph build,
    -3→-2 transitive, -2→-1 tips/bubbles, -1→0 long edges, 0→N polish."""

    def __init__(self):
        self.stage = -5
        self.piles = None  # raven_tpu_torch.pile.Piles
        self.nodes: list[Node | None] = []
        self.edges: list[Edge | None] = []
        self._node_next = 0
        self._edge_next = 0

    # --- factories (reference IndexedFactory, graph.h:53-88) --------------
    def new_node(self, name: str, codes: np.ndarray, seq_id: int = -1) -> Node:
        n = Node(self._node_next, name, codes, seq_id)
        self._node_next += 1
        self.nodes.append(n)
        return n

    def next_node_index(self) -> int:
        return self._node_next

    def new_edge(self, tail: Node, head: Node, length: int) -> Edge:
        e = Edge(self._edge_next, tail, head, length)
        self._edge_next += 1
        self.edges.append(e)
        return e

    def new_node_pair(
        self, name: str, codes: np.ndarray, seq_id: int = -1, coverage: int = 0
    ) -> tuple[Node, Node]:
        """Create a node and its reverse complement (construct.cc:589-611)."""
        fwd = self.new_node(name, codes, seq_id)
        rc = self.new_node(name, reverse_complement(codes), seq_id)
        fwd.pair = rc
        rc.pair = fwd
        fwd.coverage = rc.coverage = coverage
        return fwd, rc

    def new_edge_pair(
        self, tail: Node, head: Node, length: int, length_pair: int
    ) -> tuple[Edge, Edge]:
        e = self.new_edge(tail, head, length)
        rc = self.new_edge(head.pair, tail.pair, length_pair)
        e.pair = rc
        rc.pair = e
        return e, rc

    def live_nodes(self):
        return (n for n in self.nodes if n is not None)

    def live_edges(self):
        return (e for e in self.edges if e is not None)


def make_unitig_node_pair(graph: Graph, begin: Node, end: Node) -> tuple[Node, Node]:
    """Contract the non-branching path begin..end into a unitig node + RC
    (reference graph.cc:27-57 Node(begin, end) ctor + CreateUnitigs call
    site).  Naming: `Utg` if count > 5 and len > min_unitig_size else `Ctg`,
    suffixed with the even id (graph.cc:53-56)."""
    parts = []
    count = 0
    is_circular = begin is end
    it = begin
    while True:
        parts.append(it.outedges[0].label())
        count += it.count
        it = it.outedges[0].head
        if it is end:
            break
    if begin is not end:
        parts.append(end.codes)
        count += end.count
    codes = np.concatenate(parts) if parts else np.empty(0, np.uint8)

    is_unitig = count > 5 and codes.size > GLOBALS.min_unitig_size
    base_id = graph.next_node_index()
    name = ("Utg" if is_unitig else "Ctg") + str(base_id & ~1)

    fwd = graph.new_node(name, codes)
    rc = graph.new_node(name, reverse_complement(codes))
    fwd.pair = rc
    rc.pair = fwd
    for n in (fwd, rc):
        n.count = count
        n.is_unitig = is_unitig
        n.is_circular = is_circular
    return fwd, rc
