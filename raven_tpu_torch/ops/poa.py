"""POA window consensus — dispatch + pure-python oracle.

A copy of raven_tpu/ops/poa.py.  The hot path is the native C++ engine
(raven_tpu_torch/native/poa.cc); a pure-python implementation of the same
algorithm serves as a cross-check oracle and toolchain-free fallback.  The
batched on-device consensus (replacing the reference's CUDA POA path in the
racon dependency) lives in raven_tpu_torch.ops.consensus_device.
"""

from __future__ import annotations

import ctypes

import numpy as np

_POA_FN = None
_POA_TRIED = False


def _native_poa():
    global _POA_FN, _POA_TRIED
    if _POA_FN is not None or _POA_TRIED:
        return _POA_FN
    _POA_TRIED = True
    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    fn = lib.raven_poa_consensus
    fn.restype = ctypes.c_longlong
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [
        u8p, ctypes.c_longlong,  # backbone
        u8p, i64p, i64p,  # frags, offsets, lens
        u8p, ctypes.c_longlong,  # weights, nfrags
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scores, trim
        u8p, ctypes.c_longlong,  # out
    ]
    _POA_FN = fn
    return fn


def poa_consensus(
    backbone: np.ndarray,
    fragments: list[np.ndarray],
    weights: list[np.ndarray] | None = None,
    match: int = 3,
    mismatch: int = -5,
    gap: int = -4,
    trim: bool = True,
) -> np.ndarray:
    """Consensus of fragments against a backbone window."""
    backbone = np.ascontiguousarray(backbone, dtype=np.uint8)
    if not fragments:
        return backbone.copy()
    fn = _native_poa()
    if fn is None:
        return poa_consensus_py(
            backbone, fragments, weights, match, mismatch, gap, trim
        )
    flat = np.concatenate([np.ascontiguousarray(f, np.uint8) for f in fragments])
    lens = np.array([f.size for f in fragments], dtype=np.int64)
    offs = np.zeros(len(fragments), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    if weights is not None:
        wflat = np.concatenate(
            [np.ascontiguousarray(w, np.uint8) for w in weights]
        )
        wptr = wflat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        wflat = None
        wptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    out_cap = backbone.size * 2 + flat.size + 64
    out = np.zeros(out_cap, dtype=np.uint8)
    n = fn(
        backbone.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        backbone.size,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        wptr,
        len(fragments),
        match,
        mismatch,
        gap,
        1 if trim else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_cap,
    )
    if n < 0:
        return backbone.copy()
    return out[:n].copy()


# --------------------------------------------------------------------------
# pure-python oracle (same algorithm as native/poa.cc)
# --------------------------------------------------------------------------


class _PyPoa:
    def __init__(self):
        self.ch: list[int] = []
        self.ring: list[int] = []  # aligned ring next pointer (-1 none)
        self.support: list[int] = []
        self.in_edges: list[list[int]] = []
        self.out_edges: list[list[int]] = []
        self.e_tail: list[int] = []
        self.e_head: list[int] = []
        self.e_weight: list[int] = []

    def add_node(self, c: int) -> int:
        self.ch.append(int(c))
        self.ring.append(-1)
        self.support.append(0)
        self.in_edges.append([])
        self.out_edges.append([])
        return len(self.ch) - 1

    def add_edge(self, t: int, h: int, w: int) -> None:
        for eid in self.out_edges[t]:
            if self.e_head[eid] == h:
                self.e_weight[eid] += w
                return
        eid = len(self.e_tail)
        self.e_tail.append(t)
        self.e_head.append(h)
        self.e_weight.append(w)
        self.out_edges[t].append(eid)
        self.in_edges[h].append(eid)

    def topo(self) -> list[int]:
        n = len(self.ch)
        indeg = [len(self.in_edges[i]) for i in range(n)]
        queue = [i for i in range(n) if indeg[i] == 0]
        order = []
        qh = 0
        while qh < len(queue):
            v = queue[qh]
            qh += 1
            order.append(v)
            for eid in self.out_edges[v]:
                h = self.e_head[eid]
                indeg[h] -= 1
                if indeg[h] == 0:
                    queue.append(h)
        return order


def poa_consensus_py(
    backbone, fragments, weights=None, match=3, mismatch=-5, gap=-4, trim=True
):
    g = _PyPoa()
    prev = g.add_node(backbone[0])
    g.support[prev] = 1
    for c in backbone[1:]:
        cur = g.add_node(c)
        g.support[cur] = 1
        g.add_edge(prev, cur, 2)
        prev = cur

    NEG = -(1 << 30)
    for fi, frag in enumerate(fragments):
        m = frag.size
        if m == 0:
            continue
        w = weights[fi] if weights is not None else None
        order = g.topo()
        rank = {v: r for r, v in enumerate(order)}
        V = len(order)
        H = np.full((V + 1, m + 1), NEG, dtype=np.int32)
        mv = np.zeros((V + 1, m + 1), dtype=np.int8)
        frm = np.zeros((V + 1, m + 1), dtype=np.int32)
        H[0] = np.arange(m + 1) * gap
        mv[0] = 2
        fragv = frag.astype(np.int32)
        for r in range(V):
            node = order[r]
            row = H[r + 1]
            preds = (
                [-1]
                if not g.in_edges[node]
                else [rank[g.e_tail[e]] for e in g.in_edges[node]]
            )
            for pr in preds:
                prow = H[pr + 1]
                up = prow + gap
                better = up > row
                row[better] = up[better]
                mv[r + 1][better] = 1
                frm[r + 1][better] = pr
                sc = np.where(fragv == g.ch[node], match, mismatch)
                diag = prow[:-1] + sc
                better = diag > row[1:]
                row[1:][better] = diag[better]
                mv[r + 1, 1:][better] = 0
                frm[r + 1, 1:][better] = pr
            # free start at any node (graph-local alignment; matches the
            # native engine's window-fragment semantics)
            if row[0] < 0:
                row[0] = 0
                mv[r + 1, 0] = 3
            # left closure (sequential max with gap) via prefix-max trick
            idx = np.arange(m + 1, dtype=np.int64)
            closed = np.maximum.accumulate(row - idx * gap) + idx * gap
            left = closed > row
            row[left] = closed[left]
            mv[r + 1][left] = 2

        best_r = int(np.argmax(H[1:, m])) if V else -1
        r, j = best_r, m
        path = []
        while r != -1 or j != 0:
            if r == -1:
                path.append((-1, j - 1))
                j -= 1
                continue
            mvv = mv[r + 1, j]
            if mvv == 3:
                break  # free-start marker
            if mvv == 0:
                path.append((order[r], j - 1))
                r = int(frm[r + 1, j])
                j -= 1
            elif mvv == 1:
                r = int(frm[r + 1, j])
            else:
                path.append((-1, j - 1))
                j -= 1
        path.reverse()

        prev_node = -1
        prev_j = -1
        for node_id, jj in path:
            c = int(frag[jj])
            if node_id != -1 and g.ch[node_id] != c:
                found = -1
                cur = g.ring[node_id]
                while cur != -1 and cur != node_id:
                    if g.ch[cur] == c:
                        found = cur
                        break
                    cur = g.ring[cur]
                if found == -1:
                    fresh = g.add_node(c)
                    nxt = g.ring[node_id]
                    g.ring[node_id] = fresh
                    g.ring[fresh] = node_id if nxt == -1 else nxt
                    node_id = fresh
                else:
                    node_id = found
            elif node_id == -1:
                node_id = g.add_node(c)
            g.support[node_id] += 1
            if prev_node != -1:
                ww = (int(w[prev_j]) + int(w[jj])) if w is not None else 2
                g.add_edge(prev_node, node_id, ww)
            prev_node = node_id
            prev_j = jj

    order = g.topo()
    score = [0] * len(g.ch)
    best_w = [-1] * len(g.ch)
    pred = [-1] * len(g.ch)
    for v in order:
        for eid in g.in_edges[v]:
            ew, t = g.e_weight[eid], g.e_tail[eid]
            if ew > best_w[v] or (
                ew == best_w[v] and pred[v] != -1 and score[t] > score[pred[v]]
            ):
                best_w[v] = ew
                pred[v] = t
        score[v] = (score[pred[v]] if pred[v] != -1 else 0) + max(best_w[v], 0)
    if not order:
        return np.asarray(backbone, np.uint8).copy()
    best_node = max(order, key=lambda v: score[v])
    consensus = []
    v = best_node
    while v != -1:
        consensus.append(v)
        v = pred[v]
    consensus.reverse()

    begin, end = 0, len(consensus)
    nfrags = len(fragments)
    if trim and nfrags >= 2:
        min_support = nfrags // 2
        while begin < end and g.support[consensus[begin]] < min_support:
            begin += 1
        while end > begin and g.support[consensus[end - 1]] < min_support:
            end -= 1
        if begin >= end:
            begin, end = 0, len(consensus)
    return np.array([g.ch[v] for v in consensus[begin:end]], dtype=np.uint8)
