"""Force-directed graph layout (Fruchterman-Reingold).

Reference: CreateForceDirectedLayout (RavenLib/src/assemble.cc:357-698),
which uses a Barnes-Hut quadtree over a thread pool.  This design computes
the exact dense O(n^2) repulsion as batched array ops — on accelerators the
dense form is faster than tree traversal for the component sizes seen after
CreateUnitigs(42), and it is exact rather than approximated.  The torch
port of raven_tpu/graph/layout.py: large components run on the device in
float32, as the JAX reference does with x64 off.

Determinism: the reference seeds a static mt19937 with 21 and left-shifts
the seed on every invocation (assemble.cc:405-408).  We reproduce the seed
schedule (21 << n on the n-th call) with numpy's PCG64; layouts are
deterministic run-to-run for our implementation (bit-parity with the C++
RNG stream is not a goal — weights only feed a relative 2x comparison).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from raven_tpu_torch.device import resolve_device

_seed_state = {"seed": 21}


def _next_seed() -> int:
    _seed_state["seed"] <<= 1
    return _seed_state["seed"]


def reset_seed(value: int = 21) -> None:
    _seed_state["seed"] = value


# components at least this large run the device n-body (blocked
# O(n * blk) memory); smaller ones run as plain numpy on the host
_DEVICE_MIN_NODES = 512
# device n-body runs in this process (a run reads it to show the layout
# went through the device)
DEVICE_RUNS = 0
# above this, the [n, n, 2] host materialization is replaced by the
# blocked host loop (memory-safe at any n)
_HOST_DENSE_MAX = 4096


def _layout_component_host(
    points: np.ndarray, edges_a: np.ndarray, edges_b: np.ndarray, num_iterations: int
) -> np.ndarray:
    """Host FDL iterations (exact dense repulsion).

    points: [n, 2]; edges_a/b: int arrays of point indices for every
    attractive link (graph edges + transitive hints), directed per node as in
    the reference (each node accumulates attraction towards each neighbour).
    Repulsion is computed in row blocks so memory stays O(n * blk).
    """
    n = points.shape[0]
    k = np.sqrt(1.0 / n)
    t = 0.1
    dt = t / (num_iterations + 1)
    blk = n if n <= _HOST_DENSE_MAX else 1024
    rows = np.arange(n)

    for _ in range(num_iterations):
        repulse = np.zeros_like(points)
        for r0 in range(0, n, blk):
            r1 = min(r0 + blk, n)
            delta = points[r0:r1, None, :] - points[None, :, :]
            dist2 = (delta**2).sum(-1)
            self_col = rows[None, :] == rows[r0:r1, None]
            dist2[self_col] = 1.0
            inv = (k * k) / np.maximum(dist2, 1e-8)
            inv[self_col] = 0.0
            repulse[r0:r1] = (delta * inv[:, :, None]).sum(axis=1)

        # attraction along links: displacement += delta * (-dist / k)
        d_ab = points[edges_a] - points[edges_b]
        dist = np.sqrt((d_ab**2).sum(-1))
        dist = np.maximum(dist, 0.01)
        contrib = d_ab * (-dist / k)[:, None]
        attract = np.zeros_like(points)
        np.add.at(attract, edges_a, contrib)

        disp = repulse + attract
        length = np.sqrt((disp**2).sum(-1))
        length = np.where(length < 0.01, 0.1, length)  # reference quirk :594-597
        points = points + disp * (t / length)[:, None]
        t -= dt
    return points


def _attraction_slots(n: int, edges_a: np.ndarray, edges_b: np.ndarray):
    """[n, D] partner index per node and attraction link (-1 = none), in
    link order: the device sums each node's attraction over its slots in
    a fixed order, so the layout is deterministic run to run (a scatter-add
    with atomics is not)."""
    order = np.argsort(edges_a, kind="stable")
    a = edges_a[order]
    deg = np.bincount(a, minlength=n)
    D = max(1, int(deg.max(initial=0)))
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(a.size) - first[a]
    out = np.full((n, D), -1, dtype=np.int64)
    out[a, slot] = edges_b[order]
    return out


def _layout_component_device(
    points: np.ndarray,
    edges_a: np.ndarray,
    edges_b: np.ndarray,
    num_iterations: int,
    device,
) -> np.ndarray:
    """Device FDL iterations in float32 (the port of raven_tpu's jitted
    n-body, _device_layout_fn): exact dense repulsion in row blocks of
    O(blk * n) memory, a Python loop over the iterations.  The answer to
    the reference's Barnes-Hut + thread pool (assemble.cc:357-698): dense
    and exact instead of theta-approximated."""
    global DEVICE_RUNS
    n = points.shape[0]
    f32 = torch.float32
    pts = torch.as_tensor(points, dtype=f32, device=device)
    k = torch.sqrt(torch.tensor(1.0, dtype=f32, device=device) / n)
    kk = k * k
    slots = torch.as_tensor(
        _attraction_slots(n, np.asarray(edges_a), np.asarray(edges_b)),
        device=device,
    )
    linked = slots >= 0
    partner = slots.clamp(min=0)
    blk = max(1, min(n, (1 << 26) // n))
    rows = torch.arange(n, device=device)
    t = torch.tensor(0.1, dtype=f32, device=device)
    dt = 0.1 / (num_iterations + 1)
    for _ in range(num_iterations):
        repulse = torch.empty_like(pts)
        for r0 in range(0, n, blk):
            r1 = min(r0 + blk, n)
            delta = pts[r0:r1, None, :] - pts[None, :, :]
            dist2 = (delta**2).sum(-1)
            inv = kk / torch.clamp(dist2, min=1e-8)
            inv = torch.where(rows[None, :] == rows[r0:r1, None], 0.0, inv)
            repulse[r0:r1] = (delta * inv[:, :, None]).sum(dim=1)

        # attraction along links: displacement += delta * (-dist / k)
        d_ab = pts[:, None, :] - pts[partner]
        dist = torch.clamp(torch.sqrt((d_ab**2).sum(-1)), min=0.01)
        contrib = d_ab * torch.where(linked, -dist / k, 0.0)[:, :, None]
        attract = contrib.sum(dim=1)

        disp = repulse + attract
        length = torch.sqrt((disp**2).sum(-1))
        length = torch.where(length < 0.01, 0.1, length)
        pts = pts + (t / length)[:, None] * disp
        t = t - dt
    DEVICE_RUNS += 1
    return pts.cpu().numpy()


def _layout_component(
    points: np.ndarray,
    edges_a: np.ndarray,
    edges_b: np.ndarray,
    num_iterations: int,
    device=None,
) -> np.ndarray:
    """Route one component to the device n-body (large) or host (small)."""
    if points.shape[0] >= _DEVICE_MIN_NODES:
        return _layout_component_device(
            points, edges_a, edges_b, num_iterations, resolve_device(device)
        )
    return _layout_component_host(points, edges_a, edges_b, num_iterations)


def create_force_directed_layout(
    graph, path: str = "", num_iterations: int = 100, device=None
):
    """Assign 2-D layout distances to edge weights (assemble.cc:357-698).
    Components of _DEVICE_MIN_NODES or more run the n-body on `device`.

    Components smaller than 6 canonical nodes or without junctions are
    skipped; transitive hints are pruned to the component.  When `path` is
    given, a JSON dump compatible with misc/plotter.py is written.
    """
    # connected components over canonical (even) node ids
    components: list[list[int]] = []
    is_visited: set[int] = set()
    for i, node in enumerate(graph.nodes):
        if node is None or i in is_visited:
            continue
        comp = set()
        que = [i]
        while que:
            j = que.pop(0)
            if j in is_visited:
                continue
            n = graph.nodes[j]
            is_visited.add(n.id)
            is_visited.add(n.pair.id)
            comp.add((n.id >> 1) << 1)
            for e in n.inedges:
                que.append(e.tail.id)
            for e in n.outedges:
                que.append(e.head.id)
        components.append(sorted(comp))

    components.sort(key=len, reverse=True)

    rng = np.random.default_rng(_next_seed())
    dump = {}
    comp_counter = 0

    for component in components:
        if len(component) < 6:
            continue
        if not any(graph.nodes[c].is_junction for c in component):
            continue

        comp_set = set(component)
        for c in component:  # prune transitive hints to the component
            node = graph.nodes[c]
            node.transitive = {m for m in node.transitive if m in comp_set}

        local = {c: idx for idx, c in enumerate(component)}
        points = rng.random((len(component), 2))

        ea, eb = [], []
        for c in component:
            node = graph.nodes[c]
            for e in node.inedges:
                ea.append(local[c])
                eb.append(local[(e.tail.id >> 1) << 1])
            for e in node.outedges:
                ea.append(local[c])
                eb.append(local[(e.head.id >> 1) << 1])
            for m in node.transitive:
                ea.append(local[c])
                eb.append(local[m])
        ea = np.array(ea, dtype=np.int64)
        eb = np.array(eb, dtype=np.int64)

        points = _layout_component(points, ea, eb, num_iterations, device)

        for e in graph.live_edges():
            if e.id & 1:
                continue
            a = (e.tail.id >> 1) << 1
            b = (e.head.id >> 1) << 1
            if a in comp_set and b in comp_set:
                w = float(np.hypot(*(points[local[a]] - points[local[b]])))
                e.weight = w
                e.pair.weight = w

        if path:
            nodes_json = {
                str(c): [
                    float(points[local[c]][0]),
                    float(points[local[c]][1]),
                    1 if graph.nodes[c].is_junction else 0,
                    graph.nodes[c].count,
                ]
                for c in component
            }
            edges_json = []
            for c in component:
                node = graph.nodes[c]
                for e in node.inedges:
                    o = (e.tail.id >> 1) << 1
                    if c >= o:
                        edges_json.append([str(c), str(o), 0])
                for e in node.outedges:
                    o = (e.head.id >> 1) << 1
                    if c >= o:
                        edges_json.append([str(c), str(o), 0])
                for o in node.transitive:
                    if c >= o:
                        edges_json.append([str(c), str(o), 1])
            dump[f"component_{comp_counter}"] = {
                "nodes": nodes_json,
                "edges": edges_json,
            }
            comp_counter += 1

    if path:
        with open(path, "w") as fh:
            json.dump(dump, fh, indent=4)
