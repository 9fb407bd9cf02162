"""Port force-directed layout (raven_tpu_torch.graph.layout) vs raven_tpu's
on components of at least 512 nodes, where both run their device n-body in
float32 (JAX runs with x64 off).  Positions agree within POS_ATOL after a
few iterations; at the full 100 iterations the layout-driven long-edge
removal makes identical decisions.

The n-body is chaotic: a last-bit difference in a float32 sum grows about
2.5x per iteration (measured on the 600-node component below: 1e-7 after
one iteration, 4e-6 after five, 0.06 after twenty, O(1) after a hundred,
the same against the float64 host loop), so positions are compared after
a few iterations, and the 100-iteration check uses a component whose
long/short calls are clear-cut rather than within float noise of the 2x
ratio."""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu.graph import graph as jgraph  # noqa: E402
from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu_torch.graph import graph as tgraph  # noqa: E402
from raven_tpu_torch.graph import layout as tlayout  # noqa: E402

# the graph packages export a function named assemble over the module
jassemble = importlib.import_module("raven_tpu.graph.assemble")
tassemble = importlib.import_module("raven_tpu_torch.graph.assemble")

# float32 sums over ~600 repulsion terms in another order differ in the
# last bits (~1e-7 relative); a few cooling iterations keep that well
# under 1e-4 on coordinates of order 1
POS_ATOL = 1e-4
N = 600


def _component(seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((N, 2))
    ea = np.concatenate([np.arange(N - 1), rng.integers(0, N, 200)])
    eb = np.concatenate([np.arange(1, N), rng.integers(0, N, 200)])
    return pts, ea.astype(np.int64), eb.astype(np.int64)


@pytest.mark.parametrize("iters", [1, 5])
def test_positions_match_jax(iters):
    pts, ea, eb = _component(iters)
    assert N >= tlayout._DEVICE_MIN_NODES
    runs = tlayout.DEVICE_RUNS
    got = tlayout._layout_component(pts.copy(), ea, eb, iters, "cpu")
    assert tlayout.DEVICE_RUNS == runs + 1  # the n-body path, not the host loop
    want = jlayout._layout_component(pts.copy(), ea, eb, iters)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_ATOL)


def _junction_graph(mod, seed=3):
    """A 600-node chain with every 40th node also linked to one hub: one
    junction component above the device threshold.  The hub settles near
    the middle of the layout, so its links come out far longer than twice
    the chain links beside them — a call that stays the same under
    perturbations of the start positions (checked with 1e-6 noise)."""
    rng = np.random.default_rng(seed)
    g = mod.Graph()
    codes = lambda: rng.integers(0, 4, 64).astype(np.uint8)  # noqa: E731
    nodes = [g.new_node_pair(f"n{i}", codes())[0] for i in range(N)]
    hub = g.new_node_pair("hub", codes())[0]
    for i in range(N - 1):
        g.new_edge_pair(nodes[i], nodes[i + 1], 32, 32)
    for i in range(0, N - 1, 40):
        g.new_edge_pair(nodes[i], hub, 32, 32)
    return g


def test_long_edge_decisions_match_jax():
    gj = _junction_graph(jgraph)
    gt = _junction_graph(tgraph)
    jlayout.reset_seed()
    tlayout.reset_seed()
    runs = tlayout.DEVICE_RUNS
    nj = jassemble.remove_long_edges(gj, num_rounds=1)
    nt = tassemble.remove_long_edges(gt, num_rounds=1, device="cpu")
    assert tlayout.DEVICE_RUNS > runs
    removed = lambda g: {i for i, e in enumerate(g.edges) if e is None}  # noqa: E731
    assert nt == nj > 0
    assert removed(gt) == removed(gj)
