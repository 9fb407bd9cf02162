"""Port force-directed layout (raven_tpu_torch.graph.layout) vs raven_tpu's
on components of at least 512 nodes, where both run their device n-body in
float32 (JAX runs with x64 off) and the port rounds as raven_tpu's jitted
loop does, in its order: positions agree bit for bit
(tests/test_torch_layout_n_body.py), and the layout-driven long-edge
removal makes identical decisions.

The n-body is chaotic: a last-bit difference in a float32 sum grows about
2.5x per iteration (measured on the 600-node component below: 1e-7 after
one iteration, 4e-6 after five, 0.06 after twenty, O(1) after a hundred,
the same against the float64 host loop), so the 100-iteration check here
also uses a component whose long/short calls are clear-cut rather than
within float noise of the 2x ratio."""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu.graph import graph as jgraph  # noqa: E402
from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu_torch.graph import graph as tgraph  # noqa: E402
from raven_tpu_torch.graph import layout as tlayout  # noqa: E402
from tests.torch_layout_repeats import (  # noqa: E402, F401
    _assemble_both, _one_torch_thread, repeat_checkpoint,
)

# the graph packages export a function named assemble over the module
jassemble = importlib.import_module("raven_tpu.graph.assemble")
tassemble = importlib.import_module("raven_tpu_torch.graph.assemble")

N = 600


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


def test_repeat_genome_checkpoint_assembles_the_same(repeat_checkpoint, monkeypatch,
                                                     record_property):
    """The repeat genome's checkpoint through both packages' assemble with
    every component on the layout's float64 host loop (the n-body's
    threshold raised in both): the same edges marked in every long-edge
    round and the same unitigs.  Through the n-body they agree as well
    (tests/test_torch_layout_n_body.py)."""
    monkeypatch.setattr(jlayout, "_DEVICE_MIN_NODES", 1 << 30)
    monkeypatch.setattr(tlayout, "_DEVICE_MIN_NODES", 1 << 30)
    runs = tlayout.DEVICE_RUNS
    want, (got,), want_calls, got_calls, want_inputs, _ = _assemble_both(
        repeat_checkpoint, monkeypatch
    )
    assert want_inputs and tlayout.DEVICE_RUNS == runs
    differ = [(i, sorted(set(g) ^ set(w)))
              for i, (g, w) in enumerate(zip(got_calls, want_calls)) if g != w]
    assert len(got_calls) == len(want_calls) and not differ, (
        f"long-edge calls differ: (round, edges marked by one package only) {differ[:4]}"
    )
    assert len(want) >= 1
    assert got == want
    record_property("unitig_lengths", [len(s) for _, s in got])
