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


def _long_edge_calls(assemble_mod, monkeypatch):
    """Record the edges each long-edge round of `assemble_mod` marks: the
    remove_edges call that follows each layout."""
    calls = []
    layout_fn, remove = assemble_mod.create_force_directed_layout, assemble_mod.remove_edges
    after_layout = [False]

    def lay(graph, *args, **kwargs):
        after_layout[0] = True
        return layout_fn(graph, *args, **kwargs)

    def rem(graph, marked, *args, **kwargs):
        if after_layout[0]:
            calls.append(sorted(marked))
            after_layout[0] = False
        return remove(graph, marked, *args, **kwargs)

    monkeypatch.setattr(assemble_mod, "create_force_directed_layout", lay)
    monkeypatch.setattr(assemble_mod, "remove_edges", rem)
    return calls


@pytest.fixture(scope="module")
def repeat_checkpoint(tmp_path_factory):
    """raven_tpu's construct of a 1 Mb genome at 30x with a repeat family
    (8 copies of an 11 kb element, 2% apart; chip_smoke.py's
    cli-1M-30x-repeats reads), stored as a checkpoint (as
    tests/test_torch_pipeline.py::test_raven_tpu_checkpoint_assembles_the_same
    stores one).  Its long-edge removal lays out components of 640 nodes,
    above the n-body's 512."""
    from raven_tpu.config import OverlapPhaseCfg
    from raven_tpu.graph import Graph, construct_graph
    from raven_tpu.graph.binary import store_graph
    from raven_tpu.io import ReadSet
    from raven_tpu_torch.utils.synth import simulate_reads

    rng = np.random.default_rng(77)
    size, (length, copies, divergence) = 1_000_000, (11_000, 8, 0.02)
    genome = rng.integers(0, 4, size).astype(np.uint8)
    element = rng.integers(0, 4, length).astype(np.uint8)
    for s in np.linspace(size * 0.05, size * 0.95, copies).astype(int):
        r = element.copy()
        m = rng.random(length) < divergence
        r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
        if rng.random() < 0.5:
            r = r[::-1] ^ 3
        genome[s : s + length] = r
    reads = simulate_reads(rng, genome, 30, 9000, 0.025, 0.0125, 0.0125)
    mp = pytest.MonkeyPatch()
    mp.setenv("RAVEN_TPU_DEVICE_MAP", "0")
    try:
        graph = Graph()
        construct_graph(graph, ReadSet.from_sequences(reads), OverlapPhaseCfg())
    finally:
        mp.undo()
    ckpt = str(tmp_path_factory.mktemp("repeats") / "graph.ckpt")
    store_graph(graph, ckpt)
    return ckpt


def _record_n_body_inputs(layout_mod, calls, monkeypatch):
    """Record the components of 512 nodes or more that `layout_mod` lays
    out, as (long-edge round, points, edges_a, edges_b); the round is the
    number of rounds `calls` holds when the layout runs."""
    inputs = []
    component = layout_mod._layout_component

    def lay(points, edges_a, edges_b, *args, **kwargs):
        if len(points) >= 512:
            inputs.append((len(calls), points.copy(), edges_a.copy(), edges_b.copy()))
        return component(points, edges_a, edges_b, *args, **kwargs)

    monkeypatch.setattr(layout_mod, "_layout_component", lay)
    return inputs


def _assemble_both(ckpt, monkeypatch, port_runs=1):
    """Both packages assemble the checkpoint (the port on the CPU): each
    one's unitigs as (name, sequence) and the edges of each long-edge
    round, the components of 512 nodes or more each one lays out (see
    _record_n_body_inputs), and the port's unitigs of every run."""
    from raven_tpu.graph import get_unitigs
    from raven_tpu.graph.binary import load_graph
    from raven_tpu_torch.graph import get_unitigs as t_get_unitigs
    from raven_tpu_torch.graph.binary import load_graph as t_load_graph

    want_calls = _long_edge_calls(jassemble, monkeypatch)
    got_calls = _long_edge_calls(tassemble, monkeypatch)
    want_inputs = _record_n_body_inputs(jlayout, want_calls, monkeypatch)
    got_inputs = _record_n_body_inputs(tlayout, got_calls, monkeypatch)
    want_graph = load_graph(ckpt)
    jlayout.reset_seed()
    jassemble.assemble(want_graph)
    want = [(n.name, n.sequence_str()) for n in get_unitigs(want_graph, False)]
    got = []
    for _ in range(port_runs):
        got_graph = t_load_graph(ckpt)
        tlayout.reset_seed()
        tassemble.assemble(got_graph, device="cpu")
        got.append([(n.name, n.sequence_str()) for n in t_get_unitigs(got_graph, False)])
    return want, got, want_calls, got_calls, want_inputs, got_inputs


def test_repeat_genome_checkpoint_assembles_the_same(repeat_checkpoint, monkeypatch,
                                                     record_property):
    """The repeat genome's checkpoint through both packages' assemble with
    every component on the layout's float64 host loop (the n-body's
    threshold raised in both): the same edges marked in every long-edge
    round and the same unitigs.  Through the n-body the two packages' calls
    part (see the next test)."""
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


@pytest.fixture(scope="module")
def repeat_n_body(repeat_checkpoint):
    """The repeat checkpoint through both packages' assemble with the
    components of 512 nodes or more on their float32 n-body, the port's
    twice: _assemble_both's results and the port's n-body runs, once for
    the tests that read them."""
    mp = pytest.MonkeyPatch()
    try:
        runs = tlayout.DEVICE_RUNS
        out = _assemble_both(repeat_checkpoint, mp, port_runs=2)
        return out, tlayout.DEVICE_RUNS - runs
    finally:
        mp.undo()


def test_repeat_genome_n_body_runs_reproducibly(repeat_n_body, record_property):
    """The same checkpoint with the components of 512 nodes or more on
    both packages' float32 n-body: both lay out the same components from
    the same start points in the first round, the port's n-body holds
    raven_tpu's positions within POS_ATOL after 1 and 5 iterations on each
    of them, and the port gives the same unitigs on a second run.  The two
    packages' long-edge calls part from the first round on: over the 100
    iterations the n-body is chaotic (the module docstring), and
    raven_tpu's own unitigs differ between its n-body and its float64 host
    loop on this genome.  The rounds and edges that differ, and both
    unitig lengths, are recorded as properties of this test."""
    j_n_body, t_n_body = jlayout._layout_component, tlayout._layout_component
    (want, got, want_calls, got_calls, want_inputs, got_inputs), n_body_runs = repeat_n_body
    assert n_body_runs >= 2
    assert got[0] == got[1]
    assert len(got_calls) == 2 * len(want_calls)
    first = [[x[1:] for x in inputs if x[0] == 0] for inputs in (want_inputs, got_inputs)]
    assert len(first[0]) == len(first[1]) > 0
    for (pj, aj, bj), (pt, at, bt) in zip(*first):
        assert np.array_equal(pj, pt) and np.array_equal(aj, at) and np.array_equal(bj, bt)
        for iters in (1, 5):
            np.testing.assert_allclose(t_n_body(pt.copy(), at, bt, iters, "cpu"),
                                       j_n_body(pj.copy(), aj, bj, iters), rtol=0, atol=POS_ATOL)
    record_property("first_round_n_body_sizes", [len(p) for p, _, _ in first[0]])
    differ = [(i, sorted(set(g) ^ set(w)))
              for i, (g, w) in enumerate(zip(got_calls, want_calls)) if g != w]
    record_property("long_edge_calls_differ", differ)
    record_property("unitig_lengths", {"raven_tpu": [len(s) for _, s in want],
                                       "port": [len(s) for _, s in got[0]]})


@pytest.mark.xfail(strict=True, reason=(
    "the float32 n-body is chaotic over 100 iterations, and the two packages "
    "sum in another order: their long-edge calls, and so their unitigs, part "
    "on this genome (ROADMAP Queue 3 item 3)"))
def test_repeat_genome_n_body_unitigs_match_jax(repeat_n_body):
    """The gap that test_repeat_genome_n_body_runs_reproducibly records,
    kept visible: through the n-body, the port's unitigs on the repeat
    checkpoint are raven_tpu's.  Expected to fail until the n-body's
    summation order is raven_tpu's (or the repeat cell is held to other
    contigs); a pass fails the run, so the day they agree is seen."""
    (want, got, *_), _ = repeat_n_body
    assert got[0] == want
