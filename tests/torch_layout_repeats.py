"""Set-up shared by tests/test_torch_layout.py and
tests/test_torch_layout_n_body.py: one torch thread a worker, the repeat
genome's checkpoint (built once a run), and both packages' assemble of it
with the long-edge rounds and the n-body's inputs recorded."""

import fcntl
import importlib
import os

import numpy as np
import pytest
import torch

from raven_tpu.graph import layout as jlayout
from raven_tpu_torch.graph import layout as tlayout

# the graph packages export a function named assemble over the module
jassemble = importlib.import_module("raven_tpu.graph.assemble")
tassemble = importlib.import_module("raven_tpu_torch.graph.assemble")


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


def _build_repeat_checkpoint(path: str) -> None:
    """raven_tpu's construct of a 1 Mb genome at 30x with a repeat family
    (8 copies of an 11 kb element, 2% apart; chip_smoke.py's
    cli-1M-30x-repeats reads), stored as a checkpoint at `path` (as
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
    store_graph(graph, path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other (the n-body's
    [N, N] terms take as long on one thread when the process runs alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def repeat_checkpoint(tmp_path_factory):
    """The path of _build_repeat_checkpoint's checkpoint, built once a run:
    the test files that read it (tests/test_torch_layout.py and
    tests/test_torch_layout_n_body.py) share it across the run's xdist
    workers through the workers' common temporary root, under a lock."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # every worker's base lies in the run's root
    cache = root / "repeat_genome"
    cache.mkdir(exist_ok=True)
    path = str(cache / "graph.ckpt")
    with open(cache / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (cache / "done").exists():
                _build_repeat_checkpoint(path)
                (cache / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


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
