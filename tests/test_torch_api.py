"""The port's Python API (raven_tpu_torch.api, the ravenpy mirror) and CLI
on the CPU: ports of tests/test_cli_api.py and tests/test_serialization.py
through raven_tpu_torch with device="cpu" (--device cpu), and beyond their
own assertions, the API's sub-stage path against raven_tpu.api's on the
same reads: the per-read overlaps and the overlaps kept for the graph,
array for array, and the GFA after remove_long_edges_from_graph, byte for
byte.  The λ-phage run is marked lambda_e2e and needs the bundled data."""

import inspect
import io
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu import api as japi  # noqa: E402
from raven_tpu import config as jconfig  # noqa: E402
from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu_torch import api  # noqa: E402
from raven_tpu_torch import config as tconfig  # noqa: E402
from raven_tpu_torch.graph import layout  # noqa: E402
from raven_tpu_torch.graph.binary import load_graph, store_graph  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex  # noqa: E402
from tests.conftest import random_genome, requires_lambda, sample_reads  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    """The CLIs set their package's process-wide settings (-t, -u): restore
    them, or later tests in this process run with one worker."""
    for g in (jconfig.GLOBALS, tconfig.GLOBALS):
        for name in ("num_threads", "min_unitig_size"):
            monkeypatch.setattr(g, name, getattr(g, name))


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    """tests/test_cli_api.py's reads: a 20 kb genome, 160 reads of 3 kb at
    3% error."""
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 20000)
    reads, _ = sample_reads(rng, genome, 160, 3000, error=0.03)
    path = tmp_path_factory.mktemp("data") / "reads.fasta"
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n")
            fh.write("".join("ACGT"[c] for c in r) + "\n")
    return str(path), genome


def _build(rng):
    """tests/test_serialization.py's _build: 150 reads of 3 kb at 3% error
    from a 20 kb genome, constructed."""
    genome = random_genome(rng, 20000)
    reads, _ = sample_reads(rng, genome, 150, 3000, error=0.03)
    rs = api.ReadSet.from_sequences(reads)
    graph = api.Graph()
    api.construct_graph(graph, rs, cfg=api.OverlapPhaseCfg(), device="cpu")
    return rs, graph


def test_api_names_and_signatures():
    """Every name of raven_tpu.api's __all__, with its signature; the calls
    that reach device work add `device` last."""
    assert api.__all__ == japi.__all__
    with_device = {"construct_graph", "assemble_graph", "polish_graph",
                   "remove_long_edges_from_graph"}
    for name in japi.__all__:
        want, got = getattr(japi, name), getattr(api, name)
        if not inspect.isfunction(want):
            continue
        want_p = list(inspect.signature(want).parameters)
        got_p = list(inspect.signature(got).parameters)
        assert got_p == want_p + (["device"] if name in with_device else []), name


# ------------------------------------------------ tests/test_cli_api.py ports
def test_api_whole_phases(reads_file):
    path, _ = reads_file
    readset = api.load_sequences([path])
    graph = api.Graph()
    api.construct_graph(graph, readset, device="cpu")
    api.assemble_graph(graph, device="cpu")
    api.polish_graph(graph, readset, cfg=api.PolishCfg(num_rounds=1), device="cpu")
    buf = io.StringIO()
    api.graph_print_unitigs(graph, 0, file=buf)
    out = buf.getvalue()
    assert out.startswith(">")
    assert "LN:i:" in out


def _substages(mod, path, tmp_path, tag, **dev):
    """The sub-stage path of tests/test_cli_api.py:40 through `mod` (the
    port's api or raven_tpu's): (handle, graph, GFA bytes)."""
    readset = mod.load_sequences([path])
    graph = mod.Graph()
    index = mod.MinimizerIndex(15, 5, **dev)
    handle = mod.OverlapsHandle(readset)
    mod.find_overlaps_and_create_piles(index, readset, graph, handle)
    assert sum(o.size for o in handle.overlaps) > 0
    mod.trim_and_annotate_piles(graph, handle)
    mod.resolve_contained_reads(graph, handle, readset)
    mod.resolve_chimeric_sequences(graph, handle)
    mod.find_overlaps_and_repetitive_regions(index, graph, handle, readset)
    mod.resolve_repeat_induced_overlaps(graph, handle, readset)
    mod.construct_assembly_graph(graph, handle, readset)
    assert any(n is not None for n in graph.nodes)
    mod.remove_transitive_edges_from_graph(graph)
    mod.remove_tips_and_bubbles_from_graph(graph)
    mod.remove_long_edges_from_graph(graph, **dev)
    gfa = str(tmp_path / f"{tag}.gfa")
    mod.graph_print_gfa(graph, gfa)
    with open(gfa, "rb") as fh:
        return handle, graph, fh.read()


def test_api_substages(reads_file, tmp_path, monkeypatch):
    """The sub-stages on the port's device index (the plain K1 on the CPU)
    give raven_tpu.api's overlaps and GFA."""
    path, _ = reads_file
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MIN_BASES", 0)
    declines = MinimizerIndex.host_declines
    layout.reset_seed()
    handle, graph, gfa = _substages(api, path, tmp_path, "port", device="cpu")
    assert MinimizerIndex.host_declines == declines
    unitigs = api.get_unitigs(graph)
    assert len(unitigs) >= 1
    jlayout.reset_seed()
    jhandle, _, jgfa = _substages(japi, path, tmp_path, "raven_tpu")
    assert len(handle.overlaps) == len(jhandle.overlaps)
    for a, b in zip(handle.overlaps, jhandle.overlaps):
        assert np.array_equal(a, b)
    assert handle.all_overlaps.size > 0
    assert np.array_equal(handle.all_overlaps, jhandle.all_overlaps)
    assert gfa.startswith(b"S\t") and gfa == jgfa


def _cli(argv, monkeypatch):
    """The port's CLI on the CPU: (exit code, stdout)."""
    from raven_tpu_torch.cli import main

    out = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "stdout", out)
        rc = main([*argv, "--device", "cpu"])
    return rc, out.getvalue()


def test_cli_end_to_end(reads_file, tmp_path, monkeypatch):
    path, _ = reads_file
    monkeypatch.chdir(tmp_path)
    gfa = str(tmp_path / "out.gfa")
    ugfa = str(tmp_path / "unitigs.gfa")
    rc, fasta = _cli(
        [path, "-p", "0", "--disable-checkpoints", "-F", gfa, "-U", ugfa, "-u", "5000"],
        monkeypatch,
    )
    assert rc == 0
    assert fasta.startswith(">")
    assert os.path.getsize(gfa) > 0
    assert os.path.getsize(ugfa) > 0


def test_cli_resume(reads_file, tmp_path, monkeypatch):
    path, _ = reads_file
    monkeypatch.chdir(tmp_path)
    layout.reset_seed()
    rc, out1 = _cli([path, "-p", "0", "-u", "5000"], monkeypatch)
    assert rc == 0
    assert os.path.exists("raven_tpu.ckpt")
    layout.reset_seed()
    rc, out2 = _cli([path, "-p", "0", "-u", "5000", "--resume"], monkeypatch)
    assert rc == 0
    assert out1 == out2


def test_cli_version():
    from raven_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0


# -------------------------------------------- tests/test_serialization.py ports
def test_checkpoint_roundtrip(tmp_path):
    rs, graph = _build(np.random.default_rng(32))
    ckpt = str(tmp_path / "test.ckpt")
    store_graph(graph, ckpt)
    loaded = load_graph(ckpt)

    assert loaded.stage == graph.stage
    assert len(loaded.nodes) == len(graph.nodes)
    assert len(loaded.edges) == len(graph.edges)
    for a, b in zip(graph.nodes, loaded.nodes):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.id == b.id and a.name == b.name
            assert np.array_equal(a.codes, b.codes)
            assert b.pair is not None and b.pair.id == a.pair.id
    for a, b in zip(graph.edges, loaded.edges):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.length == b.length
            assert a.tail.id == b.tail.id and a.head.id == b.head.id
    assert np.array_equal(graph.piles.data, loaded.piles.data)
    assert np.array_equal(graph.piles.begin, loaded.piles.begin)


def test_checkpoint_resume_equality(tmp_path, monkeypatch):
    """Assembling straight through vs reloading between phases gives the
    same contigs (reference raven_test.cpp:69-95 Checkpoints test)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(57)
    genome = random_genome(rng, 20000)
    reads, _ = sample_reads(rng, genome, 150, 3000, error=0.03)
    rs = api.ReadSet.from_sequences(reads)

    layout.reset_seed()
    g1 = api.Graph()
    api.construct_graph(g1, rs, device="cpu")
    api.assemble_graph(g1, device="cpu")
    u1 = api.get_unitigs(g1)

    layout.reset_seed()
    g = api.Graph()
    api.construct_graph(g, rs, checkpoints=True, device="cpu")
    g = load_graph()
    api.assemble_graph(g, checkpoints=True, device="cpu")
    g = load_graph()
    u2 = api.get_unitigs(g)

    assert len(u1) == len(u2) > 0
    for a, b in zip(u1, u2):
        assert np.array_equal(a.codes, b.codes)


def test_gfa_roundtrip(tmp_path):
    rs, graph = _build(np.random.default_rng(86))
    gfa_path = str(tmp_path / "graph.gfa")
    api.graph_print_gfa(graph, gfa_path)
    loaded = api.graph_load_gfa(gfa_path)
    assert loaded.stage == -3

    orig_lines = api.graph_get_gfa(graph, include_dp=True)
    orig_s = sorted(line.split("\t")[1] for line in orig_lines if line.startswith("S"))
    loaded_names = sorted(n.name for n in loaded.live_nodes() if not n.is_rc)
    assert orig_s == loaded_names

    orig_l = [
        line
        for line in orig_lines
        if line.startswith("L") and not line.split("\t")[1] == line.split("\t")[3]
    ]
    assert len([e for e in loaded.edges if e is not None]) == len(orig_l)


def test_unitig_gfa_and_json(tmp_path):
    import json

    rs, graph = _build(np.random.default_rng(110))
    api.assemble_graph(graph, device="cpu")
    ugfa = str(tmp_path / "unitigs.gfa")
    api.graph_print_unitig_gfa(graph, ugfa)
    assert os.path.getsize(ugfa) > 0
    pj = str(tmp_path / "piles.json")
    api.graph_print_json(graph, pj)
    with open(pj) as fh:
        piles = json.load(fh)
    assert len(piles) > 0
    first = next(iter(piles.values()))
    assert "data_" in first and "median_" in first


def test_checkpoint_resume_through_polish(tmp_path, monkeypatch):
    """Reload the checkpoint between construct, assemble and every polish
    round: the final contigs equal the straight-through run's bit for bit
    (raven_test.cpp:69-95)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(127)
    genome = random_genome(rng, 20000)
    reads, _ = sample_reads(rng, genome, 150, 3000, error=0.05)
    rs = api.ReadSet.from_sequences(reads)
    cfg = api.PolishCfg(num_rounds=2)

    layout.reset_seed()
    g1 = api.Graph()
    api.construct_graph(g1, rs, device="cpu")
    api.assemble_graph(g1, device="cpu")
    api.polish_graph(g1, rs, cfg=cfg, device="cpu")
    u1 = api.get_unitigs(g1, drop_unpolished=True)

    layout.reset_seed()
    g = api.Graph()
    api.construct_graph(g, rs, checkpoints=True, device="cpu")
    g = load_graph()
    api.assemble_graph(g, checkpoints=True, device="cpu")
    g = load_graph()
    api.polish_graph(g, rs, checkpoints=True, cfg=cfg, device="cpu")
    g = load_graph()
    api.polish_graph(g, rs, checkpoints=True, cfg=cfg, device="cpu")  # stage == rounds
    u2 = api.get_unitigs(g, drop_unpolished=True)

    assert len(u1) == len(u2) > 0
    for a, b in zip(u1, u2):
        assert np.array_equal(a.codes, b.codes)


def test_gfa_line_format():
    """Byte-level line shapes of the reference writers
    (graph_repr.cc:19-64): S with LN/RC(/dp) tags, L with <overlap>M."""
    import re

    from raven_tpu_torch.io import encode

    g = api.Graph()
    n1, _ = g.new_node_pair("r1", encode("ACGTACGTAC"))
    n2, _ = g.new_node_pair("r2", encode("GTACGGGTTT"))
    g.new_edge_pair(n1, n2, 6, 6)
    n1.is_circular = True
    lines = api.get_gfa(g, include_dp=True)
    s_lines = [ln for ln in lines if ln.startswith("S\t")]
    l_lines = [ln for ln in lines if ln.startswith("L\t")]
    assert re.fullmatch(r"S\tr1\tACGTACGTAC\tLN:i:10\tRC:i:1\tdp:f:\d+", s_lines[0])
    assert "L\tr1\t+\tr1\t+\t0M" in l_lines
    assert "L\tr1\t+\tr2\t+\t4M" in l_lines


def test_checkpoint_is_inert_data(tmp_path):
    """The checkpoint archive is inert (npz + JSON): loading never
    unpickles, and corrupt or foreign files raise cleanly."""
    import json
    import pickle
    import zipfile

    g = api.Graph()
    g.stage = -3
    path = str(tmp_path / "ck.ckpt")
    store_graph(g, path)
    with zipfile.ZipFile(path) as zf:
        assert set(zf.namelist()) == {"MANIFEST.json", "arrays.npz"}
        manifest = json.loads(zf.read("MANIFEST.json"))
        assert manifest["magic"] == "raven_tpu-checkpoint"
        np.load(io.BytesIO(zf.read("arrays.npz")), allow_pickle=False)

    evil = str(tmp_path / "evil.ckpt")
    with open(evil, "wb") as fh:
        pickle.dump({"stage": 0}, fh)
    with pytest.raises((ValueError, zipfile.BadZipFile)):
        load_graph(evil)

    bad = str(tmp_path / "bad.ckpt")
    with zipfile.ZipFile(bad, "w") as zf:
        zf.writestr("MANIFEST.json", json.dumps({"magic": "raven_tpu-checkpoint", "version": 99}))
        zf.writestr("arrays.npz", b"")
    with pytest.raises(ValueError, match="version"):
        load_graph(bad)


# --------------------------------------------------------------------- λ
@requires_lambda
@pytest.mark.lambda_e2e
def test_api_lambda_whole_phases():
    """The λ-phage reads through the API's whole phases on the CPU (minhash
    on, two polish rounds): one unitig within the reference's golden edit
    distance (tests/test_lambda_golden.py)."""
    from raven_tpu_torch.io import parse_file
    from raven_tpu_torch.io.readset import reverse_complement
    from raven_tpu_torch.ops.edit_distance import edit_distance
    from tests.conftest import lambda_reads_path, lambda_truth_path

    lambda_reads = parse_file(lambda_reads_path())
    lambda_truth = parse_file(lambda_truth_path())
    graph = api.Graph()
    api.construct_graph(graph, lambda_reads, cfg=api.OverlapPhaseCfg(use_minhash=True),
                        device="cpu")
    api.assemble_graph(graph, device="cpu")
    api.polish_graph(graph, lambda_reads, cfg=api.PolishCfg(), device="cpu")
    unitigs = api.get_unitigs(graph, drop_unpolished=True)
    assert len(unitigs) == 1
    truth = lambda_truth.sequence(0)
    ed = min(edit_distance(unitigs[0].codes, truth),
             edit_distance(reverse_complement(unitigs[0].codes), truth))
    assert ed <= 1137
