"""The port's -p 0 path end to end vs raven_tpu's: the CLI on a 30 kb
genome with both device paths forced on must print a byte-identical contig
FASTA, and a raven_tpu checkpoint must load in the port and assemble to
the same unitigs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu import cli as jcli  # noqa: E402
from raven_tpu import config as jconfig  # noqa: E402
from raven_tpu.config import OverlapPhaseCfg  # noqa: E402
from raven_tpu.graph import Graph, assemble, construct_graph, get_unitigs  # noqa: E402
from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu.graph.binary import load_graph, store_graph  # noqa: E402
from raven_tpu.io import ReadSet  # noqa: E402
from raven_tpu_torch import cli as tcli  # noqa: E402
from raven_tpu_torch import config as tconfig  # noqa: E402
from raven_tpu_torch import graph as tgraph  # noqa: E402
from raven_tpu_torch.graph import layout as tlayout  # noqa: E402
from raven_tpu_torch.graph.binary import load_graph as t_load_graph  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(1530)
    genome = random_genome(rng, 30000)
    reads, _ = sample_reads(rng, genome, 220, 3000, error=0.03)
    return reads


def test_cli_p0_contigs_byte_identical(reads, tmp_path, monkeypatch, capsys):
    path = tmp_path / "reads.fasta"
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    monkeypatch.chdir(tmp_path)
    # both CLIs set their package's process-wide settings (-t, -u): restore
    # them afterwards, or later tests in this process run with one worker
    for g in (jconfig.GLOBALS, tconfig.GLOBALS):
        for name in ("num_threads", "min_unitig_size"):
            monkeypatch.setattr(g, name, getattr(g, name))
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "1")
    declines = TIndex.host_declines

    tlayout.reset_seed()
    capsys.readouterr()
    assert tcli.main(
        [str(path), "-p", "0", "--device", "cpu", "--disable-checkpoints"]
    ) == 0
    got = capsys.readouterr().out
    jlayout.reset_seed()
    assert jcli.main([str(path), "-p", "0", "--disable-checkpoints"]) == 0
    want = capsys.readouterr().out
    assert got.startswith(">") and got.count(">") >= 1
    assert got == want
    assert TIndex.host_declines == declines


def test_raven_tpu_checkpoint_assembles_the_same(reads, tmp_path, monkeypatch):
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "0")
    graph = Graph()
    construct_graph(graph, ReadSet.from_sequences(reads), OverlapPhaseCfg())
    ckpt = str(tmp_path / "graph.ckpt")
    store_graph(graph, ckpt)

    want_graph = load_graph(ckpt)
    jlayout.reset_seed()
    assemble(want_graph)
    got_graph = t_load_graph(ckpt)
    assert isinstance(got_graph, tgraph.Graph)
    assert got_graph.stage == -3
    tlayout.reset_seed()
    tgraph.assemble(got_graph, device="cpu")
    assert got_graph.stage == want_graph.stage == 0

    want = [(n.name, n.sequence_str()) for n in get_unitigs(want_graph, False)]
    got = [(n.name, n.sequence_str()) for n in tgraph.get_unitigs(got_graph, False)]
    assert len(want) >= 1
    assert got == want
