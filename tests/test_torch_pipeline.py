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


def _cli_p0_outputs(reads, tmp_path, monkeypatch, capsys):
    """The port's and raven_tpu's -p 0 FASTA on `reads`, with both device
    paths forced on (the port on the CPU); the port must not decline."""
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
    assert TIndex.host_declines == declines
    return got, want


def test_cli_p0_contigs_byte_identical(reads, tmp_path, monkeypatch, capsys):
    got, want = _cli_p0_outputs(reads, tmp_path, monkeypatch, capsys)
    assert got.startswith(">") and got.count(">") >= 1
    assert got == want


def test_cli_p0_partitioned_index_byte_identical(reads, tmp_path, monkeypatch, capsys):
    """Both packages' indexes in two hash-range parts
    (tests/test_device_index.py::test_partitioned_construct_end_to_end)."""
    from raven_tpu.overlap import device_index as jdi
    from raven_tpu_torch.overlap import device_index as tdi

    monkeypatch.setattr(TIndex, "INDEX_PARTS", 2)
    monkeypatch.setenv("RAVEN_TPU_INDEX_PARTS", "2")
    built = {"port": 0, "raven_tpu": 0}
    for name, cls in (("port", tdi.PartitionedIndex), ("raven_tpu", jdi.PartitionedIndex)):
        def spy(klass, *a, _orig=cls.build.__func__, _name=name, **kw):
            r = _orig(klass, *a, **kw)
            built[_name] += r is not None
            return r

        monkeypatch.setattr(cls, "build", classmethod(spy))
    got, want = _cli_p0_outputs(reads, tmp_path, monkeypatch, capsys)
    assert built["port"] > 0 and built["raven_tpu"] > 0
    assert got.startswith(">") and got.count(">") >= 1
    assert got == want


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


def test_index_batch_budget_matches_reference(monkeypatch):
    """tests/test_misc.py::test_streaming_index_batch_clamp's budget: with
    the index on the CPU the port batches at raven_tpu's 2^32 bases, as
    raven_tpu does on a CPU backend; on a card it clamps to raven_tpu's
    budget on a device backend (its partitioned index's ceiling).  The
    host index (MinimizerIndex.DEVICE_MAP off) keeps 2^32 on a card, as
    raven_tpu does under RAVEN_TPU_DEVICE_MAP=0, and a budget the caller
    sets (construct.INDEX_BATCH_BYTES) wins over the clamp, as
    RAVEN_TPU_INDEX_BATCH_BASES does.  The port's function reads only the
    device's type, so no card is needed."""
    import importlib

    import torch

    from raven_tpu.graph import construct as jconstruct
    from raven_tpu_torch.graph import construct as tconstruct

    monkeypatch.delenv("RAVEN_TPU_INDEX_BATCH_BASES", raising=False)
    monkeypatch.delenv("RAVEN_TPU_DEVICE_MAP", raising=False)
    assert jax.default_backend() == "cpu"
    want = jconstruct._index_batch_bytes()
    assert want == 1 << 32
    assert tconstruct._index_batch_bytes(torch.device("cpu")) == want
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want_card = jconstruct._index_batch_bytes()
    assert want_card == 2_174_327_193
    assert tconstruct._index_batch_bytes(torch.device("cuda")) == want_card

    # the host index on a card: raven_tpu's RAVEN_TPU_DEVICE_MAP=0
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "0")
    want_host = jconstruct._index_batch_bytes()
    assert want_host == 1 << 32
    assert tconstruct._index_batch_bytes(torch.device("cuda"), device_map=False) == want_host
    assert tconstruct._index_batch_bytes(torch.device("cuda"), device_map=True) == want_card
    monkeypatch.delenv("RAVEN_TPU_DEVICE_MAP")

    # a budget above the clamp, set explicitly: raven_tpu's
    # RAVEN_TPU_INDEX_BATCH_BASES, read when its module loads
    monkeypatch.setenv("RAVEN_TPU_INDEX_BATCH_BASES", str(3 << 30))
    importlib.reload(jconstruct)
    try:
        want_set = jconstruct._index_batch_bytes()
        assert want_set == 3 << 30 > want_card
        monkeypatch.setattr(tconstruct, "INDEX_BATCH_BYTES", 3 << 30)
        for dev, device_map in (("cuda", True), ("cuda", False), ("cpu", True)):
            assert tconstruct._index_batch_bytes(torch.device(dev), device_map) == want_set
    finally:
        monkeypatch.delenv("RAVEN_TPU_INDEX_BATCH_BASES", raising=False)
        importlib.reload(jconstruct)
