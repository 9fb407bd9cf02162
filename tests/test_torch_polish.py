"""The port's polish path (raven_tpu_torch.polish, the -p N CLI) vs
raven_tpu's on the same inputs: the Polisher with the full-NW device
consensus and the device crossing DP (DeviceCfg poa_batches and
alignment_batches), with the shift-banded device consensus (the default
engine), the host POA round, and the CLI's contig FASTA for `-p 2` and `-p 2
--device-poa-batches 1 --device-alignment-batches 1`, byte for byte.  The
anchored banded engine (--device-banded-alignment) is held to raven_tpu's in
tests/test_torch_banded_consensus.py."""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

jax = pytest.importorskip("jax")

from raven_tpu import cli as jcli  # noqa: E402
from raven_tpu import config as jconfig  # noqa: E402
from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.io import encode  # noqa: E402
from raven_tpu.polish.polisher import Polisher as JPolisher  # noqa: E402
from raven_tpu_torch import cli as tcli  # noqa: E402
from raven_tpu_torch import config as tconfig  # noqa: E402
from raven_tpu_torch.graph import layout as tlayout  # noqa: E402
from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.polish.polisher import Polisher as TPolisher  # noqa: E402
from raven_tpu_torch.utils import trace  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several xdist workers on the same cores; torch's
    default of one intra-op thread per core makes their OpenMP threads spin
    against each other through this file's thousands of small row ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# raven_tpu's polisher reads these; unset, it takes the path the port copies
_JAX_ENV = (
    "RAVEN_TPU_CONSENSUS_ENGINE", "RAVEN_TPU_CONSENSUS_ITERS",
    "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_BANDED", "RAVEN_TPU_PALLAS_CONSENSUS",
    "RAVEN_TPU_CONSENSUS_GROUP",
)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for name in _JAX_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def setup():
    """tests/test_polisher.py's setup: a 12 kb genome, 60 reads of 3 kb
    at 5% error, and a draft with ~2% deletions, 2% insertions and 3%
    substitutions."""
    rng = np.random.default_rng(4242)
    genome = random_genome(rng, 12000)
    reads, _ = sample_reads(rng, genome, 60, 3000, error=0.05)
    draft = []
    for c in encode(genome):
        r = rng.random()
        if r < 0.02:
            continue
        if r < 0.04:
            draft.append(int(rng.integers(0, 4)))
        if r < 0.07:
            draft.append((int(c) + 1) % 4)
        else:
            draft.append(int(c))
    return reads, np.array(draft, dtype=np.uint8)


def _polish_both(setup, tkw, jkw, use_device_consensus=None):
    reads, draft = setup
    tp = TPolisher(**tkw)
    jp = JPolisher(**jkw)
    tp.use_device_consensus = jp.use_device_consensus = use_device_consensus
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = jp.polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    return tp, got, want


def _same(got, want):
    assert len(got) == len(want) == 1
    for (gn, gc), (wn, wc) in zip(got, want):
        assert gn == wn
        assert gc.dtype == np.uint8
        assert np.array_equal(gc, wc)


def test_polisher_device_consensus_matches_jax(setup):
    tp, got, want = _polish_both(
        setup,
        dict(device="cpu", device_cfg=tconfig.DeviceCfg(poa_batches=1, alignment_batches=1)),
        dict(device_cfg=jconfig.DeviceCfg(poa_batches=1, alignment_batches=1)),
    )
    _same(got, want)
    assert tp.last_engine == "device"
    assert got[0][0].startswith("Ctg0 XC:f:")


def test_polisher_host_poa_round_matches_jax(setup):
    tp, got, want = _polish_both(setup, dict(device="cpu"), dict(), use_device_consensus=False)
    _same(got, want)
    assert tp.last_engine == "host"


def test_polisher_shift_banded_consensus_matches_jax(setup):
    """The device asked for without poa_batches: both polishers take the
    shift-banded consensus (and the device crossing DP)."""
    tp, got, want = _polish_both(setup, dict(device="cpu", use_device=True), dict(use_device=True))
    _same(got, want)
    assert tp.last_engine == "device"


@pytest.fixture(scope="module")
def reads_path(tmp_path_factory):
    """tests/test_torch_pipeline.py's 30 kb setup as a FASTA file."""
    rng = np.random.default_rng(1530)
    genome = random_genome(rng, 30000)
    reads, _ = sample_reads(rng, genome, 220, 3000, error=0.03)
    path = tmp_path_factory.mktemp("polish") / "reads.fasta"
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    return path


def _globals():
    return [
        (g.num_threads, g.min_unitig_size) for g in (jconfig.GLOBALS, tconfig.GLOBALS)
    ]


# the port's stage-log lines: a bracketed tag, the stage's words, seconds
STAGE_LINE = re.compile(r"\[raven_tpu(_torch)?::[A-Za-z:]*\]( [^\n]*)? \d+\.\d{6}s")


def _run_both_clis(reads_path, flags, monkeypatch, capsys):
    """Both CLIs on the same reads; returns (port stdout, raven_tpu stdout,
    the port's spans, recorded under a CPU profiler)."""
    before = _globals()
    # both CLIs set their package's process-wide settings (-t, -u): restore
    # them afterwards, or later tests in this process run with one worker
    with monkeypatch.context() as m:
        m.chdir(reads_path.parent)
        for g in (jconfig.GLOBALS, tconfig.GLOBALS):
            for name in ("num_threads", "min_unitig_size"):
                m.setattr(g, name, getattr(g, name))
        tlayout.reset_seed()
        capsys.readouterr()
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            assert tcli.main([str(reads_path), *flags, "--device", "cpu"]) == 0
        spans = list(trace.spans())
        trace.clear()
        got, err = capsys.readouterr()
        jlayout.reset_seed()
        assert jcli.main([str(reads_path), *flags]) == 0
        want = capsys.readouterr().out
        assert tconfig.GLOBALS.num_threads == jconfig.GLOBALS.num_threads == 1
    assert _globals() == before
    assert got.startswith(">")
    lines = err.splitlines()
    assert all(STAGE_LINE.fullmatch(ln) for ln in lines), lines
    assert re.fullmatch(r"\[raven_tpu_torch::\] loaded \d+ sequences \d+\.\d{6}s", lines[0])
    assert re.fullmatch(r"\[raven_tpu_torch::\] \d+\.\d{6}s", lines[-1])
    rounds = [r for r in spans if r.name == "polish.round"]
    polisher = [ln for ln in lines if ln.startswith("[raven_tpu_torch::Polisher] ")]
    assert [ln.split()[1] for ln in polisher] == ["aligned", "generated"] * len(rounds)
    return got, want, spans


def _engines(spans):
    return [r.counts["engine"] for r in sorted(spans, key=lambda r: r.start)
            if r.name == "polish.round"]


def test_cli_polish_contigs_byte_identical(reads_path, monkeypatch, capsys):
    flags = ["-p", "2", "--device-poa-batches", "1", "--device-alignment-batches", "1",
             "--disable-checkpoints"]
    got, want, spans = _run_both_clis(reads_path, flags, monkeypatch, capsys)
    assert got == want
    assert _engines(spans) == ["device", "device"]
    (polish,) = [r for r in spans if r.name == "cli.polish"]
    assert polish.end > polish.start


def test_cli_default_polish_contigs_byte_identical(reads_path, monkeypatch, capsys):
    """`-p 2` without --device-poa-batches runs (no longer refused): POA
    rounds, then the shift-banded consensus in the last round when the
    device is a card; with --device cpu (and raven_tpu on a CPU backend)
    both rounds take the host POA."""
    flags = ["-p", "2", "--disable-checkpoints"]
    got, want, spans = _run_both_clis(reads_path, flags, monkeypatch, capsys)
    assert got == want
    assert _engines(spans) == ["host", "host"]


def test_bench_and_metric_copies_match():
    """utils.synth's copies of bench_polish.make_windows and
    misc/reference_compare.py::contig_ed, which chip_smoke.py uses."""
    import importlib.util
    import os

    import bench_polish
    from raven_tpu_torch.utils import synth

    got, gb = synth.make_windows(6, 500, 5, np.random.default_rng(21))
    want, wb = bench_polish.make_windows(6, 500, 5, np.random.default_rng(21))
    assert gb == wb
    for (b0, f0, w0), (b1, f1, w1) in zip(got, want):
        assert np.array_equal(b0, b1)
        assert all(np.array_equal(x, y) for x, y in zip(f0, f1))
        assert all(np.array_equal(x, y) for x, y in zip(w0, w1))

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "reference_compare", os.path.join(root, "misc", "reference_compare.py")
    )
    rc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rc)
    rng = np.random.default_rng(9)
    truth = rng.integers(0, 4, 20000).astype(np.uint8)
    contig = truth[1500:18000].copy()
    contig[::997] = (contig[::997] + 1) % 4
    contig = np.delete(contig, np.arange(50, contig.size, 1999))
    for c in (contig, contig[::-1] ^ 3):
        assert synth.contig_ed(c, truth) == rc.contig_ed(c, truth)
    assert synth.contig_ed(contig, truth)[0] > 0
