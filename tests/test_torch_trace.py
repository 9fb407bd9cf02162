"""raven_tpu_torch.utils.trace: spans are live only under a profiler, carry
their parent, root and counts on the profiler's clock, and mark the steps
of the construct pass and the shift-banded engine."""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raven_tpu_torch.config import OverlapPhaseCfg
from raven_tpu_torch.graph import construct
from raven_tpu_torch.ops import consensus_band
from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE
from raven_tpu_torch.pile.pile import Piles
from raven_tpu_torch.utils import trace
from raven_tpu_torch.utils.synth import make_windows, synth_reads

SECONDS = r" \d+\.\d{6}s"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def log():
    """The span log, empty before and after the test."""
    trace.clear()
    yield trace.spans
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _named(records, name):
    return [r for r in records if r.name == name]


def test_no_profiler_opens_no_range_and_logs_nothing(log, monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("outer", reads=3) as s:
        s["rows"] = 256
        with trace.span("inner", log="[stage] did it"):
            pass
    assert s.counts == {"reads": 3, "rows": 256}
    assert log() == []
    # a stage-log span still prints its line
    assert re.fullmatch(r"\[stage\] did it" + SECONDS + "\n", capsys.readouterr().err)


def test_nested_spans_carry_parent_root_and_counts(log):
    with _profiled():
        with trace.span("outer", reads=3) as outer:
            with trace.span("inner") as inner:
                inner["rows"] = 256
                with trace.span("leaf", engine="device"):
                    pass
            with trace.span("inner"):
                pass
        with trace.span("second"):
            pass
    recs = {(r.name, r.id): r for r in log()}
    assert len(recs) == 5
    o = _named(log(), "outer")[0]
    first, second_inner = sorted(_named(log(), "inner"), key=lambda r: r.start)
    leaf = _named(log(), "leaf")[0]
    other = _named(log(), "second")[0]
    assert o.parent is None and o.root == o.id and o.counts == {"reads": 3}
    assert first.parent == o.id and first.root == o.id and first.counts == {"rows": 256}
    assert second_inner.parent == o.id and second_inner.root == o.id
    assert leaf.parent == first.id and leaf.root == o.id and leaf.counts == {"engine": "device"}
    assert other.parent is None and other.root == other.id != o.id
    assert o.start <= first.start <= first.end <= second_inner.start <= o.end
    assert outer.counts is o.counts


def test_spans_lie_on_the_profilers_clock(log):
    import time

    with _profiled() as prof:
        with trace.span("warm"):
            pass
        for i in range(5):
            with trace.span(f"step{i}"):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX)}
    for rec in log()[1:]:
        ev = events[trace.PREFIX + rec.name]
        assert abs(rec.start - ev.start_ns()) < 1_000_000, rec
        assert abs(rec.end - ev.end_ns()) < 1_000_000, rec
        assert rec.end - rec.start >= 2_000_000


def test_construct_pass_spans(log, monkeypatch, capsys):
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MIN_BASES", 0)
    readset = synth_reads(60_000, 12, 4000, 0.10, seed=21)
    cfg = OverlapPhaseCfg(max_num_overlaps=1 << 20)  # nothing capped
    n = len(readset)
    index = MinimizerIndex(cfg.kmer_len, cfg.window_len, device="cpu")
    piles = Piles(readset.lengths)
    overlaps = [np.zeros(0, dtype=OVERLAP_DTYPE) for _ in range(n)]
    with _profiled():
        construct.find_overlaps_and_create_piles(index, readset, cfg, piles, overlaps)
    assert index._device is not None

    root = _named(log(), "construct.find_overlaps")
    assert len(root) == 1
    for name in ("construct.minimize", "construct.map_batch", "construct.map",
                 "construct.deal", "construct.layers", "construct.cap",
                 "index.join", "index.chain", "index.unpack"):
        got = _named(log(), name)
        assert len(got) == 1, name
        assert got[0].root == root[0].id, name
    minimize = _named(log(), "construct.minimize")[0]
    assert minimize.counts == {"reads": n, "bases": int(readset.lengths.sum())}
    assert _named(log(), "construct.map")[0].counts == {"reads": n}
    dealt = _named(log(), "construct.deal")[0].counts["overlaps"]
    assert dealt > 0
    # each overlap dealt lands on both reads' lists
    assert sum(o.size for o in overlaps) == 2 * dealt
    assert _named(log(), "index.unpack")[0].counts == {"overlaps": dealt}
    assert _named(log(), "construct.layers")[0].counts == {"intervals": 2 * dealt}
    cap = _named(log(), "construct.cap")[0].counts
    assert cap["reads_capped"] == 0
    assert cap["reads_touched"] == sum(o.size > 0 for o in overlaps)

    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2
    assert re.fullmatch(r"\[raven_tpu::Graph::Construct\] minimized 0 - %d / %d" % (n, n)
                        + SECONDS, err[0])
    assert re.fullmatch(r"\[raven_tpu::Graph::Construct\] mapped sequences" + SECONDS, err[1])


def test_band_engine_spans(log):
    windows, _ = make_windows(20, 500, 6, np.random.default_rng(3))
    kw = dict(iterations=2, group=8, device="cpu")
    want = consensus_band.band_window_consensus(windows, **kw)
    assert log() == []
    with _profiled():
        got = consensus_band.band_window_consensus(windows, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))

    (call,) = _named(log(), "band.call")
    assert call.counts == {"windows": 20, "groups": 3}
    prep = sorted(_named(log(), "band.prepare"), key=lambda r: r.start)
    assert [r.counts["windows"] for r in prep] == [8, 8, 4]
    sizes = [len(w[1]) for w in windows]
    assert [r.counts["fragments"] for r in prep] == [sum(sizes[0:8]), sum(sizes[8:16]),
                                                    sum(sizes[16:])]
    assert [r.counts["rows"] for r in prep] == [256] * 3
    for name in ("band.upload", "band.queue"):
        assert len(_named(log(), name)) == 3, name
    assert all(r.counts == {"iterations": 2} for r in _named(log(), "band.queue"))
    assert all(r.counts["bytes"] > 256 * 640 for r in _named(log(), "band.upload"))
    assert len(_named(log(), "band.collect")) == 1
    assert all(r.parent == call.id for r in log() if r is not call)
