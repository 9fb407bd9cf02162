"""The nine readers of the program's own spans, on a synthetic run and span
log: each keeps the spans inside the traced window, divides by the passes
or calls there, and reads nothing where it finds none."""

import os
import sys
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.tiny import BENCH
from raven_tpu_torch.utils import trace

LO, HI = 1_700_000_000.0, 1_700_000_010.0  # the window, s on the trace's clock
MS = 1_000_000  # ns


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "perfbench_metric_" + name.replace(".", "_"))


def _run(window=(LO, HI), device_ops=(("k", LO + 1, LO + 2),)):
    tr = SimpleNamespace(window=window, window_s=window[1] - window[0],
                         device_ops=list(device_ops))
    return SimpleNamespace(trace=tr)


def _span(name, start_ms, dur_ms, **counts):
    """A record starting start_ms after the window's start."""
    start = int(LO * 1e9) + start_ms * MS
    return trace.Record(name, 0, None, 0, start, start + dur_ms * MS, counts)


@pytest.fixture
def log():
    trace.clear()
    yield trace.spans()
    trace.clear()


OVERLAP = {"deal_ms.overlap": "construct.deal", "layers_ms.overlap": "construct.layers",
           "cap_ms.overlap": "construct.cap", "unpack_ms.overlap": "index.unpack"}
POLISH = {"band_prep_ms.polish": "band.prepare", "band_upload_ms.polish": "band.upload",
          "band_queue_ms.polish": "band.queue", "band_collect_ms.polish": "band.collect"}


@pytest.mark.parametrize("metric", OVERLAP)
def test_overlap_reader_per_pass(metric, log):
    name = OVERLAP[metric]
    log += [_span("construct.find_overlaps", 0, 4000), _span(name, 100, 10),
            _span("construct.find_overlaps", 5000, 4000), _span(name, 5100, 30),
            # a pass and a step that end past the window are not read
            _span("construct.find_overlaps", 9500, 4000), _span(name, 9600, 500),
            _span("construct.other", 200, 700)]
    assert _reader(metric).read(_run()) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", POLISH)
def test_polish_reader_per_call(metric, log):
    name = POLISH[metric]
    log += [_span("band.call", 0, 3000)] + [_span(name, 10 + 100 * g, 7) for g in range(3)]
    log += [_span("band.call", 4000, 3000), _span(name, 4010, 9)]
    # before the window
    log += [_span("band.call", -5000, 3000), _span(name, -4990, 50)]
    assert _reader(metric).read(_run()) == pytest.approx(15.0)


def test_row_fill_share(log):
    log += [_span("band.call", 0, 3000),
            _span("band.prepare", 10, 5, windows=8, fragments=100, rows=256),
            _span("band.prepare", 20, 5, windows=8, fragments=200, rows=256),
            _span("band.prepare", -20, 5, windows=8, fragments=1, rows=4096)]
    assert _reader("band_row_fill_pct.polish").read(_run()) == pytest.approx(
        100.0 * 300 / 512)


@pytest.mark.parametrize("metric", [*OVERLAP, *POLISH, "band_row_fill_pct.polish"])
def test_none_where_nothing_is_read(metric, log, monkeypatch):
    reader = _reader(metric)
    steps = [*OVERLAP.values(), "band.upload", "band.queue", "band.collect"]

    def spans_at(t):
        return ([_span("construct.find_overlaps", t, 4000), _span("band.call", t, 3000),
                 _span("band.prepare", t + 10, 5, windows=8, fragments=100, rows=256)]
                + [_span(n, t + 100, 10) for n in steps])

    # every span before or after the window
    log += spans_at(-9000) + spans_at(20000)
    assert reader.read(_run()) is None
    # spans in the window, but an untraced run or one with no device work
    log += spans_at(0)
    assert reader.read(_run()) is not None
    assert reader.read(SimpleNamespace(trace=None)) is None
    assert reader.read(_run(device_ops=())) is None
    # a program that keeps no span log
    import raven_tpu_torch.utils

    monkeypatch.delattr(raven_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "raven_tpu_torch.utils.trace", None)
    assert reader.read(_run()) is None
