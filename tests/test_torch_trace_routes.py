"""The map routes' spans (raven_tpu_torch.utils.trace): under a profiler a
device index's foreign join is the span "index.join_foreign" with its
reads, bases, query entries and matches, and a map_many call on the host
route is "index.host_map" with its reads; each only on the route that
takes it."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.overlap.minimizer import minimize_reads
from raven_tpu_torch.utils import trace
from raven_tpu_torch.utils.synth import synth_reads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def log():
    trace.clear()
    yield trace.spans
    trace.clear()


@pytest.fixture(scope="module")
def readset():
    return synth_reads(40_000, 10, 3000, 0.08, seed=5)


def _named(records, name):
    return [r for r in records if r.name == name]


def _map(readset, device_map, monkeypatch, minhash):
    """An index over the upper half of the reads, every read mapped under a
    profiler: the lower half are foreign queries."""
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MAP", device_map)
    n = len(readset)
    idx = MinimizerIndex(15, 5, device="cpu")
    idx.minimize(readset, np.arange(n // 2, n), with_query_flags=True)
    idx.filter(0.001)
    with profile(activities=[ProfilerActivity.CPU]):
        out = idx.map_many(readset, np.arange(n), minhash=minhash)
    return out


@pytest.mark.parametrize("minhash", [True, False])
def test_foreign_join_span_on_the_device_route(readset, log, monkeypatch, minhash):
    out = _map(readset, True, monkeypatch, minhash)
    n = len(readset)
    (span,) = _named(log(), "index.join_foreign")
    foreign = np.arange(n // 2)
    sketch = minimize_reads(readset, foreign, 15, 5, minhash)[0]
    assert span.counts["reads"] == n // 2
    assert span.counts["bases"] == int(readset.lengths[: n // 2].sum())
    assert span.counts["entries"] == sketch.size > 0
    assert span.counts["matches"] > 0
    # the in-batch reads through the self-join, chained beside
    assert len(_named(log(), "index.join")) == 1
    assert _named(log(), "index.chain") and not _named(log(), "index.host_map")
    assert sum(out[r].size for r in range(n // 2)) > 0
    assert span.root == span.id  # not inside another span here


def test_host_map_span_on_the_host_route(readset, log, monkeypatch):
    _map(readset, False, monkeypatch, True)
    (span,) = _named(log(), "index.host_map")
    assert span.counts == {"reads": len(readset)}
    assert not _named(log(), "index.join_foreign") and not _named(log(), "index.join")


def test_no_span_without_a_profiler(readset, log, monkeypatch):
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MIN_BASES", 0)
    n = len(readset)
    idx = MinimizerIndex(15, 5, device="cpu")
    idx.minimize(readset, np.arange(n // 2, n), with_query_flags=True)
    idx.filter(0.001)
    idx.map_many(readset, np.arange(n), minhash=True)
    assert log() == []
