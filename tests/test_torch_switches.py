"""raven_tpu's environment switches and their counterparts in the port,
which reads none: each class attribute against raven_tpu run with the
variable set, on the same seeded inputs, on the CPU.

  * Polisher.CONSENSUS_ENGINE / CONSENSUS_ITERS (RAVEN_TPU_CONSENSUS_ENGINE,
    RAVEN_TPU_CONSENSUS_ITERS): "full" without --device-poa-batches (full
    NW in the last round, chunks of 2,048 rows), "shiftband" with
    --device-poa-batches 8 (the shift-banded engine in every round) and 2
    iterations, on tests/test_torch_polish.py's 12 kb Polisher setup and
    its 30 kb `-p 2` CLI reads (tests/test_torch_switches_cli.py): the
    same consensus bytes (the shift-banded route's cases, the longest, in
    tests/test_torch_switches_shiftband.py; the shared set-up in
    tests/torch_switches_common.py);
  * MinimizerIndex.MESH / Polisher.MESH = False (RAVEN_TPU_SHARDED_MAP=0,
    RAVEN_TPU_SHARDED_POLISH=0), with default_mesh giving a virtual CPU
    mesh: no sharded index and no mesh votes, the one-device results;
  * MinimizerIndex.DEVICE_CHAIN = False (RAVEN_TPU_DEVICE_CHAIN=0): a device
    join's matches chained on the host, the same per-read overlaps;
  * MinimizerIndex.DEVICE_MAP = False (RAVEN_TPU_DEVICE_MAP=0): no device
    index of any kind, the same overlaps, DEVICE_SKETCH still deciding
    where the sketch runs.

The index-batch budget's two overrides are held in
tests/test_torch_pipeline.py::test_index_batch_budget_matches_reference."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex as JIndex  # noqa: E402
from raven_tpu_torch.overlap import selfjoin as tselfjoin  # noqa: E402
from raven_tpu_torch.overlap.device_index import DeviceIndex, PartitionedIndex  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raven_tpu_torch.parallel.sharded_index import ShardedIndex  # noqa: E402
from raven_tpu_torch.utils.synth import synth_reads  # noqa: E402
from tests.test_torch_polish import setup  # noqa: E402, F401
from tests.torch_switches_common import (  # noqa: E402, F401
    ROUTES, SHIFTBAND, _calls, _never, _one_torch_thread, _reference_env,
    check_mesh_refused_polisher, check_polisher_route,
)

# the shift-banded route with 8 batches is in tests/test_torch_switches_shiftband.py
@pytest.mark.parametrize("route", [r for r in ROUTES if r != SHIFTBAND])
def test_polisher_consensus_switches_match_jax(setup, route, monkeypatch):  # noqa: F811
    check_polisher_route(setup, route, monkeypatch)


@pytest.fixture(scope="module")
def readset():
    return synth_reads(60_000, 12, 4000, 0.10, seed=21)


def _jreadset(rs):
    return JReadSet(names=list(rs.names), starts=rs.starts, lengths=rs.lengths,
                    codes=rs.codes, quals=rs.quals)


def _overlaps(index, rs):
    """tests/test_torch_engine.py's stage: minimize(with_query_flags) ->
    filter -> map_many(minhash); the per-read overlaps."""
    ids = np.arange(len(rs))
    index.minimize(rs, ids, minhash=False, with_query_flags=True)
    index.filter(0.001)
    return index.map_many(rs, ids, minhash=True)


def _same_overlaps(got, want):
    assert sorted(got) == sorted(want)
    assert sum(v.size for v in want.values()) > 0
    for rid, w in want.items():
        assert np.array_equal(got[rid], w), rid


def test_mesh_refused_index_matches_jax(readset, monkeypatch):
    """With default_mesh giving a virtual mesh of 4 CPU shards, MESH = None
    builds the sharded index; MESH = False keeps the one-device index, as
    raven_tpu's RAVEN_TPU_SHARDED_MAP=0 does, with its overlaps."""
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    one = _overlaps(TIndex(15, 5, device="cpu"), readset)
    monkeypatch.setattr(tmesh, "default_mesh", lambda device: tmesh.Mesh(["cpu"] * 4))
    built = _calls(monkeypatch, ShardedIndex, "build")
    sharded = TIndex(15, 5, device="cpu")
    sharded.minimize(readset, np.arange(len(readset)))
    assert len(built) == 1 and isinstance(sharded._device, ShardedIndex)

    _never(monkeypatch, ShardedIndex, "build")
    monkeypatch.setattr(TIndex, "MESH", False)
    t = TIndex(15, 5, device="cpu")
    got = _overlaps(t, readset)
    assert isinstance(t._device, DeviceIndex)
    _same_overlaps(got, one)
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "1")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "0")
    j = JIndex(15, 5)
    want = _overlaps(j, _jreadset(readset))
    assert j._device is not None
    _same_overlaps(got, want)


# the shift-banded engine's case is in tests/test_torch_switches_shiftband.py
@pytest.mark.parametrize("batches", [1], ids=["full"])
def test_mesh_refused_polisher_matches_jax(setup, batches, monkeypatch):  # noqa: F811
    check_mesh_refused_polisher(setup, batches, monkeypatch)


def test_device_chain_off_matches_jax(readset, monkeypatch):
    """DEVICE_CHAIN = False: the device join hands its matches to the host
    chain (selfjoin.chain_per_read), and the per-read overlaps are the
    device chain's and raven_tpu's under RAVEN_TPU_DEVICE_CHAIN=0."""
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    on = _overlaps(TIndex(15, 5, device="cpu"), readset)
    joins = _calls(monkeypatch, DeviceIndex, "distance_join")
    chained = []
    chain = tselfjoin.chain_per_read
    monkeypatch.setattr(tselfjoin, "chain_per_read",
                        lambda *a, **k: chained.append(1) or chain(*a, **k))
    monkeypatch.setattr(TIndex, "DEVICE_CHAIN", False)
    t = TIndex(15, 5, device="cpu")
    got = _overlaps(t, readset)
    assert isinstance(t._device, DeviceIndex)
    assert joins and all(c["chain_k"] is None for c in joins)
    assert chained
    _same_overlaps(got, on)
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "1")
    monkeypatch.setenv("RAVEN_TPU_DEVICE_CHAIN", "0")
    want = _overlaps(JIndex(15, 5), _jreadset(readset))
    _same_overlaps(got, want)


@pytest.mark.parametrize("device_sketch", [True, False], ids=["device-sketch", "host-sketch"])
def test_host_index_mode_matches_jax(readset, device_sketch, monkeypatch):
    """DEVICE_MAP = False: the host index at any size, a forced mesh
    refused too; no DeviceIndex, PartitionedIndex or ShardedIndex is built;
    DEVICE_SKETCH still decides where the sketch runs; the overlaps are
    raven_tpu's under RAVEN_TPU_DEVICE_MAP=0 and the device index's."""
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    device_run = _overlaps(TIndex(15, 5, device="cpu"), readset)
    for cls in (DeviceIndex, PartitionedIndex, ShardedIndex):
        _never(monkeypatch, cls, "build")
    sketches = _calls(monkeypatch, TIndex, "_device_sketch")
    monkeypatch.setattr(TIndex, "DEVICE_MAP", False)
    monkeypatch.setattr(TIndex, "MESH", tmesh.Mesh(["cpu"] * 4))
    monkeypatch.setattr(TIndex, "DEVICE_SKETCH", device_sketch)
    t = TIndex(15, 5, device="cpu")
    got = _overlaps(t, readset)
    assert t._device is None and t._hashes is not None
    assert len(sketches) == (1 if device_sketch else 0)
    _same_overlaps(got, device_run)
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "0")
    j = JIndex(15, 5)
    want = _overlaps(j, _jreadset(readset))
    assert j._device is None
    _same_overlaps(got, want)
