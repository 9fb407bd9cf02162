"""raven_tpu's environment switches and their counterparts in the port,
which reads none: each class attribute against raven_tpu run with the
variable set, on the same seeded inputs, on the CPU.

  * Polisher.CONSENSUS_ENGINE / CONSENSUS_ITERS (RAVEN_TPU_CONSENSUS_ENGINE,
    RAVEN_TPU_CONSENSUS_ITERS): "full" without --device-poa-batches (full
    NW in the last round, chunks of 2,048 rows), "shiftband" with
    --device-poa-batches 8 (the shift-banded engine in every round) and 2
    iterations, on tests/test_torch_polish.py's 12 kb Polisher setup and
    its 30 kb `-p 2` CLI reads (tests/test_torch_switches_cli.py): the
    same consensus bytes;
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
import torch

jax = pytest.importorskip("jax")

from raven_tpu import config as jconfig  # noqa: E402
from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex as JIndex  # noqa: E402
from raven_tpu.polish.polisher import Polisher as JPolisher  # noqa: E402
from raven_tpu_torch import config as tconfig  # noqa: E402
from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.ops import consensus_band as tband  # noqa: E402
from raven_tpu_torch.ops import consensus_device as tcd  # noqa: E402
from raven_tpu_torch.overlap import selfjoin as tselfjoin  # noqa: E402
from raven_tpu_torch.overlap.device_index import DeviceIndex, PartitionedIndex  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raven_tpu_torch.parallel.sharded_index import ShardedIndex  # noqa: E402
from raven_tpu_torch.polish.polisher import Polisher as TPolisher  # noqa: E402
from raven_tpu_torch.utils.synth import synth_reads  # noqa: E402
from tests.test_torch_polish import setup  # noqa: E402, F401

# every switch of raven_tpu these tests set; unset, raven_tpu takes the
# path the port takes by default
_JAX_ENV = (
    "RAVEN_TPU_CONSENSUS_ENGINE", "RAVEN_TPU_CONSENSUS_ITERS",
    "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_SHARDED_MAP", "RAVEN_TPU_BANDED",
    "RAVEN_TPU_PALLAS_CONSENSUS", "RAVEN_TPU_CONSENSUS_GROUP", "RAVEN_TPU_DEVICE_MAP",
    "RAVEN_TPU_DEVICE_CHAIN", "RAVEN_TPU_DEVICE_SKETCH", "RAVEN_TPU_INDEX_PARTS",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for name in _JAX_ENV:
        monkeypatch.delenv(name, raising=False)


def _calls(monkeypatch, module, name):
    """Record the keyword arguments of every call of module.name."""
    seen = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


def _never(monkeypatch, owner, name):
    def boom(*args, **kwargs):
        raise AssertionError(f"{name} must not be called")

    monkeypatch.setattr(owner, name, boom)


def _same_contigs(got, want):
    assert len(got) == len(want) == 1
    for (gn, gc), (wn, wc) in zip(got, want):
        assert gn == wn
        assert gc.dtype == np.uint8
        assert np.array_equal(gc, wc)


# (port attributes, raven_tpu variables, DeviceCfg.poa_batches, the CLI's
# engines by round, the device consensus the port must call and its
# keywords)
ROUTES = {
    "full-without-batches": (
        dict(CONSENSUS_ENGINE="full"), dict(RAVEN_TPU_CONSENSUS_ENGINE="full"), 0,
        ["host", "device"], "device_window_consensus", dict(iterations=4, banded=False),
    ),
    "shiftband-with-8-batches": (
        dict(CONSENSUS_ENGINE="shiftband"), dict(RAVEN_TPU_CONSENSUS_ENGINE="shiftband"), 8,
        ["device", "device"], "band_window_consensus", dict(iterations=4),
    ),
    "iters-2": (
        dict(CONSENSUS_ITERS=2), dict(RAVEN_TPU_CONSENSUS_ITERS="2"), 0,
        ["host", "device"], "band_window_consensus", dict(iterations=2),
    ),
}


def _route(monkeypatch, name):
    attrs, env, batches, engines, fn, kw = ROUTES[name]
    for k, v in attrs.items():
        monkeypatch.setattr(TPolisher, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    module = tcd if fn == "device_window_consensus" else tband
    return batches, engines, kw, _calls(monkeypatch, module, fn)


@pytest.mark.parametrize("route", list(ROUTES))
def test_polisher_consensus_switches_match_jax(setup, route, monkeypatch):  # noqa: F811
    reads, draft = setup
    batches, _, kw, calls = _route(monkeypatch, route)
    tkw, jkw = dict(device="cpu"), {}
    if batches:
        tkw["device_cfg"] = tconfig.DeviceCfg(poa_batches=batches)
        jkw["device_cfg"] = jconfig.DeviceCfg(poa_batches=batches)
    else:
        tkw["use_device"] = jkw["use_device"] = True
    tp, jp = TPolisher(**tkw), JPolisher(**jkw)
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = jp.polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    _same_contigs(got, want)
    assert tp.last_engine == "device"
    assert len(calls) == 1
    assert {k: calls[0][k] for k in kw} == kw
    if route == "full-without-batches":
        assert "chunk" not in calls[0]  # device_window_consensus's 2,048 rows


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


@pytest.mark.parametrize("batches", [0, 1], ids=["shiftband", "full"])
def test_mesh_refused_polisher_matches_jax(setup, batches, monkeypatch):  # noqa: F811
    """With default_mesh giving a virtual mesh of 4 CPU shards,
    Polisher.MESH = False (and MinimizerIndex.MESH = False for its read
    mapping) runs the one-device votes of both engines: no mesh votes, no
    sharded index, raven_tpu's consensus under RAVEN_TPU_SHARDED_POLISH=0."""
    reads, draft = setup
    monkeypatch.setattr(tmesh, "default_mesh", lambda device: tmesh.Mesh(["cpu"] * 4))
    assert tmesh.chosen_mesh(None, torch.device("cpu")).size == 4
    monkeypatch.setattr(TPolisher, "MESH", False)
    monkeypatch.setattr(TIndex, "MESH", False)
    for module in (tcd, tband):
        _never(monkeypatch, module, "local_blocks")
    _never(monkeypatch, ShardedIndex, "build")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_POLISH", "0")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "0")
    tkw, jkw = dict(device="cpu"), {}
    if batches:
        tkw["device_cfg"] = tconfig.DeviceCfg(poa_batches=batches)
        jkw["device_cfg"] = jconfig.DeviceCfg(poa_batches=batches)
    else:
        tkw["use_device"] = jkw["use_device"] = True
    tp = TPolisher(**tkw)
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = JPolisher(**jkw).polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    _same_contigs(got, want)
    assert tp.last_engine == "device"


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
