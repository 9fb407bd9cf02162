"""Port DeviceIndex (raven_tpu_torch.overlap.device_index) vs the JAX
package's, on the CPU: the built columns, the occurrence filter, the run
statistics, the self-join match set and the too-frequent entries, all on
the same reads; plus from_host round trips and the loud occurrence decline.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu.io.readset import ReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex  # noqa: E402
from raven_tpu_torch.io.readset import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.overlap import device_index as tdi  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402


def _reads(seed=11, genome_len=50000, coverage=8):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    n_reads = genome_len * coverage // 4000
    reads, _ = sample_reads(rng, genome, n_reads, mean_len=4000, error=0.08)
    return reads


@pytest.fixture(scope="module")
def reads():
    return _reads()


def _jax_index(reads, minhash, monkeypatch):
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "1")
    rs = ReadSet.from_sequences(reads)
    idx = MinimizerIndex(15, 5)
    idx.minimize(rs, np.arange(len(rs)), minhash=minhash, with_query_flags=not minhash)
    assert idx._device is not None
    return rs, idx


def _torch_index(reads, minhash, monkeypatch):
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    rs = TReadSet.from_sequences(reads)
    idx = TIndex(15, 5, device="cpu")
    idx.minimize(rs, np.arange(len(rs)), minhash=minhash, with_query_flags=not minhash)
    assert isinstance(idx._device, tdi.DeviceIndex)
    return rs, idx


def _lexsorted(cols):
    cols = [np.asarray(c).astype(np.int64) for c in cols if c is not None]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


@pytest.mark.parametrize("minhash", [False, True])
def test_build_columns_match(reads, minhash, monkeypatch):
    _, j = _jax_index(reads, minhash, monkeypatch)
    _, t = _torch_index(reads, minhash, monkeypatch)
    assert t._device.n_entries == j._device.n_entries
    assert t._device.has_flags == j._device.has_flags
    a = _lexsorted(t._device.to_host())
    b = _lexsorted(j._device.to_host())
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    # keys are sorted on both sides
    assert np.array_equal(a[0], np.sort(t._device.to_host()[0]))


def test_filter_and_run_stats_match(reads, monkeypatch):
    _, j = _jax_index(reads, False, monkeypatch)
    _, t = _torch_index(reads, False, monkeypatch)
    for f in (0.001, 0.01, 0.05):
        assert t._device.occurrence_for(f) == j._device.occurrence_for(f)
    assert np.array_equal(t._device.run_hist(), j._device.run_hist())
    for thr in (1, 2, 5, 17):
        assert t._device.le_count(thr) == j._device.le_count(thr)


def _match_set(m):
    return set(zip(*(np.asarray(c).astype(np.int64).tolist() for c in m)))


@pytest.mark.parametrize("need_flags", [True, False])
def test_distance_join_matches(reads, need_flags, monkeypatch):
    rs, j = _jax_index(reads, False, monkeypatch)
    _, t = _torch_index(reads, False, monkeypatch)
    occ = j._device.occurrence_for(0.001)
    batch = np.zeros(len(rs), dtype=bool)
    batch[: len(rs) // 2 + 3] = True  # a partial query batch
    fj, ft = {}, {}
    mj = j._device.distance_join(occ, batch, need_flags, filtered_out=fj)
    mt = t._device.distance_join(occ, batch, need_flags, filtered_out=ft)
    assert mj is not None and mt is not None
    assert len(mt[0]) == len(mj[0]) > 0
    assert _match_set(mt) == _match_set(mj)
    assert {r: sorted(p) for r, p in ft.items()} == {r: sorted(p) for r, p in fj.items()}


def test_from_host_round_trip(reads, monkeypatch):
    rs, j = _jax_index(reads, False, monkeypatch)
    dj = j._device
    t = tdi.DeviceIndex.from_host(
        np.asarray(dj._key), np.asarray(dj._rid), np.asarray(dj._packed),
        dj.n_entries, dj.has_flags, dj.k, dj.w, "cpu",
    )
    for x, y in zip(t.to_host(), dj.to_host()):
        assert np.array_equal(x, y)
    occ = dj.occurrence_for(0.001)
    assert t.occurrence_for(0.001) == occ
    batch = np.ones(len(rs), dtype=bool)
    mj = dj.distance_join(occ, batch, True)
    mt = t.distance_join(occ, batch, True)
    assert _match_set(mt) == _match_set(mj)
    # the port's own build round-trips through its host columns too
    _, ti = _torch_index(reads, False, monkeypatch)
    d = ti._device
    key, rid, pos, strand, flags = d.to_host()
    packed = pos.astype(np.int64) | (strand.astype(np.int64) << 29) | (
        flags.astype(np.int64) << 30
    )
    r = tdi.DeviceIndex.from_host(
        key, rid.astype(np.int32), packed.astype(np.int32), d.n_entries,
        True, 15, 5, "cpu",
    )
    assert all(torch.equal(a, b) for a, b in zip(
        (r._key, r._rid, r._packed), (d._key, d._rid, d._packed)
    ))


def test_occurrence_beyond_max_d_declines_loudly(reads, monkeypatch, capsys):
    rs, j = _jax_index(reads, False, monkeypatch)
    _, t = _torch_index(reads, False, monkeypatch)
    batch = np.ones(len(rs), dtype=bool)
    occ = tdi.MAX_D + 2
    assert j._device.distance_join(occ, batch, True) is None
    assert t._device.distance_join(occ, batch, True) is None
    # at MAX_D + 1 both still join on the device
    assert j._device.distance_join(tdi.MAX_D + 1, batch, True) is not None
    assert t._device.distance_join(tdi.MAX_D + 1, batch, True) is not None
    # through the engine the decline is counted and said on stderr, and
    # the host join takes over with the same overlaps
    t.filter(0.001)
    t._occurrence = occ
    before = TIndex.host_declines
    capsys.readouterr()
    out = t.map_many(TReadSet.from_sequences(reads), np.arange(len(rs)), minhash=True)
    assert TIndex.host_declines == before + 1
    assert "device path declined" in capsys.readouterr().err
    assert t._hashes is not None  # materialized for the host join
    assert sum(v.size for v in out.values()) > 0
