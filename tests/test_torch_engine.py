"""Port engine (raven_tpu_torch.overlap.engine.MinimizerIndex) through the
overlap stage bench.py times — minimize(with_query_flags) -> filter ->
map_many(minhash) — against the JAX engine with its device map forced on,
and against the port's own host path: equal overlap digests."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu.io.readset import ReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex  # noqa: E402
from raven_tpu_torch.io.readset import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.utils.synth import overlap_digest, synth_reads  # noqa: E402


def _stage(index, rs):
    ids = np.arange(len(rs))
    index.minimize(rs, ids, minhash=False, with_query_flags=True)
    index.filter(0.001)
    return index.map_many(rs, ids, minhash=True), int(index._occurrence)


@pytest.fixture(scope="module")
def readset():
    return synth_reads(60_000, 12, 4000, 0.10, seed=21)


def test_overlap_stage_digest_matches_jax(readset, monkeypatch):
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    before = TIndex.host_declines
    t = TIndex(15, 5, device="cpu")
    got, occ_t = _stage(t, readset)
    assert t._device is not None and t._hashes is None  # device all the way
    assert TIndex.host_declines == before

    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "1")
    jrs = ReadSet(
        names=list(readset.names), starts=readset.starts,
        lengths=readset.lengths, codes=readset.codes, quals=readset.quals,
    )
    j = MinimizerIndex(15, 5)
    want, occ_j = _stage(j, jrs)
    assert j._device is not None
    assert occ_t == occ_j
    dt, nt = overlap_digest(got)
    dj, nj = overlap_digest(want)
    assert nt == nj > 0
    assert dt == dj


@pytest.mark.parametrize("k,w", [(15, 5), (11, 3)])
def test_overlap_stage_device_matches_port_host(readset, k, w, monkeypatch):
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    dev = TIndex(k, w, device="cpu")
    got, occ_d = _stage(dev, readset)
    assert dev._device is not None
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 1 << 62)
    host = TIndex(k, w, device="cpu")
    want, occ_h = _stage(host, readset)
    assert host._device is None
    assert occ_d == occ_h
    assert overlap_digest(got) == overlap_digest(want)


def test_stage_minus4_pattern(monkeypatch):
    """Index a read subset (no flags), map it in sub-batches with the
    too-frequent positions collected: device equals host."""
    rs = synth_reads(40_000, 10, 3000, 0.08, seed=5)
    valid = np.arange(0, len(rs), 2)
    out = []
    for min_bases in (0, 1 << 62):
        monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", min_bases)
        idx = TIndex(15, 5, device="cpu")
        idx.minimize(rs, valid, minhash=False)
        idx.filter(0.001)
        filt = {}
        res = {}
        half = valid.size // 2
        for sub in (valid[:half], valid[half:]):
            res.update(idx.map_many(rs, sub, minhash=False, filtered_out=filt))
        out.append((overlap_digest(res), filt))
    assert out[0] == out[1]


def test_readset_copy_is_interchangeable(readset):
    """The port's ReadSet copy holds the same columns as raven_tpu's."""
    reads = [readset.sequence(i) for i in range(5)]
    a, b = TReadSet.from_sequences(reads), ReadSet.from_sequences(reads)
    for f in ("starts", "lengths", "codes"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
