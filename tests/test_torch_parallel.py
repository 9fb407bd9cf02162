"""The port's single-host multi-device path (raven_tpu_torch.parallel) vs
raven_tpu's on the CPU: the hash-range-sharded index on a virtual 8-device
CPU mesh against raven_tpu's ShardedIndex on its 8 virtual devices
(tests/conftest.py) and against the port's single and partitioned
indexes — columns, occurrence threshold (the clipped tail too), per-read
overlaps in order, too-frequent positions, a 2-D ("data", "shard") mesh,
an end-to-end construct, a skewed read set — the engine's route to it,
and the mesh helpers themselves.  The mesh-summed window votes are held
in tests/test_torch_mesh_votes.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex as JIndex  # noqa: E402
from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.overlap import device_index as tdi  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raven_tpu_torch.parallel import sharded_index as tsi  # noqa: E402
from raven_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from raven_tpu_torch.parallel.sharded_index import ShardedIndex  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402

MESH8 = Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_reference_env(monkeypatch):
    for name in ("RAVEN_TPU_SHARDED_MAP", "RAVEN_TPU_DEVICE_MAP", "RAVEN_TPU_INDEX_PARTS",
                 "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_CONSENSUS_ENGINE",
                 "RAVEN_TPU_CONSENSUS_ITERS", "RAVEN_TPU_BANDED"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from raven_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


@pytest.fixture(scope="module")
def reads():
    """tests/test_sharded_map.py's read set: a 16 kb genome, 70 reads of
    2.2 kb at 4% error."""
    rng = np.random.default_rng(2024)
    genome = random_genome(rng, 16000)
    return sample_reads(rng, genome, 70, 2200, error=0.04)[0]


def _skewed_reads():
    """tests/test_sharded_map.py:235's skew: 40 extra copies of a 25 bp
    motif in a 14 kb genome."""
    rng = np.random.default_rng(99)
    genome = random_genome(rng, 14000)
    motif = genome[1000:1025]
    g = list(genome)
    for i in range(40):
        at = 2000 + i * 290
        g[at : at + len(motif)] = motif
    return sample_reads(rng, "".join(g), 90, 2200, error=0.03)[0]


def _port_stage(reads, mesh, minhash_query, monkeypatch):
    """The port's overlap stage with MinimizerIndex.MESH = mesh (None: the
    single device index): (index, overlaps, too-frequent positions)."""
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setattr(TIndex, "MESH", mesh)
    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    idx = TIndex(15, 5, device="cpu")
    idx.minimize(rs, ids, with_query_flags=minhash_query)
    assert isinstance(idx._device, ShardedIndex if mesh is not None else tdi.DeviceIndex)
    idx.filter(0.001)
    fo = {}
    out = idx.map_many(rs, ids, minhash=minhash_query, filtered_out=fo)
    assert idx._hashes is None, "the join left the device index"
    return idx, out, {r: sorted(p) for r, p in fo.items()}


def _jax_sharded_stage(reads, minhash_query, monkeypatch):
    from raven_tpu.parallel.sharded_index import ShardedIndex as JShardedIndex

    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "1")
    rs = JReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    idx = JIndex(15, 5)
    idx.minimize(rs, ids, with_query_flags=minhash_query)
    assert isinstance(idx._device, JShardedIndex)
    idx.filter(0.001)
    fo = {}
    out = idx.map_many(rs, ids, minhash=minhash_query, filtered_out=fo)
    return idx, out, {r: sorted(p) for r, p in fo.items()}


def _same_overlaps(a, b):
    assert set(a) == set(b)
    for rid in a:
        assert a[rid].shape == b[rid].shape, f"read {rid}"
        assert np.array_equal(a[rid], b[rid]), f"read {rid} overlaps differ"


# ------------------------------------------------------------ sharded index
@pytest.mark.parametrize("minhash", [False, True])
def test_sharded_parts_equal_partitioned_index(reads, minhash):
    """Each owner's merge restores the single index's columns: part d of
    the 8-device index equals part d of the 8-part index on one device,
    column for column, and lies on device d."""
    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    sh = ShardedIndex.build(rs, ids, 15, 5, minhash, not minhash, MESH8)
    pi = tdi.PartitionedIndex.build(rs, ids, 15, 5, minhash, not minhash, "cpu", 8)
    assert len(sh.parts) == len(pi.parts) == 8
    assert sh.n_entries == pi.n_entries > 0
    for d, (a, b) in enumerate(zip(sh.parts, pi.parts)):
        assert a.device == MESH8.devices[d]
        for x, y in ((a._key, b._key), (a._rid, b._rid), (a._packed, b._packed)):
            assert torch.equal(x, y)
        assert a.capacity == b.capacity
        assert a.has_flags == b.has_flags


@pytest.mark.parametrize("minhash_query", [False, True])
def test_sharded_overlaps_match_jax_and_single(reads, jmesh8, minhash_query, monkeypatch):
    """tests/test_sharded_map.py:81: the same entries, threshold,
    per-read overlaps (order included) and too-frequent positions as
    raven_tpu's sharded index and the port's single device index."""
    s_idx, s_ovl, s_fo = _port_stage(reads, MESH8, minhash_query, monkeypatch)
    d_idx, d_ovl, d_fo = _port_stage(reads, None, minhash_query, monkeypatch)
    j_idx, j_ovl, j_fo = _jax_sharded_stage(reads, minhash_query, monkeypatch)
    assert s_idx.num_minimizers == d_idx.num_minimizers == j_idx.num_minimizers
    assert s_idx._occurrence == d_idx._occurrence == j_idx._occurrence
    assert sum(o.size for o in s_ovl.values()) > 0
    _same_overlaps(s_ovl, d_ovl)
    _same_overlaps(s_ovl, j_ovl)
    assert s_fo == d_fo == j_fo


def test_sharded_filter_quantile_matches(reads, jmesh8, monkeypatch):
    """The filter at several frequencies: the single index's threshold,
    and raven_tpu's sharded one."""
    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    sh = ShardedIndex.build(rs, ids, 15, 5, False, False, MESH8)
    single = tdi.DeviceIndex.build(rs, ids, 15, 5, False, False, "cpu")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "1")
    j = JIndex(15, 5)
    j.minimize(JReadSet.from_sequences(reads), ids)
    for f in (0.001, 0.01, 0.05):
        j.filter(f)
        assert sh.occurrence_for(f) == single.occurrence_for(f) == j._occurrence, f


def test_sharded_filter_exact_in_clipped_tail(jmesh8):
    """tests/test_sharded_map.py:198's run lengths (600, 550 and 510
    singles, past raven_tpu's 512-bin histogram), spread over the port's
    parts: the exact quantile, as raven_tpu's device search gives it."""
    from raven_tpu.ops.sketch import UINT32_INF
    from raven_tpu.parallel.sharded_index import _HBINS
    from raven_tpu.parallel.sharded_index import ShardedIndex as JShardedIndex

    run_lengths = [600, 550] + [1] * 510
    keys = np.repeat(np.arange(len(run_lengths)), run_lengths)
    # the reference's layout: every entry on its shard 0
    m_local = 2048
    key = np.full(8 * m_local, UINT32_INF, dtype=np.uint32)
    key[: keys.size] = keys
    hist = np.zeros(_HBINS, dtype=np.int64)
    for c in run_lengths:
        hist[min(c, _HBINS - 1)] += 1
    zeros = np.zeros_like(key, dtype=np.int32)
    jsh = JShardedIndex(jmesh8, key, zeros, zeros, keys.size, hist, False, 15, 5)
    # the port's: run d of every 8 in part d
    parts = []
    for d in range(8):
        k = torch.from_numpy(
            np.repeat(np.arange(d, len(run_lengths), 8), np.asarray(run_lengths)[d::8])
        ).to(torch.int32)
        z = torch.zeros_like(k)
        parts.append(tdi.DeviceIndex(k, z, z, False, 15, 5))
    sh = ShardedIndex(MESH8, parts, 15, 5, False)
    counts = np.sort(run_lengths)
    for f in (0.001, 0.002, 0.003):
        target = min(int((1.0 - f) * len(run_lengths)), len(run_lengths) - 1)
        assert sh.occurrence_for(f) == jsh.occurrence_for(f) == int(counts[target]), f


def test_two_axis_mesh_sharded_index(reads, monkeypatch):
    """tests/test_sharded_map.py:122: a ("data", "shard") mesh of 2 x 4
    gives raven_tpu's 2 x 4 index: entries, threshold and match set."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from raven_tpu.parallel.distributed import make_data_shard_mesh
    from raven_tpu.parallel.sharded_index import ShardedIndex as JShardedIndex

    mesh = Mesh(["cpu"] * 8, ("data", "shard"), (2, 4))
    ids = np.arange(len(reads))
    sh = ShardedIndex.build(TReadSet.from_sequences(reads), ids, 15, 5, False, True, mesh)
    jsh = JShardedIndex.build(JReadSet.from_sequences(reads), ids, 15, 5, False, True,
                              mesh=make_data_shard_mesh(2, 4))
    assert sh is not None and jsh is not None and len(sh.parts) == 8
    assert sh.n_entries == jsh.n_entries
    occ = sh.occurrence_for(0.001)
    assert occ == jsh.occurrence_for(0.001)
    batch = np.ones(len(reads), bool)
    got = sh.distance_join(occ, batch, need_flags=True)
    want = jsh.distance_join(occ, batch, need_flags=True)
    key = lambda t: sorted(zip(*(np.asarray(a).tolist() for a in t)))  # noqa: E731
    assert key(got) == key(want)


def test_sharded_construct_end_to_end(monkeypatch):
    """tests/test_sharded_map.py:157: construct with minhash on the
    8-device mesh gives raven_tpu's sharded construct's GFA and the port's
    single-index one."""
    from raven_tpu.config import OverlapPhaseCfg as JCfg
    from raven_tpu.graph import Graph as JGraph
    from raven_tpu.graph import construct_graph as jconstruct
    from raven_tpu.graph import get_gfa as jgfa
    from raven_tpu_torch.config import OverlapPhaseCfg
    from raven_tpu_torch.graph import Graph, construct_graph, get_gfa

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    rng = np.random.default_rng(3131)
    genome = random_genome(rng, 20000)
    reads = sample_reads(rng, genome, 90, 2500, error=0.04)[0]
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)

    def port(mesh):
        monkeypatch.setattr(TIndex, "MESH", mesh)
        g = Graph()
        construct_graph(g, TReadSet.from_sequences(reads), OverlapPhaseCfg(use_minhash=True),
                        device="cpu")
        return get_gfa(g, include_dp=True)

    declines = TIndex.host_declines
    got = port(MESH8)
    assert TIndex.host_declines == declines
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "1")
    jg = JGraph()
    jconstruct(jg, JReadSet.from_sequences(reads), JCfg(use_minhash=True))
    assert any(ln.startswith("L\t") for ln in got)
    assert got == jgfa(jg, include_dp=True)
    assert got == port(None)


def test_sharded_skew_stays_on_the_device(jmesh8, monkeypatch, capfd):
    """tests/test_sharded_map.py:235: a hot motif skews the hash ranges;
    the sharded index neither declines nor differs from raven_tpu's
    sharded index and the single device index."""
    reads = _skewed_reads()
    declines = TIndex.host_declines
    capfd.readouterr()
    _, s_ovl, s_fo = _port_stage(reads, MESH8, True, monkeypatch)
    assert "declined" not in capfd.readouterr().err
    assert TIndex.host_declines == declines
    _, d_ovl, d_fo = _port_stage(reads, None, True, monkeypatch)
    _, j_ovl, j_fo = _jax_sharded_stage(reads, True, monkeypatch)
    _same_overlaps(s_ovl, d_ovl)
    _same_overlaps(s_ovl, j_ovl)
    assert s_fo == d_fo == j_fo


def test_engine_route(reads, monkeypatch, capfd):
    """MinimizerIndex.MESH forces the sharded index at any input size and
    no environment variable does (raven_tpu's RAVEN_TPU_SHARDED_MAP=1 is
    ignored); on the CPU without it the engine builds no mesh.  A sharded
    capacity decline says so in its scope, counts, and the single device
    index takes the input."""
    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "1")
    assert TIndex.MESH is None and tmesh.default_mesh(torch.device("cpu")) is None
    idx = TIndex(15, 5, device="cpu")
    idx.minimize(rs, ids)
    assert idx._device is None  # under DEVICE_MIN_BASES: the host build
    monkeypatch.setattr(TIndex, "MESH", MESH8)
    idx.minimize(rs, ids)
    assert isinstance(idx._device, ShardedIndex)

    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setattr(tsi, "MAX_ENTRIES", 100)
    declines = TIndex.host_declines
    capfd.readouterr()
    idx.minimize(rs, ids)
    err = capfd.readouterr().err
    assert "[raven_tpu_torch::ShardedIndex] device path declined" in err
    assert TIndex.host_declines == declines + 1
    assert isinstance(idx._device, tdi.DeviceIndex)


# -------------------------------------------------------------------- meshes
def test_mesh_helpers():
    """make_mesh takes cards only and raises when there are fewer; a
    virtual mesh is built explicitly; rows split in contiguous blocks;
    the psum is an exact integer sum on the first device."""
    with pytest.raises(ValueError, match="CUDA devices"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="CUDA devices"):
        tmesh.make_data_shard_mesh(1, 2)
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 6, ("data", "shard"), (2, 4))
    m = Mesh(["cpu"] * 4, ("data", "shard"), (2, 2))
    assert m.size == 4 and m.first == torch.device("cpu")
    assert tmesh.split_rows(12, m.size) == [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)]
    with pytest.raises(ValueError):
        tmesh.split_rows(10, m.size)
    parts = [(torch.full((3,), i, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
             for i in range(4)]
    a, b = tmesh.sum_on_first(parts, m.first)
    assert a.dtype == torch.int32 and a.tolist() == [6, 6, 6] and b.tolist() == [4, 4]
