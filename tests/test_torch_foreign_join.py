"""The device route for reads outside an index's build set (foreign
queries): MinimizerIndex.map_many's foreign join against its host route,
and the construct's streamed index batches, whose later batches map the
earlier batches' reads, against raven_tpu's host route and the port's host
index, in both passes, with and without a partitioned index."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu import api as japi  # noqa: E402
from raven_tpu.config import OverlapPhaseCfg as JCfg  # noqa: E402
from raven_tpu.graph import construct as jconstruct  # noqa: E402
from raven_tpu.graph.graph import Graph as JGraph  # noqa: E402
from raven_tpu.io.readset import ReadSet as JReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex as JIndex  # noqa: E402
from raven_tpu_torch import api as tapi  # noqa: E402
from raven_tpu_torch.config import OverlapPhaseCfg  # noqa: E402
from raven_tpu_torch.graph import construct  # noqa: E402
from raven_tpu_torch.graph.graph import Graph  # noqa: E402
from raven_tpu_torch.overlap import device_index  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.overlap.types import OVERLAP_DTYPE  # noqa: E402
from raven_tpu_torch.pile.pile import Piles  # noqa: E402
from raven_tpu_torch.utils.synth import synth_reads  # noqa: E402

# the construct's budgets cut small: three index batches of the 720 kb read
# set, map sub-batches that straddle their ends, two second-pass batches
BATCHES = {"INDEX_BATCH_BYTES": 300_000, "MAP_BATCH_BYTES": 250_000,
           "SECOND_PASS_BATCH_BYTES": 400_000}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def readset():
    return synth_reads(60_000, 12, 4000, 0.10, seed=21)


def _same(got: dict, want: dict) -> None:
    """Equal {read: overlaps} dicts, keys and each read's array in order."""
    assert list(got) == list(want)
    for r in want:
        assert got[r].dtype == want[r].dtype and np.array_equal(got[r], want[r]), r


def _engine_map(readset, build, query, device_map, parts=0, build_minhash=False,
                minhash=True, avoid=True, flags=True):
    """One index over `build`, filtered as the construct does, and one
    map_many of `query`: (results, filtered_out, host_maps added, the
    index)."""
    before = TIndex.host_maps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TIndex, "DEVICE_MIN_BASES", 0)
        mp.setattr(TIndex, "DEVICE_MAP", device_map)
        mp.setattr(TIndex, "INDEX_PARTS", parts)
        idx = TIndex(15, 5, device="cpu")
        idx.minimize(readset, build, minhash=build_minhash, with_query_flags=flags)
        idx.filter(0.001)
        filt = {}
        res = idx.map_many(readset, query, avoid_equal=avoid, avoid_symmetric=avoid,
                           minhash=minhash, filtered_out=filt)
    return res, filt, TIndex.host_maps - before, idx


@pytest.mark.parametrize("parts", [0, 2, 3])
@pytest.mark.parametrize("minhash", [True, False], ids=["stage-5", "stage-4"])
def test_foreign_queries_map_as_the_host_route(readset, parts, minhash):
    """An index over the middle third of the reads, every read queried:
    the lower reads are foreign with higher targets, the upper ones
    foreign with only lower targets (avoid_symmetric leaves them none);
    the device route equals the host route's overlaps and too-frequent
    positions, and only the host route counts in host_maps."""
    n = len(readset)
    build = np.arange(n // 3, 2 * n // 3)
    query = np.arange(n)
    got, got_f, dev_maps, idx = _engine_map(readset, build, query, True, parts,
                                            minhash=minhash, flags=minhash)
    assert idx._device is not None and idx._hashes is None
    want, want_f, host_maps, host = _engine_map(readset, build, query, False, parts,
                                                minhash=minhash, flags=minhash)
    assert host._device is None
    assert dev_maps == 0 and host_maps == 1
    _same(got, want)
    assert got_f == want_f
    lower = [r for r in range(n // 3) if got[r].size]
    assert lower and all(int(o["rhs_id"]) >= n // 3 for r in lower for o in got[r])
    # the reads above the build set have only lower targets
    assert not any(got[r].size for r in range(2 * n // 3, n))
    if not minhash:
        assert sum(len(v) for v in got_f.values()) > 0


def test_foreign_query_above_its_targets(readset):
    """Without avoid_symmetric a foreign query keeps its hits on lower
    ids: the query reads lie above the whole build set."""
    n = len(readset)
    build = np.arange(0, n // 2)
    query = np.arange(n // 2 + 10, n // 2 + 40)
    got, got_f, dev_maps, _ = _engine_map(readset, build, query, True, minhash=False,
                                          avoid=False, flags=False)
    want, want_f, _, _ = _engine_map(readset, build, query, False, minhash=False,
                                     avoid=False, flags=False)
    assert dev_maps == 0
    _same(got, want)
    assert got_f == want_f
    hits = [o for r in query.tolist() for o in got[r]]
    assert hits and all(int(o["rhs_id"]) < int(o["lhs_id"]) for o in hits)


def test_foreign_join_chunks_give_the_same_overlaps(readset, monkeypatch):
    """Expansion and chaining cut into many chunks (of whole reads for the
    chain) change nothing, in the self-join's chain too."""
    n = len(readset)
    build = np.arange(n // 2, n)
    query = np.arange(n)
    want, want_f, _, _ = _engine_map(readset, build, query, True, parts=2, minhash=False,
                                     flags=False)
    monkeypatch.setattr(device_index, "EXPAND_MATCHES", 700)
    monkeypatch.setattr(device_index, "CHAIN_MATCHES", 3000)
    calls = []
    from raven_tpu_torch.ops import chain_device

    orig = chain_device.chain_matches_device

    def counted(*a, **k):
        calls.append(a[0].numel())
        return orig(*a, **k)

    monkeypatch.setattr(chain_device, "chain_matches_device", counted)
    got, got_f, dev_maps, _ = _engine_map(readset, build, query, True, parts=2,
                                          minhash=False, flags=False)
    assert dev_maps == 0 and len(calls) > 4
    _same(got, want)
    assert got_f == want_f


def _batched(monkeypatch):
    for name, value in BATCHES.items():
        monkeypatch.setattr(construct, name, value)
        monkeypatch.setattr(jconstruct, name, value)
    monkeypatch.delenv("RAVEN_TPU_INDEX_BATCH_BASES", raising=False)


def _spy(monkeypatch, cls, calls):
    orig = cls.map_many

    def spy(self, readset, ids, *a, filtered_out=None, **kw):
        res = orig(self, readset, ids, *a, filtered_out=filtered_out, **kw)
        calls.append((np.asarray(ids).tolist(), res,
                      None if filtered_out is None else
                      {int(r): list(p) for r, p in filtered_out.items()}))
        return res

    monkeypatch.setattr(cls, "map_many", spy)


def _port_construct(readset, monkeypatch, device_map, parts):
    """The port's construct_graph on the CPU with the budgets cut: its map
    calls, stage -5's overlaps and piles, the GFA."""
    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(TIndex, "DEVICE_MIN_BASES", 0)
        mp.setattr(TIndex, "DEVICE_MAP", device_map)
        mp.setattr(TIndex, "INDEX_PARTS", parts)
        cfg = OverlapPhaseCfg()
        index = TIndex(cfg.kmer_len, cfg.window_len, device="cpu")
        piles = Piles(readset.lengths)
        overlaps = [np.zeros(0, dtype=OVERLAP_DTYPE) for _ in range(len(readset))]
        construct.find_overlaps_and_create_piles(index, readset, cfg, piles, overlaps)
        stage5 = (overlaps, [piles.row(r).copy() for r in range(len(readset))])
        _spy(mp, TIndex, calls)
        graph = Graph()
        construct.construct_graph(graph, readset, cfg, device="cpu")
    return calls, stage5, tapi.graph_get_gfa(graph, include_dp=True)


@pytest.fixture(scope="module")
def raven_tpu_construct(readset):
    """raven_tpu's construct_graph on its host route with the same budgets:
    its map calls and GFA."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _batched(mp)
        mp.setenv("RAVEN_TPU_DEVICE_MAP", "0")
        _spy(mp, JIndex, calls)
        jrs = JReadSet(names=list(readset.names), starts=readset.starts,
                       lengths=readset.lengths, codes=readset.codes, quals=readset.quals)
        graph = JGraph()
        jconstruct.construct_graph(graph, jrs, JCfg())
    return calls, japi.graph_get_gfa(graph, include_dp=True)


@pytest.fixture(scope="module")
def port_host_construct(readset):
    """The port's construct on its host index (DEVICE_MAP off): every map
    call takes the host route."""
    maps = TIndex.host_maps
    with pytest.MonkeyPatch.context() as mp:
        _batched(mp)
        calls, stage5, gfa = _port_construct(readset, mp, False, 0)
    assert TIndex.host_maps - maps >= len(calls) > 0
    return calls, stage5, gfa


def _same_calls(got, want):
    assert [ids for ids, _, _ in got] == [ids for ids, _, _ in want]
    for (_, res, filt), (_, w_res, w_filt) in zip(got, want):
        _same(res, w_res)
        assert filt == w_filt


@pytest.mark.parametrize("parts", [0, 3])
def test_streamed_construct_maps_foreign_reads_on_the_device(
        readset, parts, monkeypatch, raven_tpu_construct, port_host_construct):
    """Three index batches: stage -5's overlaps and piles, every map call
    of both passes (overlaps and too-frequent positions) and the GFA equal
    the port's host index's and raven_tpu's host route's, with no host
    map and no decline on the device route."""
    _batched(monkeypatch)
    foreign = []
    orig = device_index.foreign_join

    def counted(parts_, readset_, ids, *a, **kw):
        foreign.append(set(np.asarray(ids).tolist()))
        return orig(parts_, readset_, ids, *a, **kw)

    monkeypatch.setattr(device_index, "foreign_join", counted)
    maps, declines = TIndex.host_maps, TIndex.host_declines
    calls, stage5, gfa = _port_construct(readset, monkeypatch, True, parts)
    assert TIndex.host_maps == maps and TIndex.host_declines == declines
    # the foreign join ran in both passes, and some map call held reads of
    # both kinds
    assert len(foreign) >= 4
    assert any(f < set(ids) for f in foreign for ids, _, _ in calls)
    h_calls, h_stage5, h_gfa = port_host_construct
    j_calls, j_gfa = raven_tpu_construct

    # stage -5 streamed three batches, and a map sub-batch held both kinds
    stage5_calls = [c for c in calls if c[2] is None]
    assert len(stage5_calls) >= 5
    (ovl, rows), (w_ovl, w_rows) = stage5, h_stage5
    assert all(np.array_equal(a, b) for a, b in zip(ovl, w_ovl))
    assert all(np.array_equal(a, b) for a, b in zip(rows, w_rows))
    assert sum(o.size for o in stage5[0]) > 0
    _same_calls(calls, h_calls)
    assert len(j_calls) == len(calls)
    for (ids, res, filt), (j_ids, j_res, j_filt) in zip(calls, j_calls):
        assert ids == j_ids and filt == j_filt
        assert list(res) == list(j_res)
        for r in res:
            assert np.array_equal(res[r].view(np.uint8), np.asarray(j_res[r]).view(np.uint8)), r
    assert any(f for _, _, f in calls if f)  # stage -4's too-frequent positions
    assert gfa == h_gfa == j_gfa and len(gfa) > 0


@pytest.mark.parametrize("limit", ["MAX_ENTRIES", "SAFE_JOIN_ENTRIES"])
def test_partitioned_index_balances_crowded_ranges(readset, monkeypatch, limit):
    """Minimizer hashes crowd the low end of the hash space, so raven_tpu's
    equal ranges overfill the first part near the partitioned ceiling:
    with MAX_ENTRIES (or the self-join's SAFE_JOIN_ENTRIES) under the
    first equal range's entries, the ranges are cut by the build's
    histogram into as many as keep every part under it, and the overlaps
    and too-frequent positions of own and foreign queries are the single
    index's."""
    n = len(readset)
    build, query = np.arange(n // 4, n), np.arange(n)
    want, want_f, _, _ = _engine_map(readset, build, query, True, minhash=False, flags=False)
    cols = device_index._build_columns(readset, build, 15, 5, False, False, "cpu",
                                       device_index.range_splits(3))
    counts = cols[4]
    total = sum(counts)
    assert counts[0] > total // 2  # the crowded low end
    cap = counts[0] - 1 if limit == "MAX_ENTRIES" else total // 5
    monkeypatch.setattr(device_index, limit, cap)
    got, got_f, dev_maps, idx = _engine_map(readset, build, query, True, parts=3,
                                            minhash=False, flags=False)
    parts = idx._device.parts
    assert isinstance(idx._device, device_index.PartitionedIndex)
    assert len(parts) == (3 if limit == "MAX_ENTRIES" else 6)
    assert all(p.n_entries <= cap for p in parts)
    assert max(p.n_entries for p in parts) < 1.1 * total / len(parts)
    assert dev_maps == 0
    _same(got, want)
    assert got_f == want_f
