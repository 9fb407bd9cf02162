"""The port's multi-process path (raven_tpu_torch.parallel.distributed, the
process-spanning mesh, the sharded index and the mesh votes across
processes, sharded_candidate_step, sketch_compact and the engine's
device-sketch route) against raven_tpu on the CPU.

In-process: sharded_candidate_step on virtual 8-device meshes against
raven_tpu's on its 8 virtual devices (tests/conftest.py) and the host
oracle (tests/test_parallel.py:18,94); sketch_compact against
sketch_compact_kernel (tests/test_sketch_device.py:59); the device-sketch
route against the host sketch; initialize_distributed's contract.

Across processes (the port of tests/test_distributed.py:49,87): ranks of
`python -m raven_tpu_torch.parallel.worker` on gloo over a file:// store,
4 CPU devices a rank, against raven_tpu, the host oracle and the port in
one process; a rank that owns no reads; a decline on one rank; the
collectives on zero-size splits.  Every child gets a time limit, and on a
timeout every child of its run is killed."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.overlap.engine import MinimizerIndex as JIndex  # noqa: E402
from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex  # noqa: E402
from raven_tpu_torch.parallel import distributed as tdist  # noqa: E402
from raven_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raven_tpu_torch.parallel import worker  # noqa: E402
from raven_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from raven_tpu_torch.parallel.sharded_index import sharded_candidate_step  # noqa: E402
from raven_tpu_torch.utils.synth import overlap_digest  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH8 = Mesh(["cpu"] * 8)
CHILD_TIMEOUT = 240


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
                 "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_DEVICE_SKETCH"):
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


def _write_fasta(path, reads) -> str:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n" % i + lut[r].tobytes() + b"\n")
    return str(path)


def _ranks(argv_of, nproc: int):
    """Run `nproc` children, argv_of(rank) each, to their end: a list of
    (stdout JSON lines, stderr) by rank; every child is killed when one
    outlives CHILD_TIMEOUT, and a child that fails fails the test."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, *argv_of(r)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, f"rank exited {p.returncode}:\n{err[-3000:]}"
            outs.append(([json.loads(ln) for ln in out.splitlines() if ln.startswith("{")],
                         err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _worker(roles, init, *extra, shards=4, nproc=2):
    def argv(rank):
        return ["-m", "raven_tpu_torch.parallel.worker", roles, str(rank), str(nproc),
                init, "gloo", "cpu", str(shards), "--timeout", "120", *extra]

    return _ranks(argv, nproc)


def _script(code, init, *extra, nproc=2):
    """Run `code` in `nproc` children as rank sys.argv[1] of sys.argv[2] at
    sys.argv[3], `extra` after."""
    return _ranks(lambda r: ["-c", code, str(r), str(nproc), init, *extra], nproc)


def _port_stage(reads, mesh, monkeypatch):
    """The worker's overlap stage in this process, with the index on
    `mesh` (None: the single device index): (overlaps, too-frequent
    positions, occurrence)."""
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setattr(TIndex, "MESH", mesh)
    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    idx = TIndex(15, 5, device="cpu")
    idx.minimize(rs, ids, with_query_flags=True)
    idx.filter(0.001)
    fo = {}
    out = idx.map_many(rs, ids, minhash=True, filtered_out=fo)
    return out, fo, int(idx._occurrence)


# -------------------------------------------------------- candidate step
def _candidate_codes(rng, B=16, L=512):
    genome = rng.integers(0, 4, 4096).astype(np.uint32)
    codes = np.zeros((B, L), dtype=np.uint32)
    for b in range(B):
        s = int(rng.integers(0, genome.size - L))
        codes[b] = genome[s : s + L]
    return codes, np.full(B, L, dtype=np.int32), np.arange(B, dtype=np.int32)


def _jax_pairs(mesh, codes, lengths, read_ids, capacity, occurrence=1000):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raven_tpu.parallel.sharded_index import sharded_candidate_step as jstep

    axis = mesh.axis_names[0] if len(mesh.axis_names) == 1 else tuple(mesh.axis_names)
    step = jstep(mesh, k=15, w=5, capacity=capacity, occurrence=occurrence)
    return int(step(
        jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P(axis, None))),
        jax.device_put(jnp.asarray(lengths), NamedSharding(mesh, P(axis))),
        jax.device_put(jnp.asarray(read_ids), NamedSharding(mesh, P(axis))),
    ))


@pytest.mark.parametrize("layout", ["1d", "2x4"])
def test_candidate_step_matches_jax_and_oracle(jmesh8, layout):
    """tests/test_parallel.py:18 (a 1-D mesh of 8) and :94 (a ("data",
    "shard") mesh of 2 x 4): raven_tpu's count and the host oracle's."""
    from raven_tpu.parallel.distributed import make_data_shard_mesh

    codes, lengths, read_ids = _candidate_codes(np.random.default_rng(11))
    capacity = ((2 * 512) // 8) * 8
    if layout == "1d":
        mesh, jmesh = MESH8, jmesh8
    else:
        mesh = Mesh(["cpu"] * 8, ("data", "shard"), (2, 4))
        jmesh = make_data_shard_mesh(2, 4)
    step = sharded_candidate_step(mesh, 15, 5, capacity, 1000)
    pairs = step(codes, lengths, read_ids)
    assert pairs == _jax_pairs(jmesh, codes, lengths, read_ids, capacity)
    assert pairs == worker.oracle_pairs(codes.astype(np.uint8)) > 0


def test_candidate_step_says_what_it_drops(jmesh8, capfd):
    """A capacity below the rows' minimizers: raven_tpu drops the entries
    past a slot silently; the port gives its count and says so."""
    codes, lengths, read_ids = _candidate_codes(np.random.default_rng(12))
    capacity = 128  # slot 32; a device's 2 rows hold ~340 minimizers
    capfd.readouterr()
    pairs = sharded_candidate_step(MESH8, 15, 5, capacity, 1000)(codes, lengths, read_ids)
    err = capfd.readouterr().err
    assert pairs == _jax_pairs(jmesh8, codes, lengths, read_ids, capacity)
    assert pairs < worker.oracle_pairs(codes.astype(np.uint8))
    assert "[raven_tpu_torch::ShardedIndex] candidate step dropped entries" in err


def test_sketch_compact_matches_jax():
    """tests/test_sketch_device.py:59: sketch_compact_kernel's columns,
    entry for entry: ragged lengths, a cut below the cells and a
    capacity past them."""
    import jax.numpy as jnp

    from raven_tpu.ops.sketch import sketch_compact_kernel
    from raven_tpu_torch.ops.sketch import sketch_compact

    rng = np.random.default_rng(13)
    B, L = 5, 512
    codes = rng.integers(0, 4, (B, L)).astype(np.uint32)
    lengths = np.array([512, 300, 14, 511, 200], dtype=np.int32)
    read_ids = np.arange(7, 7 + B, dtype=np.int32)
    for cap in (B * L, 600):
        want = sketch_compact_kernel(jnp.asarray(codes), jnp.asarray(lengths),
                                     jnp.asarray(read_ids), 15, 5, cap)
        got = sketch_compact(torch.from_numpy(codes.astype(np.uint8)),
                             torch.from_numpy(lengths), torch.from_numpy(read_ids), 15, 5, cap)
        assert min(int(got[4]), cap) == int((np.asarray(want[0]) != 0xFFFFFFFF).sum())
        for g, w in zip(got[:4], want):
            assert g.numel() == cap
            assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    got = sketch_compact(torch.from_numpy(codes[:1].astype(np.uint8)),
                         torch.from_numpy(lengths[:1]), torch.from_numpy(read_ids[:1]),
                         15, 5, 1000)
    assert got[0].numel() == 1000 and int(got[0][-1]) == 0xFFFFFFFF
    assert int(got[1][-1]) == -1


def test_device_sketch_route_matches_host(reads, monkeypatch, capsys):
    """The engine's device-sketch route (MinimizerIndex.DEVICE_SKETCH, on
    by default) after a device-index decline: K1's plain version on the
    CPU gives raven_tpu's minimize_reads columns bit for bit, and the host
    index built from them is the host sketch's."""
    from raven_tpu.overlap.minimizer import minimize_reads as jminimize_reads
    from raven_tpu_torch.overlap import engine as tengine

    rs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    got = TIndex(15, 5, device="cpu")._device_sketch(rs, ids)
    want = jminimize_reads(JReadSet.from_sequences(reads), ids, 15, 5, False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert TIndex(16, 5, device="cpu")._device_sketch(rs, ids) is None

    calls = []
    real = TIndex._device_sketch
    monkeypatch.setattr(TIndex, "_device_sketch",
                        lambda self, *a: calls.append(1) or real(self, *a))
    monkeypatch.setattr(TIndex, "DEVICE_MIN_BASES", 0)
    monkeypatch.setattr(tengine, "MAX_TOTAL_ENTRIES", 0)  # every device index declines
    assert TIndex.DEVICE_SKETCH
    before = TIndex.host_declines
    capsys.readouterr()
    dev = TIndex(15, 5, device="cpu")
    dev.minimize(rs, ids, with_query_flags=True)
    assert dev._device is None and len(calls) == 1
    assert TIndex.host_declines == before + 1
    assert "partitioned index's ceiling" in capsys.readouterr().err
    dev.minimize(rs, ids, minhash=True)  # raven_tpu sketches minhash on the host
    assert len(calls) == 1
    dev.minimize(rs, ids, with_query_flags=True)
    monkeypatch.setattr(TIndex, "DEVICE_SKETCH", False)
    host = TIndex(15, 5, device="cpu")
    host.minimize(rs, ids, with_query_flags=True)
    assert len(calls) == 2
    for a in ("_hashes", "_ids", "_pos", "_strand", "_qflag"):
        assert np.array_equal(getattr(dev, a), getattr(host, a)), a
    dev.filter(0.001)
    host.filter(0.001)
    a, b = dev.map_many(rs, ids, minhash=True), host.map_many(rs, ids, minhash=True)
    assert overlap_digest(a) == overlap_digest(b)


# -------------------------------------------------------- the process group
def test_initialize_distributed_contract(tmp_path, monkeypatch):
    """None is a no-op; one gloo rank on the CPU joins over file://; the
    same world again returns it, another raises; the global mesh is the
    rank's device, so default_mesh takes none at one device; a process
    mesh goes through the collectives at world size 1; CUDA asked for
    without a card raises."""
    assert tdist.initialize_distributed(None) is None and tdist.world() is None
    init = f"file://{tmp_path / 'pg'}"
    try:
        w = tdist.initialize_distributed(init, 1, 0, device="cpu", timeout_s=60)
        assert (w.size, w.rank, w.backend, w.devices) == (1, 0, "gloo", (torch.device("cpu"),))
        assert tdist.initialize_distributed(init, 1, 0, device="cpu") is w
        with pytest.raises(RuntimeError, match="cannot join another world"):
            tdist.initialize_distributed(init, 2, 0, device="cpu")
        with pytest.raises(RuntimeError, match="cannot join another world"):
            tdist.initialize_distributed(f"file://{tmp_path / 'other'}", 1, 0, device="cpu")
        m = tmesh.make_mesh()
        assert m.group is not None and m.devices == (torch.device("cpu"),)
        assert tmesh.default_mesh(torch.device("cpu")) is None
        with pytest.raises(ValueError, match="holds 1 devices"):
            tmesh.make_data_shard_mesh(1, 2)
        pm = tdist.process_mesh(["cpu"] * 3)
        assert pm.size == 3 and pm.local_indices == (0, 1, 2) and pm.n_ranks == 1
        tdist.COLLECTIVES.update(calls=0, bytes=0)
        tables = [(torch.ones(2, dtype=torch.int32),) for _ in range(3)]
        t = tmesh.sum_on_first(tables, pm.first, pm.group)[0]
        assert t.tolist() == [3, 3] and tdist.COLLECTIVES["calls"] == 1
    finally:
        tdist.shutdown()
    assert tdist.world() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize_distributed(f"file://{tmp_path / 'cuda'}", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize_distributed(f"file://{tmp_path / 'cuda'}", 1, 0, device="cuda")
    assert tdist.world() is None


def test_mesh_owners():
    """A mesh's devices belong to ranks in rank order, each rank owning
    one or more; a rank drives only its own."""
    m = Mesh(["cpu"] * 4, owners=[0, 0, 1, 1], rank=1)
    assert m.local_indices == (2, 3) and m.n_ranks == 2
    assert list(m.rank_indices(0)) == [0, 1]
    assert [(d, s) for d, s in tmesh.local_blocks(m, 8)] == [
        (torch.device("cpu"), slice(4, 6)), (torch.device("cpu"), slice(6, 8))]
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu"] * 2, owners=[1, 0])
    with pytest.raises(ValueError, match="must each own"):
        Mesh(["cpu"] * 2, owners=[0, 2])
    with pytest.raises(ValueError, match="must each own"):
        Mesh(["cpu"] * 2, owners=[0, 0], rank=1)


_COLLECTIVES = """
import json, sys, torch
from raven_tpu_torch.parallel import distributed as D
r, n, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
D.initialize_distributed(init, n, r, device="cpu", timeout_s=120)
splits = [[3, 0], [0, 0]][r]  # rank 1 sends nothing, rank 0 nothing to rank 1
k = torch.arange(sum(splits), dtype=torch.int64) + 10 * r
W = torch.distributed.group.WORLD
(a, b), got = D.exchange((k, k > 10), splits, W)
(g, gb), counts = D.all_gather_columns((torch.arange(2 * r, dtype=torch.int32),
                                        torch.ones(2 * r, dtype=torch.bool)), W)
s = D.all_reduce_sum(torch.tensor([r + 1], dtype=torch.int32), W)
print(json.dumps({"a": a.tolist(), "b": b.tolist(), "bdt": str(b.dtype), "got": got,
                  "g": g.tolist(), "gb": gb.tolist(), "counts": counts, "s": s.tolist()}))
D.shutdown()
"""


def test_collectives_on_zero_splits(tmp_path):
    """The exchange with zero-size splits (a rank that sends nothing), the
    all-gather with a rank of no rows, bool columns and the integer sum,
    on 2 gloo ranks."""
    outs = _script(_COLLECTIVES, f"file://{tmp_path / 'pg'}")
    (r0,), _ = outs[0]
    (r1,), _ = outs[1]
    assert r0["a"] == [0, 1, 2] and r0["got"] == [3, 0] and r0["bdt"] == "torch.bool"
    assert r1["a"] == [] and r1["got"] == [0, 0]
    for rec in (r0, r1):
        assert rec["g"] == [0, 1] and rec["gb"] == [True, True] and rec["counts"] == [0, 2]
        assert rec["s"] == [3]


# ------------------------------------------------------ two worker ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, reads):
    """The worker's candidates, construct and overlap roles on 2 gloo
    ranks of 4 CPU devices each: {role: [rank 0's line, rank 1's]}."""
    d = tmp_path_factory.mktemp("two_ranks")
    path = _write_fasta(d / "reads.fa", reads)
    outs = _worker("candidates,construct,overlap", f"file://{d / 'pg'}", "--reads", path)
    by_role = {}
    for lines, _ in outs:
        for rec in lines:
            by_role.setdefault(rec["role"], []).append(rec)
    # the construct role takes its own workload, not --reads
    outs = _worker("construct", f"file://{d / 'pg2'}")
    by_role["construct"] = [lines[0] for lines, _ in outs]
    return by_role


def test_two_rank_candidates_and_votes(two_ranks, jmesh8):
    """tests/test_distributed.py:49: both ranks' count equals raven_tpu's
    on its 8 devices and the host oracle's; the three engines' consensus
    on the mesh of 2 ranks is the single device's, bit for bit."""
    codes, lengths, read_ids, _ = worker.candidate_workload()
    jcodes = codes.astype(np.uint32)
    want = _jax_pairs(jmesh8, jcodes, lengths, read_ids, (32 // 8) * 512)
    assert want == worker.oracle_pairs(codes)
    recs = two_ranks["candidates"]
    assert [r["rank"] for r in recs] == [0, 1]
    for rec in recs:
        assert (rec["nproc"], rec["ndev"]) == (2, 8)
        assert rec["pairs"] == rec["oracle"] == want
        assert set(rec["votes"]) == {"full-NW", "banded", "shift-banded"}
        assert all(v["equal"] for v in rec["votes"].values()), rec


def test_two_rank_construct_matches_jax_and_one_process(two_ranks, monkeypatch):
    """tests/test_distributed.py:87: both ranks' construct digest equals
    raven_tpu's host construct and the port's in one process."""
    from raven_tpu.config import OverlapPhaseCfg as JCfg
    from raven_tpu.graph import Graph as JGraph
    from raven_tpu.graph import construct_graph as jconstruct
    from raven_tpu_torch.config import OverlapPhaseCfg
    from raven_tpu_torch.graph import Graph, construct_graph

    rng = np.random.default_rng(2)
    genome = random_genome(rng, 16000)
    rd = sample_reads(rng, genome, 70, 2200, error=0.04)[0]
    monkeypatch.setenv("RAVEN_TPU_DEVICE_MAP", "0")
    jg = JGraph()
    jconstruct(jg, JReadSet.from_sequences(rd), JCfg(use_minhash=True))
    monkeypatch.delenv("RAVEN_TPU_DEVICE_MAP")
    g = Graph()
    construct_graph(g, TReadSet.from_sequences(rd), OverlapPhaseCfg(use_minhash=True),
                    device="cpu")
    want = worker.graph_digest(jg)
    assert worker.graph_digest(g) == want
    for rec in two_ranks["construct"]:
        assert rec["digest"] == want, rec
        assert rec["declines"] == 0 and rec["collectives"] > 0  # the sharded index ran


def test_two_rank_overlaps_match_one_process_and_jax(two_ranks, reads, jmesh8, monkeypatch):
    """The overlaps (their order too), the too-frequent positions and the
    threshold of the index sharded over 2 ranks: the single-process
    ShardedIndex's on 8 virtual devices and raven_tpu's sharded index's."""
    out, fo, occ = _port_stage(reads, MESH8, monkeypatch)
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "1")
    j = JIndex(15, 5)
    jrs = JReadSet.from_sequences(reads)
    ids = np.arange(len(reads))
    j.minimize(jrs, ids, with_query_flags=True)
    j.filter(0.001)
    jfo = {}
    jout = j.map_many(jrs, ids, minhash=True, filtered_out=jfo)
    assert worker.ordered_digest(out) == worker.ordered_digest(jout)
    assert worker.filtered_digest(fo) == worker.filtered_digest(jfo)
    assert occ == j._occurrence
    for rec in two_ranks["overlap"]:
        assert rec["sharded"] and rec["declines"] == 0 and rec["steady_equal"]
        assert rec["ordered"] == worker.ordered_digest(out)
        assert rec["digest"] == overlap_digest(out)[0]
        assert rec["filtered"] == worker.filtered_digest(fo)
        assert rec["occ"] == occ and rec["overlaps"] > 0
        assert rec["exchange"]["bytes"] > 0


def test_rank_without_reads(tmp_path, reads, monkeypatch):
    """Three reads over 2 ranks of 4 devices: rank 1 sketches nothing and
    sends empty cuts, yet owns half the hash ranges; both ranks give the
    single-process index's overlaps."""
    few = reads[:3]
    path = _write_fasta(tmp_path / "few.fa", few)
    outs = _worker("overlap", f"file://{tmp_path / 'pg'}", "--reads", path)
    out, fo, occ = _port_stage(few, MESH8, monkeypatch)
    single, _, _ = _port_stage(few, None, monkeypatch)
    assert overlap_digest(out) == overlap_digest(single)
    for (rec,), _ in outs:
        assert rec["sharded"] and rec["entries"] > 0
        assert rec["ordered"] == worker.ordered_digest(out)
        assert rec["occ"] == occ


_DECLINE = """
import json, sys, numpy as np
from raven_tpu_torch.io import load_sequences
from raven_tpu_torch.overlap import device_index
from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.parallel import distributed, sharded_index, worker
r, n, init, path, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
distributed.initialize_distributed(init, n, r, device="cpu", timeout_s=120)
mesh = distributed.process_mesh(["cpu"] * 4)
if r == 1 and where == "build":  # a sketch chunk over capacity on rank 1 alone
    sharded_index._build_columns = lambda *a, **k: None
if r == 1 and where == "join":  # a join over capacity on rank 1 alone
    device_index.DeviceIndex.join_columns = lambda *a, **k: None
MinimizerIndex.MESH = mesh
MinimizerIndex.DEVICE_MIN_BASES = 0
rs = load_sequences([path])
ids = np.arange(len(rs))
idx = MinimizerIndex(15, 5, device="cpu")
idx.minimize(rs, ids, with_query_flags=True)
kind = type(idx._device).__name__
idx.filter(0.001)
res = idx.map_many(rs, ids, minhash=True)
print(json.dumps({"kind": kind, "declines": MinimizerIndex.host_declines,
                  "ordered": worker.ordered_digest(res)}))
distributed.shutdown()
"""


@pytest.mark.parametrize("where", ["build", "join"])
def test_decline_on_one_rank(tmp_path, reads, where, monkeypatch):
    """A capacity decline on rank 1 alone, in the build or in the join: both
    ranks report it, count it and take the same next path (the single
    device index, or the host join over the index gathered from every
    rank), neither hangs, and both give the single index's overlaps."""
    path = _write_fasta(tmp_path / "reads.fa", reads)
    outs = _script(_DECLINE, f"file://{tmp_path / 'pg'}", path, where)
    single, _, _ = _port_stage(reads, None, monkeypatch)
    for (rec,), err in outs:
        assert "[raven_tpu_torch::ShardedIndex] device path declined" in err
        assert rec["declines"] == 1
        assert rec["kind"] == ("DeviceIndex" if where == "build" else "ShardedIndex")
        assert rec["ordered"] == worker.ordered_digest(single)


def test_two_rank_construct_assemble_gives_the_cli_gfa(tmp_path):
    """The worker's construct role on a reads file, then assemble, on 2
    gloo ranks: both ranks write `python -m raven_tpu_torch reads -p 0
    -F`'s GFA, byte for byte (chip_smoke's phase 3c at 1 Mb)."""
    import contextlib
    import io

    from raven_tpu_torch import cli
    from raven_tpu_torch.utils.synth import simulate_reads

    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, 100_000).astype(np.uint8)
    path = _write_fasta(tmp_path / "reads.fa",
                        simulate_reads(rng, genome, 30, 9000, 0.025, 0.0125, 0.0125))
    want = tmp_path / "cli.gfa"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main([path, "-p", "0", "--disable-checkpoints", "--device", "cpu",
                         "-F", str(want)]) == 0
    outs = _worker("construct", f"file://{tmp_path / 'pg'}", "--reads", path,
                   "--gfa", str(tmp_path / "mp"), shards=2)
    for (rec,), _ in outs:
        assert rec["collectives"] > 0 and rec["declines"] == 0
        with open(rec["gfa"], "rb") as a, open(want, "rb") as b:
            got = a.read()
            assert got.startswith(b"S\t") and got == b.read()
