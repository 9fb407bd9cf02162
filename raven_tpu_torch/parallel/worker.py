"""One rank of a multi-process run of the port.

    python -m raven_tpu_torch.parallel.worker ROLES PID NPROC INIT BACKEND DEVICE SHARDS \\
        [--reads FILE] [--gfa PREFIX] [--bank] [--timeout S]

The port's counterpart of misc/distributed_worker.py and
misc/distributed_construct_worker.py.  Start NPROC of these, PID 0 to
NPROC - 1, with one INIT address (tcp://127.0.0.1:PORT or file:///path);
each joins the process group (BACKEND nccl or gloo, on DEVICE: cpu or
cuda:N) and lays SHARDS copies of DEVICE into one mesh over every rank's
devices (a virtual mesh when SHARDS > 1).  ROLES is a comma-separated list
of:

  candidates  raven_tpu's fixed candidate-count workload (B, L, k, w = 32,
              512, 15, 5, seed 7) through sharded_candidate_step, this
              rank's rows of it, beside the host oracle's count; then the
              three window-consensus engines (full-NW, anchored banded,
              shift-banded) on the rank's device alone and on the mesh:
              on 4 windows drawn after the reads (raven_tpu's), or with
              --bank on bench_polish.py's bank of 512 windows at its shapes;
  overlap     the overlap stage (minimize -> filter -> map_many, as bench.py
              runs it) on the reads of --reads, cold and steady, through
              the index sharded over the mesh, then once more with the
              collectives timed (a pass of its own: the timer synchronises
              the device around each collective);
  construct   construct_graph through the sharded index on the reads of
              --reads (the CLI's defaults, as `-p 0` runs it) or on
              raven_tpu's 16 kb workload (70 reads of 2.2 kb at 4%
              error, seed 2, with micromizers), and the live nodes' and
              edges' digest; with --gfa, then assemble and the GFA written
              to PREFIX.rank<PID>.gfa, as `-p 0 -F` writes it.

Each role prints one JSON line.  Every kernel's launch count starts at 0
just before the role's mesh run and is read just after.  The workloads
come from the port's own generators (utils/synth.py).  On an exception a
rank prints it, aborts the group and exits 1, so no rank waits on it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
import traceback

import numpy as np
import torch

K, W, FREQ = 15, 5, 0.001


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda, sketch_cuda

    return {"K1": sketch_cuda.LAUNCHES, "K2": consensus_cuda.LAUNCHES,
            "K3": band_cuda.LAUNCHES["band_forward"],
            "K4": band_cuda.LAUNCHES["mask_walk_votes"],
            "K9": banded_cuda.LAUNCHES["nw_moves_banded"],
            "K10": banded_cuda.LAUNCHES["traceback_banded"]}


def _reset_counts() -> None:
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda, sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel import distributed

    sketch_cuda.LAUNCHES = 0
    consensus_cuda.LAUNCHES = 0
    band_cuda.LAUNCHES.update(dict.fromkeys(band_cuda.LAUNCHES, 0))
    banded_cuda.LAUNCHES.update(dict.fromkeys(banded_cuda.LAUNCHES, 0))
    MinimizerIndex.host_declines = 0
    distributed.COLLECTIVES.update(calls=0, bytes=0)


@contextlib.contextmanager
def _timed_collectives(device):
    """While the context lasts, torch.distributed's all_to_all_single,
    all_gather and all_reduce (the ones parallel/distributed.py calls)
    add their seconds to the dict it yields, the device synchronised
    before and after each, so each holds its own transfer only."""
    spent = {"seconds": 0.0}
    names = ("all_to_all_single", "all_gather", "all_reduce")
    real = {n: getattr(torch.distributed, n) for n in names}

    def timed(fn):
        def call(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _sync(device)
                spent["seconds"] += time.perf_counter() - t0
        return call

    for n, fn in real.items():
        setattr(torch.distributed, n, timed(fn))
    try:
        yield spent
    finally:
        for n, fn in real.items():
            setattr(torch.distributed, n, fn)


def _peak(device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def candidate_workload():
    """raven_tpu's worker workload: (codes [32, 512] uint8, lengths,
    read_ids, the generator, which the windows continue from)."""
    B, L = 32, 512
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 4096).astype(np.uint32)
    codes = np.zeros((B, L), dtype=np.uint8)
    for b in range(B):
        s = int(rng.integers(0, genome.size - L))
        codes[b] = genome[s : s + L]
    return codes, np.full(B, L, dtype=np.int32), np.arange(B, dtype=np.int32), rng


def oracle_pairs(codes) -> int:
    """The host count: pairs of equal minimizer hashes over every row."""
    from raven_tpu_torch.overlap.minimizer import minimize_read

    hs = np.sort(np.concatenate([minimize_read(c, K, W)[0] for c in codes]))
    lo = np.searchsorted(hs, hs, "left")
    hi = np.searchsorted(hs, hs, "right")
    return int(((hi - lo) - 1).sum() // 2)


def _engines(windows, bank: bool):
    """(name, call(**where)) of the three window-consensus engines."""
    from raven_tpu_torch.ops.consensus_band import band_window_consensus
    from raven_tpu_torch.ops.consensus_device import device_window_consensus

    if bank:  # chip_smoke's phase 8b: the polisher's shapes, 4 iterations
        full = dict(iterations=4, chunk=2048)
        band = dict(iterations=4)
    else:  # raven_tpu's worker: 1 iteration at 256 x 256
        full = dict(iterations=1, t_pad=256, q_pad=256, chunk=8)
        band = dict(iterations=1, t_pad=256, q_pad=256)
        windows = [(bb, frs, wts, [(0, f.size) for f in frs]) for bb, frs, wts in windows]
    return (
        ("full-NW", lambda **k: device_window_consensus(windows, **full, **k)),
        ("banded", lambda **k: device_window_consensus(windows, banded=True, **full, **k)),
        ("shift-banded", lambda **k: band_window_consensus(windows, **band, **k)),
    )


def role_candidates(mesh, args) -> dict:
    from raven_tpu_torch.parallel.sharded_index import sharded_candidate_step
    from raven_tpu_torch.utils.synth import make_windows

    device = torch.device(args.device)
    codes, lengths, read_ids, rng = candidate_workload()
    B, L = codes.shape
    if B % mesh.n_ranks or B % mesh.size:
        raise ValueError(f"{B} rows do not split over {mesh.n_ranks} ranks and "
                         f"{mesh.size} devices")
    rows = B // mesh.n_ranks
    mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    step = sharded_candidate_step(mesh, K, W, capacity=(B // mesh.size) * L, occurrence=1000)
    _reset_counts()
    t0 = time.perf_counter()
    pairs = step(codes[mine], lengths[mine], read_ids[mine])
    step_s = time.perf_counter() - t0
    out = {"role": "candidates", "rank": mesh.rank, "nproc": mesh.n_ranks,
           "ndev": mesh.size, "pairs": pairs, "oracle": oracle_pairs(codes),
           "step_s": step_s, "step_k1": _launches()["K1"], "votes": {}}

    if args.bank:
        windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    else:
        windows = []
        for _ in range(4):
            truth = rng.integers(0, 4, 200).astype(np.uint8)
            frags = [np.where(rng.random(200) < 0.05, (truth + 1) % 4, truth).astype(np.uint8)
                     for _ in range(8)]
            windows.append((truth.copy(), frags, None))
    for name, call in _engines(windows, args.bank):
        call(device=device)  # warm: the first call of an engine loads its kernels
        _sync(device)
        t0 = time.perf_counter()
        want = call(device=device)
        single = time.perf_counter() - t0
        call(mesh=mesh)
        _reset_counts()
        _reset_peak(device)
        t0 = time.perf_counter()
        got = call(mesh=mesh)
        _sync(device)
        out["votes"][name] = {
            "equal": len(got) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(got, want)),
            "single_s": single, "mesh_s": time.perf_counter() - t0,
            "launches": _launches(), "peak_bytes": _peak(device),
        }
    return out


def _load(path):
    from raven_tpu_torch.io import load_sequences

    return load_sequences([path])


def ordered_digest(results) -> str:
    """The emitted overlaps in emission order (read order, then each
    read's overlaps as emitted)."""
    h = hashlib.sha256()
    for rid, arr in results.items():
        h.update(np.int64(rid).tobytes())
        h.update(arr.tobytes())
    return h.hexdigest()


def filtered_digest(filtered: dict) -> str:
    """The too-frequent positions {read: [positions]}, by read, each
    read's positions sorted."""
    h = hashlib.sha256()
    for rid in sorted(filtered):
        h.update(np.int64(rid).tobytes())
        h.update(np.sort(np.asarray(filtered[rid], np.int64)).tobytes())
    return h.hexdigest()


def role_overlap(mesh, args) -> dict:
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel import distributed
    from raven_tpu_torch.utils.synth import overlap_digest

    if not args.reads:
        raise ValueError("the overlap role needs --reads")
    device = torch.device(args.device)
    rs = _load(args.reads)
    ids = np.arange(len(rs))
    MinimizerIndex.MESH = mesh

    def stage(filtered=None):
        t0 = time.perf_counter()
        idx = MinimizerIndex(K, W, device=device)
        idx.minimize(rs, ids, minhash=False, with_query_flags=True)
        _sync(device)
        t1 = time.perf_counter()
        idx.filter(FREQ)
        _sync(device)
        t2 = time.perf_counter()
        res = idx.map_many(rs, ids, minhash=True, filtered_out=filtered)
        _sync(device)
        t3 = time.perf_counter()
        return idx, res, (t3 - t0, t1 - t0, t2 - t1, t3 - t2)

    _reset_counts()
    filtered = {}
    idx, res, cold = stage(filtered)
    counts = _launches()
    declines = MinimizerIndex.host_declines
    cold_bytes = distributed.COLLECTIVES["bytes"]
    _reset_counts()
    _reset_peak(device)
    idx2, res2, steady = stage()
    steady_collectives = dict(distributed.COLLECTIVES)
    peak = _peak(device)
    with _timed_collectives(device) as spent:
        timed = stage()[2][0]
    digest, n = overlap_digest(res)
    return {
        "role": "overlap", "rank": mesh.rank, "nproc": mesh.n_ranks, "ndev": mesh.size,
        "reads": len(rs), "bases": int(rs.lengths.sum()), "digest": digest,
        "ordered": ordered_digest(res), "filtered": filtered_digest(filtered),
        "overlaps": n, "occ": int(idx._occurrence),
        "entries": int(idx._device.n_entries) if idx._device is not None else None,
        "sharded": type(idx._device).__name__ == "ShardedIndex",
        "steady_equal": overlap_digest(res2)[0] == digest, "cold_s": cold[0],
        "steady_s": steady[0], "steady_stages_s": steady[1:], "k1": counts["K1"],
        "declines": declines, "cold_bytes": cold_bytes,
        "exchange": steady_collectives, "peak_bytes": peak,
        "timed_s": timed, "collective_s": spent["seconds"],
    }


def graph_digest(g) -> str:
    """raven_tpu's construct-test digest of the live nodes and edges."""
    h = hashlib.sha256()
    for nd in g.live_nodes():
        h.update(np.int64(nd.id).tobytes())
        h.update(nd.codes.tobytes())
    for e in g.live_edges():
        h.update(np.int64(e.id).tobytes())
        h.update(np.int64(e.length).tobytes())
    return h.hexdigest()


def role_construct(mesh, args) -> dict:
    from raven_tpu_torch.config import GLOBALS, OverlapPhaseCfg
    from raven_tpu_torch.graph import Graph, assemble, construct_graph, print_gfa
    from raven_tpu_torch.io import ReadSet
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel import distributed
    from raven_tpu_torch.utils.synth import random_genome, sample_reads

    device = torch.device(args.device)
    if args.reads:
        rs, cfg = _load(args.reads), OverlapPhaseCfg()
    else:
        rng = np.random.default_rng(2)
        genome = random_genome(rng, 16000)
        rs = ReadSet.from_sequences(sample_reads(rng, genome, 70, 2200, error=0.04)[0])
        cfg = OverlapPhaseCfg(use_minhash=True)
    GLOBALS.num_threads = 1  # the CLI's default -t
    MinimizerIndex.MESH = mesh
    _reset_counts()
    t0 = time.perf_counter()
    g = Graph()
    construct_graph(g, rs, cfg, device=device)
    _sync(device)
    out = {"role": "construct", "rank": mesh.rank, "nproc": mesh.n_ranks,
           "ndev": mesh.size, "construct_s": time.perf_counter() - t0,
           "digest": graph_digest(g), "nodes": sum(1 for _ in g.live_nodes()),
           "edges": sum(1 for _ in g.live_edges()), "k1": _launches()["K1"],
           "declines": MinimizerIndex.host_declines,
           "collectives": distributed.COLLECTIVES["calls"]}
    if args.gfa:
        t0 = time.perf_counter()
        assemble(g, False, device=device)
        out["assemble_s"] = time.perf_counter() - t0
        out["gfa"] = f"{args.gfa}.rank{mesh.rank}.gfa"
        print_gfa(g, out["gfa"])
    return out


ROLES = {"candidates": role_candidates, "overlap": role_overlap,
         "construct": role_construct}


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m raven_tpu_torch.parallel.worker")
    p.add_argument("roles", help="comma-separated: " + ", ".join(ROLES))
    p.add_argument("pid", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("init", help="tcp://127.0.0.1:PORT or file:///path")
    p.add_argument("backend", choices=("nccl", "gloo"))
    p.add_argument("device", help="cpu or cuda:N")
    p.add_argument("shards", type=int, help="copies of DEVICE in the mesh (its devices)")
    p.add_argument("--reads", default="", help="FASTA/FASTQ of the overlap and construct roles")
    p.add_argument("--gfa", default="", help="construct: assemble and write PREFIX.rank<PID>.gfa")
    p.add_argument("--bank", action="store_true",
                   help="candidates: the votes on bench_polish.py's bank of 512 windows")
    p.add_argument("--timeout", type=float, default=600.0, help="a collective's time limit, s")
    args = p.parse_args(argv)
    roles = args.roles.split(",")
    for r in roles:
        if r not in ROLES:
            p.error(f"unknown role {r!r}")
    return args, roles


def main(argv=None) -> int:
    args, roles = parse(argv)
    from raven_tpu_torch.parallel import distributed

    try:
        distributed.initialize_distributed(args.init, args.nproc, args.pid, args.backend,
                                           args.device, args.timeout)
        mesh = distributed.process_mesh([args.device] * args.shards)
        for role in roles:
            print(json.dumps(ROLES[role](mesh, args)), flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        abort = getattr(torch.distributed.distributed_c10d, "_abort_process_group", None)
        if torch.distributed.is_initialized() and abort is not None:
            abort()
        return 1
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
