"""The compile check and the multi-device dry run of __graft_entry__.py.

    python -m raven_tpu_torch.dryrun [--device cpu]

`entry` is the flagship consensus step with its example inputs: the
full-NW fused window-consensus votes (ops/consensus_cuda.py::fused_votes,
kernel K2 and the vote epilogue), raven_tpu's fused_votes_kernel(band=0)
on the same draws.  `dryrun_multichip` drives every mesh path in one go,
with raven_tpu's inputs and checks: the sharded candidate step, the infix
DP split by rows over the mesh, the sharded construct on a skewed read
set that may not decline to the host, and the mesh votes of the full-NW
and the shift-banded consensus engines, each bit-equal to one device.

Given a count n, the dry run takes `make_mesh(n)` over real cards and
raises when fewer are visible; a virtual mesh (Mesh(["cuda:0"] * 8),
Mesh(["cpu"] * 8)) is passed explicitly.  The command line runs entry's
step once, then the dry run on a virtual mesh of 8 copies of the device
(CUDA unless --device cpu), as __graft_entry__.py runs it on 8 devices.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from raven_tpu_torch.device import resolve_device


def entry(device=None):
    """(fn, args) for the flagship consensus step: `fn(*args)` returns the
    vote tables (base_votes [8, 128, 5], ins_votes [8, 129, 4], cover
    [8, 128]) of 64 fragments against 8 windows, T=128, Q=160, through K2
    on a CUDA device (its plain version on the CPU).  The args are
    __graft_entry__.entry's, from the same draws of default_rng(21), as
    int32 tensors on `device` (CUDA unless the caller asks for the CPU)."""
    from raven_tpu_torch.ops.consensus_cuda import fused_votes
    from raven_tpu_torch.ops.consensus_device import homopolymer_run_map

    device = resolve_device(device)
    NWIN, T, Q, B = 8, 128, 160, 64
    rng = np.random.default_rng(21)
    cons_lens = np.full(NWIN, T - 8, np.int32)
    cons_arr = np.where(
        np.arange(T)[None, :] < cons_lens[:, None], rng.integers(0, 4, (NWIN, T)), -1
    ).astype(np.int32)
    cons_runs = homopolymer_run_map(cons_arr, cons_lens)
    q_lens = np.full(B, Q - 16, np.int32)
    frags = np.where(
        np.arange(Q)[None, :] < q_lens[:, None], rng.integers(0, 4, (B, Q)), -1
    ).astype(np.int32)
    wts = np.ones((B, Q), np.int32)
    win_idx = (np.arange(B) % NWIN).astype(np.int32)
    fn = functools.partial(fused_votes, T=T, Q=Q, NWIN=NWIN)
    args = tuple(
        torch.from_numpy(a).to(device)
        for a in (cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx)
    )
    return fn, args


def dryrun_inputs(n_devices: int) -> dict:
    """Every input of the dry run, drawn from one default_rng(7) in
    __graft_entry__.dryrun_multichip's order (no check draws):

      codes [2n, 512] uint32, lengths, read_ids [2n] int32: reads cut from
          a 4,096-base genome, for the candidate step;
      targets [2n, 128], queries [2n, 256] int32: each target planted at
          column 10 of its query (pad -1), for the infix DP;
      readset: 120 reads of 3 kb from a 30 kb genome holding 30 copies of
          a 20 bp motif (6 k-mers, below the 0.1% filter tail), so the
          hash ranges' loads are skewed, for the construct;
      windows: 2n consensus windows of a mutated 300-base backbone and 10
          mutated fragments (5% deletions, 4% substitutions, weight 9)."""
    from raven_tpu_torch.io import ReadSet, decode

    rng = np.random.default_rng(7)
    B, L = 2 * n_devices, 512
    genome = rng.integers(0, 4, 4096).astype(np.uint32)
    codes = np.zeros((B, L), dtype=np.uint32)
    for b in range(B):
        s = int(rng.integers(0, genome.size - L))
        codes[b] = genome[s : s + L]

    T, Q = 128, 256
    targets = rng.integers(0, 4, (B, T)).astype(np.int32)
    queries = np.full((B, Q), -1, dtype=np.int32)
    queries[:, 10 : 10 + T] = targets

    genome2 = rng.integers(0, 4, 30000)
    motif = genome2[500:520].copy()
    for i in range(30):
        at = 2000 + i * 800
        genome2[at : at + motif.size] = motif
    reads = []
    for _ in range(120):
        s = int(rng.integers(0, genome2.size - 3000))
        reads.append(decode(genome2[s : s + 3000].astype(np.uint8)))

    def mutate(t):
        keep = rng.random(t.size) >= 0.05
        seg = t[keep]
        subs = rng.random(seg.size) < 0.04
        return np.where(subs, (seg + 1) % 4, seg).astype(np.uint8)

    windows = []
    for _ in range(B):
        truth = rng.integers(0, 4, 300).astype(np.uint8)
        frs = [mutate(truth) for _ in range(10)]
        windows.append((mutate(truth), frs, [np.full(f.size, 9, np.uint8) for f in frs]))
    return {
        "codes": codes, "lengths": np.full(B, L, dtype=np.int32),
        "read_ids": np.arange(B, dtype=np.int32), "targets": targets, "queries": queries,
        "readset": ReadSet.from_sequences(reads), "windows": windows,
    }


def dryrun_multichip(mesh) -> dict:
    """Run __graft_entry__.dryrun_multichip's five checks on a mesh of n
    devices, in its order, on its inputs (dryrun_inputs(n)):

      (a) sharded_candidate_step over the mesh finds candidate pairs;
      (b) the infix DP (ops/dp_device.py::infix_scan), its rows split over
          the mesh's devices, places every query exactly (distance 0);
      (c) the construct with the index sharded over the mesh
          (MinimizerIndex.MESH) on a skewed read set builds a graph with no
          decline to the host (MinimizerIndex.host_declines unchanged);
      (d) device_window_consensus with its votes on the mesh is bit-equal
          to the one-device call;
      (e) so is band_window_consensus.

    `mesh` is a Mesh, used as given, or a count n: make_mesh(n) over n
    real cards, raising when fewer are visible.  The one-device calls of
    (d) and (e) and the construct's engine run on the mesh's first
    device.  A failed check raises.  Returns {"pairs", "dp_max",
    "live_nodes", "graph_digest", "declines", "consensus_equal",
    "band_equal", "consensus", "band"} ("consensus" and "band": the
    one-device consensus of (d) and (e)) and prints one summary line."""
    from raven_tpu_torch.config import OverlapPhaseCfg
    from raven_tpu_torch.graph import Graph, construct_graph
    from raven_tpu_torch.ops.consensus_band import band_window_consensus
    from raven_tpu_torch.ops.consensus_device import device_window_consensus
    from raven_tpu_torch.ops.dp_device import infix_scan
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel.mesh import Mesh, local_blocks, make_mesh
    from raven_tpu_torch.parallel.sharded_index import sharded_candidate_step
    from raven_tpu_torch.parallel.worker import graph_digest

    mesh = mesh if isinstance(mesh, Mesh) else make_mesh(mesh)
    n_devices, device = mesh.size, mesh.first
    inp = dryrun_inputs(n_devices)

    # (a) reads data-parallel, the index sharded by hash range, the counts summed
    codes = inp["codes"]
    capacity = ((2 * codes.shape[1]) // n_devices) * n_devices
    pairs = sharded_candidate_step(mesh, k=15, w=5, capacity=capacity, occurrence=64)(
        codes, inp["lengths"], inp["read_ids"])
    if pairs <= 0:
        raise AssertionError("sharded overlap step found no candidate pairs")

    # (b) the window-placement DP batch-sharded over the mesh
    tgt, qry = inp["targets"], inp["queries"]
    cols = (tgt, np.full(len(tgt), tgt.shape[1], np.int32), qry,
            np.full(len(qry), qry.shape[1], np.int32))
    dist = torch.cat([
        infix_scan(*(torch.from_numpy(a[rows]).to(dev) for a in cols))[0].to(mesh.first)
        for dev, rows in local_blocks(mesh, len(tgt))
    ])
    dp_max = int(dist.max())
    if dp_max != 0:
        raise AssertionError(f"sharded DP misaligned (largest distance {dp_max})")

    # (c) the production overlap stage on the mesh under skew: any decline
    # to the host fails the dry run
    saved, declines = MinimizerIndex.MESH, MinimizerIndex.host_declines
    MinimizerIndex.MESH = mesh
    try:
        g = Graph()
        construct_graph(g, inp["readset"], OverlapPhaseCfg(use_minhash=True), device=device)
    finally:
        MinimizerIndex.MESH = saved
    declines = MinimizerIndex.host_declines - declines
    if declines:
        raise AssertionError(f"sharded path declined to the host {declines} times")
    live = sum(1 for _ in g.live_nodes())
    if live <= 0:
        raise AssertionError("sharded construct produced an empty graph")

    # (d) fragment chunks dealt over the mesh, vote tables summed: the
    # one-device consensus bit for bit
    cwins = inp["windows"]
    kw = dict(iterations=2, t_pad=384, q_pad=384)
    single = device_window_consensus(cwins, chunk=16, device=device, **kw)
    sharded = device_window_consensus(cwins, chunk=16, mesh=mesh, **kw)
    cons_equal = all(np.array_equal(a, b) for a, b in zip(single, sharded))
    if not cons_equal:
        raise AssertionError("sharded consensus diverged from single-device")

    # (e) the production polish default, the shift-banded engine
    bwins = [w + ([(0, f.size) for f in w[1]],) for w in cwins]
    b_single = band_window_consensus(bwins, device=device, **kw)
    b_sharded = band_window_consensus(bwins, mesh=mesh, **kw)
    band_equal = all(np.array_equal(a, b) for a, b in zip(b_single, b_sharded))
    if not band_equal:
        raise AssertionError("sharded shiftband consensus diverged from single-device")

    print(
        f"[raven_tpu_torch::dryrun] {n_devices}-device mesh ({mesh}): {pairs} "
        f"candidate pairs, DP ok, sharded construct {live} live nodes (skewed "
        f"batch, {declines} host declines), sharded consensus bit-identical "
        f"(voting + shiftband engines)",
        flush=True,
    )
    return {"pairs": pairs, "dp_max": dp_max, "live_nodes": live,
            "graph_digest": graph_digest(g), "declines": declines,
            "consensus_equal": cons_equal, "band_equal": band_equal,
            "consensus": single, "band": b_single}


def main(argv=None) -> int:
    from raven_tpu_torch.parallel.mesh import Mesh

    ap = argparse.ArgumentParser(prog="python -m raven_tpu_torch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fn, fargs = entry(device)
    base, ins, cover = fn(*fargs)
    print(f"entry: base_votes {tuple(base.shape)} sum {int(base.sum())}, ins_votes "
          f"{tuple(ins.shape)} sum {int(ins.sum())}, cover {tuple(cover.shape)} sum "
          f"{int(cover.sum())}", flush=True)
    dryrun_multichip(Mesh([device] * 8))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
