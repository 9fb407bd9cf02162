#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (raven_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and outside a checkout
of the repository) and the CUDA toolkit's nvcc.  Phases, each fatal on
failure:

  1. the card, the versions, the builds (the host C++ library, then K1,
     K2, K3, K4, K9, K10 and K12 with nvcc for sm_90a, one nvcc per
     source, started together);
  2. kernel K1 (segment sketch, csrc/sketch.cu) against its plain torch
     version on the card, bit for bit, at (k, w) = (15, 5) and (11, 3), on
     a chunk of real segment rows [8192, 2048] and a ragged row count, and
     on the cases its strips and 16-byte accesses could break: widths 2047
     and 1000, lengths below k, a row of one repeated base and rows whose
     k-mers are their own reverse complements (at an even k), and a window
     wider than 16; median times over CUDA events beside the bound;
  3. the overlap stage on bench.py's workload (2.3 Mb genome at 50x,
     ~115 Mbp): minimize -> filter -> map_many on the card, cold and
     steady, its overlap digest held against the port's host path run in
     a child process started before this process touches CUDA; one more
     steady pass with the index forced into 3 hash-range parts (the
     partitioned index that carries index batches above 2^28 entries)
     must give the same overlaps; one more steady pass under
     torch.profiler gives the device's busy share and the ops that take
     the most device time;
 3b. the same stage through the hash-range-sharded index
     (raven_tpu_torch.parallel) on a virtual mesh of 4 shards on the card,
     forced by MinimizerIndex.MESH: the single index's digest and
     occurrence, K1 launched, no decline, its steady wall and peak device
     memory beside the single index's (and once on every card when there
     are 2 or more);
 3c. the multi-process path (raven_tpu_torch.parallel.distributed and
     parallel/worker.py): ranks of `python -m raven_tpu_torch.parallel.worker`
     in child processes on overlap-115M's reads, written once to the work
     directory: (a) one rank on NCCL with a virtual mesh of 4 shards on
     cuda:0, whose index goes through NCCL's all-to-all, all-gather and
     all-reduce: phase 3's digest and occurrence, raven_tpu's candidate
     count equal to the host oracle's, and the three engines' votes on
     phase 8b's window bank bit-equal to one device; (b) two ranks on gloo,
     both on cuda:0 with 2 shards each (NCCL refuses two ranks on one
     card): the same on both ranks, and then the construct and assemble of
     phase 4's reads, whose GFA on both ranks must be phase 4b's `-p 0
     -F` GFA byte for byte; each run's steady wall beside phase 3b's, its
     collectives' bytes and, in a pass of its own with the device
     synchronised around each collective, their time, each rank's peak
     device memory and K1, K2, K3/K4 and K9/K10 launches (two processes
     sharing one card over gloo, not a multi-card wall);
 3d. the engine's device-sketch route (MinimizerIndex.DEVICE_SKETCH, on by
     default): on phase 4's reads, with the partitioned index's ceiling
     lowered to 0 for the run so the engine declines the device index,
     the host index's sketch runs K1 on the card; the index must equal the
     host sketch's (DEVICE_SKETCH off) column for column, with one decline
     and K1 launched; both builds' walls and both sketches' walls alone;
  4. the main path: `raven_tpu_torch.cli.main([reads, "-p", "0", ...])` on
     a 1 Mb genome at 30x with indels, which must give one contig of at
     least 0.97 of the genome with every overlap index built by K1; then
     again on a 1 Mb genome with a repeat family, whose junction components
     (512 nodes or more) must send the layout n-body to the card (K12
     launched once a run; each component's points and links are kept for
     phase 5);
 4b. the Python API (raven_tpu_torch.api) on the first run's reads: its
     sub-stages on the card must give the GFA of `cli.main([reads, "-p",
     "0", "-F", gfa])`, byte for byte, and construct_graph(checkpoints=True),
     a load of the checkpoint and assemble_graph the sub-stages' unitigs;
  5. kernel K12 (the layout n-body, csrc/layout.cu, every iteration of a
     call in one launch) against its plain torch version on the card, bit
     for bit, at 1, 2, 512, 600, 1,024, 1,025 and 1,500 points x 100
     iterations, at as many points as the card holds blocks and one more x
     5, at 32,769 x 3 and 40,000 x 1, on 64 sampled rows of 2^20 + 32 and
     of 32^4 + 32^3 + 64 points x 1 (four levels of windows; against the
     plain rules over those rows alone) and on each of phase 4's repeat
     components, one launch a call, each case's blocks logged; against the
     plain version on the CPU at 600 points (whose bits the CPU tests hold
     to raven_tpu's); the n-body against the float64 host loop after 3
     iterations; K12's time a call (CUDA events, and device time from
     torch.profiler) beside its bound and the plain version's at 600 and
     1,500 points, and the 100-iteration n-body's host wall at 600 points;
     through the assemble stage remove_long_edges on a 601-node
     junction component built by hand, one K12 launch a run;
  6. kernel K2 (window-consensus votes, csrc/consensus.cu) against its
     plain torch version on the card, bit for bit, on the first chunk of
     bench_polish.py's window bank (512 windows x 30 fragments) laid out
     as the polisher lays it out: [B, T, Q] = [2048, 640, 768], a ragged
     B = 1237, and T = Q = 256; and on the cases its fragment pairs and
     column tiles could break: the chunk's rows shuffled, qlen 0 in one
     half of some pairs at the odd B, fragments twice their consensus's
     length at Q = 1024, fragments that mismatch everywhere (the int16
     floor), and walks that start at row 0; median times over CUDA events
     beside the bound;
  7. kernels K3 (banded forward) and K4 (walk and votes), csrc/band.cu,
     against their plain torch versions on the card, bit for bit: the
     bank's first group of 128 windows as the shift-banded consensus lays
     it out, [B, T, BW] = [4096, 640, 256] with 256 padded rows (qlen 0),
     a ragged B = 1237, partial fragments placed at r0 > 0 with weights
     above the cap of 63, fragments longer than the band reaches, insertion
     runs of 20-60 bases whose left moves cross K3's 16-lane strips, and
     walks from row 0; median times over CUDA events beside the bound, K3's
     and K4's SASS loop sizes and K4's serial floor;
 7b. band_pack (csrc/band.cu), the fragment rows K3 and K4 read laid out
     on the card from one flat upload a group, against
     pack_shifted_fragments on the host, byte for byte: the bank's four
     groups, spans with weights over the cap, and 128 windows x 52
     fragments (8,192 rows), its one-call and device time beside its bound
     by bytes, and the group's host prep before and after;
  8. kernels K9 (anchored banded forward) and K10 (banded walk),
     csrc/banded.cu, against their plain torch versions on the card, bit
     for bit on every output (move words, band starts, end scores, row-0
     scores, the four vote primitives): the bank's first chunk as the
     anchored banded consensus lays it out, [B, T, Q, BW] = [2048, 640,
     768, 256] with full spans, a ragged B = 1237, partial spans at r0 > 0,
     spans of one row (band starts that leap by BW or more), steep spans of
     2-250 rows beside full-span ones (band starts that step by 3 to BW - 1
     a row, the two fragments of a warp stepping differently), fragments
     twice their consensus's length at Q = 1024, qlen 0 rows, all-mismatch
     rows, walks from row 0 (some of which must stall on the top row), and
     K10 on band starts raised under the moves (some walks must stop at the
     band's edge); how the walks ended, median times over CUDA events
     beside the bound and K2's time at the same chunk, K10's serial floor,
     and K9's and K10's SASS loop sizes;
 8b. the mesh votes: device_window_consensus (full-NW and banded) and
     band_window_consensus on the whole window bank, each with its votes
     on a virtual mesh of 4 shards on the card, bit-identical to the
     single-device call (K2, K9/K10 or K3/K4 launched on the shards), both
     walls printed (and once on every card when there are 2 or more);
  9. the main path with polish: `raven_tpu_torch.cli.main([reads, "-p",
     "2", "--device-poa-batches", "8", "-t", <cores>, ...])` on phase 4's
     1 Mb x 30x reads, which must give one contig of at least 0.97 of the
     genome at an edit-distance rate of 0.05% or less against the true
     genome (the synthetic golden gate), with K2 and the crossing DP run
     on the card, and the consensus calls split into K2 and the vote
     epilogue;
 9b. the same CLI run with the Polisher forced onto a virtual mesh of 4
     shards (Polisher.MESH): phase 9's contig, byte for byte;
 10. the default polish: the same reads through `-p 2 -t <cores>` (host
     POA in round 0, the shift-banded consensus on the card in round 1),
     with the same gate, K3 and K4 launched 64 times each, the crossing DP
     run on the card, and the consensus call split into host prep, K3, K4,
     the epilogue and the K5 torch ops;
 11. the banded polish: the same reads through `-p 2 --device-poa-batches 8
     --device-banded-alignment -t <cores>` (the anchored banded consensus
     on the card in both rounds), with the same gate, K9 and K10 launched
     equally often, the crossing DP run on the card, and the consensus
     calls split into K9, K10 and the epilogue;
 12. the end of the module port: (a) raven_tpu_torch.dryrun.entry's
     consensus step (K2 and the vote epilogue at T=128, Q=160) on the
     card, one K2 launch, its vote tables bit-equal to the same step on
     the CPU; (b) dryrun_multichip on a virtual mesh of 8 shards on the
     card (the sharded candidate step, the row-split infix DP, the
     sharded construct on a skewed read set, both engines' mesh votes):
     every check, 0 declines, K1, K2, K3 and K4 launched, and its pairs,
     DP maximum, graph and one-device consensus of both engines equal to
     the same dry run's on Mesh(["cpu"] * 8) (the plain versions); (c)
     ops/overlap_step.py's metric functions at full size, each equal to a
     numpy recount of the same key-sorted sketch: candidate_count,
     join_count and join_count_filtered on overlap-115M's reads in segment
     rows, overlap_candidates (max_hits 16) on phase 4's reads; each wall
     and rate printed beside the card's name and power limit;
 13. parity with raven_tpu's switches and widths: (a) K3/K4 against their
     plain versions, bit for bit, at every band width raven_tpu takes up
     to 512 (a multiple of 16; 16 windows of 120 bases at T = 160), and
     timed beside their bounds at BW = 128 and 384 on the bank's first 128
     windows (insertion runs across the strips too); K9/K10 at q_pad 100,
     128 and 200 (bands of 128, 128 and 256, two wider than the fragment)
     on the K2 rows cut to each, with fragments cut at random lengths,
     steep spans and all-mismatch rows, the bank chunk timed beside its
     bound; (b) `-p 2 --device-poa-batches 8` on phase 4's reads with
     Polisher.CONSENSUS_ENGINE = "shiftband" and CONSENSUS_ITERS = 2: the
     shift-banded consensus in both rounds (K3 and K4 launched in each, K2
     never), the polish gate, its wall beside phase 9's; (c) the
     index-batch budget for an index on the card by default, for the host
     index and under a budget set above the clamp, raven_tpu's values;
     (d) past the old limits: each first route's ceiling confirmed (its
     launcher launches at the last shape launch_plan gives it and refuses
     one past: K2's pair route at T 9,412 for Q 768, K3's strips at T 14,399
     for BW 256 and 28,799 for 512, K4's staging at T 10,143 and 5,791, K9's
     shared-memory codes at Q 55,887); bit for bit against the plain
     versions: K2 at [64, 640, 1040], [64, 640, 2048], [16, 16384, 1024]
     and [16, 12000, 4096] (the int32 route) and its pair route on pairs
     whose consensus rows end apart (the case of its borrow fix), K3/K4
     at BW 528, 768, 1024, 2048 and 4096 on 16 windows with insertion runs
     (T = 160), at BW 256 with T = 16,384 and at BW 1024 with T = 8,192 (the
     wide and direct routes), K9/K10 at q_pad 8208, 16384 and 65536 on bank
     rows, cut fragments, steep spans and all-mismatch rows in one batch
     each (65536 on K9's global route) and at T = 16,384, q_pad 768; past
     the last refusals: K2's int32 route at [8, 64, 262400] (fragments
     whose end values all fall below NEG) under both start-row rules, each
     bit-equal to the plain version under the same rule and the two
     different, K3's global route and K4's direct walk at BW 16,400 and
     32,768 (T = 160), K10 on 8 of K9_LONG's fragments whose band starts
     wrap, as K9 left them and started inside the wrapped stretch; the
     three engines through their entry points on 16 windows, the card's
     consensus the CPU's byte for byte: device_window_consensus at q_pad
     2048, banded at q_pad 16384 and 65536, band_window_consensus at bw 768,
     and device_window_consensus on 4 windows two of which hold a fragment
     of 262,400 bases (q_pad 262,400) and band_window_consensus at bw 16,400
     on 2 windows;
     and one call of each engine on a bank of 512 windows of 2,000 bases x
     30 fragments at t_pad 2048 (full NW and banded at q_pad 2560,
     shift-banded at bw 768): the walls, the routes launched, the consensus
     closer to the truth than the backbones, and each kernel on the first
     chunk or group bit-equal and timed beside its bound; no route past an
     old limit may launch before this phase (the CLI paths take the first
     routes);
 14. a `kernels` JSON line (K3, K4, K9 and K10 with the widths they ran
     at; K12 with its launches on phase 4's repeat run; the routes past
     the old limits, K3's global one among them, as kernels of their own,
     their launches phase 13(d)'s engine calls'), the card's name and power
     limit,
     and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K, W, FREQ = 15, 5, 0.001
SEG_ROWS = 8192  # one sketch chunk of the device index build
# H100 SXM: HBM3 3.35 TB/s (NVIDIA data sheet); integer instructions: 4
# schedulers x 32 lanes issued per SM per clock x 132 SMs x 1.98 GHz boost
# (Hopper white paper), the ALU and FMA (IMAD) pipes together
HBM_BYTES_PER_S = 3.35e12
INT_INSTR_PER_S = 4 * 32 * 132 * 1.98e9
# K2's forward needs at least 4 integer instructions per DP cell on the
# H100's 16-bit pair instructions (DPX), which hold two cells: per pair,
# the substitution score's compare and select (2), the diag add (1), the up
# add and max with its which-won predicate (2), the left add and max with
# its predicate (2), and one pack of the predicates into move bits (1).
# (With scalar int32 instructions the fewest is 14 a cell.)
K2_INSTR_PER_CELL = 4
K2_TILE = 256  # columns of one of K2's column tiles
# K3's forward needs at least 10 integer instructions per band cell: the
# substitution score's compare and select (2), the diag add (1), the up add
# fused with the max (one VIADDMNMX, 1), the which-won predicate (1), the
# left closure as the recurrence max(e, left + GAP) (one VIADDMNMX, 1), the
# left predicate (1), the fragment domain's compare and select (2), one pack
# of the move bits (1).
K3_INSTR_PER_CELL = 10
# K4 needs at least 6 integer instructions per row it votes on: the move's
# shift and mask (2), the left test (1), the vote's packing (2), the next
# lane (1).
K4_INSTR_PER_ROW = 6
# K4's walk is one chain per fragment: from the walker's lane to the next
# row's, its common step (the move at the walker is not left) is the move
# word's shared-memory address (2 instructions), its load (~30 cycles on
# Hopper), the move's extraction and test (3) and the next lane and its
# checks (4): 9 dependent integer instructions of at least 4 cycles (the
# shortest dependent latency of Hopper's integer pipes) and one load,
# at 1.98 GHz.  Printed beside the bound as information: the fragments'
# walks run side by side, so a launch takes at least its longest walk.
K4_CHAIN_CYCLES = 9 * 4 + 30
SM_CLOCK_HZ = 1.98e9
# H100 SXM: 67 TFLOP/s in float32 outside the tensor cores, an FMA two
# (NVIDIA data sheet).  K12's float32 operations, an FMA two and a
# division or square root one: 11 a pair of points (two subtractions,
# three products, one FMA, a maximum, a division, two adds), 12 a link
# (two subtractions, two products and an add for the squared distance, a
# root, a maximum, a division, two products, two adds), 10 a row's update
# (a product and an FMA for the squared length, a root, a compare, a
# division, two FMAs) and 2 a partial summed into its row (x and y)
FP32_FLOPS_PER_S = 67e12
K12_FLOPS_PAIR, K12_FLOPS_LINK, K12_FLOPS_ROW = 11, 12, 10
K12_CASES = ((1, 100), (2, 100), (512, 100), (600, 100), (1024, 100), (1025, 100),
             (1500, 100), (32769, 3), (40000, 1))
# four levels of windows, 64 rows of each held: at 32^4 + 32^3 + 64 the top
# level's second group holds two sums, so a tree cut to three levels differs
K12_SAMPLED = ((1 << 20) + 32, 32 ** 4 + 32 ** 3 + 64)
# K9's recurrence is K2's (scores 3/-5/-4, diag and up, the left closure,
# move bits), so it needs at least K2's 4 integer instructions per band cell
# on the 16-bit pair instructions; the two previous-row values it regathers
# come from shared memory, not the integer pipes.  (With scalar int32
# instructions, as the kernel runs today, K3's count of 10 a cell; printed
# beside the bound as information.)
K9_INSTR_PER_CELL = 4
K9_INT32_INSTR_PER_CELL = K3_INSTR_PER_CELL
K9_CELLS_PER_LANE = 16  # band lanes a lane of K9 holds (csrc/banded.cu, C)
# K10 needs at least 6 integer instructions per move of its walk: the move's
# shift and mask (2), the band test (1), the next row and column (2), the
# vote's select (1).
K10_INSTR_PER_STEP = 6
# K10's walk is one chain per fragment: a step's lane offset, its clamp and
# the move word's address (4), the word's shared-memory load (~30 cycles on
# Hopper), the move's extraction and test (3), and the next column and band
# start (2; the next row's band start is read beside the word): 9 dependent
# integer instructions of at least 4 cycles and one load, at 1.98 GHz.
K10_CHAIN_CYCLES = 9 * 4 + 30
BANDED_T, BANDED_Q, BANDED_BW = 640, 768, 256  # device_window_consensus's shapes
BAND_DEFAULT_GROUPS = 16  # groups of up to 128 windows: band_pack launches once each
BAND_DEFAULT_LAUNCHES = BAND_DEFAULT_GROUPS * 4  # K3 and K4: 4 iterations a group
BAND_T, BAND_BW = 640, 256  # the shift-banded consensus's t_pad and band
# phase 13: the band widths beside 256 that K3/K4 are timed at (raven_tpu
# takes any multiple of 16; every one up to 512 is held bit for bit), and
# the q_pads that give K9/K10 a band of 128 or one past the fragment
BAND_WIDTHS = (128, 384)
BAND_SWEEP = tuple(range(16, 513, 16))
BANDED_Q_PADS = (100, 128, 200)
ED_RATE_CEILING = 0.0005  # tests/test_synthetic_golden.py
# raven_tpu's unitig lengths on the repeat genome's checkpoint (phase 4's
# second reads), which tests/test_torch_layout_n_body.py holds the port to
RAVEN_TPU_REPEAT_UNITIGS = (259191, 185530, 385592, 137302, 47696)


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------- host child
def host_overlap_main(out_path: str, genome: int, cov: float) -> int:
    """The port's host path (its copied minimizer/selfjoin/chain modules)
    on the overlap workload; never touches CUDA, so its fork pools run."""
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.utils.synth import overlap_digest, synth_reads

    rs = synth_reads(genome, cov, 9000, 0.10)
    MinimizerIndex.DEVICE_MIN_BASES = 1 << 62
    ids = np.arange(len(rs))
    t0 = time.perf_counter()
    idx = MinimizerIndex(K, W, device="cpu")
    idx.minimize(rs, ids, minhash=False, with_query_flags=True)
    idx.filter(FREQ)
    res = idx.map_many(rs, ids, minhash=True)
    wall = time.perf_counter() - t0
    digest, n = overlap_digest(res)
    with open(out_path, "w") as f:
        json.dump(
            {"wall": wall, "digest": digest, "overlaps": n,
             "occ": int(idx._occurrence)},
            f,
        )
    return 0


# ------------------------------------------------------------------ timing
def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `runs` CUDA-event-timed calls (one
    call between two events: a kernel shorter than its wrapper's host work
    before the launch is charged that work too)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel: str, runs: int = 20, warmup: int = 3):
    """Median device time in milliseconds of the launches of `kernel` (a
    substring of its name) over `runs` calls of fn(), from a torch.profiler
    trace: the kernel's own time on the card, without its wrapper's host
    work.  A trace that holds no device event of the kernel (seen on the
    H100 for the first trace after phase 12's) is taken again, up to three
    in all; None when none holds one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times:
            return statistics.median(times)
    return None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def sketch_bound(S: int, L: int, w: int) -> tuple[float, str, dict]:
    """Least time for K1's work on these inputs: the larger of the bytes
    each read or written once (codes u8, lengths i32, hash i32, strand u8,
    keep u8) over HBM bandwidth, and the fewest integer instructions the
    function needs per position (5 for the rolling forward and reverse
    k-mer codes, 3 for the canonical pick, strand and ambiguity, 2 for the
    window sentinel, 14 for the hash mix with each multiply-add one IMAD,
    2(w-1) for the two window passes, 2 for the keep flag) over the card's
    instruction issue rate."""
    nbytes = S * L * (1 + 4 + 1 + 1) + S * 4
    ops = S * L * (5 + 3 + 2 + 14 + 2 * (w - 1) + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "int_ops": ops,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def votes_bound(tlens, qlens, T: int, Q: int) -> tuple[float, str, dict]:
    """Least time for K2's work on these inputs: the larger of the bytes
    each read or written once (cw, frags, wts, the two lengths in; col_sym,
    col_w, ins_b, ins_w out; all int32) over HBM bandwidth, and
    K2_INSTR_PER_CELL integer instructions per DP cell this data needs
    (tlen x qlen per fragment: no output depends on another cell) over the
    card's instruction issue rate.  Also counts the cells the kernel
    computes: per pair of rows, the longer active consensus times its
    column tiles, in both halves."""
    import torch

    B = int(tlens.numel())
    tl = tlens.to(torch.int64).clamp(0, T)
    ql = qlens.to(torch.int64).clamp(0, Q)
    cells = int((tl * ql).sum())
    act = torch.where(ql > 0, tl, 0)
    if B % 2:
        act = torch.cat([act, act.new_zeros(1)])
        ql = torch.cat([ql, ql.new_zeros(1)])
    rows = act.view(-1, 2).max(dim=1).values
    tiles = (ql.view(-1, 2).max(dim=1).values + K2_TILE - 1) // K2_TILE
    computed = int((rows * tiles).sum()) * K2_TILE * 2
    nbytes = 4 * (B * T + 2 * B * Q + 2 * B) + 4 * (2 * B * T + 2 * B * (T + 1))
    ops = cells * K2_INSTR_PER_CELL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {
        "bytes": nbytes, "int_ops": ops, "cells": cells,
        "computed_cells": computed, "padded_cells": B * T * Q,
        "bytes_ms": t_bytes, "ops_ms": t_ops,
    }


def band_forward_bound(B: int, T: int, BW: int) -> tuple[float, str, dict]:
    """Least time for K3's work: the larger of the bytes each read or
    written once (cw int32 [B, T], t_lens, q_lens, r0 int32 [B], fw_sh
    uint8 [B, T+BW+1] in; moves int32 [T, B, BW/16], end scores int32 [T,
    B], row-0 scores int32 [B] out) over HBM bandwidth, and
    K3_INSTR_PER_CELL integer instructions for each of the B x T x BW band
    cells (every cell's move is an output) over the card's instruction
    issue rate."""
    cells = B * T * BW
    nbytes = 4 * B * T + 12 * B + B * (T + BW + 1) + 4 * T * B * (BW // 16) + 4 * T * B + 4 * B
    ops = cells * K3_INSTR_PER_CELL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "int_ops": ops, "cells": cells,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def band_walk_bound(votes, B: int, T: int, BW: int) -> tuple[float, str, dict]:
    """Least time for K4's work on these inputs: the larger of the bytes it
    must move (the end scores int32 [T, B], which the best row needs whole;
    row-0 scores, q_lens, r0 int32 [B]; fw_sh uint8 [B, T+BW+1]; one 4-byte
    move word for each row the data casts a vote on; votes int32 [B, T] and
    insertions int32 [B, T+1] out) over HBM bandwidth, and
    K4_INSTR_PER_ROW integer instructions per voted row over the card's
    instruction issue rate."""
    voted = int((votes != 0).sum())
    nbytes = 4 * T * B + 12 * B + B * (T + BW + 1) + 4 * voted + 4 * B * T + 4 * B * (T + 1)
    ops = voted * K4_INSTR_PER_ROW
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "int_ops": ops, "voted_rows": voted,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def banded_forward_bound(tlens, qlens, B: int, T: int, Q: int,
                         BW: int) -> tuple[float, str, dict]:
    """Least time for K9's work on these inputs: the larger of the bytes
    each read or written once (cw int32 [B, T]; of frags int32 [B, Q] the
    min(q_len, Q) columns an output depends on; t_lens, q_lens, r0, r1 int32
    [B] in; moves int32 [T, B, BW/16], offs and end scores int32 [T, B],
    row-0 scores int32 [B] out) over HBM bandwidth, and
    K9_INSTR_PER_CELL integer instructions for each band cell of a row
    within the fragment's consensus (every such cell's move is an output;
    the rows past it are constants) over the card's instruction issue
    rate."""
    import torch

    cells = int(tlens.to(torch.int64).clamp(0, T).sum()) * BW
    frag_cols = int(qlens.to(torch.int64).clamp(0, Q).sum())
    nbytes = 4 * B * T + 4 * frag_cols + 16 * B + 4 * T * B * (BW // 16) + 8 * T * B + 4 * B
    ops = cells * K9_INSTR_PER_CELL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "int_ops": ops, "cells": cells,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def banded_walk_bound(steps, col_sym, ins_b, B: int, T: int) -> tuple[float, str, dict]:
    """Least time for K10's work on these inputs: the larger of the bytes it
    must move (the end scores int32 [T, B], which the best row needs whole;
    row-0 scores and q_lens int32 [B]; a 4-byte move word and a 4-byte band
    start for each move the walks take; a fragment base and weight, 8
    bytes, for each vote they cast; col_sym, col_w int32 [B, T] and ins_b,
    ins_w int32 [B, T + 1] out) over HBM bandwidth, and K10_INSTR_PER_STEP
    integer instructions per move over the card's instruction issue
    rate."""
    moves = int(steps.sum())
    votes = int((col_sym < 5).sum()) + int((ins_b >= 0).sum())
    nbytes = 4 * T * B + 8 * B + 8 * moves + 8 * votes + 4 * B * (2 * T + 2 * (T + 1))
    ops = moves * K10_INSTR_PER_STEP
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_INSTR_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "int_ops": ops, "moves": moves,
                                     "votes": votes, "bytes_ms": t_bytes, "ops_ms": t_ops}


def sass_loops(so_path: str, kernel: str) -> tuple[int, list]:
    """What cuobjdump -sass shows of `kernel` in the library at `so_path`:
    its instruction count and its loops as (instructions, first address,
    last address, opcode counts), largest first; a loop is the span from a
    backward branch's target to the branch."""
    import re
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    body = next(blk for blk in re.split(r"\n\s*Function : ", out)[1:]
                if kernel in blk.split("\n", 1)[0])
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            instrs.append((addr, m.group(2)))
            labels.update((lab, addr) for lab in pending)
            pending = []
    loops = []
    for addr, text in instrs:
        if not re.search(r"\bBRA\b", text):
            continue
        lab = re.search(r"\.L_x_\d+", text)
        hexa = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        tgt = labels.get(lab.group(0)) if lab else (int(hexa.group(1), 16) if hexa else None)
        if tgt is not None and tgt < addr:
            ops = Counter(re.sub(r"^@!?U?P\w+ ", "", t).split(" ")[0].split(".")[0]
                          for a, t in instrs if tgt <= a <= addr)
            loops.append((sum(ops.values()), tgt, addr, ops))
    return len(instrs), sorted(loops, key=lambda lp: lp[:3], reverse=True)


# compare, select, logic and min/max opcodes: Hopper's integer ALU pipe
# runs them, one warp instruction every other cycle a scheduler
ALU_PIPE_OPS = ("ISETP", "SEL", "LOP3", "VIMNMX", "VIADDMNMX")


def log_band_sass() -> None:
    """K3's and K4's SASS: instructions, those of each loop, and the
    largest loop's opcodes; K3's row loop over 8 is its instructions a
    cell at one closure round (a warp instruction covers 2 fragments x 16
    lanes of 16 cells = 512 cells, so 32 lane-instructions over 256)."""
    from raven_tpu_torch import csrc

    so = os.path.join(csrc.build_dir(), "libband.so")
    # the BW = 256 instantiations, by their mangled template arguments
    for kernel, inst in (("band_forward_kernel", "ILi16ELi256EE"),
                         ("band_walk_kernel", "ILi256ELi16EE")):
        try:
            n, loops = sass_loops(so, kernel + inst)
        except (OSError, subprocess.SubprocessError, StopIteration) as e:
            log(f"  SASS of {kernel}: not read ({e!r})")
            continue
        spans = ", ".join(f"{k} at {a:#x}-{b:#x}" for k, a, b, _ in loops[:4])
        log(f"  SASS of {kernel}: {n} instructions; loops (instructions): {spans}")
        if not loops:
            continue
        ops = loops[0][3]
        alu = sum(ops[o] for o in ALU_PIPE_OPS)
        log(f"  its largest loop: {alu} of {loops[0][0]} on the integer ALU pipe "
            f"({', '.join(f'{o} {c}' for o, c in ops.most_common(8))})")
        if kernel == "band_forward_kernel":
            log(f"  K3 row loop: {loops[0][0]} SASS instructions a warp a row (static, "
                f"one closure round) = {loops[0][0] / 16:.2f} a cell, against the "
                f"bound's {K3_INSTR_PER_CELL}")


def log_banded_sass() -> None:
    """K9's and K10's SASS: instructions, those of each loop, and the
    largest loop's opcodes; K9's row loop over the band lanes a lane holds
    is its instructions a cell on one pass of the loop's body (static: the
    count includes the branches a row does not take, such as the
    regathers for other band steps), against K9_INSTR_PER_CELL and the
    int32 count; K10's largest loop is its walk."""
    from raven_tpu_torch import csrc

    so = os.path.join(csrc.build_dir(), "libbanded.so")
    # the BW = 256 instantiations, by their mangled template argument
    for kernel in ("nw_moves_banded_kernel", "traceback_banded_kernel"):
        try:
            n, loops = sass_loops(so, kernel + "ILi256EE")
        except (OSError, subprocess.SubprocessError, StopIteration) as e:
            log(f"  SASS of {kernel}: not read ({e!r})")
            continue
        spans = ", ".join(f"{k} at {a:#x}-{b:#x}" for k, a, b, _ in loops[:4])
        log(f"  SASS of {kernel}: {n} instructions; loops (instructions): {spans}")
        if not loops:
            continue
        ops = loops[0][3]
        alu = sum(ops[o] for o in ALU_PIPE_OPS)
        log(f"  its largest loop: {alu} of {loops[0][0]} on the integer ALU pipe "
            f"({', '.join(f'{o} {c}' for o, c in ops.most_common(10))})")
        if kernel == "nw_moves_banded_kernel":
            log(f"  K9 row loop: {loops[0][0]} SASS instructions a lane a row (static) / "
                f"{K9_CELLS_PER_LANE} band lanes a lane = {loops[0][0] / K9_CELLS_PER_LANE:.2f} a cell, against "
                f"the bound's {K9_INSTR_PER_CELL} (16-bit pairs) and "
                f"{K9_INT32_INSTR_PER_CELL} (int32)")
        else:
            log(f"  K10 walk loop: {loops[0][0]} SASS instructions (static)")


# ------------------------------------------------------------------ phases
def phase_sketch(readset, device):
    """K1 vs sketch_plain on real segment rows; returns the kernels entry
    fields for the main-path shape ((15, 5), [8192, 2048])."""
    import torch

    from raven_tpu_torch.ops import sketch as sk
    from raven_tpu_torch.ops import sketch_cuda

    n_reads = min(len(readset), 2200)
    packed, eff, *_ = sk.segment_reads_packed(
        readset, np.arange(n_reads), K, W, width=2048
    )
    rows = min(SEG_ROWS, packed.shape[0])
    codes_all = sk.unpack_codes(torch.from_numpy(packed[:rows]).to(device))
    eff_all = torch.from_numpy(eff[:rows]).to(device)
    main = None
    for k, w in ((15, 5), (11, 3)):
        for S in (rows, rows - 3 if rows > 3 else rows, 1237 % rows or rows):
            codes = codes_all[:S].contiguous()
            lens = eff_all[:S].contiguous()
            got = sketch_cuda._kernel(codes, lens, k, w)
            want = sketch_cuda.sketch_plain(codes, lens, k, w)
            torch.cuda.synchronize()
            eq = all(torch.equal(a, b) for a, b in zip(got, want))
            err = int(
                (got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max()
            )
            require(eq, f"K1 differs from sketch_plain at k={k} w={w} S={S}")
            ms = cuda_ms(lambda: sketch_cuda._kernel(codes, lens, k, w))
            plain_ms = cuda_ms(
                lambda: sketch_cuda.sketch_plain(codes, lens, k, w), runs=10
            )
            bound, by, parts = sketch_bound(S, 2048, w)
            log(
                f"K1 k={k} w={w} S={S} L=2048: bit-equal, max_abs_err {err}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound:.4f} ms by {by}"
            )
            log(
                f"  bound parts: {parts['bytes']} B at {HBM_BYTES_PER_S:.3g} "
                f"B/s = {parts['bytes_ms']:.4f} ms; {parts['int_ops']} integer "
                f"instructions at {INT_INSTR_PER_S:.4g}/s = "
                f"{parts['ops_ms']:.4f} ms"
            )
            if (k, w) == (15, 5) and S == rows:
                dev = device_ms(lambda: sketch_cuda._kernel(codes, lens, k, w),
                                "sketch_rows_kernel")
                log(f"  device time (torch.profiler): {fmt_ms(dev)}")
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "device_ms": dev, "bound_ms": bound, "bound_by": by,
                        "shape": [S, 2048]}
    for k, w in ((15, 5), (12, 4), (11, 20)):
        for L in (2047, 1000):
            codes, lens = sketch_edge_case(codes_all, eff_all, 1237, L, k)
            got = sketch_cuda._kernel(codes, lens, k, w)
            want = sketch_cuda.sketch_plain(codes, lens, k, w)
            torch.cuda.synchronize()
            eq = all(torch.equal(a, b) for a, b in zip(got, want))
            require(eq, f"K1 differs from sketch_plain on the edge rows at "
                    f"k={k} w={w} L={L}")
            ms = cuda_ms(lambda: sketch_cuda._kernel(codes, lens, k, w))
            log(f"K1 edge rows k={k} w={w} S=1237 L={L}: bit-equal; kernel "
                f"{ms:.4f} ms; {int(want[2].sum())} kept, "
                f"{int((want[1] == 0).sum())} reverse-strand or empty positions")
    return main


def sketch_edge_case(codes_all, eff_all, S: int, L: int, k: int):
    """S real segment rows cut to width L, with rows 0-2 of lengths 0, k - 1
    and k, row 3 one repeated base, rows 4 and 5 the periodic ACGT... and
    ATAT..., whose k-mers at an even k include (or, for ATAT..., are all)
    their own reverse complements, and row 6 ending exactly at L."""
    import torch

    codes = codes_all[:S, :L].clone()
    lens = eff_all[:S].clamp(max=L).clone()
    lens[0], lens[1], lens[2] = 0, k - 1, k
    codes[3] = 2
    codes[4] = torch.arange(L, device=codes.device) % 4
    codes[5] = (torch.arange(L, device=codes.device) % 2) * 3
    lens[3:7] = L
    return codes.contiguous(), lens.contiguous()


def overlap_stage(readset, device, parts: int = 0, mesh=None):
    """minimize -> filter -> map_many on `device`, with the index in
    `parts` hash-range parts when 2 or more, or sharded over `mesh`:
    (wall, stage walls, overlaps, occurrence)."""
    import torch

    from raven_tpu_torch.overlap.device_index import PartitionedIndex
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel.sharded_index import ShardedIndex

    ids = np.arange(len(readset))
    t0 = time.perf_counter()
    idx = MinimizerIndex(K, W, device=device)
    idx.INDEX_PARTS = parts
    idx.MESH = mesh
    idx.minimize(readset, ids, minhash=False, with_query_flags=True)
    torch.cuda.synchronize()  # each stage's wall holds its own device work
    t1 = time.perf_counter()
    idx.filter(FREQ)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = idx.map_many(readset, ids, minhash=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    require(idx._device is not None and idx._hashes is None,
            "overlap stage left the device path")
    if mesh is not None:
        require(isinstance(idx._device, ShardedIndex), f"the index was not sharded over {mesh}")
    else:
        require(isinstance(idx._device, PartitionedIndex) == (parts > 1),
                f"the index was not built in {parts} parts" if parts > 1
                else "the index was partitioned")
    return t3 - t0, (t1 - t0, t2 - t1, t3 - t2), res, int(idx._occurrence)


def profile_overlap(readset, device, top: int = 12) -> None:
    """One more steady pass under torch.profiler: the device's busy share
    of the wall and the ops that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, *_ = overlap_stage(readset, device)
    events = prof.key_averages()
    # device time: the kernels and copies themselves (a torch op's own
    # self device time repeats the kernels it launched)
    busy = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / 1e6
    log(
        f"profiled steady pass: wall {wall:.3f} s (profiler on), device busy "
        f"{busy:.3f} s = {busy / wall:.3f} of the wall; torch ops by the "
        "device time of their kernels:"
    )
    ops = sorted(
        (e for e in events if e.device_type == DeviceType.CPU),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    for e in ops[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms device  "
            f"{e.count:7d} calls  {e.key[:90]}")
    torch.cuda.synchronize()


def phase_overlap(readset, device, child, child_out):
    import torch

    from raven_tpu_torch.ops import sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.utils.synth import overlap_digest

    # the device passes start once the host child is done, so their host
    # side does not share the cores with its fork pool
    rc = child.wait(timeout=900)
    require(rc == 0, f"host overlap child exited {rc}")
    with open(child_out) as f:
        host = json.load(f)
    log(
        f"host path (child, {os.cpu_count()} cores): {host['wall']:.3f} s, "
        f"{host['overlaps']} overlaps, occurrence {host['occ']}"
    )

    bases = int(readset.lengths.sum())
    sketch_cuda.LAUNCHES = 0
    MinimizerIndex.host_declines = 0
    cold, parts_c, res, occ = overlap_stage(readset, device)
    launches = sketch_cuda.LAUNCHES
    declines = MinimizerIndex.host_declines
    digest, n_ov = overlap_digest(res)
    torch.cuda.reset_peak_memory_stats()
    steady, parts_s, res2, _ = overlap_stage(readset, device)
    peak = torch.cuda.max_memory_allocated()
    require(overlap_digest(res2)[0] == digest, "steady pass differs from cold")
    part_s, parts_p, res3, occ3 = overlap_stage(readset, device, parts=3)
    require(overlap_digest(res3)[0] == digest and occ3 == occ,
            "the index in 3 hash-range parts differs from the single index")
    profile_overlap(readset, device)
    log(
        f"overlap stage ({len(readset)} reads, {bases} bases): cold "
        f"{cold:.3f} s (minimize {parts_c[0]:.3f}, filter {parts_c[1]:.3f}, "
        f"map {parts_c[2]:.3f}), steady {steady:.3f} s (minimize "
        f"{parts_s[0]:.3f}, filter {parts_s[1]:.3f}, map {parts_s[2]:.3f}); "
        f"{bases / steady:.1f} bases/s steady; {n_ov} overlaps; occurrence "
        f"{occ}; K1 launches {launches}; host declines {declines}; peak "
        f"device memory {peak} B; the index in 3 hash-range parts (the "
        f"partitioned index, forced) {part_s:.3f} s (minimize {parts_p[0]:.3f}, "
        f"filter {parts_p[1]:.3f}, map {parts_p[2]:.3f}), the same overlaps"
    )
    require(launches > 0, "the overlap stage launched K1 no time")
    require(declines == 0, f"{declines} device-path declines")
    require(host["digest"] == digest, "overlap digest differs from the host path")
    require(host["occ"] == occ, "occurrence differs from the host path")
    log("overlap digest equal to the port's host path")
    return {"cold_s": cold, "steady_s": steady, "bases": bases,
            "bases_per_s": bases / steady, "overlaps": n_ov,
            "launches": launches, "peak_bytes": peak, "digest": digest, "occ": occ}


def phase_sharded(readset, device, ov):
    """The overlap stage through the hash-range-sharded index on a virtual
    mesh of 4 shards on one card (MinimizerIndex.MESH): the single
    index's digest and occurrence, K1 launched on each shard, no decline;
    its steady wall and peak device memory beside the single index's (a
    virtual mesh's wall is the exchange and the per-shard launches on one
    card, not what 4 cards would give).  With 2 or more cards, once more
    on make_mesh()."""
    import torch

    from raven_tpu_torch.ops import sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel.mesh import Mesh, make_mesh
    from raven_tpu_torch.utils.synth import overlap_digest

    mesh = Mesh([device] * 4)
    sketch_cuda.LAUNCHES = 0
    MinimizerIndex.host_declines = 0
    cold, _, res, occ = overlap_stage(readset, device, mesh=mesh)
    launches = sketch_cuda.LAUNCHES
    declines = MinimizerIndex.host_declines
    require(overlap_digest(res)[0] == ov["digest"] and occ == ov["occ"],
            "the sharded index's overlaps differ from the single index's")
    torch.cuda.reset_peak_memory_stats()
    steady, walls, res, _ = overlap_stage(readset, device, mesh=mesh)
    peak = torch.cuda.max_memory_allocated()
    require(overlap_digest(res)[0] == ov["digest"], "the sharded steady pass differs")
    log(
        f"sharded index on a virtual mesh of 4 shards on one card ({mesh}): cold "
        f"{cold:.3f} s, steady {steady:.3f} s (minimize {walls[0]:.3f}, filter "
        f"{walls[1]:.3f}, map {walls[2]:.3f}) against the single index's steady "
        f"{ov['steady_s']:.3f} s; peak device memory {peak} B against {ov['peak_bytes']} "
        f"B; K1 launches {launches}; host declines {declines}; the single index's "
        "overlap digest and occurrence"
    )
    require(launches > 0, "the sharded index launched K1 no time")
    require(declines == 0, f"{declines} sharded-path declines")
    out = {"steady_s": steady, "cold_s": cold, "peak_bytes": peak, "launches": launches,
           "cards_steady_s": None}
    if torch.cuda.device_count() > 1:
        cards = make_mesh()
        wall, _, res, occ = overlap_stage(readset, device, mesh=cards)
        require(overlap_digest(res)[0] == ov["digest"] and occ == ov["occ"],
                f"the index sharded over {cards} differs from the single index")
        out["cards_steady_s"] = wall
        log(f"sharded index over {cards}: {wall:.3f} s, the single index's digest")
    return out


def write_readset(readset, path: str) -> str:
    """`readset` as FASTA at `path` (the multi-process ranks load it)."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        for i in range(len(readset)):
            fh.write(b">r%d\n" % i + lut[readset.sequence(i)].tobytes() + b"\n")
    return path


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(roles: str, nproc: int, backend: str, shards: int, extra, timeout=300):
    """`nproc` ranks of raven_tpu_torch.parallel.worker on cuda:0, started
    together: each rank's {role: its JSON line}.  A rank that exits
    non-zero or outlives `timeout` (every rank is then killed) fails the
    run.  gloo and NCCL are told to bind the loopback interface (a setting
    of the libraries, in the children's environment only)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "raven_tpu_torch.parallel.worker", roles, str(r),
             str(nproc), init, backend, "cuda:0", str(shards), "--timeout", "240", *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(nproc)
    ]
    deadline = time.perf_counter() + timeout
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{backend} rank {r} of {nproc} ({roles}) ran past "
                                   f"{timeout} s") from None
            tail = "\n".join(ln for ln in err.splitlines()
                             if "::Graph::" not in ln and "hostname" not in ln)[-3000:]
            require(p.returncode == 0,
                    f"{backend} rank {r} of {nproc} ({roles}) exited {p.returncode}:\n{tail}")
            recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
            results.append({rec["role"]: rec for rec in recs})
            require(set(results[-1]) == set(roles.split(",")),
                    f"{backend} rank {r} printed {sorted(results[-1])}, not {roles}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def check_rank(tag: str, rank: dict, ov: dict) -> None:
    """A rank's overlap and candidates roles: phase 3's digest and
    occurrence, no decline, K1 launched, the candidate count of the host
    oracle, each engine's votes bit-equal to one device, its kernels
    launched."""
    o, c = rank["overlap"], rank["candidates"]
    require(o["sharded"] and o["digest"] == ov["digest"] and o["occ"] == ov["occ"],
            f"{tag}: the overlaps or the occurrence differ from phase 3's")
    require(o["steady_equal"], f"{tag}: the steady pass differs from the cold one")
    require(o["declines"] == 0, f"{tag}: {o['declines']} declines")
    require(o["k1"] > 0 and c["step_k1"] > 0, f"{tag}: K1 launched no time")
    require(c["pairs"] == c["oracle"], f"{tag}: {c['pairs']} candidate pairs, the host "
            f"oracle {c['oracle']}")
    kernels = {"full-NW": ("K2",), "banded": ("K9", "K10"), "shift-banded": ("K3", "K4")}
    for name, ks in kernels.items():
        v = c["votes"][name]
        require(v["equal"], f"{tag}: the {name} votes differ from one device's")
        require(all(v["launches"][k] > 0 for k in ks),
                f"{tag}: the {name} votes launched {ks} no time: {v['launches']}")


def rank_launches(rank: dict) -> dict:
    """K1-K10 launches over a rank's roles."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K9", "K10"), 0)
    if "overlap" in rank:
        out["K1"] += rank["overlap"]["k1"]
    if "candidates" in rank:
        out["K1"] += rank["candidates"]["step_k1"]
        for v in rank["candidates"]["votes"].values():
            for k in ("K2", "K3", "K4", "K9", "K10"):
                out[k] += v["launches"][k]
    if "construct" in rank:
        out["K1"] += rank["construct"]["k1"]
    return out


def log_rank(tag: str, rank: dict, shd: dict) -> None:
    o, c = rank["overlap"], rank["candidates"]
    x = o["exchange"]
    votes = ", ".join(f"{n} {v['mesh_s']:.3f} s (one device {v['single_s']:.3f} s)"
                      for n, v in c["votes"].items())
    log(f"{tag}: overlap-115M cold {o['cold_s']:.3f} s, steady {o['steady_s']:.3f} s "
        f"(minimize {o['steady_stages_s'][0]:.3f}, filter {o['steady_stages_s'][1]:.3f}, "
        f"map {o['steady_stages_s'][2]:.3f}) against phase 3b's 4-shard single process "
        f"{shd['steady_s']:.3f} s; collectives {x['calls']} calls, {x['bytes']} B handed "
        f"to them; a pass of its own with the collectives timed (the device synchronised "
        f"around each) {o['timed_s']:.3f} s, {o['collective_s']:.3f} s of it in them; "
        f"peak device memory {o['peak_bytes']} B; "
        f"{o['overlaps']} overlaps, phase 3's digest; candidate pairs {c['pairs']} (the "
        f"host oracle's); votes on the bank, bit-equal: {votes}; launches "
        f"{rank_launches(rank)}")


def phase_multiprocess(work_dir, reads115: str, ov: dict, shd: dict):
    """Phase 3c (see the module docstring): one NCCL rank, then two gloo
    ranks, each in child processes on cuda:0."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the children share the card
    reads, _, _ = write_reads(work_dir, 1_000_000)  # phase 4's reads
    with open(os.path.join(work_dir, "cli.gfa"), "rb") as f:
        gfa_want = f.read()
    t0 = time.perf_counter()
    (nccl,) = run_ranks("overlap,candidates", 1, "nccl", 4, ["--reads", reads115, "--bank"])
    nccl_wall = time.perf_counter() - t0
    check_rank("NCCL, 1 rank, 4 shards on cuda:0", nccl, ov)
    log_rank("NCCL, 1 rank of a virtual 4-shard mesh on cuda:0", nccl, shd)
    t0 = time.perf_counter()
    gloo = run_ranks("overlap,candidates", 2, "gloo", 2, ["--reads", reads115, "--bank"])
    t1 = time.perf_counter()
    prefix = os.path.join(work_dir, "multiprocess")
    built = run_ranks("construct", 2, "gloo", 2, ["--reads", reads, "--gfa", prefix])
    t2 = time.perf_counter()
    for r, (rank, con) in enumerate(zip(gloo, built)):
        tag = f"gloo rank {r} of 2, 2 shards on cuda:0"
        check_rank(tag, rank, ov)
        c = con["construct"]
        with open(c["gfa"], "rb") as f:
            got = f.read()
        require(c["declines"] == 0 and c["k1"] > 0 and c["collectives"] > 0,
                f"{tag}: the construct left the sharded index ({c})")
        require(got.startswith(b"S\t") and got == gfa_want,
                f"{tag}: the construct's GFA differs from phase 4b's")
        rank["construct"] = c
        log_rank(f"{tag} (two processes sharing one card over gloo, not a multi-card "
                 "wall)", rank, shd)
        log(f"{tag}: construct of phase 4's reads {c['construct_s']:.3f} s, assemble "
            f"{c['assemble_s']:.3f} s, {c['nodes']} nodes, {c['edges']} edges; GFA "
            f"{len(got)} B, phase 4b's byte for byte")
    log(f"multi-process runs, start to exit: NCCL 1 rank {nccl_wall:.3f} s, gloo 2 ranks "
        f"{t1 - t0:.3f} s (overlap, candidates) + {t2 - t1:.3f} s (construct)")
    return {"nccl": nccl, "gloo": gloo, "reads": reads,
            "launches": {"nccl_w1": rank_launches(nccl),
                         **{f"gloo_rank{r}": rank_launches(g) for r, g in enumerate(gloo)}}}


def phase_device_sketch(device, reads_path: str) -> dict:
    """Phase 3d (see the module docstring) on the reads at `reads_path`."""
    import torch

    from raven_tpu_torch.io import load_sequences
    from raven_tpu_torch.ops import sketch_cuda
    from raven_tpu_torch.overlap import engine
    from raven_tpu_torch.overlap.minimizer import minimize_reads

    index = engine.MinimizerIndex
    rs = load_sequences([reads_path])
    ids = np.arange(len(rs))
    bases = int(rs.lengths.sum())
    require(bases >= index.DEVICE_MIN_BASES and index.DEVICE_SKETCH,
            f"{bases} bases do not take the device-sketch route")

    def build(on: bool):
        idx = index(K, W, device=device)
        idx.DEVICE_SKETCH = on
        t0 = time.perf_counter()
        idx.minimize(rs, ids, minhash=False, with_query_flags=True)
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t0

    ceiling = engine.MAX_TOTAL_ENTRIES
    engine.MAX_TOTAL_ENTRIES = 0  # every device index declines
    try:
        sketch_cuda.LAUNCHES = 0
        index.host_declines = 0
        dev, dev_s = build(True)
        launches, declines = sketch_cuda.LAUNCHES, index.host_declines
        host, host_s = build(False)
    finally:
        engine.MAX_TOTAL_ENTRIES = ceiling
    require(dev._device is None and host._device is None, "a device index was built")
    require(declines == 1, f"{declines} declines, not 1")
    require(launches > 0, "the device-sketch route launched K1 no time")
    for a in ("_hashes", "_ids", "_pos", "_strand", "_qflag"):
        require(np.array_equal(getattr(dev, a), getattr(host, a)),
                f"the device-sketch route's index differs from the host sketch's in {a}")
    t0 = time.perf_counter()
    dev._device_sketch(rs, ids)
    torch.cuda.synchronize()
    sketch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    minimize_reads(rs, ids, K, W, False)
    host_sketch_s = time.perf_counter() - t0
    log(f"device-sketch route ({len(rs)} reads, {bases} bases, {dev._hashes.size} "
        f"entries): index build {dev_s:.3f} s against {host_s:.3f} s with the host "
        f"sketch, the same columns; the sketch alone {sketch_s:.3f} s on the card "
        f"against {host_sketch_s:.3f} s on the host; K1 launches {launches}; "
        f"declines {declines} (forced)")
    return {"launches": launches, "index_s": dev_s, "host_index_s": host_s,
            "sketch_s": sketch_s, "host_sketch_s": host_sketch_s}


def make_genome(rng, size: int, repeat: tuple | None = None) -> np.ndarray:
    """A random genome; `repeat` = (length, copies, divergence) plants a
    repeat family: copies of one element spread evenly over the genome,
    each in a random orientation with its own substitutions."""
    genome = rng.integers(0, 4, size).astype(np.uint8)
    if repeat is not None:
        length, copies, divergence = repeat
        element = rng.integers(0, 4, length).astype(np.uint8)
        for s in np.linspace(size * 0.05, size * 0.95, copies).astype(int):
            r = element.copy()
            m = rng.random(length) < divergence
            r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
            if rng.random() < 0.5:
                r = r[::-1] ^ 3
            genome[s : s + length] = r
    return genome


def write_reads(work_dir, genome_size, repeat=None):
    """Reads simulated at 30x (mean 9 kb, 2.5% substitutions, 1.25%
    insertions, 1.25% deletions, seed 77) from make_genome's genome, as
    FASTA in work_dir: (path, genome, reads)."""
    from raven_tpu_torch.utils.synth import simulate_reads

    rng = np.random.default_rng(77)
    genome = make_genome(rng, genome_size, repeat)
    reads = simulate_reads(rng, genome, 30, 9000, 0.025, 0.0125, 0.0125)
    path = os.path.join(work_dir, "reads.fa")
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n" % i + lut[r].tobytes() + b"\n")
    return path, genome, reads


def cli_run(device, work_dir, genome_size, repeat=None, flags=("-p", "0")) -> dict:
    """One `raven_tpu_torch.cli.main([reads, *flags, ...])` run on
    write_reads's reads; every count starts at 0 right before it and is
    read right after.  The stages' walls are the program's spans
    (raven_tpu_torch.utils.trace) under a CPU profiler: cli.construct,
    cli.assemble, cli.polish and each polish.round with its engine."""
    from torch.profiler import ProfilerActivity, profile

    from raven_tpu_torch import cli
    from raven_tpu_torch.graph import layout
    from raven_tpu_torch.io.readset import encode
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda, dp_device
    from raven_tpu_torch.ops import layout_cuda, sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.utils import trace

    path, genome, reads = write_reads(work_dir, genome_size, repeat)
    argv = [path, *flags, "--disable-checkpoints", "--device", device]
    out = io.StringIO()
    zero_counts()
    dp_device.DEVICE_RUNS = 0
    layout.DEVICE_RUNS = 0
    MinimizerIndex.host_declines = 0
    trace.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), profile(activities=[ProfilerActivity.CPU]):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    spans = sorted(trace.spans(), key=lambda r: r.start)
    trace.clear()

    def seconds(name):
        return sum(r.end - r.start for r in spans if r.name == name) / 1e9

    timings = {"construct_s": seconds("cli.construct"), "assemble_s": seconds("cli.assemble"),
               "polish_s": seconds("cli.polish"),
               "polish_rounds": [{"round": r.counts["round"], "engine": r.counts["engine"],
                                  "wall_s": (r.end - r.start) / 1e9}
                                 for r in spans if r.name == "polish.round"]}
    run = {"launches": sketch_cuda.LAUNCHES, "layout_runs": layout.DEVICE_RUNS,
           "k2_launches": consensus_cuda.LAUNCHES,
           "k3_launches": band_cuda.LAUNCHES["band_forward"],
           "k4_launches": band_cuda.LAUNCHES["mask_walk_votes"],
           "pack_launches": band_cuda.LAUNCHES["band_pack"],
           "k9_launches": banded_cuda.LAUNCHES["nw_moves_banded"],
           "k10_launches": banded_cuda.LAUNCHES["traceback_banded"],
           "k12_launches": layout_cuda.LAUNCHES["n_body"],
           "dp_runs": dp_device.DEVICE_RUNS,
           "declines": MinimizerIndex.host_declines, "wall_s": wall, **timings}
    require(rc == 0, f"cli exited {rc}")
    lines = out.getvalue().split("\n")
    seqs = [ln for ln in lines if ln and not ln.startswith(">")]
    require(len(seqs) == sum(ln.startswith(">") for ln in lines),
            "contig FASTA is malformed")
    require(all(set(s) <= set("ACGT") for s in seqs),
            "a contig holds non-ACGT symbols")
    run["lengths"] = [len(s) for s in seqs]
    run["contigs"] = [encode(s) for s in seqs]  # base codes 0-3
    run["genome"] = genome
    log(
        f"cli {' '.join(flags)} ({len(reads)} reads, {sum(r.size for r in reads)} "
        f"bases, {genome_size} bp genome, repeat family {repeat}): construct "
        f"{timings['construct_s']:.3f} s, assemble {timings['assemble_s']:.3f} "
        f"s, polish {timings['polish_s']:.3f} s, wall {wall:.3f} s; contigs "
        f"{len(seqs)} {run['lengths']}; K1 launches {run['launches']}; layout "
        f"n-body runs {run['layout_runs']} (K12 launches {run['k12_launches']}); host "
        f"declines {run['declines']}"
    )
    require(run["launches"] > 0, "the cli run launched K1 no time")
    require(run["declines"] == 0, f"{run['declines']} device-path declines")
    return run


def phase_cli(device, work_dir, genome_size=1_000_000):
    """The main path twice: on a repeat-free genome, which must assemble
    into one contig; and on one with a repeat family (8 copies of an 11 kb
    element, 2% apart, longer than most reads), whose collapsed copies
    leave a junction component of 512 nodes or more, so the assemble
    stage's layout runs the n-body (K12) on the card; its inputs (points
    and links) are recorded for phase 5.  Such repeats cannot be
    resolved from these reads, so that run must give at most 9 contigs
    that together hold 0.97-1.1 x the genome."""
    main = cli_run(device, work_dir, genome_size)
    lengths = main["lengths"]
    require(len(lengths) == 1, f"expected 1 contig, got {len(lengths)}")
    require(lengths[0] >= 0.97 * genome_size,
            f"contig {lengths[0]} < 0.97 x {genome_size}")
    from raven_tpu_torch.graph import layout

    component = layout._layout_component
    n_body_inputs = []

    def record(points, edges_a, edges_b, *args, **kwargs):
        if len(points) >= layout._DEVICE_MIN_NODES:
            n_body_inputs.append((points.copy(), edges_a.copy(), edges_b.copy()))
        return component(points, edges_a, edges_b, *args, **kwargs)

    layout._layout_component = record
    layout.reset_seed()  # the layout's start points of a fresh CLI process
    try:
        rep = cli_run(device, work_dir, genome_size, repeat=(11_000, 8, 0.02))
    finally:
        layout._layout_component = component
    rep["n_body_inputs"] = n_body_inputs
    log(f"repeat run's contigs {rep['lengths']}; raven_tpu's unitigs of this genome's "
        f"checkpoint (tests/test_torch_layout_n_body.py, on the CPU) "
        f"{list(RAVEN_TPU_REPEAT_UNITIGS)}: "
        f"{'the same' if tuple(rep['lengths']) == RAVEN_TPU_REPEAT_UNITIGS else 'other'}")
    require(rep["layout_runs"] > 0 and rep["k12_launches"] == rep["layout_runs"],
            f"the repeat cli run: {rep['layout_runs']} n-body runs on the card, "
            f"{rep['k12_launches']} K12 launches (one a run)")
    total = sum(rep["lengths"])
    require(len(rep["lengths"]) <= 9, f"{len(rep['lengths'])} contigs")
    require(0.97 * genome_size <= total <= 1.1 * genome_size,
            f"contigs hold {total} bp of a {genome_size} bp genome")
    return main, rep


def phase_api(device, work_dir, genome_size=1_000_000):
    """raven_tpu_torch.api on phase 4's reads: the sub-stages
    (find_overlaps_and_create_piles -> ... -> remove_long_edges_from_graph)
    on the card must give the GFA that `cli.main([reads, "-p", "0", ...])`
    gives, byte for byte; then construct_graph(checkpoints=True), a load
    of the checkpoint and assemble_graph must give the sub-stages'
    unitigs.  K1 launches are counted over the sub-stages alone."""
    import torch

    from raven_tpu_torch import api, cli
    from raven_tpu_torch.graph import layout
    from raven_tpu_torch.graph.binary import load_graph
    from raven_tpu_torch.ops import sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    path, _, _ = write_reads(work_dir, genome_size)
    api_gfa = os.path.join(work_dir, "api.gfa")
    cli_gfa = os.path.join(work_dir, "cli.gfa")
    layout.reset_seed()
    sketch_cuda.LAUNCHES = 0
    MinimizerIndex.host_declines = 0
    t0 = time.perf_counter()
    readset = api.load_sequences([path])
    graph = api.Graph()
    index = api.MinimizerIndex(K, W, device=device)
    handle = api.OverlapsHandle(readset)
    api.find_overlaps_and_create_piles(index, readset, graph, handle)
    api.trim_and_annotate_piles(graph, handle)
    api.resolve_contained_reads(graph, handle, readset)
    api.resolve_chimeric_sequences(graph, handle)
    api.find_overlaps_and_repetitive_regions(index, graph, handle, readset)
    api.resolve_repeat_induced_overlaps(graph, handle, readset)
    api.construct_assembly_graph(graph, handle, readset)
    api.remove_transitive_edges_from_graph(graph)
    api.remove_tips_and_bubbles_from_graph(graph)
    api.remove_long_edges_from_graph(graph, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, declines = sketch_cuda.LAUNCHES, MinimizerIndex.host_declines
    api.graph_print_gfa(graph, api_gfa)
    unitigs = api.get_unitigs(graph)

    layout.reset_seed()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([path, "-p", "0", "--disable-checkpoints", "--device", device,
                       "-F", cli_gfa])
    require(rc == 0, f"cli exited {rc}")
    with open(api_gfa, "rb") as a, open(cli_gfa, "rb") as b:
        got, want = a.read(), b.read()
    log(f"api sub-stages ({len(readset)} reads): {wall:.3f} s, K1 launches {launches}, "
        f"host declines {declines}; GFA {len(got)} B, the cli's {len(want)} B, "
        f"{'equal' if got == want else 'DIFFERENT'}; {len(unitigs)} unitigs")
    require(launches > 0, "the api sub-stages launched K1 no time")
    require(declines == 0, f"{declines} device-path declines")
    require(got.startswith(b"S\t") and got == want, "the api's GFA differs from the cli's")

    cwd = os.getcwd()
    os.chdir(work_dir)
    try:
        layout.reset_seed()
        t0 = time.perf_counter()
        g = api.Graph()
        api.construct_graph(g, readset, checkpoints=True, device=device)
        g = load_graph()
        api.assemble_graph(g, checkpoints=True, device=device)
        g = load_graph()
        ck_wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    resumed = api.get_unitigs(g)
    require(len(resumed) == len(unitigs) > 0 and all(
        np.array_equal(a.codes, b.codes) for a, b in zip(resumed, unitigs)
    ), "the checkpointed construct and assemble give other unitigs")
    log(f"api construct_graph(checkpoints=True) -> load -> assemble_graph -> load: "
        f"{ck_wall:.3f} s, the sub-stages' {len(unitigs)} unitigs")
    return {"wall_s": wall, "launches": launches, "checkpoint_wall_s": ck_wall}


def n_body_bound(n: int, links: int, slots: int, iters: int) -> tuple[float, str, dict]:
    """Least time for K12's work on these inputs: the larger of the bytes
    each read or written once (points float32 [n, 2] in and out, the
    links int32 [slots, n]) over HBM bandwidth, and its float32 operations
    (K12_FLOPS_* a pair of points, a link and a row, 2 a partial of the row
    sums' tree) over the card's float32 rate."""
    W = -(-n // 32)
    partials = W
    while W > 32:
        W = -(-W // 32)
        partials += W
    nbytes = 8 * n + 4 * slots * n + 8 * n
    flops = iters * (n * (n - 1) * K12_FLOPS_PAIR + links * K12_FLOPS_LINK
                     + n * K12_FLOPS_ROW + 2 * n * partials)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "fp32_flops": flops,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def n_body_case(n: int, seed: int):
    """A component of n points in the unit square, a chain and 200 random
    links, as the layout tests build it."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, 200)])
    eb = np.concatenate([np.arange(1, n), rng.integers(0, n, 200)])
    return pts, ea, eb


def phase_layout(device, smi: str, repeat_inputs):
    """Phase 5: K12 against its plain version, the n-body against the
    float64 host loop, and remove_long_edges through K12 (see the module
    docstring)."""
    import importlib

    import torch

    from raven_tpu_torch.graph import graph as gmod
    from raven_tpu_torch.graph import layout
    from raven_tpu_torch.ops import layout_cuda

    # the graph package exports a function named assemble over the module
    asm = importlib.import_module("raven_tpu_torch.graph.assemble")
    iters = 100
    card = layout_cuda.card_info(device)
    blocks = card["sms"] * card["per_sm"]
    log(f"K12 on {smi}: {card}; one cooperative grid of {blocks} blocks, at most one a row")

    def k12(pts, ea, eb, it=iters):
        before = layout_cuda.LAUNCHES["n_body"]
        out = layout_cuda.n_body_kernel(
            torch.as_tensor(pts, dtype=torch.float32, device=device), ea, eb, it)
        launched = layout_cuda.LAUNCHES["n_body"] - before
        require(launched == 1, f"K12 launched {launched} times in one call of {it} iterations")
        return out

    def plain(pts, ea, eb, it=iters, dev=device):
        return layout_cuda.n_body_plain(
            torch.as_tensor(pts, dtype=torch.float32, device=dev), ea, eb, it)

    def held(tag, got, want):
        got, want = got.cpu(), want.cpu()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"K12 {tag}: shape {tuple(got.shape)} or non-finite values")
        differ = int((got != want).sum())
        require(differ == 0, f"K12 {tag}: {differ} of {got.numel()} coordinates differ "
                             "from its plain version")
        return float((got - want).abs().max())

    def plan_of(n):
        return f"{layout_cuda.launch_plan(n, **card)['ctas']} blocks"

    cases, errs, checked = {}, [], []
    for n, it in K12_CASES + ((blocks, 5), (blocks + 1, 5)):
        pts, ea, eb = n_body_case(n, 3)
        t0 = time.perf_counter()
        got = k12(pts, ea, eb, it)
        torch.cuda.synchronize()
        k12_s = time.perf_counter() - t0
        want, plain_ms = timed_plain(lambda: plain(pts, ea, eb, it))  # noqa: B023
        errs.append(held(f"at {n} points x {it} iterations ({plan_of(n)})", got, want))
        checked.append({"n": n, "iterations": it, "plan": plan_of(n),
                        "k12_s": k12_s, "plain_ms": plain_ms})
        log(f"K12 bit-equal at {n} points x {it} iterations ({plan_of(n)}): {k12_s:.3f} s, "
            f"the plain version {plain_ms:.1f} ms")
        if it == iters and n in (600, 1500):
            cases[n] = {"plain_ms": plain_ms, "links": len(ea)}
    # four levels of windows; 64 rows of each size, among them the first and
    # the last, rows about each power-of-32 boundary and the first and last
    # rows of some blocks, held to the plain rules over those rows alone
    sampled = []
    for n in K12_SAMPLED:
        pts, ea, eb = n_body_case(n, 3)
        ranges = layout_cuda.row_ranges(n, layout_cuda.launch_plan(n, **card)["ctas"])
        rows = {0, n - 1, *(r for b in (0, 1, len(ranges) // 2, len(ranges) - 1)
                            for r in (ranges[b][0], ranges[b][1] - 1)),
                *(b + d for b in (1 << 10, 1 << 15, 1 << 20, (1 << 20) + (1 << 15))
                  for d in (-1, 0, 1) if b + d < n)}
        rng = np.random.default_rng(9)
        while len(rows) < 64:
            rows.add(int(rng.integers(0, n)))
        rows = np.array(sorted(rows))
        t0 = time.perf_counter()
        got = k12(pts, ea, eb, 1)
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t0
        want = layout_cuda.n_body_rows_plain(
            torch.as_tensor(pts, dtype=torch.float32, device=device), ea, eb, rows)
        errs.append(held(f"on {len(rows)} rows of {n} points x 1 iteration",
                         got[torch.as_tensor(rows, device=got.device)], want))
        sampled.append({"n": n, "rows": len(rows), "k12_s": big_s})
        log(f"K12 at {n} points x 1 iteration ({plan_of(n)}): {big_s:.3f} s; {len(rows)} "
            f"sampled rows bit-equal to the plain rules over those rows alone")
    # the card's bits are the CPU's, which the CPU tests hold to raven_tpu's
    pts, ea, eb = n_body_case(600, 3)
    t0 = time.perf_counter()
    cpu = plain(pts, ea, eb, dev="cpu")
    cpu_s = time.perf_counter() - t0
    errs.append(held("at 600 points against the plain version on the CPU",
                     k12(pts, ea, eb), cpu))
    for i, (pts, ea, eb) in enumerate(repeat_inputs):
        errs.append(held(f"on phase 4's repeat component {i} ({len(pts)} points, "
                         f"{plan_of(len(pts))})", k12(pts, ea, eb), plain(pts, ea, eb)))
    require(len(repeat_inputs) > 0, "phase 4's repeat run gave the n-body no component")
    log(f"K12 bit-equal to the plain version on the CPU at 600 points ({cpu_s:.3f} s "
        f"there), and on phase 4's {len(repeat_inputs)} repeat components "
        f"({sorted({len(p) for p, _, _ in repeat_inputs})} points); one launch a call")

    # float32 on the card against the float64 host loop: the n-body
    # amplifies rounding ~2.5x per iteration, so compare after 3, where
    # the gap is ~1e-6 on coordinates of order 1
    pts, ea, eb = n_body_case(600, 3)
    dev = layout._layout_component_device(pts.copy(), ea, eb, 3, device)
    host = layout._layout_component_host(pts.copy(), ea, eb, 3)
    err = float(np.abs(dev - host).max())
    log(f"layout n-body vs host loop (3 iterations, n=600): max abs diff {err:.3g}")
    require(err < 1e-4, "device n-body disagrees with the host loop")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layout._layout_component_device(pts.copy(), ea, eb, iters, device)
    t_nbody = time.perf_counter() - t0

    for n in (600, 1500):
        pts, ea, eb = n_body_case(n, 3)
        p32 = torch.as_tensor(pts, dtype=torch.float32, device=device)
        slots = layout_cuda.attraction_slots(n, ea, eb).shape[1]
        bound, by, detail = n_body_bound(n, len(ea), slots, iters)
        fn = lambda: layout_cuda.n_body_kernel(p32, ea, eb, iters)  # noqa: B023, E731
        cases[n].update({
            "ms": cuda_ms(fn, runs=10, warmup=2),
            "device_ms": device_ms(fn, "n_body"),
            "plan": plan_of(n),
            "bound_ms": bound, "bound_by": by, **detail,
            "shape": [n, 2], "slots": slots, "iterations": iters,
        })
        c = cases[n]
        log(f"K12 at {n} points ({c['links']} links, {slots} slots) x {iters} iterations "
            f"on {smi} ({c['plan']}): {c['ms']:.4f} ms a call, device "
            f"{fmt_ms(c['device_ms'])}, bound {bound:.4f} ms ({by}: {detail['fp32_flops']} "
            f"float32 flops), {bound / c['ms']:.2%} of it; plain version on the card "
            f"{c['plain_ms']:.1f} ms; 1 launch a call")

    g = gmod.Graph()
    n = 600
    rng = np.random.default_rng(3)
    nodes = [
        g.new_node_pair(f"n{i}", rng.integers(0, 4, 64).astype(np.uint8))[0]
        for i in range(n)
    ]
    hub = g.new_node_pair("hub", rng.integers(0, 4, 64).astype(np.uint8))[0]
    for i in range(n - 1):
        g.new_edge_pair(nodes[i], nodes[i + 1], 32, 32)
    for i in range(0, n - 1, 40):
        g.new_edge_pair(nodes[i], hub, 32, 32)
    layout.DEVICE_RUNS = 0
    zero_counts()
    removed = asm.remove_long_edges(g, num_rounds=1, device=device)
    runs, launches = layout.DEVICE_RUNS, read_counts()["K12"]
    log(
        f"remove_long_edges on a {n + 1}-node junction component: "
        f"{removed} long edges, layout n-body runs on the card {runs}, K12 launches "
        f"{launches}; 100-iteration n-body at 600 points (host wall, the transfers "
        f"included) {t_nbody:.3f} s"
    )
    require(runs > 0 and launches == runs,
            f"remove_long_edges: {runs} n-body runs on the card, {launches} K12 launches")
    return {"layout_runs": runs, "launches": launches, "nbody_100_s": t_nbody,
            "max_abs_err": max(errs), "cases": cases, "checked": checked,
            "cpu_plain_s": cpu_s, "sampled": sampled}


def consensus_chunk(n_rows: int = 2048, t_pad: int = 640, q_pad: int = 768, windows=None):
    """The first `n_rows` fragment rows of bench_polish.py's window bank
    (make_windows(512, 500, 30), seed 21; or of `windows`) as
    device_window_consensus lays out its first iteration: each row's window
    backbone (the working consensus) padded to t_pad with -1, the fragment
    to q_pad with -1, its weights with 0.  Returns numpy (cw, tlens, frags,
    qlens, wts) and the bank's row count."""
    from raven_tpu_torch.utils.synth import make_windows

    if windows is None:
        windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    total = sum(len(f) for _, f, _ in windows)
    cw = np.full((n_rows, t_pad), -1, np.int32)
    tl = np.zeros(n_rows, np.int32)
    fr = np.full((n_rows, q_pad), -1, np.int32)
    ql = np.zeros(n_rows, np.int32)
    wt = np.zeros((n_rows, q_pad), np.int32)
    row = 0
    for backbone, frags, wts in windows:
        for f, w in zip(frags, wts):
            if row == n_rows:
                return (cw, tl, fr, ql, wt), total
            b = backbone[:t_pad]
            cw[row, : b.size] = b
            tl[row] = b.size
            f, w = f[:q_pad], w[:q_pad]
            fr[row, : f.size] = f
            ql[row] = f.size
            wt[row, : w.size] = w
            row += 1
    return (cw, tl, fr, ql, wt), total


def votes_edge_cases(cw, tl, fr, ql, wt):
    """[name, (cw, tlens, frags, qlens, wts)] cases that K2's fragment
    pairs and column tiles could break, built from the bank's chunk."""
    rng = np.random.default_rng(5)
    cases = []
    perm = rng.permutation(cw.shape[0])
    cases.append(("shuffled", tuple(a[perm] for a in (cw, tl, fr, ql, wt))))
    # qlen 0 in one half of some pairs (odd and even rows), at an odd B
    q0 = ql[:1237].copy()
    q0[1::7] = 0
    cases.append(("odd B, qlen 0 halves", (cw[:1237], tl[:1237], fr[:1237, :768],
                                           q0, wt[:1237, :768])))
    # each fragment twice over: ~2x its consensus's length, at Q = 1024
    Q = 1024
    fr2 = np.full((cw.shape[0], Q), -1, np.int32)
    wt2 = np.zeros((cw.shape[0], Q), np.int32)
    q2 = np.minimum(2 * ql, Q).astype(np.int32)
    for b in range(cw.shape[0]):
        f = np.concatenate([fr[b, : ql[b]], fr[b, : ql[b]]])[:Q]
        fr2[b, : f.size] = f
        wt2[b, : f.size] = np.concatenate([wt[b, : ql[b]], wt[b, : ql[b]]])[:Q]
    cases.append(("twice the consensus, Q = 1024", (cw, tl, fr2, q2, wt2)))
    # all-A consensus against all-C fragments of 1024 bases: every cell a
    # mismatch, the DP at its floor
    n = 256
    cwm = np.where(np.arange(cw.shape[1])[None, :] < tl[:n, None], 0, -1).astype(np.int32)
    cases.append(("all mismatches, Q = 1024", (
        cwm, tl[:n], np.ones((n, Q), np.int32), np.full(n, Q, np.int32),
        np.full((n, Q), 7, np.int32))))
    # consensus of 0 or 1 bases against 50 mismatching ones: q * GAP is the
    # best end value (or there is none), so each walk starts at row 0
    t0 = (np.arange(n) % 2).astype(np.int32)
    f0 = np.full((n, 768), -1, np.int32)
    f0[:, :50] = 1
    w0 = np.where(f0 >= 0, 9, 0).astype(np.int32)
    cases.append(("walks from row 0", (cwm[:, :640] * 0, t0, f0,
                                       np.full(n, 50, np.int32), w0)))
    return cases


def phase_votes(device):
    """K2 vs votes_primitives_plain on the window bank's first chunk and on
    the edge cases; returns the kernels entry fields for the main-path
    shape [2048, 640, 768]."""
    import torch

    from raven_tpu_torch.ops import consensus_cuda as cc

    (cw, tl, fr, ql, wt), total = consensus_chunk()
    log(f"window bank: 512 windows, {total} fragment rows; first chunk "
        f"{cw.shape[0]} rows, fragments {int(ql.min())}-{int(ql.max())} bases, "
        f"consensus {int(tl.min())}-{int(tl.max())} bases")
    cases = [
        (name, tuple(
            np.ascontiguousarray(a) for a in (
                cw[:B, :T], np.minimum(tl[:B], T), fr[:B, :Q],
                np.minimum(ql[:B], Q), wt[:B, :Q],
            )
        ))
        for name, B, T, Q in (
            ("chunk", 2048, 640, 768),
            ("ragged", 1237, 640, 768),
            ("narrow", 2048, 256, 256),
        )
    ] + votes_edge_cases(cw, tl, fr, ql, wt)
    main = None
    for name, arrays in cases:
        args = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
        )
        B, T = args[0].shape
        Q = args[2].shape[1]
        got = cc._kernel(*args)
        want = cc.votes_primitives_plain(*args)
        torch.cuda.synchronize()
        eq = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(
            int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(got, want)
        )
        require(eq, f"K2 differs from votes_primitives_plain at {name} "
                f"[{B}, {T}, {Q}] (max abs err {err})")
        ms = cuda_ms(lambda: cc._kernel(*args))
        plain_ms = cuda_ms(lambda: cc.votes_primitives_plain(*args), runs=3, warmup=1)
        bound, by, parts = votes_bound(args[1], args[3], T, Q)
        log(
            f"K2 {name} [B, T, Q] = [{B}, {T}, {Q}]: bit-equal, max_abs_err "
            f"{err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({bound / ms:.3f} of it reached)"
        )
        log(
            f"  bound parts: {parts['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
            f"{parts['bytes_ms']:.4f} ms; {parts['cells']} DP cells needed x "
            f"{K2_INSTR_PER_CELL} = {parts['int_ops']} integer instructions at "
            f"{INT_INSTR_PER_S:.4g}/s = {parts['ops_ms']:.4f} ms; the kernel "
            f"computes {parts['computed_cells']} cells (padded rectangle "
            f"{parts['padded_cells']})"
        )
        if name == "chunk":
            dev = device_ms(lambda: cc._kernel(*args), "votes_primitives_kernel")
            log(f"  device time (torch.profiler): {fmt_ms(dev)}")
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev,
                    "bound_ms": bound, "bound_by": by, "shape": [B, T, Q],
                    "padded_bound_ms": parts["padded_cells"] * K2_INSTR_PER_CELL
                    / INT_INSTR_PER_S * 1e3,
                    "cells": parts["cells"],
                    "computed_cells": parts["computed_cells"]}
    return main


def band_mutate(rng, codes, sub, dele, ins):
    """tests/test_consensus_band.py's mutate: deletions, substitutions,
    then insertions (a base doubled)."""
    keep = rng.random(codes.size) >= dele
    seg = codes[keep]
    subs = rng.random(seg.size) < sub
    seg = np.where(subs, (seg + rng.integers(1, 4, seg.size)) % 4, seg).astype(np.uint8)
    insm = rng.random(seg.size) < ins
    return np.repeat(seg, 1 + insm.astype(np.int64))


def band_layout(grp, BW: int, q_pad: int = 768, T: int = BAND_T):
    """A group of windows ((backbone, fragments, weights[, spans]) each) as
    band_window_consensus lays it out at t_pad T and a band of BW (its
    _prepare_group, then band_pack's plain version): numpy (cw, t_lens,
    fw_sh, q_lens, r0)."""
    from raven_tpu_torch.ops import consensus_band as cb

    grp = [(w[0], w[1], w[2], w[3] if len(w) > 3 else None) for w in grp]
    (cons0, lens0, fw_sh, q_lens, r0, win), _ = cb.host_layout(grp, T, q_pad, BW)
    return cons0[win], lens0[win], fw_sh, q_lens, r0


def band_spanned_windows(n: int = 128):
    """n windows of 500 bases x 30 fragments, 40% of them partial (read
    ends) placed at r0 > 0, as in tests/test_consensus_band.py's production
    case, with weights up to 255."""
    rng = np.random.default_rng(5)
    spanned = []
    for _ in range(n):
        truth = rng.integers(0, 4, 500).astype(np.uint8)
        frags, spans = [], []
        for _ in range(30):
            s, e = 0, 500
            if rng.random() < 0.4:
                s = int(rng.integers(0, 300))
                e = int(rng.integers(s + 150, 501))
            frags.append(band_mutate(rng, truth[s:e], 0.04, 0.05, 0.05))
            spans.append((s, e))
        wts = [rng.integers(1, 256, f.size).astype(np.uint8) for f in frags]
        spanned.append((band_mutate(rng, truth, 0.04, 0.05, 0.05), frags, wts, spans))
    return spanned


def band_rows_host(grp, q_pad: int, B_pad: int, BW: int = BAND_BW, T: int = BAND_T):
    """A group's fragment rows as the host packed them before band_pack:
    pack_shifted_fragments over its fragments one by one (the layout's
    specification): numpy fw_sh [B_pad, T + BW + 1], q_lens [B_pad]."""
    from raven_tpu_torch.ops import consensus_band as cb

    frags = [np.asarray(f, np.uint8) for w in grp for f in w[1]]
    wts = [np.asarray(w[2][i], np.uint8) if w[2] is not None else np.ones(len(f), np.uint8)
           for w in grp for i, f in enumerate(w[1])]
    r0 = np.clip([int(w[3][i][0]) if len(w) > 3 and w[3] is not None else 0
                  for w in grp for i in range(len(w[1]))], 0, T - 1)
    fw_sh = np.zeros((B_pad, T + BW + 1), np.uint8)
    q_lens = np.zeros(B_pad, np.int32)
    fw_sh[: len(frags)], q_lens[: len(frags)] = cb.pack_shifted_fragments(
        frags, wts, r0, q_pad, T, BW)
    return fw_sh, q_lens


def band_cases():
    """[name, (cw, t_lens, fw_sh, q_lens, r0)] numpy cases for K3 and K4 at
    T = 640, BW = 256, laid out as band_window_consensus lays out a group
    (its _prepare_group): the bank's first 128 windows (3,840 fragment rows
    padded to 4,096), and the cases the kernels could break on."""
    from raven_tpu_torch.ops import consensus_band as cb
    from raven_tpu_torch.utils.synth import make_windows

    T, BW = BAND_T, BAND_BW
    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))

    def layout(grp, q_pad=768):
        return band_layout(grp, BW, q_pad)

    bank = layout(windows[:128])
    cases = [("bank group", bank), ("ragged B", tuple(a[:1237] for a in bank))]
    cases.append(("spans, weights over the cap", layout(band_spanned_windows())))
    # every other fragment twice over: q_len ~1,000 > T + BW/2 - r0 = 768
    doubled = [
        (bb, [np.concatenate([f, f]) if i % 2 else f for i, f in enumerate(fr)],
         [np.concatenate([w, w]) if i % 2 else w for i, w in enumerate(wt)])
        for bb, fr, wt in windows[128:256]
    ]
    cases.append(("fragments past the band", layout(doubled, q_pad=1536)))
    # runs of 20-60 bases the consensus lacks, 1-3 a fragment: their left
    # moves cross K3's 16-lane strips on one band row
    cases.append(("insertion runs across strips", layout(insertion_runs(windows[256:384]))))
    # all-A consensus rows of 0, 1 or 640 bases against 50 C's: 50 * GAP is
    # the best end score or ties it, so every walk starts at row 0
    n = 1024
    tl = np.resize(np.array([0, 1, T, T], np.int32), n)
    cw = np.where(np.arange(T)[None, :] < tl[:, None], 0, -1).astype(np.int32)
    fw_sh, ql = cb.pack_shifted_fragments(
        [np.ones(50, np.uint8)] * n, [np.full(50, 9, np.uint8)] * n,
        np.zeros(n, np.int32), 768, T, BW,
    )
    cases.append(("walks from row 0", (cw, tl, fw_sh, ql, np.zeros(n, np.int32))))
    return cases


def phase_band(device):
    """K3 and K4 vs their plain versions on the band cases, bit for bit;
    returns the kernels entry fields for the main-path shape [4096, 640,
    256]."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc

    T, BW = BAND_T, BAND_BW
    k3 = k4 = None
    for name, arrays in band_cases():
        cw, tl, fw, ql, r0 = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
        )
        B = cw.shape[0]
        got = bc.band_forward(cw, tl, fw, ql, r0, T, BW)
        want = bc.band_forward_plain(cw, tl, fw, ql, r0, T, BW)
        torch.cuda.synchronize()
        err3 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K3 differs from band_forward_plain at {name} [{B}, {T}, {BW}] "
                f"(max abs err {err3})")
        gv = bc.mask_walk_votes(*want, fw, ql, r0, T, BW)
        wv = bc.mask_walk_votes_plain(*want, fw, ql, r0, T, BW)
        torch.cuda.synchronize()
        err4 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(gv, wv))
        require(all(torch.equal(a, b) for a, b in zip(gv, wv)),
                f"K4 differs from mask_walk_votes_plain at {name} [{B}, {T}, {BW}] "
                f"(max abs err {err4})")
        # walks that start at row 0: the row-0 score wins and the lane of
        # column qlen lies in the band there
        t0_zero = int(((want[2] >= want[1].max(dim=0).values) & (ql > 0)
                       & (ql + BW // 2 + r0 < BW)).sum())
        reach = int((ql > T + BW // 2 - r0).sum())
        ms3 = cuda_ms(lambda: bc.band_forward(cw, tl, fw, ql, r0, T, BW))
        ms4 = cuda_ms(lambda: bc.mask_walk_votes(*want, fw, ql, r0, T, BW))
        b3, by3, p3 = band_forward_bound(B, T, BW)
        b4, by4, p4 = band_walk_bound(wv[0], B, T, BW)
        log(
            f"K3/K4 {name} [B, T, BW] = [{B}, {T}, {BW}]: bit-equal (max_abs_err "
            f"{err3}, {err4}); {int((ql == 0).sum())} rows with qlen 0, {reach} "
            f"past the band, {t0_zero} walks from row 0, {p4['voted_rows']} voted "
            f"rows, {int((wv[1] != 0).sum())} insertion votes"
        )
        log(
            f"  K3 {ms3:.4f} ms, bound {b3:.4f} ms by {by3} ({b3 / ms3:.3f} of it "
            f"reached); K4 {ms4:.4f} ms, bound {b4:.4f} ms by {by4} "
            f"({b4 / ms4:.3f} of it reached)"
        )
        if name == "bank group":
            plain3 = cuda_ms(lambda: bc.band_forward_plain(cw, tl, fw, ql, r0, T, BW),
                             runs=3, warmup=1)
            plain4 = cuda_ms(lambda: bc.mask_walk_votes_plain(*want, fw, ql, r0, T, BW),
                             runs=3, warmup=1)
            log(f"  plain versions: K3 {plain3:.4f} ms, K4 {plain4:.4f} ms")
            log(
                f"  K3 bound parts: {p3['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
                f"{p3['bytes_ms']:.4f} ms; {p3['cells']} band cells x "
                f"{K3_INSTR_PER_CELL} = {p3['int_ops']} integer instructions at "
                f"{INT_INSTR_PER_S:.4g}/s = {p3['ops_ms']:.4f} ms"
            )
            log(
                f"  K4 bound parts: {p4['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
                f"{p4['bytes_ms']:.4f} ms; {p4['voted_rows']} voted rows x "
                f"{K4_INSTR_PER_ROW} = {p4['int_ops']} integer instructions at "
                f"{INT_INSTR_PER_S:.4g}/s = {p4['ops_ms']:.4f} ms"
            )
            walk = int((wv[0] != 0).sum(dim=1).max()) + 1
            floor4 = walk * K4_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
            log(
                f"  K4 serial floor (information): the longest walk, {walk} rows, x "
                f"{K4_CHAIN_CYCLES} dependent cycles a row at {SM_CLOCK_HZ:.3g} Hz = "
                f"{floor4:.4f} ms; at T = {T} rows "
                f"{T * K4_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3:.4f} ms"
            )
            log_band_sass()
            dev3 = device_ms(lambda: bc.band_forward(cw, tl, fw, ql, r0, T, BW),
                             "band_forward_kernel")
            dev4 = device_ms(lambda: bc.mask_walk_votes(*want, fw, ql, r0, T, BW),
                             "band_walk_kernel")
            log(f"  device time (torch.profiler): K3 {fmt_ms(dev3)}, K4 {fmt_ms(dev4)}")
            k3 = {"max_abs_err": err3, "ms": ms3, "plain_ms": plain3, "device_ms": dev3,
                  "bound_ms": b3, "bound_by": by3, "shape": [B, T, BW]}
            k4 = {"max_abs_err": err4, "ms": ms4, "plain_ms": plain4, "device_ms": dev4,
                  "bound_ms": b4, "bound_by": by4, "shape": [B, T, BW]}
    return k3, k4


def phase_band_pack(device):
    """band_pack on the card against pack_shifted_fragments on the host,
    byte for byte: the window bank's four groups of 128 windows (30
    fragments each, 4,096 rows), a group with spans and weights over the
    cap, and a group of 128 windows x 52 fragments without weights (the
    polish cell's depth, 8,192 rows), each uploaded as band_window_consensus
    uploads it; then at the 8,192 rows one call (CUDA events, the wrapper's
    host work within), the kernel's device time beside its bound by bytes,
    its plain version's time on the card, and the host prep before and
    after (the host clock).  Returns the kernels entry fields."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.ops import consensus_band as cb
    from raven_tpu_torch.utils.synth import make_windows

    T, BW, Q = BAND_T, BAND_BW, 768
    bank, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    deep, _ = make_windows(128, 500, 52, np.random.default_rng(22))
    groups = [(f"bank group {i}", bank[128 * i: 128 * (i + 1)]) for i in range(4)]
    # the deep group without weights, as a FASTA run's groups and the polish cell's
    groups += [("spans, weights over the cap", band_spanned_windows()),
               ("52 fragments a window, no weights", [(w[0], w[1], None) for w in deep])]
    before = bc.LAUNCHES["band_pack"]
    for name, grp in groups:
        grp = [(w[0], w[1], w[2], w[3] if len(w) > 3 else None) for w in grp]
        stage, v, _ = cb._prepare_group(grp, T, Q, BW, pinned=True)
        d = cb._upload(stage, v, torch.device(device))
        args = (d["bases"], d["wts"], d["src"], d["q_lens"], d["r0"], T, BW)
        got = bc.band_pack(*args)
        torch.cuda.synchronize()
        B = got.shape[0]
        want, ql = band_rows_host(grp, Q, B)
        diff = int((got.cpu().numpy() != want).sum())
        require(diff == 0 and np.array_equal(v["q_lens"], ql),
                f"band_pack differs from pack_shifted_fragments at {name} [{B}, {T}, {BW}] "
                f"({diff} bytes)")
        n = np.minimum(ql, np.maximum(T + BW + 1 - (v["r0"] + BW // 2 + 1), 0))
        log(f"band_pack {name} [B, T, BW] = [{B}, {T}, {BW}]: byte-equal to "
            f"pack_shifted_fragments; {int(n.sum())} fragment bytes, weights "
            f"{'uploaded' if d['wts'] is not None else 'none (1)'}, {stage.nbytes} B staged")
    launched = bc.LAUNCHES["band_pack"] - before
    require(launched == len(groups), f"band_pack launched {launched} times, not {len(groups)}")
    # the main path's shape: the deep group, as the polish cell's groups
    ms = cuda_ms(lambda: bc.band_pack(*args))
    dev = device_ms(lambda: bc.band_pack(*args), "band_pack_kernel")
    plain = cuda_ms(lambda: bc.band_pack_plain(*args), runs=5, warmup=1)
    nbytes = B * (T + BW + 1) + int(n.sum()) + 16 * B
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        cb._prepare_group(grp, T, Q, BW, pinned=True)
    prep = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    band_rows_host(grp, Q, B)
    host = (time.perf_counter() - t0) * 1e3
    log(f"  band_pack one call {ms:.4f} ms, device {fmt_ms(dev)}, its plain version on the "
        f"card {plain:.4f} ms; bound {bound:.4f} ms by "
        f"bytes ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s; "
        f"{bound / dev if dev else 0:.3f} of it reached on the device)")
    log(f"  host prep of the group: _prepare_group {prep:.2f} ms; the previous host "
        f"layout (pack_shifted_fragments row by row) {host:.2f} ms")
    return {"equal": True, "ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "shape": [B, T, BW], "prep_ms": prep,
            "previous_host_ms": host, "launches": launched}


def banded_layout(windows, n_rows: int, t_pad: int = BANDED_T, q_pad: int = BANDED_Q):
    """The first `n_rows` fragment rows of `windows` ((backbone, fragments,
    weights[, spans]) each) as device_window_consensus(banded=True) lays out
    its first iteration, through its own helpers: the window backbone (the
    working consensus) padded to t_pad, the fragment and its weights to
    q_pad, its anchors rescaled to the consensus length.  Returns numpy (cw,
    tlens, frags, qlens, r0, r1, wts)."""
    from raven_tpu_torch.ops import consensus_device as cd

    fr, wt, ql, win, s0, s1, n = cd.flatten_fragments(windows, q_pad, n_rows)
    cons_arr, cons_lens = cd.pad_consensus(
        [np.asarray(w[0], np.uint8) for w in windows], t_pad, len(windows)
    )
    r0, r1 = cd.rescale_anchors(s0, s1, win, n, cons_lens, [len(w[0]) for w in windows])
    rows = slice(0, min(n, n_rows))
    return (cons_arr[win[rows]], cons_lens[win[rows]], fr[rows], ql[rows], r0[rows],
            r1[rows], wt[rows])


def banded_cases():
    """[name, (cw, tlens, frags, qlens, r0, r1, wts)] numpy cases for K9
    and K10 at T = 640, BW = 256: the window bank's first chunk as the
    anchored banded consensus lays it out ([B, T, Q] = [2048, 640, 768],
    full spans), and the cases the kernels could break on."""
    from raven_tpu_torch.utils.synth import make_windows

    T, Q = BANDED_T, BANDED_Q
    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    chunk = banded_layout(windows, 2048)
    cases = [("bank chunk", chunk), ("ragged B", tuple(a[:1237] for a in chunk))]
    # partial fragments (read ends) placed at r0 > 0, weights up to 255
    rng = np.random.default_rng(5)
    spanned = []
    for _ in range(70):
        truth = rng.integers(0, 4, 500).astype(np.uint8)
        frags, spans = [], []
        for _ in range(30):
            s0, s1 = 0, 500
            if rng.random() < 0.4:
                s0 = int(rng.integers(0, 300))
                s1 = int(rng.integers(s0 + 150, 501))
            frags.append(band_mutate(rng, truth[s0:s1], 0.04, 0.05, 0.05))
            spans.append((s0, s1))
        wts = [rng.integers(1, 256, f.size).astype(np.uint8) for f in frags]
        spanned.append((band_mutate(rng, truth, 0.04, 0.05, 0.05), frags, wts, spans))
    cases.append(("partial spans", banded_layout(spanned, 2048)))
    # each fragment anchored on one row: its band start leaps by BW or more
    cw, tl, fr, ql, r0, r1, wt = (a.copy() for a in chunk)
    r0 = (rng.random(r0.size) * tl).astype(np.int32)
    cases.append(("one-row spans", (cw, tl, fr, ql, r0, r0 + 1, wt)))
    # every other fragment anchored on a span of 2-250 rows: its band start
    # steps by ~3 to over 255 a row, beside a full-span fragment in its warp
    steep = rng.random(r0.size) < 0.5
    r0s = np.where(steep, (rng.random(r0.size) * tl * 0.7).astype(np.int32), chunk[4])
    r1s = np.where(steep, r0s + rng.integers(2, 251, r0.size), chunk[5]).astype(np.int32)
    cases.append(("steep spans", (cw, tl, fr, ql, r0s, r1s, wt)))
    # each fragment twice over: slope 2, at Q = 1024
    Q2 = 1024
    fr2 = np.full((fr.shape[0], Q2), -1, np.int32)
    wt2 = np.zeros((fr.shape[0], Q2), np.int32)
    for b in range(fr.shape[0]):
        f = np.concatenate([fr[b, : ql[b]], fr[b, : ql[b]]])[:Q2]
        fr2[b, : f.size] = f
        wt2[b, : f.size] = np.concatenate([wt[b, : ql[b]], wt[b, : ql[b]]])[:Q2]
    cases.append(("slope 2, Q = 1024", (cw, tl, fr2, np.minimum(2 * ql, Q2).astype(np.int32),
                                         chunk[4], chunk[5], wt2)))
    # qlen 0 rows, at an odd B
    q0 = chunk[3][:1237].copy()
    q0[::7] = 0
    f0 = chunk[2][:1237].copy()
    f0[::7] = -1
    cases.append(("qlen 0 rows", (chunk[0][:1237], chunk[1][:1237], f0, q0, chunk[4][:1237],
                                  chunk[5][:1237], chunk[6][:1237])))
    # all-A consensus against all-C fragments: every cell a mismatch, the DP
    # on NEG-derived values past the fragment
    n = 256
    cwm = np.where(np.arange(T)[None, :] < tl[:n, None], 0, -1).astype(np.int32)
    cases.append(("all mismatches", (cwm, tl[:n], np.ones((n, Q), np.int32),
                                     np.full(n, Q, np.int32), np.zeros(n, np.int32),
                                     np.maximum(tl[:n], 1), np.full((n, Q), 7, np.int32))))
    # consensus of 0 or 1 bases against 50 or 300 mismatching ones: each
    # walk starts at row 0; the 300-base ones start past row 1's band's
    # left end at column 0 and stall on the top row
    t0 = (np.arange(n) % 2).astype(np.int32)
    q_r0 = np.where(np.arange(n) % 4 < 2, 50, 300).astype(np.int32)
    f_r0 = np.where(np.arange(Q)[None, :] < q_r0[:, None], 1, -1).astype(np.int32)
    cases.append(("walks from row 0", (cwm * 0, t0, f_r0, q_r0, np.zeros(n, np.int32),
                                       np.maximum(t0, 1),
                                       np.where(f_r0 >= 0, 9, 0).astype(np.int32))))
    return cases


def phase_mesh_votes(device):
    """The window consensus of both engines with its votes on a virtual
    mesh of 4 shards on one card against the single-device call, bit for
    bit, on bench_polish.py's window bank (512 windows x 30 fragments):
    device_window_consensus full-NW and banded (chunks of 2,048 rows, the
    bank's 15,360 rows padded to 8 chunks, 2 a shard), and
    band_window_consensus (4 groups of 128 windows, 4,096 rows each, 1,024
    a shard); 4 iterations each, as the polisher runs them.  Each mesh
    call's launches are counted over that call alone.  With 2 or more
    cards, once more on make_mesh()."""
    import torch

    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda
    from raven_tpu_torch.ops.consensus_band import band_window_consensus
    from raven_tpu_torch.ops.consensus_device import device_window_consensus
    from raven_tpu_torch.parallel.mesh import Mesh, make_mesh
    from raven_tpu_torch.utils.synth import make_windows

    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    mesh = Mesh([device] * 4)
    meshes = [mesh] + ([make_mesh()] if torch.cuda.device_count() > 1 else [])
    engines = (
        ("full-NW", lambda **k: device_window_consensus(windows, iterations=4, chunk=2048, **k),
         lambda: {"K2": consensus_cuda.LAUNCHES}),
        ("banded", lambda **k: device_window_consensus(windows, iterations=4, chunk=2048,
                                                       banded=True, **k),
         lambda: {"K9": banded_cuda.LAUNCHES["nw_moves_banded"],
                  "K10": banded_cuda.LAUNCHES["traceback_banded"]}),
        ("shift-banded", lambda **k: band_window_consensus(windows, iterations=4, **k),
         lambda: {"K3": band_cuda.LAUNCHES["band_forward"],
                  "K4": band_cuda.LAUNCHES["mask_walk_votes"]}),
    )
    out = {}
    for name, call, count in engines:
        call(device=device)  # warm: the first call of an engine loads its kernels
        t0 = time.perf_counter()
        want = call(device=device)
        single = time.perf_counter() - t0
        walls = []
        for m in meshes:
            zero_counts()
            t0 = time.perf_counter()
            got = call(mesh=m)
            walls.append(time.perf_counter() - t0)
            launches = count()
            require(len(got) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(got, want)
            ), f"the {name} consensus on {m} differs from one device's")
            require(min(launches.values()) > 0,
                    f"the {name} consensus on {m} launched a kernel no time: {launches}")
            if m is mesh:
                out[name] = {"single_s": single, "mesh_s": walls[0], "launches": launches}
            log(f"{name} window consensus on {m}: {walls[-1]:.3f} s against one "
                f"device's {single:.3f} s, {launches} kernel launches, bit-equal")
        if len(walls) > 1:
            out[name]["cards_s"] = walls[1]
    log("(a virtual mesh's wall is the per-shard launches and the sums on one card, "
        "not what 4 cards would give)")
    return out


def first_diffs(got, want, names) -> str:
    """Where each pair of equal-shaped tensors differs: its count of
    differing entries and the first index."""
    import torch

    parts = []
    for name, a, b in zip(names, got, want):
        bad = (a != b).nonzero()
        if bad.numel():
            parts.append(f"{name}: {bad.shape[0]} entries, first at {bad[0].tolist()} "
                         f"({int(a[tuple(bad[0])])} vs {int(b[tuple(bad[0])])})")
    return "; ".join(parts)


def phase_banded(device, k2_ms):
    """K9 and K10 vs their plain versions on the banded cases, bit for bit on
    every output, with how the walks ended; K10 also on the partial-span
    case's forward with band starts raised at random under the moves, which
    sends walks out of the band.  Returns the kernels entry fields for the
    main-path shape [2048, 640, 256] (Q = 768)."""
    import torch

    from raven_tpu_torch.ops import banded_cuda as bc

    T, BW = BANDED_T, BANDED_BW
    k9 = k10 = None
    rng = np.random.default_rng(13)
    cases = banded_cases()
    # the partial-span case again, its band starts raised under K9's moves
    cases.append(("off the band", dict(cases)["partial spans"]))
    for name, arrays in cases:
        cw, tl, fr, ql, r0, r1, wt = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
        )
        B, Q = fr.shape
        got = bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW)
        want = bc.nw_moves_banded_plain(cw, tl, fr, ql, r0, r1, T, Q, BW)
        torch.cuda.synchronize()
        err9 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K9 differs from nw_moves_banded_plain at {name} [{B}, {T}, {Q}] "
                f"(max abs err {err9}; " + first_diffs(
                    got, want, ("moves", "offs", "end_scores", "row0")) + ")")
        fwd = list(want)
        if name == "off the band":
            raise_by = rng.integers(0, 40, fwd[1].shape) * (rng.random(fwd[1].shape) < 0.2)
            fwd[1] = (fwd[1] + torch.from_numpy(raise_by).to(device)).to(torch.int32)
        gw = bc.traceback_banded(*fwd, ql, fr, wt, T, Q, BW)
        ww, kinds, steps = bc.traceback_banded_plain(*fwd, ql, fr, wt, T, Q, BW,
                                                     return_walks=True)
        torch.cuda.synchronize()
        err10 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    for a, b in zip(gw, ww))
        require(all(torch.equal(a, b) for a, b in zip(gw, ww)),
                f"K10 differs from traceback_banded_plain at {name} [{B}, {T}, {Q}] "
                f"(max abs err {err10}; " + first_diffs(
                    gw, ww, ("col_sym", "col_w", "ins_b", "ins_w")) + ")")
        ends = {k: int((kinds == i).sum()) for i, k in enumerate(
            ("at column 0", "stalled on the top row", "stopped at the band's edge",
             "on a row past the consensus"))}
        rise = want[1][1:].to(torch.int64) - want[1][:-1]  # band-start steps
        leaps = int((rise >= BW).any(dim=0).sum())
        steep = int(((rise >= 3) & (rise < BW)).any(dim=0).sum())
        ms9 = cuda_ms(lambda: bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW))
        ms10 = cuda_ms(lambda: bc.traceback_banded(*fwd, ql, fr, wt, T, Q, BW))
        b9, by9, p9 = banded_forward_bound(tl, ql, B, T, Q, BW)
        b10, by10, p10 = banded_walk_bound(steps, ww[0], ww[2], B, T)
        log(
            f"K9/K10 {name} [B, T, Q, BW] = [{B}, {T}, {Q}, {BW}]: bit-equal (max_abs_err "
            f"{err9}, {err10}); {int((ql == 0).sum())} rows with qlen 0, {leaps} fragments "
            f"whose band start leaps by BW or more, {steep} whose band start steps by "
            f"3 to BW - 1; walks: " + ", ".join(
                f"{v} {k}" for k, v in ends.items()) + f"; {p10['moves']} moves, "
            f"{p10['votes']} votes"
        )
        log(
            f"  K9 {ms9:.4f} ms, bound {b9:.4f} ms by {by9} ({b9 / ms9:.3f} of it "
            f"reached); K10 {ms10:.4f} ms, bound {b10:.4f} ms by {by10} "
            f"({b10 / ms10:.3f} of it reached)"
        )
        if name == "walks from row 0":
            require(ends["stalled on the top row"] > 0,
                    "no walk of the row-0 case stalled on the top row")
        if name == "off the band":
            require(ends["stopped at the band's edge"] > 0,
                    "no walk of the raised-band case stopped at the band's edge")
        if name == "one-row spans":
            require(leaps > 0, "no band start of the one-row case leapt by BW")
        if name == "steep spans":
            require(steep > 0, "no band start of the steep case stepped by 3 to BW - 1")
        if name == "bank chunk":
            plain9 = cuda_ms(lambda: bc.nw_moves_banded_plain(cw, tl, fr, ql, r0, r1, T, Q, BW),
                             runs=3, warmup=1)
            plain10 = cuda_ms(lambda: bc.traceback_banded_plain(*fwd, ql, fr, wt, T, Q, BW),
                              runs=3, warmup=1)
            log(f"  plain versions: K9 {plain9:.4f} ms, K10 {plain10:.4f} ms; K2 at the "
                f"same chunk (phase 6, Q = 768, full NW) {k2_ms:.4f} ms against K9 + K10 "
                f"{ms9 + ms10:.4f} ms")
            log(
                f"  K9 bound parts: {p9['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
                f"{p9['bytes_ms']:.4f} ms; {p9['cells']} band cells x "
                f"{K9_INSTR_PER_CELL} = {p9['int_ops']} integer instructions at "
                f"{INT_INSTR_PER_S:.4g}/s = {p9['ops_ms']:.4f} ms (information: at "
                f"{K9_INT32_INSTR_PER_CELL} scalar int32 instructions a cell, "
                f"{p9['cells'] * K9_INT32_INSTR_PER_CELL / INT_INSTR_PER_S * 1e3:.4f} ms)"
            )
            log(
                f"  K10 bound parts: {p10['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
                f"{p10['bytes_ms']:.4f} ms; {p10['moves']} moves x {K10_INSTR_PER_STEP} = "
                f"{p10['int_ops']} integer instructions at {INT_INSTR_PER_S:.4g}/s = "
                f"{p10['ops_ms']:.4f} ms"
            )
            walk = int(steps.max())
            log(
                f"  K10 serial floor (information): the longest walk, {walk} moves, x "
                f"{K10_CHAIN_CYCLES} dependent cycles a move at {SM_CLOCK_HZ:.3g} Hz = "
                f"{walk * K10_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3:.4f} ms"
            )
            log_banded_sass()
            dev9 = device_ms(lambda: bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW),
                             "nw_moves_banded_kernel")
            dev10 = device_ms(lambda: bc.traceback_banded(*fwd, ql, fr, wt, T, Q, BW),
                              "traceback_banded_kernel")
            log(f"  device time (torch.profiler): K9 {fmt_ms(dev9)}, K10 {fmt_ms(dev10)}")
            k9 = {"max_abs_err": err9, "ms": ms9, "plain_ms": plain9, "device_ms": dev9,
                  "bound_ms": b9, "bound_by": by9, "shape": [B, T, Q, BW], "k2_ms": k2_ms}
            k10 = {"max_abs_err": err10, "ms": ms10, "plain_ms": plain10, "device_ms": dev10,
                   "bound_ms": b10, "bound_by": by10, "shape": [B, T, Q, BW]}
    return k9, k10


def insertion_runs(windows):
    """The windows with 1-3 runs of 20-60 bases their consensus lacks put
    into each fragment (weight 30): left moves across K3's 16-lane strips."""
    rng = np.random.default_rng(9)
    runs = []
    for bb, fr, wt in windows:
        frs, wts = [], []
        for f, w in zip(fr, wt):
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(1, f.size))
                n_ins = int(rng.integers(20, 61))
                f = np.concatenate([f[:at], rng.integers(0, 4, n_ins).astype(np.uint8), f[at:]])
                w = np.concatenate([w[:at], np.full(n_ins, 30, np.uint8), w[at:]])
            frs.append(f)
            wts.append(w)
        runs.append((bb, frs, wts))
    return runs


def check_band(device, arrays, BW: int, name: str, timed: bool):
    """K3 and K4 against their plain versions at a band of BW on `arrays`
    (cw [B, T], t_lens, fw_sh, q_lens, r0), bit for bit; with `timed`,
    their times and bounds.  Returns the case's fields for the kernels
    line."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc

    cw, tl, fw, ql, r0 = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
    B, T = cw.shape
    got = bc.band_forward(cw, tl, fw, ql, r0, T, BW)
    want = bc.band_forward_plain(cw, tl, fw, ql, r0, T, BW)
    gv = bc.mask_walk_votes(*want, fw, ql, r0, T, BW)
    wv = bc.mask_walk_votes_plain(*want, fw, ql, r0, T, BW)
    torch.cuda.synchronize()
    err3 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
    err4 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(gv, wv))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"K3 differs from band_forward_plain at {name} [{B}, {T}, {BW}] (max abs err {err3})")
    require(all(torch.equal(a, b) for a, b in zip(gv, wv)),
            f"K4 differs from mask_walk_votes_plain at {name} [{B}, {T}, {BW}] "
            f"(max abs err {err4})")
    out = {"case": name, "shape": [B, T, BW], "max_abs_err": max(err3, err4)}
    if not timed:
        return out
    ms3 = cuda_ms(lambda: bc.band_forward(cw, tl, fw, ql, r0, T, BW))
    ms4 = cuda_ms(lambda: bc.mask_walk_votes(*want, fw, ql, r0, T, BW))
    dev3 = device_ms(lambda: bc.band_forward(cw, tl, fw, ql, r0, T, BW), "band_forward_kernel")
    dev4 = device_ms(lambda: bc.mask_walk_votes(*want, fw, ql, r0, T, BW), "band_walk_kernel")
    b3, by3, _ = band_forward_bound(B, T, BW)
    b4, by4, p4 = band_walk_bound(wv[0], B, T, BW)
    log(f"K3/K4 {name} [B, T, BW] = [{B}, {T}, {BW}]: bit-equal; {p4['voted_rows']} voted "
        f"rows, {int((wv[1] != 0).sum())} insertion votes; K3 {ms3:.4f} ms (device "
        f"{fmt_ms(dev3)}), bound {b3:.4f} ms by {by3}; K4 {ms4:.4f} ms (device "
        f"{fmt_ms(dev4)}), bound {b4:.4f} ms by {by4}")
    out.update({"K3": {"ms": ms3, "device_ms": dev3, "bound_ms": b3, "bound_by": by3},
                "K4": {"ms": ms4, "device_ms": dev4, "bound_ms": b4, "bound_by": by4}})
    return out


def banded_width_cases(q_pad: int, n_rows: int = 2048):
    """[name, (cw, tlens, frags, qlens, r0, r1, wts)] numpy cases for K9 and
    K10 at T = 640 and q_pad (its band min(256, pow2(q_pad))): the bank's
    first chunk of `n_rows` rows cut to q_pad (with q_pad below the
    fragments' ~500 bases, every fragment longer than it, so the band's
    columns past Q read its last base), the same rows cut at random lengths
    up to q_pad (past the fragment, pad codes), steep spans of 2-250 rows
    beside full-span ones, and up to 256 all-mismatch rows."""
    from raven_tpu_torch.utils.synth import make_windows

    T = BANDED_T
    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    chunk = banded_layout(windows, n_rows, q_pad=q_pad)
    cw, tl, fr, ql, r0, r1, wt = (a.copy() for a in chunk)
    cases = [(f"bank chunk, q_pad {q_pad}", chunk)]
    rng = np.random.default_rng(q_pad)
    cut = rng.integers(0, q_pad + 1, ql.size).astype(np.int32)
    fr_c = np.where(np.arange(q_pad)[None, :] < cut[:, None], fr, -1).astype(np.int32)
    wt_c = np.where(fr_c >= 0, wt, 0).astype(np.int32)
    cases.append((f"cut fragments, q_pad {q_pad}", (cw, tl, fr_c, cut, r0, r1, wt_c)))
    steep = rng.random(r0.size) < 0.5
    r0s = np.where(steep, (rng.random(r0.size) * tl * 0.7).astype(np.int32), r0)
    r1s = np.where(steep, r0s + rng.integers(2, 251, r0.size), r1).astype(np.int32)
    cases.append((f"steep spans, q_pad {q_pad}", (cw, tl, fr_c, cut, r0s, r1s, wt_c)))
    n = min(256, n_rows)
    cwm = np.where(np.arange(T)[None, :] < tl[:n, None], 0, -1).astype(np.int32)
    cases.append((f"all mismatches, q_pad {q_pad}",
                  (cwm, tl[:n], np.ones((n, q_pad), np.int32), np.full(n, q_pad, np.int32),
                   np.zeros(n, np.int32), np.maximum(tl[:n], 1),
                   np.full((n, q_pad), 7, np.int32))))
    return cases


def check_banded(device, arrays, name: str, timed: bool):
    """K9 and K10 against their plain versions on `arrays` (cw, tlens,
    frags, qlens, r0, r1, wts) at q_pad = frags' width and its band, bit
    for bit on every output; with `timed`, their times and bounds.
    Returns the case's fields for the kernels line."""
    import torch

    from raven_tpu_torch.ops import banded_cuda as bc
    from raven_tpu_torch.ops.consensus_device import _pow2_of

    cw, tl, fr, ql, r0, r1, wt = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
    )
    B, Q = fr.shape
    T = cw.shape[1]
    BW = min(256, _pow2_of(Q))
    got = bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW)
    want = bc.nw_moves_banded_plain(cw, tl, fr, ql, r0, r1, T, Q, BW)
    gw = bc.traceback_banded(*want, ql, fr, wt, T, Q, BW)
    ww, kinds, steps = bc.traceback_banded_plain(*want, ql, fr, wt, T, Q, BW, return_walks=True)
    torch.cuda.synchronize()
    err9 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
    err10 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(gw, ww))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"K9 differs from nw_moves_banded_plain at {name} [{B}, {T}, {Q}, {BW}] (max abs "
            f"err {err9}; " + first_diffs(got, want, ("moves", "offs", "end_scores", "row0"))
            + ")")
    require(all(torch.equal(a, b) for a, b in zip(gw, ww)),
            f"K10 differs from traceback_banded_plain at {name} [{B}, {T}, {Q}, {BW}] (max abs "
            f"err {err10}; " + first_diffs(gw, ww, ("col_sym", "col_w", "ins_b", "ins_w"))
            + ")")
    out = {"case": name, "shape": [B, T, Q, BW], "max_abs_err": max(err9, err10)}
    ends = ", ".join(f"{int((kinds == i).sum())} {k}" for i, k in enumerate(
        ("at column 0", "stalled on the top row", "stopped at the band's edge",
         "on a row past the consensus")))
    if not timed:
        log(f"K9/K10 {name} [B, T, Q, BW] = [{B}, {T}, {Q}, {BW}]: bit-equal; walks: {ends}")
        return out
    ms9 = cuda_ms(lambda: bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW))
    ms10 = cuda_ms(lambda: bc.traceback_banded(*want, ql, fr, wt, T, Q, BW))
    dev9 = device_ms(lambda: bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW),
                     "nw_moves_banded_kernel")
    dev10 = device_ms(lambda: bc.traceback_banded(*want, ql, fr, wt, T, Q, BW),
                      "traceback_banded_kernel")
    b9, by9, _ = banded_forward_bound(tl, ql, B, T, Q, BW)
    b10, by10, _ = banded_walk_bound(steps, ww[0], ww[2], B, T)
    log(f"K9/K10 {name} [B, T, Q, BW] = [{B}, {T}, {Q}, {BW}]: bit-equal; walks: {ends}; "
        f"K9 {ms9:.4f} ms (device {fmt_ms(dev9)}), bound {b9:.4f} ms by {by9}; K10 "
        f"{ms10:.4f} ms (device {fmt_ms(dev10)}), bound {b10:.4f} ms by {by10}")
    out.update({"K9": {"ms": ms9, "device_ms": dev9, "bound_ms": b9, "bound_by": by9},
                "K10": {"ms": ms10, "device_ms": dev10, "bound_ms": b10, "bound_by": by10}})
    return out


def phase_widths(device) -> dict:
    """Phase 13(a): K3/K4 at every band width raven_tpu takes up to 512 (a
    multiple of 16), bit for bit, on 16 windows of 120 bases with 30
    fragments each at t_pad 160 (the plain versions loop over T rows), and
    timed at BAND_WIDTHS on the bank's first 128 windows (with insertion
    runs across the strips); K9/K10 at BANDED_Q_PADS (bands of 128 and
    256, some past the fragment) on the K2 rows cut to each, bit for bit,
    the bank chunk timed.  Returns {"band": [...], "banded": [...]} for
    the kernels line."""
    from raven_tpu_torch.utils.synth import make_windows

    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    short, _ = make_windows(16, 120, 30, np.random.default_rng(21))
    band = []
    for BW in BAND_SWEEP:
        check_band(device, band_layout(short, BW, q_pad=240, T=160), BW,
                   f"16 windows of 120 bases, BW {BW}", timed=False)
    log(f"K3/K4 at every BW in {BAND_SWEEP[0]}..{BAND_SWEEP[-1]} step 16 on 16 windows of "
        f"120 bases at T = 160: bit-equal")
    for BW in BAND_WIDTHS:
        band.append(check_band(device, band_layout(windows[:128], BW), BW,
                               f"bank group, BW {BW}", timed=True))
        band.append(check_band(device, band_layout(insertion_runs(windows[256:384]), BW), BW,
                               f"insertion runs across strips, BW {BW}", timed=False))
    banded = []
    for q_pad in BANDED_Q_PADS:
        for i, (name, arrays) in enumerate(banded_width_cases(q_pad)):
            banded.append(check_banded(device, arrays, name, timed=i == 0))
    return {"band": band, "banded": banded}


def phase_switches(device, work_dir, draft, pol) -> dict:
    """Phase 13(b): `-p 2 --device-poa-batches 8` on phase 4's reads with
    Polisher.CONSENSUS_ENGINE = "shiftband" and CONSENSUS_ITERS = 2 (the
    counterparts of raven_tpu's RAVEN_TPU_CONSENSUS_ENGINE=shiftband and
    RAVEN_TPU_CONSENSUS_ITERS=2): the shift-banded consensus on the card in
    both rounds, K3 and K4 launched in each, K2 in none; the polish gate;
    its wall beside phase 9's."""
    from raven_tpu_torch.ops import band_cuda, consensus_band
    from raven_tpu_torch.polish.polisher import Polisher

    per_call = []
    inner = consensus_band.band_window_consensus

    def counted(*args, **kwargs):
        before = dict(band_cuda.LAUNCHES)
        out = inner(*args, **kwargs)
        per_call.append({k: band_cuda.LAUNCHES[k] - before[k] for k in before})
        return out

    flags = ("-p", "2", "--device-poa-batches", "8", "-t", str(os.cpu_count()))
    consensus_band.band_window_consensus = counted
    Polisher.CONSENSUS_ENGINE, Polisher.CONSENSUS_ITERS = "shiftband", 2
    try:
        run = polish_run(device, work_dir, draft, flags)
    finally:
        consensus_band.band_window_consensus = inner
        Polisher.CONSENSUS_ENGINE, Polisher.CONSENSUS_ITERS = None, 4
    engines = [r["engine"] for r in run["polish_rounds"]]
    require(engines == ["device", "device"], f"polish engines {engines}")
    require(len(per_call) == 2 and all(
        c["band_forward"] > 0 and c["mask_walk_votes"] > 0 for c in per_call),
        f"K3/K4 launches by round {per_call}: not both rounds on the shift-banded engine")
    require(run["k2_launches"] == 0, f"the shift-banded route launched K2 {run['k2_launches']} "
            "times")
    log(f"  CONSENSUS_ENGINE shiftband, CONSENSUS_ITERS 2 with --device-poa-batches 8: "
        f"K3/K4 launches by round " + ", ".join(
            f"{c['band_forward']}/{c['mask_walk_votes']}" for c in per_call)
        + f", K2 {run['k2_launches']}; polish {run['polish_s']:.3f} s against phase 9's "
        f"{pol['polish_s']:.3f} s (full NW, 4 iterations)")
    run["per_round"] = per_call
    return run


def phase_budget() -> dict:
    """Phase 13(c): the index-batch budget for an index on the card
    (graph/construct.py::_index_batch_bytes) by default, for the host index
    (MinimizerIndex.DEVICE_MAP off) and under a budget set above the clamp
    (construct.INDEX_BATCH_BYTES): raven_tpu's 2,174,327,193, 2^32 and the
    budget set, as tests/test_misc.py::test_streaming_index_batch_clamp
    holds them."""
    import torch

    from raven_tpu_torch.graph import construct

    cuda = torch.device("cuda")
    out = {"default": construct._index_batch_bytes(cuda),
           "host_index": construct._index_batch_bytes(cuda, device_map=False)}
    saved = construct.INDEX_BATCH_BYTES
    construct.INDEX_BATCH_BYTES = 3 << 30
    try:
        out["explicit"] = construct._index_batch_bytes(cuda)
    finally:
        construct.INDEX_BATCH_BYTES = saved
    require(out == {"default": 2_174_327_193, "host_index": 1 << 32, "explicit": 3 << 30},
            f"index-batch budgets on the card {out}")
    log(f"index-batch budget on the card: default {out['default']}, host index "
        f"{out['host_index']}, explicit {out['explicit']} (raven_tpu's)")
    return out


# ------------------------------------------------- 13(d): past the old limits
# the shapes each kernel's first route refused before this slice: K2 past
# Q 1024, its 16-bit range (4Q + 3T + 8 > 49152) and a warp's shared memory
# ([B, T, Q]); K3/K4 past 512 lanes and past their shared memory (T);
# K9/K10 past q_pad 8192 and past 8 fragments' packed codes (BW 256)
PAST_K2 = ((64, 640, 1040), (64, 640, 2048), (16, 16384, 1024), (16, 12000, 4096))
PAST_BAND_WIDTHS = (528, 768, 1024, 2048, 4096)
PAST_BAND_LONG = ((256, 16384), (1024, 8192))  # (BW, T)
PAST_BANDED_Q_PADS = (8208, 16384, 65536)
# K9's global route timed on [B, T, Q, seed] rows of 59,500 .. 61,500 bases
# before their 5% deletions (q_len past 55,887) on consensus rows of 62,000
# .. 64,000
K9_LONG, K9_LONG_BASES = (256, 64000, 65536, 7), (59500, 61500)
# past the last refusals: K2's int32 route past Q 262,143, where every end
# value can fall below NEG and raven_tpu's two start-row rules part ([B, T,
# Q]; a fragment's end values stay above NEG while 4 q_len - 7 tlen <= 2^20,
# its matches making up for part of its gaps); K3's global route and K4's
# direct walk past BW 16,384 (T 160); K10 on up to K10_WRAPPED of K9_LONG's
# fragments whose band starts wrap; the full-NW engine on windows of which
# two hold a fragment of NEG_Q bases
PAST_K2_NEG = (8, 64, 262400)
PAST_BAND_GLOBAL = (16400, 32768)
K10_WRAPPED = 8
NEG_Q = 262400
# the full batch: a bank of 512 windows of 2,000 bases x 30 fragments
FULL_WINDOWS, FULL_WINDOW, FULL_COVERAGE = 512, 2000, 30
FULL_T, FULL_Q, FULL_BW = 2048, 2560, 768
# each route's CUDA kernel, for its device time in a profiler trace
ROUTE_KERNELS = {
    "votes_primitives": "votes_primitives_kernel",
    "votes_primitives_i32": "votes_primitives_i32_kernel",
    "band_forward": "band_forward_kernel", "band_forward_wide": "band_forward_wide_kernel",
    "band_pack": "band_pack_kernel",
    "band_forward_global": "band_forward_global_kernel",
    "mask_walk_votes": "band_walk_kernel", "mask_walk_votes_direct": "band_walk_direct_kernel",
    "nw_moves_banded": "nw_moves_banded_kernel", "nw_moves_banded_global": "nw_moves_banded_kernel",
    "traceback_banded": "traceback_banded_kernel",
}
NEW_ROUTES = ("votes_primitives_i32", "band_forward_wide", "band_forward_global",
              "mask_walk_votes_direct", "nw_moves_banded_global")


def route_counts() -> dict:
    """Launches per route since the process started (no phase zeroes them)."""
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda

    return {**consensus_cuda.ROUTE_LAUNCHES, **band_cuda.ROUTE_LAUNCHES,
            **banded_cuda.ROUTE_LAUNCHES}


def k2_long_rows(B: int, T: int, Q: int, seed: int):
    """[B, T] / [B, Q] int32 K2 inputs whose fragments cycle through their
    consensus: consensus rows of T/2 .. T bases, fragments of Q/2 .. Q
    bases with 5% substitutions (long runs of left or up moves), weights
    1-255, every 7th row empty (q_len 0); neighbouring rows (a pair on the
    pair route) end their consensus at different rows."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    cw = np.where(np.arange(T)[None] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 0:
            continue
        n = int(rng.integers(Q // 2, Q + 1))
        src = np.resize(cw[b, : tl[b]], n)
        fr[b, :n] = np.where(rng.random(n) < 0.05, (src + 1) % 4, src)
        ql[b] = n
    wt = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0)
    return cw.astype(np.int32), tl, fr, ql, wt.astype(np.int32)


def k2_neg_rows(B: int, T: int, Q: int, seed: int, longest: int = 0):
    """[B, T] / [B, Q] int32 K2 inputs past Q 262,143: fragments of Q, Q -
    40, 262,144, 262,100 and 200,000 bases cycling through consensus rows of
    L = `longest` (T when 0) or L - 8 bases with 5% substitutions, one
    fragment without bases and one without a consensus, weights 1-255.
    Where q_len * |GAP| > 2^20 every end value is below NEG: the argmax
    rule's walk starts one below the best row, or on the inactive row tlen
    (casting nothing; with L < T on a consensus of L bases that row lies
    past every row the plain forward computes), the Pallas rule's on row
    1."""
    rng = np.random.default_rng(seed)
    L = longest or T
    qls = (Q, Q, Q - 40, 262144, 262100, 200000, 0, Q)
    tls = (L, L - 8, L, L - 8, L, L - 8, L, 0)
    tl = np.array([tls[b % 8] for b in range(B)], np.int32)
    cw = np.where(np.arange(T)[None] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.array([qls[b % 8] for b in range(B)], np.int32)
    for b in range(B):
        n = int(ql[b])
        src = np.resize(cw[b, : tl[b]], n) if tl[b] else rng.integers(0, 4, n)
        fr[b, :n] = np.where(rng.random(n) < 0.05, (src + 1) % 4, src)
    wt = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0)
    return cw.astype(np.int32), tl, fr, ql, wt.astype(np.int32)


def neg_windows(n: int, window: int, coverage: int, seed: int):
    """make_windows' windows, with the first fragment of windows 0 and 2
    replaced by one of NEG_Q bases cycling through its backbone (5%
    substitutions, weight 11)."""
    from raven_tpu_torch.utils.synth import make_windows

    rng = np.random.default_rng(seed)
    windows, _ = make_windows(n, window, coverage, rng)
    for w in (0, 2):
        bb, frags, wts = windows[w]
        src = np.resize(bb, NEG_Q)
        frags[0] = np.where(rng.random(NEG_Q) < 0.05, (src + 1) % 4, src).astype(np.uint8)
        wts[0] = np.full(NEG_Q, 11, np.uint8)
    return windows


def banded_long_rows(B: int, T: int, Q: int, seed: int, n_min: int = 0, n_max: int = 0):
    """[B, T] / [B, Q] K9/K10 inputs on long consensus rows: each fragment
    (n_min .. n_max bases, Q/2 .. Q by default, then 5% substitutions and
    deletions) drawn from a random place r0 of its consensus row (T - 2,000
    .. T bases) and anchored there, every 4th anchored on the whole row (a
    shallow band), weights 1-255."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(T - 2000, T + 1, B).astype(np.int32)
    cw = np.where(np.arange(T)[None] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.zeros(B, np.int32)
    r0 = np.zeros(B, np.int32)
    r1 = tl.copy()
    for b in range(B):
        n = int(rng.integers(n_min or Q // 2, (n_max or Q) + 1))
        if b % 4:
            r0[b] = rng.integers(0, tl[b] - n)
            r1[b] = r0[b] + n
        src = cw[b, r0[b] : r0[b] + n]
        s = np.where(rng.random(src.size) < 0.05, (src + 1) % 4, src)[rng.random(src.size) >= 0.05]
        fr[b, : s.size] = s
        ql[b] = s.size
    wt = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0)
    return cw.astype(np.int32), tl, fr, ql, r0, r1, wt.astype(np.int32)


def past_ceilings(device) -> dict:
    """Each first route's ceiling on the card: its launcher, called
    directly, launches at the last shape its wrapper's launch_plan gives
    it, the card refuses one step past (the block's shared memory: the
    launchers keep no limit of their own), and the next launch after a
    refusal goes through.  Returns {kernel: (last, past)}."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.ops import banded_cuda as bd
    from raven_tpu_torch.ops import consensus_cuda as cc

    i32 = torch.int32
    st = torch.cuda.current_stream().cuda_stream

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def k2(T, Q=768, B=2):
        _, words, fn, _ = cc._fns()
        a = [torch.from_numpy(x).to(device) for x in k2_long_rows(B, T, Q, T)]
        mv = z(max(words(B, T, Q), 1))
        outs = (z(B, T), z(B, T), z(B, T + 1), z(B, T + 1))
        return fn(*(x.data_ptr() for x in (*a, mv, *outs)), B, T, Q, st, 2)

    # each first route's launcher at its own fragments a block, also one
    # step past the shape where launch_plan leaves it
    def k3(T, BW, B=8):
        fn = bc._fns()[1]["band_forward"]
        args = (z(B, T), z(B), z(B, T + BW + 1, dtype=torch.uint8), z(B), z(B),
                z(T, B, BW // 16), z(T, B), z(B))
        return fn(*(x.data_ptr() for x in args), B, T, BW, st, 8 if BW <= 256 else 4)

    def k4(T, BW, B=16):
        fn = bc._fns()[1]["mask_walk_votes"]
        args = (z(T, B, BW // 16), z(T, B), z(B), z(B, T + BW + 1, dtype=torch.uint8), z(B),
                z(B), z(B, T), z(B, T + 1))
        return fn(*(x.data_ptr() for x in args), B, T, BW, st, 16)

    def k9(Q, T=16, B=8):
        fn = bd._fns()[1]
        args = (z(B, T), z(B), z(B, Q), z(B), z(B), z(B) + 1, z(T, B, 16), z(T, B), z(T, B), z(B))
        return fn(*(x.data_ptr() for x in args), B, T, Q, 256, st, bd.FWD_FRAGS[256])

    probes = {
        "K2 pair route, T at Q 768": (k2, 9412, lambda T: cc.launch_plan(T, 768)[0]),
        "K3 strips, T at BW 256": (lambda T: k3(T, 256), 14399,
                                   lambda T: bc.launch_plan(T, 256)[0][0]),
        "K3 strips, T at BW 512": (lambda T: k3(T, 512), 28799,
                                   lambda T: bc.launch_plan(T, 512)[0][0]),
        "K4 staged, T at BW 256": (lambda T: k4(T, 256), 10143,
                                   lambda T: bc.launch_plan(T, 256)[1][0]),
        "K4 staged, T at BW 512": (lambda T: k4(T, 512), 5791,
                                   lambda T: bc.launch_plan(T, 512)[1][0]),
        "K9 smem, Q at BW 256": (k9, 55887, lambda Q: bd.launch_plan(16, Q, 256)[0]),
    }
    out = {}
    for name, (launch, last, plan) in probes.items():
        require(plan(last) != plan(last + 1), f"{name}: launch_plan's boundary is not at {last}")
        err_last = launch(last)
        torch.cuda.synchronize()
        err_past = launch(last + 1)
        err_next = launch(last)
        torch.cuda.synchronize()
        require(err_last == 0 and err_next == 0 and err_past != 0,
                f"{name}: the card's ceiling is not launch_plan's {last} (errors at {last}, "
                f"{last + 1}, {last} again: {err_last}, {err_past}, {err_next})")
        out[name] = {"last": last, "past_error": err_past}
        log(f"ceiling {name}: {last} launches, {last + 1} refused (CUDA error {err_past}), "
            f"as launch_plan has it")
    return out


def check_votes(device, arrays, name: str):
    """K2 against its plain version on `arrays` (cw, tlens, frags, qlens,
    wts), bit for bit; returns the case's fields."""
    import torch

    from raven_tpu_torch.ops import consensus_cuda as cc

    cw, tl, fr, ql, wt = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
    (B, T), Q = cw.shape, fr.shape[1]
    route = cc.launch_plan(T, Q)[0]
    got = cc.votes_primitives(cw, tl, fr, ql, wt)
    want = cc.votes_primitives_plain(cw, tl, fr, ql, wt)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"K2 ({route}) differs from votes_primitives_plain at {name} [{B}, {T}, {Q}] (max "
            f"abs err {err}; " + first_diffs(got, want, ("col_sym", "col_w", "ins_b", "ins_w"))
            + ")")
    log(f"K2 {name} [B, T, Q] = [{B}, {T}, {Q}], route {route}: bit-equal, "
        f"{int((got[0] < 5).sum())} column votes")
    return {"case": name, "shape": [B, T, Q], "route": route, "max_abs_err": err}


def past_neg_votes(device) -> dict:
    """K2's int32 route at PAST_K2_NEG (k2_neg_rows) under both start-row
    rules, each bit-equal to votes_primitives_plain under the same rule:
    with the longest consensus T bases, and with every consensus shorter
    than T (the argmax rule's walk then starts a fragment on the row one
    past every computed row); the two rules' outputs must differ (each
    case reaches NEG).  The argmax rule's kernel, the engine's, timed
    beside its bound on the first case."""
    import torch

    from raven_tpu_torch.ops import consensus_cuda as cc

    B, T, Q = PAST_K2_NEG
    route = cc.launch_plan(T, Q)[0]
    errs, plain_ms = [], 0.0
    inputs = {L: [torch.from_numpy(x).to(device) for x in k2_neg_rows(B, T, Q, 13, L)]
              for L in (T, T - 4)}
    for longest, a in inputs.items():
        outs = {}
        for argmax in (False, True):
            rule = "argmax" if argmax else "Pallas"
            got = cc._kernel(*a, argmax=argmax)
            want, ms = timed_plain(lambda: cc.votes_primitives_plain(*a, argmax=argmax))
            torch.cuda.synchronize()
            errs.append(max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                            for x, y in zip(got, want)))
            require(all(torch.equal(x, y) for x, y in zip(got, want)),
                    f"K2 ({route}, the {rule} rule) differs from votes_primitives_plain at "
                    f"{[B, T, Q]}, longest consensus {longest} (max abs err {errs[-1]}; "
                    + first_diffs(got, want, ("col_sym", "col_w", "ins_b", "ins_w")) + ")")
            outs[argmax] = want
            if argmax and longest == T:
                plain_ms = ms
            log(f"K2 ({route}) past Q 262,143 [B, T, Q] = {[B, T, Q]}, longest consensus "
                f"{longest}, the {rule} rule: bit-equal, {int((got[0] < 5).sum())} column "
                f"votes, {int((got[2] >= 0).sum())} insertions")
        require(any(not torch.equal(x, y) for x, y in zip(outs[False], outs[True])),
                f"K2's two start-row rules agree at PAST_K2_NEG, longest consensus {longest}: "
                f"the case does not reach NEG")
    a = inputs[T]
    b, by, _ = votes_bound(a[1], a[3], T, Q)
    return {"case": "fragments past q_len 262,143, both start-row rules", "shape": [B, T, Q],
            "route": route, "max_abs_err": max(errs), "bound_ms": b, "bound_by": by,
            "plain_ms": plain_ms, **time_route(lambda: cc._kernel(*a, argmax=True), route)}


def past_band_global(device) -> list:
    """K3's global route and K4's direct walk at PAST_BAND_GLOBAL on 16
    windows of 120 bases x 30 with insertion runs (T 160), each bit-equal
    to its plain version and timed beside its bound."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.utils.synth import make_windows

    short, _ = make_windows(16, 120, 30, np.random.default_rng(21))
    runs = insertion_runs(short)
    out = []
    for BW in PAST_BAND_GLOBAL:
        T = 160
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in band_layout(runs, BW, q_pad=240, T=T)]
        B = a[0].shape[0]
        (r3, _), (r4, _) = bc.launch_plan(T, BW)
        fwd, plain3 = timed_plain(lambda: bc.band_forward_plain(*a, T, BW))
        got = bc.band_forward(*a, T, BW)
        walk, plain4 = timed_plain(lambda: bc.mask_walk_votes_plain(*fwd, *a[2:], T, BW))
        gv = bc.mask_walk_votes(*fwd, *a[2:], T, BW)
        torch.cuda.synchronize()
        err = max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                  for x, y in zip((*got, *gv), (*fwd, *walk)))
        require(all(torch.equal(x, y) for x, y in zip(got, fwd)),
                f"K3 ({r3}) differs from band_forward_plain at {[B, T, BW]} (max abs err {err})")
        require(all(torch.equal(x, y) for x, y in zip(gv, walk)),
                f"K4 ({r4}) differs from mask_walk_votes_plain at {[B, T, BW]} (max abs err "
                f"{err})")
        b3, by3, _ = band_forward_bound(B, T, BW)
        b4, by4, p4 = band_walk_bound(walk[0], B, T, BW)
        c = {"case": f"16 windows with insertion runs, BW {BW}", "shape": [B, T, BW],
             "routes": [r3, r4], "max_abs_err": err,
             "K3": {"route": r3, "bound_ms": b3, "bound_by": by3, "plain_ms": plain3,
                    **time_route(lambda: bc.band_forward(*a, T, BW), r3)},
             "K4": {"route": r4, "bound_ms": b4, "bound_by": by4, "plain_ms": plain4,
                    **time_route(lambda: bc.mask_walk_votes(*fwd, *a[2:], T, BW), r4)}}
        log(f"K3 ({r3}) / K4 ({r4}) at {[B, T, BW]}: bit-equal, {p4['voted_rows']} voted rows; "
            f"K3 {c['K3']['ms']:.4f} ms (device {fmt_ms(c['K3']['device_ms'])}), bound "
            f"{b3:.4f} ms by {by3}, plain {plain3:.4f} ms; K4 {c['K4']['ms']:.4f} ms (device "
            f"{fmt_ms(c['K4']['device_ms'])}), bound {b4:.4f} ms by {by4}, plain {plain4:.4f} ms")
        out.append(c)
        del fwd, got, walk, gv
    return out


def k10_wrapped(device, fwd, arrays) -> dict:
    """K10 on up to K10_WRAPPED of the fragments whose band starts wrap in
    K9's outputs `fwd` (moves, offs, end_scores, row0) on `arrays` (cw,
    tlens, frags, qlens, r0, r1, wts), bit-equal to its plain version: once
    as K9 left them (every end value there is NEG, and the walks stall on
    the top row), and once started inside the wrapped stretch (its band at
    column 0: an end value of 0 on the 64th row past the first wrapped one,
    at column 200), so that each walk reads K9's moves on wrapped rows and
    stops where the band jumps back."""
    import torch

    from raven_tpu_torch.ops import banded_cuda as bd

    moves, offs, ends, row0 = fwd
    T, Q, BW = moves.shape[0], arrays[2].shape[1], 256
    wrapped = (offs[1:] < offs[:-1])
    sel = torch.nonzero(wrapped.any(dim=0)).flatten()[:K10_WRAPPED]
    require(sel.numel() > 0, "no fragment of K9_LONG has a wrapped band start")
    _, _, fr, ql, _, _, wt = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                              for a in arrays)
    m, o, e, r0s = (moves[:, sel].contiguous(), offs[:, sel].contiguous(),
                    ends[:, sel].contiguous(), row0[sel].contiguous())
    fr, ql, wt = fr[sel].contiguous(), ql[sel].contiguous(), wt[sel].contiguous()
    n = sel.numel()
    start = wrapped[:, sel].to(torch.int8).argmax(dim=0) + 1 + 64  # a row in the stretch
    e2 = torch.full_like(e, bd.NEG)
    e2[start - 1, torch.arange(n, device=device)] = 0
    ql2 = torch.full_like(ql, 200)
    row02 = ql2 * bd.GAP
    out = {"fragments": n}
    for name, args in (("as K9 left them", (m, o, e, r0s, ql)),
                       ("started in the wrapped stretch", (m, o, e2, row02, ql2))):
        got = bd.traceback_banded(*args, fr, wt, T, Q, BW)
        want, kinds, _ = bd.traceback_banded_plain(*args, fr, wt, T, Q, BW, return_walks=True)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"K10 differs from traceback_banded_plain on K9_LONG's wrapped rows, {name}: "
                + first_diffs(got, want, ("col_sym", "col_w", "ins_b", "ins_w")))
        out[name] = {"column_votes": int((want[0] < 5).sum()),
                     "walk_ends": [int((kinds == i).sum()) for i in range(4)]}
        log(f"K10 on {n} of K9_LONG's fragments whose band starts wrap, {name}: bit-equal, "
            f"{out[name]['column_votes']} column votes, walks ending at column 0 / stalled / "
            f"at the band's edge / past the consensus: {out[name]['walk_ends']}")
    require(out["started in the wrapped stretch"]["column_votes"] > 0,
            "K10's walks started in the wrapped stretch cast no column vote")
    return out


def timed_plain(plain):
    """(plain()'s result, its one call's milliseconds between two CUDA
    events): the plain version that a check compares with, timed as it
    runs."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = plain()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def time_route(fn, route: str, runs: int = 5) -> dict:
    """A kernel's one-call time and its device time on the card."""
    return {"ms": cuda_ms(fn, runs=runs, warmup=1),
            "device_ms": device_ms(fn, ROUTE_KERNELS[route], runs=runs, warmup=1)}


def time_k9(device, arrays):
    """K9 on `arrays` (cw, tlens, frags, qlens, r0, r1, wts) at BW 256:
    (its route, times and bound, its plain version's outputs)."""
    import torch

    from raven_tpu_torch.ops import banded_cuda as bd

    cw, tl, fr, ql, r0, r1, _ = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                 for a in arrays)
    (B, Q), T = fr.shape, cw.shape[1]
    route = bd.launch_plan(T, Q, 256)[0]
    bound, by, _ = banded_forward_bound(tl, ql, B, T, Q, 256)
    want, plain_ms = timed_plain(lambda: bd.nw_moves_banded_plain(cw, tl, fr, ql, r0, r1, T, Q,
                                                                  256))
    got = bd.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, 256)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(got, want)),
            f"K9 ({route}) differs from its plain version at {[B, T, Q, 256]}")
    # band starts that step back: raven_tpu's (row - r0) * q_len wrapped
    wrapping = int((want[1][1:] < want[1][:-1]).any(dim=0).sum())
    out = {"route": route, "shape": [B, T, Q, 256], "bound_ms": bound, "bound_by": by,
           "plain_ms": plain_ms, "wrapping": wrapping,
           **time_route(lambda: bd.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, 256), route)}
    return out, want


def past_kernel_cases(device) -> dict:
    """Every kernel bit-equal to its plain version on the card at the
    shapes past its old limits (small batches, each case's seconds kept);
    K9's global route timed on K9_LONG's rows.  Returns the cases'
    fields."""
    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.utils.synth import make_windows

    out = {"K2": [], "band": [], "banded": []}

    def case(kind, check, *args):
        t = time.perf_counter()
        out[kind].append({**check(device, *args), "s": time.perf_counter() - t})
        log(f"  ({out[kind][-1]['case']}, {out[kind][-1]['shape']}: {out[kind][-1]['s']:.1f} s)")
        return out[kind][-1]

    t0 = time.perf_counter()
    for B, T, Q in PAST_K2:
        case("K2", check_votes, k2_long_rows(B, T, Q, T + Q), "fragments cycling their consensus")
    # the case that found the pair route's borrow across its halves
    for B, T, Q in ((64, 640, 768), (16, 200, 300)):
        case("K2", check_votes, k2_long_rows(B, T, Q, T + Q),
             "pairs whose consensus rows end apart")
    t_band = time.perf_counter()
    short, _ = make_windows(16, 120, 30, np.random.default_rng(21))
    runs = insertion_runs(short)
    for BW in PAST_BAND_WIDTHS:
        c = case("band", check_band, band_layout(runs, BW, q_pad=240, T=160), BW,
                 f"16 windows with insertion runs, BW {BW}", False)
        c["routes"] = bc.launch_plan(160, BW)
    for BW, T in PAST_BAND_LONG:
        grp, _ = make_windows(4, T - 400, 8, np.random.default_rng(T))
        c = case("band", check_band, band_layout(grp, BW, q_pad=T + BW, T=T), BW,
                 f"4 windows of {T - 400} bases, BW {BW}", False)
        c["routes"] = bc.launch_plan(T, BW)
    log(f"K3/K4 past 512 lanes (BW {PAST_BAND_WIDTHS}) and past their T ceilings "
        f"({PAST_BAND_LONG}): bit-equal")
    t1 = time.perf_counter()
    for q_pad in PAST_BANDED_Q_PADS:
        # 16 rows of each kind in one batch: the plain walk takes one move a
        # step for the batch's longest walk, so one batch costs it once
        cases = banded_width_cases(q_pad, n_rows=16)
        mixed = tuple(np.concatenate(parts) for parts in zip(*(a for _, a in cases)))
        case("banded", check_banded, mixed, f"bank rows, cut fragments, steep spans, all "
             f"mismatches, q_pad {q_pad}", False)
    case("banded", check_banded, banded_long_rows(32, 16384, 768, 5),
         "long consensus rows, T 16384", False)
    t2 = time.perf_counter()
    # K9's global route timed where it is needed: fragments whose bases run
    # past the shared-memory route's 55,887 columns, on consensus rows as
    # long as they are
    long_rows = banded_long_rows(*K9_LONG, n_min=K9_LONG_BASES[0], n_max=K9_LONG_BASES[1])
    out["K9_global"], fwd = time_k9(device, long_rows)
    t3 = time.perf_counter()
    out["K10_wrapped"] = k10_wrapped(device, fwd, long_rows)
    del fwd
    t4 = time.perf_counter()
    out["K2_neg"] = past_neg_votes(device)
    t5 = time.perf_counter()
    out["band_global"] = past_band_global(device)
    t6 = time.perf_counter()
    k9g = out["K9_global"]
    log(f"K9 ({k9g['route']}) on long rows {k9g['shape']}: bit-equal, {k9g['wrapping']} "
        f"fragments whose int32 band start wraps (as raven_tpu's); {k9g['ms']:.4f} ms (device "
        f"{fmt_ms(k9g['device_ms'])}), bound {k9g['bound_ms']:.4f} ms by {k9g['bound_by']}, "
        f"plain version {k9g['plain_ms']:.4f} ms")
    log(f"phase 13(d) kernel cases: K2 {t_band - t0:.1f} s, K3/K4 {t1 - t_band:.1f} s, "
        f"K9/K10 {t2 - t1:.1f} s, K9 global timed {t3 - t2:.1f} s, K10 on wrapped rows "
        f"{t4 - t3:.1f} s, K2 past Q 262,143 {t5 - t4:.1f} s, K3/K4 past BW 16,384 "
        f"{t6 - t5:.1f} s")
    return out


def engine_calls(windows, t_pad: int, q_pad: int, bw: int, chunk: int):
    """The three engines' calls on `windows`, each (name, call(device))."""
    from raven_tpu_torch.ops.consensus_band import band_window_consensus
    from raven_tpu_torch.ops.consensus_device import device_window_consensus

    kw = dict(iterations=2, t_pad=t_pad)
    return (
        (f"full NW, q_pad {q_pad}",
         lambda d: device_window_consensus(windows, q_pad=q_pad, chunk=chunk, device=d, **kw)),
        (f"anchored banded, q_pad {q_pad}",
         lambda d: device_window_consensus(windows, q_pad=q_pad, chunk=chunk, banded=True,
                                           device=d, **kw)),
        (f"shift-banded, bw {bw}",
         lambda d: band_window_consensus(windows, q_pad=q_pad, bw=bw, device=d, **kw)),
    )


def past_engines(device) -> dict:
    """The three engines through their entry points on 16 windows at the
    shapes past the old limits, on the card and on the CPU (the plain
    versions): the same consensus bytes.  Returns each call's route
    launches."""
    from raven_tpu_torch.ops.consensus_device import device_window_consensus
    from raven_tpu_torch.utils.synth import make_windows

    from raven_tpu_torch.ops.consensus_band import band_window_consensus

    long16, _ = make_windows(16, 1100, 10, np.random.default_rng(31))
    win16, _ = make_windows(16, 500, 10, np.random.default_rng(33))
    _, banded, shift = engine_calls(win16, 640, 16384, 768, 256)
    # two fragments past q_len 262,143 among 4 windows of 120 bases x 6 (in
    # one chunk of 8), on consensus rows as long as t_pad
    neg4 = neg_windows(4, 120, 6, 35)
    win2, _ = make_windows(2, 100, 6, np.random.default_rng(37))
    calls = [
        ("full NW, q_pad 2048", lambda d: device_window_consensus(
            long16, iterations=2, t_pad=1280, q_pad=2048, chunk=256, device=d)),
        banded,
        ("anchored banded, q_pad 65536", lambda d: device_window_consensus(
            win16, iterations=2, t_pad=640, q_pad=65536, chunk=256, banded=True, device=d)),
        shift,
        (f"full NW, fragments of {NEG_Q} bases", lambda d: device_window_consensus(
            neg4, iterations=2, t_pad=120, q_pad=NEG_Q, chunk=8, device=d)),
        (f"shift-banded, bw {PAST_BAND_GLOBAL[0]}", lambda d: band_window_consensus(
            win2, iterations=2, t_pad=128, q_pad=200, bw=PAST_BAND_GLOBAL[0], device=d)),
    ]
    out = {}
    for name, call in calls:
        before = route_counts()
        (got, wall) = timed(lambda: call(device))
        after = route_counts()
        t0 = time.perf_counter()
        want = call("cpu")
        cpu_s = time.perf_counter() - t0
        require(len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            f"the {name} consensus on the card differs from the CPU's")
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        out[name] = {"wall_s": wall, "launches": launched}
        log(f"{name} on {len(got)} windows: the card's consensus is the CPU's, byte for byte; "
            f"{wall:.3f} s on the card ({cpu_s:.1f} s on the CPU); routes launched {launched}")
    return out


def full_batch(device, smi: str) -> dict:
    """One call of each engine on a bank of FULL_WINDOWS windows of
    FULL_WINDOW bases x FULL_COVERAGE fragments at t_pad FULL_T (q_pad
    FULL_Q, the shift-banded band FULL_BW): its wall, its route launches,
    and its consensus against the windows' truth (closer than the
    backbones on the first 32 windows); then each route's kernel on the
    engine's first chunk or group, bit-equal to its plain version, timed
    beside its bound."""
    import torch

    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.ops import banded_cuda as bd
    from raven_tpu_torch.ops import consensus_cuda as cc
    from raven_tpu_torch.ops.edit_distance import edit_distance
    from raven_tpu_torch.utils.synth import make_windows

    truths: list = []
    bank, _ = make_windows(FULL_WINDOWS, FULL_WINDOW, FULL_COVERAGE,
                           np.random.default_rng(41), truths)
    out = {"engines": {}}
    ed_bb = sum(edit_distance(w[0], t) for w, t in zip(bank[:32], truths))
    for name, call in engine_calls(bank, FULL_T, FULL_Q, FULL_BW, 2048):
        before = route_counts()
        cons, wall = timed(lambda: call(device))
        after = route_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ed = sum(edit_distance(c, t) for c, t in zip(cons[:32], truths))
        require(len(cons) == FULL_WINDOWS and ed < ed_bb / 2,
                f"{name} on the bank: {len(cons)} windows, edit distance {ed} to the truth "
                f"on 32 windows against the backbones' {ed_bb}")
        out["engines"][name] = {"wall_s": wall, "launches": launched, "ed_32": ed,
                                "backbone_ed_32": ed_bb}
        log(f"{name} on {FULL_WINDOWS} windows of {FULL_WINDOW} bases x {FULL_COVERAGE}, t_pad "
            f"{FULL_T}: {wall:.3f} s, routes launched {launched}; edit distance to the truth "
            f"on 32 windows {ed} (backbones {ed_bb}) [{smi}]")

    kernels = {}
    T, Q, BW = FULL_T, FULL_Q, FULL_BW

    def dev(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]

    def same(got, want, what):
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"{what} differs from its plain version at the bank's full batch")

    (cw, tl, fr, ql, wt), _ = consensus_chunk(2048, T, Q, windows=bank)
    a2 = dev((cw, tl, fr, ql, wt))
    route = cc.launch_plan(T, Q)[0]
    want, plain_ms = timed_plain(lambda: cc.votes_primitives_plain(*a2))
    same(cc.votes_primitives(*a2), want, f"K2 ({route})")
    b, by, _ = votes_bound(a2[1], a2[3], T, Q)
    kernels["K2"] = {"route": route, "shape": [2048, T, Q], "bound_ms": b, "bound_by": by,
                     "plain_ms": plain_ms,
                     **time_route(lambda: cc.votes_primitives(*a2), route)}
    del want

    a3 = dev(band_layout(bank[:128], BW, q_pad=Q, T=T))
    B3 = a3[0].shape[0]
    (r3, _), (r4, _) = bc.launch_plan(T, BW)
    fwd, plain3 = timed_plain(lambda: bc.band_forward_plain(*a3, T, BW))
    same(bc.band_forward(*a3, T, BW), fwd, f"K3 ({r3})")
    walk, plain4 = timed_plain(lambda: bc.mask_walk_votes_plain(*fwd, *a3[2:], T, BW))
    same(bc.mask_walk_votes(*fwd, *a3[2:], T, BW), walk, f"K4 ({r4})")
    b3, by3, _ = band_forward_bound(B3, T, BW)
    b4, by4, _ = band_walk_bound(walk[0], B3, T, BW)
    kernels["K3"] = {"route": r3, "shape": [B3, T, BW], "bound_ms": b3, "bound_by": by3,
                     "plain_ms": plain3, **time_route(lambda: bc.band_forward(*a3, T, BW), r3)}
    kernels["K4"] = {"route": r4, "shape": [B3, T, BW], "bound_ms": b4, "bound_by": by4,
                     "plain_ms": plain4,
                     **time_route(lambda: bc.mask_walk_votes(*fwd, *a3[2:], T, BW), r4)}
    del fwd

    banded = banded_layout(bank, 2048, t_pad=T, q_pad=Q)
    cw9, tl9, fr9, ql9, r09, r19, wt9 = dev(banded)
    B9, BW9 = fr9.shape[0], 256
    kernels["K9"], _ = time_k9(device, banded)
    fwd9 = bd.nw_moves_banded(cw9, tl9, fr9, ql9, r09, r19, T, Q, BW9)  # held to its plain
    (walk9, _, steps), plain10 = timed_plain(lambda: bd.traceback_banded_plain(
        *fwd9, ql9, fr9, wt9, T, Q, BW9, return_walks=True))
    same(bd.traceback_banded(*fwd9, ql9, fr9, wt9, T, Q, BW9), walk9, "K10")
    b10, by10, _ = banded_walk_bound(steps, walk9[0], walk9[2], B9, T)
    kernels["K10"] = {"route": "traceback_banded", "shape": [B9, T, Q, BW9], "bound_ms": b10,
                      "bound_by": by10, "plain_ms": plain10,
                      **time_route(lambda: bd.traceback_banded(*fwd9, ql9, fr9, wt9, T, Q, BW9),
                                   "traceback_banded")}
    for k, v in kernels.items():
        log(f"{k} ({v['route']}) at the bank's full batch {v['shape']}: bit-equal; "
            f"{v['ms']:.4f} ms (device {fmt_ms(v['device_ms'])}), bound {v['bound_ms']:.4f} ms "
            f"by {v['bound_by']}, plain version {v['plain_ms']:.4f} ms [{smi}]")
    out["kernels"] = kernels
    return out


def phase_past_limits(device, smi: str) -> dict:
    """Phase 13(d): every consensus kernel past its old limits.  The first
    routes' ceilings confirmed on the card; the kernels bit-equal to their
    plain versions at shapes past each limit; the three engines through
    their entry points on 16 windows, the card's consensus the CPU's; one
    engine call each at a full batch, timed.  No route past an old limit
    may have launched before this phase (the CLI paths take the first
    routes).  Returns the phase's fields for the kernels line."""
    before = route_counts()
    require(all(before[r] == 0 for r in NEW_ROUTES),
            f"a route past the old limits launched before phase 13(d): {before}")
    # the phase's plain versions are host-bound: what else holds the host
    log(f"phase 13(d) starts: host load average {os.getloadavg()[0]:.2f} over a minute, "
        f"{os.cpu_count()} cores")
    t0 = time.perf_counter()
    out = {"ceilings": past_ceilings(device), "cases": past_kernel_cases(device)}
    t1 = time.perf_counter()
    out["engines"] = past_engines(device)
    out["full_batch"] = full_batch(device, smi)
    # the slice's own path: the engines' calls, the 16 windows' and the full
    # batch's (not the launches that time or check a kernel)
    calls = [*out["engines"].values(), *out["full_batch"]["engines"].values()]
    out["launches"] = {r: sum(c["launches"].get(r, 0) for c in calls) for r in before}
    out["launches_before"] = {r: before[r] for r in NEW_ROUTES}
    require(all(out["launches"][r] > 0 for r in NEW_ROUTES),
            f"phase 13(d)'s engine calls launched a new route no time: {out['launches']}")
    log(f"phase 13(d): ceilings and kernel cases {t1 - t0:.1f} s, engines (16 windows and "
        f"the full batch) {time.perf_counter() - t1:.1f} s; route launches on the engines' "
        f"calls {out['launches']}")
    return out


@contextlib.contextmanager
def device_split(split: dict, parts: dict):
    """Split calls of the functions in `parts` ({(module, name): part}) into
    `split` (seconds summed over the calls): "host prep" on the host clock,
    any other part as the device time between CUDA events recorded around
    each call, read once the calls are done."""
    import torch

    events = []

    def wrap(part, fn):
        def wrapper(*a, **k):
            if part == "host prep":
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split[part] = split.get(part, 0.0) + time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.append((part, start, end))
            return out
        return wrapper

    saved = {key: getattr(*key) for key in parts}
    for key, part in parts.items():
        setattr(*key, wrap(part, saved[key]))
    try:
        yield split
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
        torch.cuda.synchronize()
        for part, start, end in events:
            split[part] = split.get(part, 0.0) + start.elapsed_time(end) / 1e3


def band_consensus_split(split: dict):
    """Split the shift-banded consensus calls into `split`: the host prep
    of each group, K3, K4, the vote epilogue and the K5 torch ops (run map,
    canonicalisation, rebuild)."""
    from raven_tpu_torch.ops import band_cuda, consensus_band

    return device_split(split, {
        (consensus_band, "_prepare_group"): "host prep",
        (band_cuda, "band_pack"): "pack",
        (band_cuda, "band_forward"): "K3",
        (band_cuda, "mask_walk_votes"): "K4",
        (band_cuda, "vote_tables"): "epilogue",
        (consensus_band, "_run_map_device"): "K5 torch ops",
        (consensus_band, "canonicalize_ins"): "K5 torch ops",
        (consensus_band, "_rebuild_device"): "K5 torch ops",
    })


def votes_consensus_split(split: dict):
    """Split the full-NW consensus calls into `split`: K2 and the vote
    epilogue it shares with the anchored banded engine (the rest of each
    call is host work)."""
    from raven_tpu_torch.ops import consensus_cuda

    return device_split(split, {
        (consensus_cuda, "votes_primitives"): "K2",
        (consensus_cuda, "votes_from_primitives"): "epilogue",
    })


def banded_consensus_split(split: dict):
    """Split the anchored banded consensus calls into `split`: K9, K10 and
    the vote epilogue (the rest of each call is host work: layout, uploads,
    the anchors' rescale and the rebuild)."""
    from raven_tpu_torch.ops import banded_cuda

    return device_split(split, {
        (banded_cuda, "nw_moves_banded"): "K9",
        (banded_cuda, "traceback_banded"): "K10",
        (banded_cuda, "votes_from_primitives"): "epilogue",
    })


@contextlib.contextmanager
def polisher_stage_walls(walls: dict, consensus_calls: list):
    """Time the Polisher's stages (read mapping, fragment placement with
    its crossing DP, the crossing DP alone, the consensus) into `walls`,
    in seconds summed over the rounds, and append each consensus call's
    windows, fragment rows and seconds to `consensus_calls`; each stage's
    device work ends in a host copy of its result, so the walls hold it."""
    from raven_tpu_torch.polish.polisher import Polisher

    names = ("_find_overlaps", "_fragments", "_crossings", "_run_consensus")
    saved = {n: getattr(Polisher, n) for n in names}

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                walls[name] = walls.get(name, 0.0) + dt
                if name == "_run_consensus":
                    jobs = a[1]
                    consensus_calls.append({
                        "windows": len(jobs),
                        "rows": sum(len(job[3]) for job in jobs),
                        "seconds": dt,
                    })
        return wrapper

    for n, fn in saved.items():
        setattr(Polisher, n, timed(n, fn))
    try:
        yield walls
    finally:
        for n, fn in saved.items():
            setattr(Polisher, n, fn)


def polish_run(device, work_dir, draft, flags, split=None, splitter=band_consensus_split,
               genome_size=1_000_000):
    """The main path with polish on phase 4's reads with `flags`: one
    contig of at least 0.97 of the genome at an edit-distance rate of
    ED_RATE_CEILING or less, with the crossing DP on the card.  `draft` is
    phase 4's unpolished contig, whose error rate is measured against the
    truth span and orientation the polished contig aligns to (a draft at ~5%
    error has too few exact 48-mers for contig_ed's own anchoring, and its
    fallback aligns the whole genome in both orientations, which takes
    minutes).  With `split`, the device consensus calls are split into it
    by `splitter`."""
    from raven_tpu_torch.io.readset import reverse_complement
    from raven_tpu_torch.ops.edit_distance import edit_distance_banded
    from raven_tpu_torch.utils.synth import _anchor_span, contig_ed

    walls: dict = {}
    calls: list = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(polisher_stage_walls(walls, calls))
        if split is not None:
            stack.enter_context(splitter(split))
        run = cli_run(device, work_dir, genome_size, flags=flags)
    genome = run["genome"]
    lengths = run["lengths"]
    require(len(lengths) == 1, f"expected 1 polished contig, got {len(lengths)}")
    require(lengths[0] >= 0.97 * genome_size,
            f"polished contig {lengths[0]} < 0.97 x {genome_size}")
    t0 = time.perf_counter()
    polished = run["contigs"][0]
    ed, span = contig_ed(polished, genome)
    consistent, spans = _anchor_span(polished, genome)
    if not consistent:
        draft = reverse_complement(draft)
        consistent, spans = _anchor_span(reverse_complement(polished), genome)
    require(consistent, "the polished contig has no consistent truth span")
    s0, e0 = spans[0]
    ed0, span0 = int(edit_distance_banded(draft, genome[s0:e0])), e0 - s0
    t_ed = time.perf_counter() - t0
    rate, rate0 = ed / lengths[0], ed0 / draft.size
    for r in run["polish_rounds"]:
        log(f"  polish round {r['round']}: {r['engine']} consensus, wall "
            f"{r['wall_s']:.3f} s")
    log("  polisher stages over both rounds: " + ", ".join(
        f"{n.strip('_')} {v:.3f} s" for n, v in walls.items()
    ) + " (fragments holds crossings)")
    for i, c in enumerate(calls):
        log(f"  consensus call {i}: {c['windows']} windows, {c['rows']} "
            f"fragment rows, {c['seconds']:.3f} s")
    log(
        f"polished contig {lengths[0]} bp: edit distance {ed} over a "
        f"{span} bp truth span = {rate * 100:.4f}% (unpolished -p 0 contig "
        f"{draft.size} bp: {ed0} over {span0} bp = {rate0 * 100:.4f}%; "
        f"metric {t_ed:.1f} s); K2 launches {run['k2_launches']}; K3 launches "
        f"{run['k3_launches']}; K4 launches {run['k4_launches']}; K9 launches "
        f"{run['k9_launches']}; K10 launches {run['k10_launches']}; crossing-DP "
        f"runs on the card {run['dp_runs']}"
    )
    require(rate <= ED_RATE_CEILING,
            f"polished edit-distance rate {rate:.6f} above {ED_RATE_CEILING}")
    require(run["dp_runs"] > 0, "the crossing DP did not run on the card")
    run["ed_rate"], run["ed_rate_unpolished"] = rate, rate0
    run["stage_walls"] = walls
    run["consensus_calls"] = calls
    return run


def phase_polish(device, work_dir, draft):
    """-p 2 with the full-NW device consensus in chunks of 8 x 256
    fragment rows in both rounds, every core for the host stages; the
    consensus calls split into K2 and the vote epilogue."""
    flags = ("-p", "2", "--device-poa-batches", "8", "-t", str(os.cpu_count()))
    split: dict = {}
    run = polish_run(device, work_dir, draft, flags, split=split,
                     splitter=votes_consensus_split)
    require(run["k2_launches"] > 0, "the polish run launched K2 no time")
    require(all(r["engine"] == "device" for r in run["polish_rounds"]),
            "a polish round left the device consensus")
    wall = sum(c["seconds"] for c in run["consensus_calls"])
    log(f"  full-NW consensus calls {wall:.3f} s: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in split.items()
    ) + " (device time between CUDA events around each call; the rest is host work)")
    run["votes_split"] = split
    return run


def phase_polish_mesh(device, work_dir, pol, genome_size=1_000_000):
    """Phase 9's CLI run (-p 2 --device-poa-batches 8) with the Polisher
    forced onto a virtual mesh of 4 shards on one card (Polisher.MESH):
    phase 9's contig, byte for byte, with K2 launched on the shards."""
    from raven_tpu_torch.parallel.mesh import Mesh
    from raven_tpu_torch.polish.polisher import Polisher

    flags = ("-p", "2", "--device-poa-batches", "8", "-t", str(os.cpu_count()))
    Polisher.MESH = Mesh([device] * 4)
    try:
        run = cli_run(device, work_dir, genome_size, flags=flags)
    finally:
        Polisher.MESH = None
    require(run["k2_launches"] > 0, "the mesh polish launched K2 no time")
    require(len(run["contigs"]) == 1 and np.array_equal(run["contigs"][0], pol["contigs"][0]),
            "the mesh polish's contig differs from phase 9's")
    log(f"  the Polisher on a virtual mesh of 4 shards on one card: polish "
        f"{run['polish_s']:.3f} s against phase 9's {pol['polish_s']:.3f} s; K2 launches "
        f"{run['k2_launches']} (phase 9: {pol['k2_launches']}); phase 9's contig")
    return run


def phase_polish_default(device, work_dir, draft):
    """-p 2 as users run it: the host POA in round 0, the shift-banded
    consensus on the card (K3, K4, the K5 torch ops) in round 1."""
    flags = ("-p", "2", "-t", str(os.cpu_count()))
    split: dict = {}
    run = polish_run(device, work_dir, draft, flags, split=split)
    engines = [r["engine"] for r in run["polish_rounds"]]
    require(engines == ["host", "device"], f"polish engines {engines}")
    require(run["k3_launches"] == run["k4_launches"] == BAND_DEFAULT_LAUNCHES,
            f"the default polish launched K3 {run['k3_launches']} and K4 "
            f"{run['k4_launches']} times, not {BAND_DEFAULT_LAUNCHES} each")
    require(run["pack_launches"] == BAND_DEFAULT_GROUPS,
            f"the default polish launched band_pack {run['pack_launches']} times, not "
            f"once a group ({BAND_DEFAULT_GROUPS})")
    wall = run["consensus_calls"][-1]["seconds"]
    log(f"  shift-banded consensus call {wall:.3f} s: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in split.items()
    ) + " (host prep on the host clock; the rest device time between CUDA "
        "events around each call)")
    run["band_split"] = split
    return run


def phase_polish_banded(device, work_dir, draft):
    """-p 2 with the anchored banded device consensus in chunks of 8 x 256
    fragment rows in both rounds (the reference's `-c 8 -b`), every core for
    the host stages."""
    flags = ("-p", "2", "--device-poa-batches", "8", "--device-banded-alignment",
             "-t", str(os.cpu_count()))
    split: dict = {}
    run = polish_run(device, work_dir, draft, flags, split=split,
                     splitter=banded_consensus_split)
    engines = [r["engine"] for r in run["polish_rounds"]]
    require(engines == ["device", "device"], f"polish engines {engines}")
    require(run["k9_launches"] == run["k10_launches"] > 0,
            f"the banded polish launched K9 {run['k9_launches']} and K10 "
            f"{run['k10_launches']} times")
    wall = sum(c["seconds"] for c in run["consensus_calls"])
    log(f"  anchored banded consensus calls {wall:.3f} s: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in split.items()
    ) + " (device time between CUDA events around each call; the rest is host work)")
    run["banded_split"] = split
    return run


# ------------------------------------------------------ the end of the port
def zero_counts() -> None:
    """Every kernel's launch count (K1, K2, K3/K4, K9/K10, K12) to 0."""
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda, layout_cuda
    from raven_tpu_torch.ops import sketch_cuda

    sketch_cuda.LAUNCHES = 0
    consensus_cuda.LAUNCHES = 0
    band_cuda.LAUNCHES.update(dict.fromkeys(band_cuda.LAUNCHES, 0))
    banded_cuda.LAUNCHES.update(dict.fromkeys(banded_cuda.LAUNCHES, 0))
    layout_cuda.LAUNCHES.update(dict.fromkeys(layout_cuda.LAUNCHES, 0))


def read_counts() -> dict:
    from raven_tpu_torch.ops import band_cuda, banded_cuda, consensus_cuda, layout_cuda
    from raven_tpu_torch.ops import sketch_cuda

    return {"K1": sketch_cuda.LAUNCHES, "K2": consensus_cuda.LAUNCHES,
            "K3": band_cuda.LAUNCHES["band_forward"],
            "K4": band_cuda.LAUNCHES["mask_walk_votes"],
            "K9": banded_cuda.LAUNCHES["nw_moves_banded"],
            "K10": banded_cuda.LAUNCHES["traceback_banded"],
            "K12": layout_cuda.LAUNCHES["n_body"]}


def timed(fn):
    """(fn()'s result, its wall in seconds with the card synchronised on
    both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_entry(device, smi: str) -> dict:
    """Phase 12a: raven_tpu_torch.dryrun.entry's consensus step (K2 and the
    vote epilogue at T=128, Q=160, 8 windows) on the card, one K2 launch,
    its three vote tables bit-equal to the same fn on the CPU (the plain
    version)."""
    import torch

    from raven_tpu_torch.dryrun import entry

    fn, args = entry(device)
    zero_counts()
    got, wall = timed(lambda: fn(*args))
    launches = read_counts()["K2"]
    want, plain = timed(lambda: fn(*(a.cpu() for a in args)))
    require(launches == 1, f"entry's step launched K2 {launches} times, not once")
    require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
            "entry's vote tables on the card differ from the plain version's")
    _, steady = timed(lambda: fn(*args))
    log(f"entry (fused_votes, T=128, Q=160, 8 windows, 64 fragments) on {smi}: "
        f"{wall:.6f} s on the card for the first call (K2 launches {launches}), "
        f"{steady:.6f} s for a second; the plain version's {plain:.6f} s on the CPU; "
        "the three vote tables bit-equal")
    return {"launches": launches, "wall_s": wall, "steady_s": steady}


def phase_dryrun(device, smi: str) -> dict:
    """Phase 12b: dryrun_multichip on a virtual mesh of 8 shards on the
    card: every check, 0 declines, K1, K2, K3 and K4 launched; then the same
    dry run on Mesh(["cpu"] * 8), where every kernel is its plain version,
    and the card's results equal to the CPU's: the candidate pairs (K1),
    the DP maximum, the construct's live nodes and graph digest (K1), and
    the one-device consensus of (d) (K2) and (e) (K3, K4) bit for bit."""
    from raven_tpu_torch.dryrun import dryrun_multichip
    from raven_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([device] * 8)
    zero_counts()
    res, wall = timed(lambda: dryrun_multichip(mesh))
    launches = read_counts()
    require(res["declines"] == 0, f"{res['declines']} declines in the dry run")
    for k in ("K1", "K2", "K3", "K4"):
        require(launches[k] > 0, f"the dry run launched {k} no time: {launches}")
    t0 = time.perf_counter()
    plain = dryrun_multichip(Mesh(["cpu"] * 8))
    plain_wall = time.perf_counter() - t0
    for key in ("pairs", "dp_max", "live_nodes", "graph_digest"):
        require(res[key] == plain[key],
                f"the dry run's {key} on the card {res[key]}, on the CPU {plain[key]}")
    for key in ("consensus", "band"):
        require(len(res[key]) == len(plain[key]) and all(
            np.array_equal(g, w) for g, w in zip(res[key], plain[key])),
            f"the dry run's one-device {key} on the card differs from the CPU's")
    log(f"dry run on {mesh} on {smi}: {wall:.3f} s; {res['pairs']} candidate pairs, DP "
        f"max {res['dp_max']}, {res['live_nodes']} live nodes, {res['declines']} "
        f"declines, both consensus engines bit-equal to one device; launches "
        f"{launches} (a virtual mesh's wall, not what 8 cards would give); on "
        f"Mesh(['cpu'] * 8) with the plain versions {plain_wall:.3f} s, the same pairs, "
        f"DP max, live nodes, graph digest and one-device consensus of both engines")
    return {**res, "launches": launches, "wall_s": wall, "plain_wall_s": plain_wall}


def segment_rows(readset, device):
    """`readset` tiled into K1's halo'd segment rows of the device index
    (width 2048) on the card: codes [S, 2048] uint8, lengths and read ids
    [S] int32.  A cell in a halo is sketched by both of its rows."""
    import torch

    from raven_tpu_torch.ops.sketch import segment_reads_packed, unpack_codes
    from raven_tpu_torch.overlap.device_index import SEG_WIDTH

    packed, eff, rid, *_ = segment_reads_packed(readset, np.arange(len(readset)), K, W,
                                                width=SEG_WIDTH)
    return (unpack_codes(torch.from_numpy(packed).to(device)),
            torch.from_numpy(eff).to(device), torch.from_numpy(rid).to(device))


def phase_metrics(device, smi: str, reads115: str, reads_cli: str) -> dict:
    """Phase 12c: ops/overlap_step.py's metric functions at full size on
    the card, each held against a numpy recount of the same key-sorted
    sketch (sketch_compact's columns, copied to the host).  On
    overlap-115M's reads in segment rows: candidate_count, join_count and
    join_count_filtered (blacklist: the hashes above the occurrence
    threshold) must each give the sum of c (c - 1) / 2 over the runs of at
    most the threshold (np.unique counts; the three agree there by their
    definitions).  On cli-1M-30x's reads: overlap_candidates with
    max_hits=16 and the capacity at the kept minimizers must give the
    per-entry slot rule's columns and pair count.  Walls and rates are
    information only."""
    import torch

    from raven_tpu_torch.io import load_sequences
    from raven_tpu_torch.ops import overlap_step as ostep
    from raven_tpu_torch.ops.sketch import sketch_compact

    out = {}
    codes, lens, rids = segment_rows(load_sequences([reads115]), device)
    cells = codes.numel()
    key, ids, _, _, kept = sketch_compact(codes, lens, rids, K, W, cells)
    key_h = key.cpu().numpy()
    uniq, counts = np.unique(key_h[: int(kept)], return_counts=True)
    occ = ostep.estimate_occurrence(counts, FREQ)
    small = counts[counts <= occ]
    want = int((small * (small - 1) // 2).sum())
    blacklist = torch.from_numpy(uniq[counts > occ]).to(device)
    require(blacklist.numel() > 0, f"no hash occurs more than {occ} times")
    zero_counts()
    runs = (
        ("candidate_count", cells,
         lambda: ostep.candidate_count(codes, lens, rids, K, W, cells, occ)),
        ("join_count", cells, lambda: ostep.join_count(key, ids, occ)),
        ("join_count_filtered", cells,
         lambda: ostep.join_count_filtered(key, blacklist, occ)),
    )
    for name, n, call in runs:
        got, wall = timed(call)
        require(int(got) == want, f"{name} gave {int(got)}, the numpy recount {want}")
        out[name] = {"entries": n, "pairs": want, "wall_s": wall}
        log(f"{name} on overlap-115M ({codes.shape[0]} segment rows, {n} entries, "
            f"{int(kept)} kept minimizers, occurrence {occ}, blacklist "
            f"{blacklist.numel()}) on {smi}: {wall:.4f} s, {n / wall:.1f} entries/s, "
            f"{want} pairs, the numpy recount's")
    out["k1_launches_115M"] = read_counts()["K1"]
    del codes, lens, rids, key, ids, blacklist, key_h

    codes, lens, rids = segment_rows(load_sequences([reads_cli]), device)
    key, ids, pos, sb, kept = sketch_compact(codes, lens, rids, K, W, codes.numel())
    cap, hits = int(kept), 16
    key_h, ids_h, pos_h, sb_h = (c[:cap].cpu().numpy() for c in (key, ids, pos, sb))
    occ2 = ostep.estimate_occurrence(np.unique(key_h, return_counts=True)[1], FREQ)
    zero_counts()
    got, wall = timed(lambda: ostep.overlap_candidates(codes, lens, rids, K, W, cap, hits,
                                                       occ2))
    launches = read_counts()["K1"]
    # the numpy recount: each entry's slots [lo, lo + hits) of its bucket
    lo = np.searchsorted(key_h, key_h, "left")
    hi = np.searchsorted(key_h, key_h, "right")
    slot = lo[:, None] + np.arange(hits)[None, :]
    in_range = slot < hi[:, None]
    np.clip(slot, 0, cap - 1, out=slot)
    t_id = ids_h[slot]
    valid = in_range & ((hi - lo <= occ2)[:, None]) & (t_id > ids_h[:, None])
    want_cols = (np.broadcast_to(ids_h[:, None], slot.shape),
                 np.broadcast_to(pos_h[:, None], slot.shape), t_id, pos_h[slot],
                 (sb_h[slot] == sb_h[:, None]).astype(np.int32), valid)
    names = ("q_id", "q_pos", "t_id", "t_pos", "same", "valid")
    for name, g, w in zip(names, got[:6], want_cols):
        require(np.array_equal(g.cpu().numpy().reshape(slot.shape), w),
                f"overlap_candidates' {name} differs from the numpy recount")
    pairs = int(valid.sum())
    require(int(got[6]) == pairs > 0,
            f"overlap_candidates counted {int(got[6])} pairs, the recount {pairs}")
    out["overlap_candidates"] = {"entries": cap, "slots": cap * hits, "pairs": pairs,
                                 "wall_s": wall, "k1_launches": launches}
    out["k1_launches"] = out["k1_launches_115M"] + launches
    log(f"overlap_candidates on cli-1M-30x ({codes.shape[0]} segment rows, {cap} kept "
        f"minimizers, max_hits {hits}, occurrence {occ2}) on {smi}: {wall:.4f} s, "
        f"{pairs / wall:.1f} pairs/s, {cap * hits / wall:.1f} slots/s, {pairs} pairs; "
        f"the numpy recount's six columns and count; K1 launches {launches}")
    return out


# -------------------------------------------------------------------- main
def run() -> dict:
    import torch

    t_run = time.perf_counter()
    require(torch.cuda.is_available(), "no CUDA device: this run needs one card")
    try:
        sys.path.insert(0, REPO)
        from raven_tpu_torch import csrc, native
        from raven_tpu_torch.utils.synth import synth_reads
    except ImportError as e:
        raise SmokeFailure(f"raven_tpu_torch is not beside chip_smoke.py ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # the host library first (the host child needs it), then the host
    # child, which runs while nvcc builds K1; neither touches CUDA
    t0 = time.perf_counter()
    native.build()
    log(f"host C++ library build: {time.perf_counter() - t0:.2f} s")
    work = os.path.join(REPO, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    child_out = os.path.join(work, "host_overlap.json")
    genome, cov = 2_300_000, 50
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--host-overlap",
         child_out, str(genome), str(cov)],
        cwd=REPO,
    )
    try:
        csrc.build_all(["sketch", "consensus", "band", "banded", "layout"])
        for name in ("sketch", "consensus", "band", "banded", "layout"):
            log(f"nvcc {name}.cu: done {csrc.BUILD_SECONDS.get(name, 0.0):.2f} s "
                f"after the builds started (0 when build/cuda/lib{name}.so was "
                "up to date)")
            for line in csrc.BUILD_LOG.get(name, "").splitlines():
                if "Compiling entry" in line or "registers" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        readset = synth_reads(genome, cov, 9000, 0.10)

        device = "cuda"
        k1 = phase_sketch(readset, device)
        ov = phase_overlap(readset, device, child, child_out)
        shd = phase_sharded(readset, device, ov)
        reads115 = write_readset(readset, os.path.join(work, "overlap115.fa"))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    del readset
    main_path, repeat_path = phase_cli(device, work)
    api_run = phase_api(device, work)
    mp = phase_multiprocess(work, reads115, ov, shd)
    dsk = phase_device_sketch(device, mp["reads"])
    lay = phase_layout(device, smi, repeat_path["n_body_inputs"])
    k2 = phase_votes(device)
    k3, k4 = phase_band(device)
    bpk = phase_band_pack(device)
    k9, k10 = phase_banded(device, k2["ms"])
    mv = phase_mesh_votes(device)
    pol = phase_polish(device, work, main_path["contigs"][0])
    pol_mesh = phase_polish_mesh(device, work, pol)
    dflt = phase_polish_default(device, work, main_path["contigs"][0])
    bnd = phase_polish_banded(device, work, main_path["contigs"][0])
    ent = phase_entry(device, smi)
    dry = phase_dryrun(device, smi)
    met = phase_metrics(device, smi, reads115, mp["reads"])
    wid = phase_widths(device)
    sw = phase_switches(device, work, main_path["contigs"][0], pol)
    phase_budget()
    past = phase_past_limits(device, smi)

    def widths(cases, kernel):
        # a timed case's measurements, the other cases' shapes: all bit-equal
        return [{"case": c["case"], "shape": c["shape"], "max_abs_err": c["max_abs_err"],
                 **c.get(kernel, {})} for c in cases]

    kernels = [{
        "name": "segment_sketch",
        "launches_multiprocess": {r: n["K1"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/sketch.cu",
        "replaces": "raven_tpu/ops/pallas_sketch.py:125",
        "launches": main_path["launches"],
        "launches_overlap_stage": ov["launches"],
        "launches_repeat_cli": repeat_path["launches"],
        "launches_polish_cli": pol["launches"],
        "launches_default_polish_cli": dflt["launches"],
        "launches_banded_polish_cli": bnd["launches"],
        "launches_api_substages": api_run["launches"],
        "launches_sharded_overlap_stage": shd["launches"],
        "launches_mesh_polish_cli": pol_mesh["launches"],
        "launches_device_sketch": dsk["launches"],
        "launches_dryrun": dry["launches"]["K1"],
        "launches_metrics": met["k1_launches"],
        "equal": True,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "device_ms": k1["device_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "shape": k1["shape"],
    }, {
        "name": "window_consensus_votes",
        "launches_multiprocess": {r: n["K2"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/consensus.cu",
        "replaces": "raven_tpu/ops/pallas_consensus.py:237",
        "launches": pol["k2_launches"],
        "launches_mesh_votes": mv["full-NW"]["launches"]["K2"],
        "launches_mesh_polish_cli": pol_mesh["k2_launches"],
        "launches_entry": ent["launches"],
        "launches_dryrun": dry["launches"]["K2"],
        "launches_shiftband_polish": sw["k2_launches"],
        "equal": True,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "device_ms": k2["device_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "shape": k2["shape"],
        "padded_bound_ms": k2["padded_bound_ms"],
        "cells": k2["cells"],
        "computed_cells": k2["computed_cells"],
    }, {
        "name": "band_forward",
        "launches_multiprocess": {r: n["K3"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/band.cu",
        "replaces": "raven_tpu/ops/consensus_band.py:97",
        "launches": dflt["k3_launches"],
        "launches_mesh_votes": mv["shift-banded"]["launches"]["K3"],
        "launches_dryrun": dry["launches"]["K3"],
        "launches_shiftband_polish": sw["k3_launches"],
        "equal": True,
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "device_ms": k3["device_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
        "shape": k3["shape"],
        "widths_bit_equal": list(BAND_SWEEP),
        "widths": widths(wid["band"], "K3"),
    }, {
        "name": "band_pack",
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/band.cu",
        "replaces": None,  # the host's pack_shifted_fragments, no TPU kernel
        "launches": dflt["pack_launches"],
        "launches_phase_7b": bpk["launches"],
        "library_ms": None,
        **{k: v for k, v in bpk.items() if k != "launches"},
    }, {
        "name": "band_walk_votes",
        "launches_multiprocess": {r: n["K4"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/band.cu",
        "replaces": "raven_tpu/ops/consensus_band.py:172",
        "launches": dflt["k4_launches"],
        "launches_mesh_votes": mv["shift-banded"]["launches"]["K4"],
        "launches_dryrun": dry["launches"]["K4"],
        "launches_shiftband_polish": sw["k4_launches"],
        "equal": True,
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "device_ms": k4["device_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "shape": k4["shape"],
        "widths_bit_equal": list(BAND_SWEEP),
        "widths": widths(wid["band"], "K4"),
    }, {
        "name": "nw_moves_banded",
        "launches_multiprocess": {r: n["K9"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/banded.cu",
        "replaces": "raven_tpu/ops/consensus_device.py:163",
        "launches": bnd["k9_launches"],
        "launches_mesh_votes": mv["banded"]["launches"]["K9"],
        "equal": True,
        "max_abs_err": k9["max_abs_err"],
        "ms": k9["ms"],
        "plain_ms": k9["plain_ms"],
        "device_ms": k9["device_ms"],
        "bound_ms": k9["bound_ms"],
        "bound_by": k9["bound_by"],
        "library_ms": None,
        "shape": k9["shape"],
        "k2_ms_same_chunk": k9["k2_ms"],
        "widths": widths(wid["banded"], "K9"),
    }, {
        "name": "traceback_banded",
        "launches_multiprocess": {r: n["K10"] for r, n in mp["launches"].items()},
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/banded.cu",
        "replaces": "raven_tpu/ops/consensus_device.py:304",
        "launches": bnd["k10_launches"],
        "launches_mesh_votes": mv["banded"]["launches"]["K10"],
        "equal": True,
        "max_abs_err": k10["max_abs_err"],
        "ms": k10["ms"],
        "plain_ms": k10["plain_ms"],
        "device_ms": k10["device_ms"],
        "bound_ms": k10["bound_ms"],
        "bound_by": k10["bound_by"],
        "library_ms": None,
        "shape": k10["shape"],
        "widths": widths(wid["banded"], "K10"),
    }]
    k12 = lay["cases"][600]
    kernels.append({
        "name": "layout_n_body",
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/layout.cu",
        "replaces": "raven_tpu/graph/layout.py:89",
        "launches": repeat_path["k12_launches"],
        "launches_repeat_cli": repeat_path["k12_launches"],
        "launches_remove_long_edges": lay["launches"],
        "n_body_runs_repeat_cli": repeat_path["layout_runs"],
        "equal": True,
        "max_abs_err": lay["max_abs_err"],
        "ms": k12["ms"],
        "plain_ms": k12["plain_ms"],
        "device_ms": k12["device_ms"],
        "bound_ms": k12["bound_ms"],
        "bound_by": k12["bound_by"],
        "library_ms": None,
        "shape": k12["shape"],
        "iterations": k12["iterations"],
        "plan": k12["plan"],
        "at_1500": {key: lay["cases"][1500][key] for key in (
            "ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "shape", "plan")},
        "bit_equal_cases": lay["checked"],
        "sampled_rows": lay["sampled"],
        "nbody_100_s": lay["nbody_100_s"],
    })
    # the routes past the old limits, timed at phase 13(d)'s full batch (K9's
    # global route at q_pad 65,536); their launches are 13(d)'s engine calls'
    fb = past["full_batch"]["kernels"]
    require((fb["K2"]["route"], fb["K3"]["route"], fb["K4"]["route"], fb["K9"]["route"]) == (
        "votes_primitives_i32", "band_forward_wide", "mask_walk_votes_direct", "nw_moves_banded"),
        f"the full batch took other routes: {[(k, v['route']) for k, v in fb.items()]}")
    cases = past["cases"]
    k9g = cases["K9_global"]
    require(k9g["route"] == "nw_moves_banded_global", f"K9 at q_pad 65,536 took {k9g['route']}")
    bg = cases["band_global"]
    require([c["routes"] for c in bg] == [["band_forward_global", "mask_walk_votes_direct"]]
            * len(PAST_BAND_GLOBAL), f"K3/K4 past BW 16,384 took {[c['routes'] for c in bg]}")
    errs = {"votes_primitives_i32": [*cases["K2"], cases["K2_neg"]],
            "band_forward_wide": cases["band"], "band_forward_global": bg,
            "mask_walk_votes_direct": [*cases["band"], *bg],
            "nw_moves_banded_global": cases["banded"]}
    for name, route, source, replaces, t in (
        ("window_consensus_votes_i32", "votes_primitives_i32", "consensus.cu",
         "raven_tpu/ops/pallas_consensus.py:237", fb["K2"]),
        ("band_forward_wide", "band_forward_wide", "band.cu",
         "raven_tpu/ops/consensus_band.py:97", fb["K3"]),
        ("band_forward_global", "band_forward_global", "band.cu",
         "raven_tpu/ops/consensus_band.py:97", {**bg[-1]["K3"], "shape": bg[-1]["shape"]}),
        ("band_walk_votes_direct", "mask_walk_votes_direct", "band.cu",
         "raven_tpu/ops/consensus_band.py:172", fb["K4"]),
        ("nw_moves_banded_global", "nw_moves_banded_global", "banded.cu",
         "raven_tpu/ops/consensus_device.py:163", k9g),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"raven_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": past["launches"][route],
            "launches_before_phase_13d": past["launches_before"][route],
            "equal": True, "max_abs_err": max(c["max_abs_err"] for c in errs[route]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "device_ms": t["device_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"],
        })
    named = {k["name"]: k for k in kernels}  # the first routes past the old limits
    named["window_consensus_votes"]["past_limit_cases"] = cases["K2"]
    named["window_consensus_votes_i32"]["past_q_262143"] = cases["K2_neg"]
    named["band_forward_global"]["widths"] = [{"shape": c["shape"], **c["K3"]} for c in bg]
    named["band_walk_votes_direct"]["past_bw_16384"] = [{"shape": c["shape"], **c["K4"]}
                                                        for c in bg]
    named["nw_moves_banded"]["full_batch"] = fb["K9"]
    named["traceback_banded"]["full_batch"] = fb["K10"]
    named["traceback_banded"]["wrapped_band_starts"] = cases["K10_wrapped"]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--host-overlap":
        sys.path.insert(0, REPO)
        return host_overlap_main(
            sys.argv[2], int(sys.argv[3]), float(sys.argv[4])
        )
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
