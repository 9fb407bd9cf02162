#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (raven_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one, and outside a checkout
of the repository) and the CUDA toolkit's nvcc.  Phases, each fatal on
failure:

  1. the card, the versions, the builds (the host C++ library, then K1
     with nvcc for sm_90a);
  2. kernel K1 (segment sketch, csrc/sketch.cu) against its plain torch
     version on the card, bit for bit, at (k, w) = (15, 5) and (11, 3), on
     a chunk of real segment rows [8192, 2048] and a ragged row count;
     median times over CUDA events beside the bound;
  3. the overlap stage on bench.py's workload (2.3 Mb genome at 50x,
     ~115 Mbp): minimize -> filter -> map_many on the card, cold and
     steady, its overlap digest held against the port's host path run in
     a child process started before this process touches CUDA; one more
     steady pass under torch.profiler gives the device's busy share and
     the ops that take the most device time;
  4. the main path: `raven_tpu_torch.cli.main([reads, "-p", "0", ...])` on
     a 1 Mb genome at 30x with indels, which must give one contig of at
     least 0.97 of the genome with every overlap index built by K1; then
     again on a 1 Mb genome with a repeat family, whose junction component
     (512 nodes or more) must send the layout n-body to the card;
  5. the layout n-body against the float64 host loop on the card, and
     through the assemble stage remove_long_edges on a 601-node junction
     component built by hand;
  6. a `kernels` JSON line, the card's name and power limit, and the last
     line {"ok": true, "device": {...}}.
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
    """Median milliseconds of fn() over `runs` CUDA-event-timed calls."""
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
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by, "shape": [S, 2048]}
    return main


def overlap_stage(readset, device):
    import torch

    from raven_tpu_torch.overlap.engine import MinimizerIndex

    ids = np.arange(len(readset))
    t0 = time.perf_counter()
    idx = MinimizerIndex(K, W, device=device)
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
    profile_overlap(readset, device)
    log(
        f"overlap stage ({len(readset)} reads, {bases} bases): cold "
        f"{cold:.3f} s (minimize {parts_c[0]:.3f}, filter {parts_c[1]:.3f}, "
        f"map {parts_c[2]:.3f}), steady {steady:.3f} s (minimize "
        f"{parts_s[0]:.3f}, filter {parts_s[1]:.3f}, map {parts_s[2]:.3f}); "
        f"{bases / steady:.1f} bases/s steady; {n_ov} overlaps; occurrence "
        f"{occ}; K1 launches {launches}; host declines {declines}; peak "
        f"device memory {peak} B"
    )
    require(launches > 0, "the overlap stage launched K1 no time")
    require(declines == 0, f"{declines} device-path declines")
    require(host["digest"] == digest, "overlap digest differs from the host path")
    require(host["occ"] == occ, "occurrence differs from the host path")
    log("overlap digest equal to the port's host path")
    return {"cold_s": cold, "steady_s": steady, "bases": bases,
            "bases_per_s": bases / steady, "overlaps": n_ov,
            "launches": launches}


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


def cli_run(device, work_dir, genome_size, repeat=None) -> dict:
    """One `raven_tpu_torch.cli.main([reads, "-p", "0", ...])` run on reads
    simulated at 30x (mean 9 kb, 2.5% substitutions, 1.25% insertions,
    1.25% deletions, seed 77); every count starts at 0 right before it and
    is read right after."""
    from raven_tpu_torch import cli
    from raven_tpu_torch.graph import layout
    from raven_tpu_torch.ops import sketch_cuda
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.utils.synth import simulate_reads

    rng = np.random.default_rng(77)
    genome = make_genome(rng, genome_size, repeat)
    reads = simulate_reads(rng, genome, 30, 9000, 0.025, 0.0125, 0.0125)
    path = os.path.join(work_dir, "reads.fa")
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n" % i + lut[r].tobytes() + b"\n")
    argv = [path, "-p", "0", "--disable-checkpoints", "--device", device]
    timings: dict = {}
    out = io.StringIO()
    sketch_cuda.LAUNCHES = 0
    layout.DEVICE_RUNS = 0
    MinimizerIndex.host_declines = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, timings=timings)
    wall = time.perf_counter() - t0
    run = {"launches": sketch_cuda.LAUNCHES, "layout_runs": layout.DEVICE_RUNS,
           "declines": MinimizerIndex.host_declines, "wall_s": wall, **timings}
    require(rc == 0, f"cli exited {rc}")
    lines = out.getvalue().split("\n")
    seqs = [ln for ln in lines if ln and not ln.startswith(">")]
    require(len(seqs) == sum(ln.startswith(">") for ln in lines),
            "contig FASTA is malformed")
    require(all(set(s) <= set("ACGT") for s in seqs),
            "a contig holds non-ACGT symbols")
    run["lengths"] = [len(s) for s in seqs]
    log(
        f"cli -p 0 ({len(reads)} reads, {sum(r.size for r in reads)} bases, "
        f"{genome_size} bp genome, repeat family {repeat}): construct "
        f"{timings['construct_s']:.3f} s, assemble {timings['assemble_s']:.3f} "
        f"s, wall {wall:.3f} s; contigs {len(seqs)} {run['lengths']}; K1 "
        f"launches {run['launches']}; layout n-body runs {run['layout_runs']}; "
        f"host declines {run['declines']}"
    )
    require(run["launches"] > 0, "the cli run launched K1 no time")
    require(run["declines"] == 0, f"{run['declines']} device-path declines")
    return run


def phase_cli(device, work_dir, genome_size=1_000_000):
    """The main path twice: on a repeat-free genome, which must assemble
    into one contig; and on one with a repeat family (8 copies of an 11 kb
    element, 2% apart, longer than most reads), whose collapsed copies
    leave a junction component of 512 nodes or more, so the assemble
    stage's layout runs the n-body on the card.  Such repeats cannot be
    resolved from these reads, so that run must give at most 9 contigs
    that together hold 0.97-1.1 x the genome."""
    main = cli_run(device, work_dir, genome_size)
    lengths = main["lengths"]
    require(len(lengths) == 1, f"expected 1 contig, got {len(lengths)}")
    require(lengths[0] >= 0.97 * genome_size,
            f"contig {lengths[0]} < 0.97 x {genome_size}")
    rep = cli_run(device, work_dir, genome_size, repeat=(11_000, 8, 0.02))
    require(rep["layout_runs"] > 0,
            "the layout n-body did not run on the card in the cli run")
    total = sum(rep["lengths"])
    require(len(rep["lengths"]) <= 9, f"{len(rep['lengths'])} contigs")
    require(0.97 * genome_size <= total <= 1.1 * genome_size,
            f"contigs hold {total} bp of a {genome_size} bp genome")
    return main, rep


def phase_layout(device):
    import torch

    import importlib

    from raven_tpu_torch.graph import graph as gmod
    from raven_tpu_torch.graph import layout

    # the graph package exports a function named assemble over the module
    asm = importlib.import_module("raven_tpu_torch.graph.assemble")
    n = 600
    rng = np.random.default_rng(3)
    pts = rng.random((n, 2))
    ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, 200)])
    eb = np.concatenate([np.arange(1, n), rng.integers(0, n, 200)])
    # float32 on the card against the float64 host loop: the n-body
    # amplifies rounding ~2.5x per iteration, so compare after 3, where
    # the gap is ~1e-6 on coordinates of order 1
    dev = layout._layout_component_device(pts.copy(), ea, eb, 3, device)
    host = layout._layout_component_host(pts.copy(), ea, eb, 3)
    err = float(np.abs(dev - host).max())
    log(f"layout n-body vs host loop (3 iterations, n={n}): max abs diff {err:.3g}")
    require(err < 1e-4, "device n-body disagrees with the host loop")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layout._layout_component_device(pts.copy(), ea, eb, 100, device)
    t_nbody = time.perf_counter() - t0

    g = gmod.Graph()
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
    removed = asm.remove_long_edges(g, num_rounds=1, device=device)
    runs = layout.DEVICE_RUNS
    log(
        f"remove_long_edges on a {n + 1}-node junction component: "
        f"{removed} long edges, layout n-body runs on the card {runs}, "
        f"100-iteration n-body {t_nbody:.3f} s"
    )
    require(runs > 0, "the layout n-body did not run on the card")
    return {"layout_runs": runs, "nbody_100_s": t_nbody}


# -------------------------------------------------------------------- main
def run() -> dict:
    import torch

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
        csrc.build("sketch")
        log(f"nvcc sketch.cu: {csrc.BUILD_SECONDS.get('sketch', 0.0):.2f} s "
            "(0 when build/cuda/libsketch.so was up to date)")
        readset = synth_reads(genome, cov, 9000, 0.10)

        device = "cuda"
        k1 = phase_sketch(readset, device)
        ov = phase_overlap(readset, device, child, child_out)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    del readset
    main_path, repeat_path = phase_cli(device, work)
    lay = phase_layout(device)

    kernels = [{
        "name": "segment_sketch",
        "route": "cuda",
        "source": "raven_tpu_torch/csrc/sketch.cu",
        "replaces": "raven_tpu/ops/pallas_sketch.py:125",
        "launches": main_path["launches"],
        "launches_overlap_stage": ov["launches"],
        "launches_repeat_cli": repeat_path["launches"],
        "equal": True,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "shape": k1["shape"],
    }]
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
