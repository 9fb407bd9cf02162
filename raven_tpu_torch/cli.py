"""Command-line interface, mirroring the reference CLI surface.

The torch port of raven_tpu/cli.py: the same flags and defaults, plus
`--device` (default cuda).  Reference: RavenExe/src/main.cc:16-223 — same
run order: [resume] -> load sequences -> construct -> assemble -> GFA dumps
-> polish -> GFA dumps -> unitig FASTA to stdout.  Polishing (`-p` above 0)
runs raven_tpu's hybrid schedule: host POA rounds, then the shift-banded
device consensus in the last round; `--device-poa-batches B` selects the
full-NW device consensus for every round instead, and
`--device-banded-alignment` its anchored banded form (in every round with
`--device-poa-batches`, else in the last).
"""

from __future__ import annotations

import argparse
import sys
import time

from raven_tpu_torch import __version__
from raven_tpu_torch.config import (
    GLOBALS,
    AlignCfg,
    DeviceCfg,
    OverlapPhaseCfg,
    PolishCfg,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raven-tpu-torch",
        description=(
            "De novo genome assembler for long uncorrected reads "
            "(PyTorch/CUDA port of raven-tpu)"
        ),
    )
    p.add_argument(
        "sequences", nargs="*", help="input FASTA/FASTQ files (optionally .gz)"
    )
    p.add_argument("-k", "--kmer-len", type=int, default=15)
    p.add_argument("-w", "--window-len", type=int, default=5)
    p.add_argument("-f", "--frequency", type=float, default=0.001)
    p.add_argument("--identity", type=float, default=0.0)
    p.add_argument(
        "-o", "--kMaxNumOverlaps", dest="max_overlaps", type=int, default=32
    )
    p.add_argument(
        "-M", "--use-micromizers", dest="minhash", action="store_true"
    )
    p.add_argument("-p", "--polishing-rounds", type=int, default=2)
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-n", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument("-u", "--min-unitig-size", type=int, default=9999)
    p.add_argument("--device-poa-batches", type=int, default=0)
    p.add_argument("--device-alignment-batches", type=int, default=0)
    p.add_argument("--device-banded-alignment", action="store_true")
    p.add_argument("-F", "--graphical-fragment-assembly", default="")
    p.add_argument("-U", "--unitig-graphical-fragment-assembly", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--disable-checkpoints", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument(
        "--device",
        default="cuda",
        help="device for the overlap index, the layout and the polish "
        "(cuda or cpu)",
    )
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv: list[str] | None = None, timings: dict | None = None) -> int:
    """Run the CLI; `timings`, when given, receives the construct, assemble
    and polish walls in seconds ("construct_s", "assemble_s", "polish_s")
    and each polish round's wall and engine ("polish_rounds")."""
    args = build_parser().parse_args(argv)
    if not args.sequences and not args.resume:
        build_parser().print_help()
        return 0

    from raven_tpu_torch.device import resolve_device
    from raven_tpu_torch.graph import (
        Graph,
        assemble,
        construct_graph,
        get_unitigs,
        load_graph,
        print_gfa,
        print_unitig_gfa,
    )
    from raven_tpu_torch.graph.common import unitig_record_name
    from raven_tpu_torch.io import load_sequences
    from raven_tpu_torch.polish import polish

    device = resolve_device(args.device)
    GLOBALS.min_unitig_size = args.min_unitig_size
    GLOBALS.num_threads = args.threads  # fork-pool worker count (main.cc:102)
    t_start = time.perf_counter()

    graph = Graph()
    if args.resume:
        try:
            graph = load_graph()
        except Exception as e:
            print(f"[raven_tpu_torch::] error loading checkpoint: {e}", file=sys.stderr)
            return 1
        print(
            f"[raven_tpu_torch::] loaded previous run "
            f"{time.perf_counter() - t_start:.6f}s",
            file=sys.stderr,
        )

    # sequences needed unless resuming past construct with polishing done
    readset = None
    if graph.stage < -3 or args.polishing_rounds > max(0, graph.stage):
        t0 = time.perf_counter()
        try:
            readset = load_sequences(args.sequences)
        except Exception as e:
            print(str(e), file=sys.stderr)
            return 1
        if len(readset) == 0:
            print("[raven_tpu_torch::] error: empty sequences set", file=sys.stderr)
            return 1
        print(
            f"[raven_tpu_torch::] loaded {len(readset)} sequences "
            f"{time.perf_counter() - t0:.6f}s",
            file=sys.stderr,
        )

    checkpoints = not args.disable_checkpoints
    cfg = OverlapPhaseCfg(
        kmer_len=args.kmer_len,
        window_len=args.window_len,
        freq=args.frequency,
        identity=args.identity,
        max_num_overlaps=args.max_overlaps,
        use_minhash=args.minhash,
    )
    t0 = time.perf_counter()
    if readset is not None:
        construct_graph(graph, readset, cfg, checkpoints, device=device)
    t1 = time.perf_counter()
    assemble(graph, checkpoints, device=device)
    t2 = time.perf_counter()
    if readset is not None:
        polish(
            graph,
            readset,
            PolishCfg(
                align_cfg=AlignCfg(args.match, args.mismatch, args.gap),
                device_cfg=DeviceCfg(
                    args.device_poa_batches,
                    args.device_alignment_batches,
                    args.device_banded_alignment,
                ),
                num_rounds=args.polishing_rounds,
            ),
            checkpoints,
            device=device,
            timings=timings,
        )
    t3 = time.perf_counter()
    if timings is not None:
        timings["construct_s"] = t1 - t0
        timings["assemble_s"] = t2 - t1
        timings["polish_s"] = t3 - t2

    print_gfa(graph, args.graphical_fragment_assembly)
    if args.unitig_graphical_fragment_assembly:
        print_unitig_gfa(graph, args.unitig_graphical_fragment_assembly)

    for node in get_unitigs(graph, args.polishing_rounds > 0):
        sys.stdout.write(f">{unitig_record_name(node)}\n")
        sys.stdout.write(node.sequence_str() + "\n")

    print(
        f"[raven_tpu_torch::] {time.perf_counter() - t_start:.6f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
