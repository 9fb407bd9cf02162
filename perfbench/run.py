"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
program (raven_tpu_torch).  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 the
device's busy and window seconds and a breakdown, and last the numbers
compared with their limits); the compared numbers are also the last lines
of standard error.  Exits non-zero, printing no result, without a card or
the program, or when a module of JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg: str, code: int) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr)
    sys.exit(code)


def card_and_power_limit() -> str:
    """nvidia-smi's name and power limit of the card, the rooflines'
    peaks being the published ones at the full power limit."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout's root in place of this folder: the program and the
    # perfbench package import from there
    sys.path[0] = ROOT
    spec_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(spec_path):
        fail(f"no BENCHMARK.json at {ROOT}", 2)
    with open(spec_path) as fh:
        spec = json.load(fh)
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r}; cells: {sorted(cells)}", 2)
    try:
        import raven_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}", 2)
    if not os.path.abspath(raven_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"raven_tpu_torch comes from {raven_tpu_torch.__file__}, not this checkout", 2)
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} card(s); CUDA available: {torch.cuda.is_available()}, "
             f"cards: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)

    from perfbench import harness

    result = harness.run_cell(spec, ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}", 4)
    print(f"[perfbench] card: {card_and_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[perfbench] check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
