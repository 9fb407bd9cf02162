"""The controls of the cells' checks: the plain reference put in the
program's place with one guarantee that the configuration states broken
(each stage's `control`), judged by the same comparison as a run.

    python3 perfbench/control.py --workload <cell> --seeds <n>[,<n>...]
        [--controls <name>[,<name>...]] [--device cuda:0]

prints one JSON line per seed and control (every control of the cell's
stage unless --controls names some) with the numbers compared and their
limits; a sound control fails at least one of them.  The inputs of a seed
are made once for all its controls.  The benchmark's runs do not
run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from perfbench import harness

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic, stage = harness.load_cell(spec, ROOT, args.workload)
    kinds = args.controls.split(",") if args.controls else list(stage.CONTROLS)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(config, traffic, seed, args.device, False)
        state = stage.inputs(ctx)
        for kind in kinds:
            t0 = time.perf_counter()
            stage.control(state, ctx, kind)
            checks, _ = stage.check(state, ctx)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": kind,
                              "control_fails": any(v > lim for v, lim in checks.values()),
                              "checks": {k: {"value": v, "limit": lim}
                                         for k, (v, lim) in checks.items()},
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
