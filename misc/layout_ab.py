#!/usr/bin/env python3
"""Time the layout n-body of two trees of the port side by side.

    python3 misc/layout_ab.py OTHER_TREE

OTHER_TREE is the root of another tree of this repository's files (such as
an earlier commit's, unpacked with `git archive` into tree_check/, which
.gitignore lists).  In turns (other, this, this, other), each in a child
process on one CUDA card, times
raven_tpu_torch.graph.layout._layout_component_device at 600 and 1,500
points x 100 iterations (chip_smoke.n_body_case's components): the host
wall from numpy points in to numpy points out with the card synchronised
on both sides, the median of 5 calls after one warm-up (which builds a
kernel where the tree has one), and the device time of a call, the n-body
kernels' launches summed in a torch.profiler trace (the median of 5
calls).  Prints the card's name and power limit, one line a measurement
and a last line of JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (600, 1500)
ITERS = 100


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raven_tpu_torch.graph import layout

    out = {}
    for n in SIZES:
        rng = np.random.default_rng(3)
        pts = rng.random((n, 2))
        ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, 200)])
        eb = np.concatenate([np.arange(1, n), rng.integers(0, n, 200)])
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layout._layout_component_device(pts.copy(), ea, eb, ITERS, "cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        device = []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                layout._layout_component_device(pts.copy(), ea, eb, ITERS, "cuda")
                torch.cuda.synchronize()
            device.append(sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                              if e.device_type == DeviceType.CUDA and "n_body" in e.name))
        out[n] = {"wall_s": statistics.median(walls[1:]), "first_s": walls[0],
                  "device_ms": statistics.median(device)}
    print(json.dumps(out))


def main() -> int:
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    runs = []
    for tag, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, timeout=900, cwd=tree)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tag, **got})
        for n, r in got.items():
            print(f"{tag} ({tree}) n-body at {n} points x {ITERS} iterations on {smi}: "
                  f"{r['wall_s']:.4f} s (first call {r['first_s']:.3f} s), device "
                  f"{r['device_ms']:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
