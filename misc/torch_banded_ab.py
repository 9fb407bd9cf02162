#!/usr/bin/env python3
"""Time two builds of the anchored banded kernels (K9, K10) side by side.

    python3 misc/torch_banded_ab.py OTHER_BANDED_CU

builds OTHER_BANDED_CU (another version of raven_tpu_torch/csrc/banded.cu
with the same C interface, such as an earlier commit's, unpacked with `git
archive`) beside the checkout's own, and on one CUDA card, at the bank
chunk of chip_smoke.py's phase 8 ([B, T, Q, BW] = [2048, 640, 768, 256],
full spans):

  * holds both builds bit for bit to the plain versions on every output;
  * times K9 and K10 of each through the public wrappers
    (raven_tpu_torch.ops.banded_cuda), in turns (this, other, other,
    this), in two ways: chip_smoke.cuda_ms (one call between two CUDA
    events, the wrapper's host work before its launch included) and
    chip_smoke.device_ms (the kernel's own time in a torch.profiler trace).

Prints the card's name and power limit, one line a measurement and a last
line of JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from raven_tpu_torch import csrc
    from raven_tpu_torch.ops import banded_cuda as bc

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other_src = os.path.abspath(sys.argv[1])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip(), flush=True)

    csrc.build_all(["banded"])
    other_so = os.path.join(csrc.build_dir(), "libbanded_other.so")
    out = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", other_so, other_src],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        print(f"nvcc {other_src} failed:\n{out.stdout}{out.stderr}", file=sys.stderr)
        return 1
    # the wrappers' typed C functions for each build: banded_cuda._fns()
    # types whatever csrc.load returns
    fns = {"this": bc._fns()}
    load = csrc.load
    try:
        csrc.load = lambda name: ctypes.CDLL(other_so)
        bc._FNS = None
        fns["other"] = bc._fns()
    finally:
        csrc.load = load

    T, BW = cs.BANDED_T, cs.BANDED_BW
    cw, tl, fr, ql, r0, r1, wt = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                  for a in cs.banded_cases()[0][1])
    B, Q = fr.shape
    fwd_want = bc.nw_moves_banded_plain(cw, tl, fr, ql, r0, r1, T, Q, BW)
    walk_want = bc.traceback_banded_plain(*fwd_want, ql, fr, wt, T, Q, BW)

    def k9():
        return bc.nw_moves_banded(cw, tl, fr, ql, r0, r1, T, Q, BW)

    def k10():
        return bc.traceback_banded(*fwd_want, ql, fr, wt, T, Q, BW)

    for build, f in fns.items():
        bc._FNS = f
        for name, fn, want in (("K9", k9, fwd_want), ("K10", k10, walk_want)):
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"{name} of the {build} build differs from its plain version",
                      file=sys.stderr)
                return 1
    print(f"both builds bit-equal to the plain versions at [B, T, Q, BW] = "
          f"[{B}, {T}, {Q}, {BW}]", flush=True)

    res = {b: {"K9": {"cuda_ms": [], "device_ms": []},
               "K10": {"cuda_ms": [], "device_ms": []}} for b in fns}
    for build in ("this", "other", "other", "this"):
        bc._FNS = fns[build]
        for name, fn, kernel in (("K9", k9, "nw_moves_banded_kernel"),
                                 ("K10", k10, "traceback_banded_kernel")):
            res[build][name]["cuda_ms"].append(cs.cuda_ms(fn))
            res[build][name]["device_ms"].append(cs.device_ms(fn, kernel))
    bc._FNS = None
    for build in ("other", "this"):
        src = other_src if build == "other" else csrc.source("banded")
        for name in ("K9", "K10"):
            r = res[build][name]
            print(f"{build} ({os.path.relpath(src, REPO)}) {name}: cuda_ms "
                  + " / ".join(f"{t:.4f}" for t in r["cuda_ms"]) + " ms, device_ms "
                  + " / ".join(cs.fmt_ms(t) for t in r["device_ms"]), flush=True)
    print(json.dumps({"shape": [B, T, Q, BW], "other": other_src, "times": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
