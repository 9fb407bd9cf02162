#!/usr/bin/env python3
"""Time two builds of the consensus kernels (K2 in consensus.cu; K3, K4 in
band.cu; K9, K10 in banded.cu) side by side.

    python3 misc/torch_kernel_ab.py OTHER_CSRC_DIR

builds OTHER_CSRC_DIR's consensus.cu, band.cu and banded.cu (another
version of raven_tpu_torch/csrc, such as an earlier commit's, unpacked
with `git archive`) beside the checkout's own, and on one CUDA card, at
the main path's shapes of chip_smoke.py's phases 6, 7 and 8 (K2 on the
bank chunk, [B, T, Q] = [2048, 640, 768]; K3/K4 on the bank group, [B, T,
BW] = [4096, 640, 256]; K9/K10 on the bank chunk, [B, T, Q, BW] = [2048,
640, 768, 256]), and K3 at phase 13(a)'s other widths
(chip_smoke.BAND_WIDTHS, on the bank's first 128 windows):

  * holds both builds bit for bit to the plain versions on every output;
  * times each kernel of each build through the public wrappers, in turns
    (this, other, other, this), in two ways: chip_smoke.cuda_ms (one call
    between two CUDA events, the wrapper's host work before its launch
    included) and chip_smoke.device_ms (the kernel's own time in a
    torch.profiler trace).

These shapes take each wrapper's first route; a build that lacks a
launcher of a later route (an older source) raises only if that launcher
is called.  Prints the card's name and power limit, one line a
measurement and a last line of JSON.
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


def _build(name: str, src: str) -> ctypes.CDLL:
    """nvcc `src` into build/cuda/lib<name>_other.so and load it."""
    from raven_tpu_torch import csrc

    so = os.path.join(csrc.build_dir(), f"lib{name}_other.so")
    out = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", so, src],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    lib.raven_cuda_error_string.restype = ctypes.c_char_p
    lib.raven_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


class _Missing:
    """A launcher the other build does not have: raises when called."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args):
        raise RuntimeError(f"the other build has no {self.name}")


class _Lib:
    """`lib` with _Missing in place of the launchers it lacks."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib

    def __getattr__(self, name: str):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return _Missing(name)


def _typed(mod, lib):
    """`mod._fns()` for `lib`, the launchers typed as the wrapper types
    them."""
    from raven_tpu_torch import csrc

    load = csrc.load
    try:
        csrc.load = lambda name: _Lib(lib)
        mod._FNS = None
        return mod._fns()
    finally:
        csrc.load = load
        mod._FNS = None


def main() -> int:
    import torch

    from raven_tpu_torch import csrc
    from raven_tpu_torch.ops import band_cuda as bc
    from raven_tpu_torch.ops import banded_cuda as bdc
    from raven_tpu_torch.ops import consensus_cuda as cc
    from raven_tpu_torch.utils.synth import make_windows

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other_dir = os.path.abspath(sys.argv[1])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip(), flush=True)

    csrc.build_all(["consensus", "band", "banded"])
    fns = {}
    for mod, name in ((cc, "consensus"), (bc, "band"), (bdc, "banded")):
        other_src = os.path.join(other_dir, f"{name}.cu")
        fns[name] = {"this": mod._fns(), "other": _typed(mod, _build(name, other_src))}

    T, BW = cs.BAND_T, cs.BAND_BW
    cw, tl, fw, ql, r0 = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                          for a in cs.band_cases()[0][1])
    band_want = bc.band_forward_plain(cw, tl, fw, ql, r0, T, BW)
    TB = cs.BANDED_T
    bcw, btl, bfr, bql, br0, br1, bwt = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                         for a in cs.banded_cases()[0][1])
    Q = bfr.shape[1]
    banded_want = bdc.nw_moves_banded_plain(bcw, btl, bfr, bql, br0, br1, TB, Q, BW)
    k2 = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in cs.consensus_chunk()[0]]
    kernels = [
        ("K2", cc, "consensus", "votes_primitives_kernel",
         lambda: cc.votes_primitives(*k2), cc.votes_primitives_plain(*k2)),
        ("K3", bc, "band", "band_forward_kernel",
         lambda: bc.band_forward(cw, tl, fw, ql, r0, T, BW), band_want),
        ("K4", bc, "band", "band_walk_kernel",
         lambda: bc.mask_walk_votes(*band_want, fw, ql, r0, T, BW),
         bc.mask_walk_votes_plain(*band_want, fw, ql, r0, T, BW)),
        ("K9", bdc, "banded", "nw_moves_banded_kernel",
         lambda: bdc.nw_moves_banded(bcw, btl, bfr, bql, br0, br1, TB, Q, BW), banded_want),
        ("K10", bdc, "banded", "traceback_banded_kernel",
         lambda: bdc.traceback_banded(*banded_want, bql, bfr, bwt, TB, Q, BW),
         bdc.traceback_banded_plain(*banded_want, bql, bfr, bwt, TB, Q, BW)),
    ]
    windows, _ = make_windows(512, 500, 30, np.random.default_rng(21))
    for W in cs.BAND_WIDTHS:
        wa = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in cs.band_layout(windows[:128], W)]
        kernels.append((f"K3 at BW {W}", bc, "band", "band_forward_kernel",
                        lambda wa=wa, W=W: bc.band_forward(*wa, T, W),
                        bc.band_forward_plain(*wa, T, W)))
    for build in ("this", "other"):
        for name, mod, src, _, fn, want in kernels:
            mod._FNS = fns[src][build]
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"{name} of the {build} build differs from its plain version",
                      file=sys.stderr)
                return 1
    print("both builds bit-equal to the plain versions at [B, T, Q] = "
          f"{list(k2[0].shape) + [k2[2].shape[1]]}, [B, T, BW] = [{cw.shape[0]}, {T}, {BW}] "
          f"and [B, T, Q, BW] = [{bcw.shape[0]}, {TB}, {Q}, {BW}], K3 at BW {cs.BAND_WIDTHS}",
          flush=True)

    res = {b: {k[0]: {"cuda_ms": [], "device_ms": []} for k in kernels}
           for b in ("this", "other")}
    for build in ("this", "other", "other", "this"):
        for name, mod, src, kernel, fn, _ in kernels:
            mod._FNS = fns[src][build]
            res[build][name]["cuda_ms"].append(cs.cuda_ms(fn))
            res[build][name]["device_ms"].append(cs.device_ms(fn, kernel))
    cc._FNS = bc._FNS = bdc._FNS = None
    for build in ("other", "this"):
        where = other_dir if build == "other" else os.path.dirname(csrc.source("band"))
        for name, *_ in kernels:
            r = res[build][name]
            print(f"{build} ({os.path.relpath(where, REPO)}) {name}: cuda_ms "
                  + " / ".join(f"{t:.4f}" for t in r["cuda_ms"]) + " ms, device_ms "
                  + " / ".join(cs.fmt_ms(t) for t in r["device_ms"]), flush=True)
    print(json.dumps({"other": other_dir, "times": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
