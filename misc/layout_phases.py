#!/usr/bin/env python3
"""Where an iteration of kernel K12 (the layout n-body) spends its cycles.

    python3 misc/layout_phases.py [N ...]        (default: 600 640 1500)

On one CUDA card.  Builds a copy of raven_tpu_torch/csrc/layout.cu into
build/cuda/ with clock64() marks in thread 0 of block 0, which add each
iteration's cycles into five phases: the reload of the pass's columns from
L2 into shared memory ("stage"), the (row, window) sums ("windows"), the
in-order adds of a row's window sums ("tree"), the links and the move
("update"), and the wait from there to the next iteration's start (the
grid barrier and the slowest block, "barrier").  At each N (a component
of N points in the unit square, a chain and 200 random links, as
chip_smoke.n_body_case builds it) it runs 100 iterations, checks that the
marked kernel gives the unmarked one's bits, times both launches alike
(CUDA events around the launch alone, the median of 10) and prints the
median cycles of each phase over iterations 5-94, beside an estimate of
one iteration's serial floor: its dependent chain with latencies assumed
for Hopper (K12_LAT_* below).
Prints the card's name, power limit and SM clocks, one line a size and a
last line of JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ITERS = 100
PHASES = ("stage", "windows", "tree", "update", "barrier")
MAX_ITERS = 1024  # iterations the marks keep
# The serial floor's assumed latencies in cycles: a dependent float32 add,
# product, FMA or maximum 4, a MUFU reciprocal or root 16, a shared-memory
# load 30, an L2 round trip 260.  One iteration's chain: a window's first
# term (its column's load, dx, dx * dx, the FMA, the maximum, the division:
# a MUFU and 5 FMAs, the product) and its 32 in-order adds; the load of the
# row's window sums and its in-order adds over its windows and the 5
# accumulators; the links' adds; the update (a product and an FMA, the
# root: a MUFU and 4 dependent operations, the select, the division, the
# FMA); and the grid barrier: the arrival at a counter in L2, its sight,
# and the next iteration's points read back.
K12_LAT_OP, K12_LAT_MUFU, K12_LAT_LDS, K12_LAT_L2 = 4, 16, 30, 260


def floor_cycles(n: int, slots: int) -> int:
    """One iteration's estimated dependent chain in cycles (see above)."""
    op, mufu = K12_LAT_OP, K12_LAT_MUFU
    window = K12_LAT_LDS + 4 * op + (mufu + 5 * op) + op + 32 * op
    tree = K12_LAT_LDS + (-(-n // 32) + 5) * op
    update = 2 * op + (mufu + 4 * op) + op + (mufu + 5 * op) + op
    return window + tree + slots * op + update + 3 * K12_LAT_L2


def marked_source(src: str) -> str:
    """layout.cu with the phase marks in thread 0 of block 0."""
    def rep(a: str, b: str) -> None:
        nonlocal src
        if src.count(a) != 1:
            raise RuntimeError(f"layout.cu has changed: no single {a.strip()!r}")
        src = src.replace(a, b)

    rep("namespace {\n", f"""namespace {{
__device__ long long g_k12_cycles[{MAX_ITERS * len(PHASES)}];
#define K12_MARK(slot)                                                        \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {{                                  \\
    const long long now = clock64();                                          \\
    if ((slot) >= 0 && (slot) < {MAX_ITERS * len(PHASES)}) g_k12_cycles[slot] += now - t_mark; \\
    t_mark = now;                                                             \\
  }}
""")
    rep("  __syncthreads();\n  for (int it = 0; it < iters; ++it) {\n",
        "  __syncthreads();\n  long long t_mark = 0;\n"
        "  for (int it = 0; it < iters; ++it) {\n    K12_MARK(it > 0 ? (it - 1) * 5 + 4 : -1)\n")
    rep("          P.hi = hi;\n          __syncthreads();\n",
        "          P.hi = hi;\n          __syncthreads();\n          K12_MARK(it * 5 + 0)\n")
    rep("        __syncthreads();\n        if (tid < nrow) {\n",
        "        __syncthreads();\n        K12_MARK(it * 5 + 1)\n        if (tid < nrow) {\n")
    rep("        __syncthreads();\n      }\n      if (tid < nrow) {\n",
        "        __syncthreads();\n        K12_MARK(it * 5 + 2)\n      }\n      if (tid < nrow) {\n")
    rep("        next[i] = update(P, total(acc), P.one(i), i, L, D, k, t);\n      }\n",
        "        next[i] = update(P, total(acc), P.one(i), i, L, D, k, t);\n      }\n"
        "      K12_MARK(it * 5 + 3)\n")
    rep('extern "C" {\n', f"""extern "C" {{
int raven_k12_cycles(void* dst) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_k12_cycles, sizeof(g_k12_cycles)));
}}
int raven_k12_cycles_reset() {{
  static long long zero[{MAX_ITERS * len(PHASES)}];
  return static_cast<int>(cudaMemcpyToSymbol(g_k12_cycles, zero, sizeof(zero)));
}}
""")
    return src


def build() -> ctypes.CDLL:
    from raven_tpu_torch import csrc

    out = os.path.join(csrc.build_dir(), "libk12_phases.so")
    cu = os.path.join(csrc.build_dir(), "k12_phases.cu")
    os.makedirs(csrc.build_dir(), exist_ok=True)
    with open(csrc.source("layout")) as f:
        src = marked_source(f.read())
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", out, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the marked layout.cu:\n{res.stdout}{res.stderr}")
    lib = bind(ctypes.CDLL(out))
    lib.raven_k12_cycles.argtypes = [ctypes.c_void_p]
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of layout.cu's C interface."""
    lib.raven_cuda_error_string.restype = ctypes.c_char_p
    lib.raven_cuda_error_string.argtypes = [ctypes.c_int]
    lib.raven_n_body_card.restype = ctypes.c_int
    lib.raven_n_body_card.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.raven_n_body_launch.restype = ctypes.c_int
    lib.raven_n_body_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    import numpy as np
    import torch

    from raven_tpu_torch import csrc
    from raven_tpu_torch.ops import layout_cuda as L

    sizes = [int(a) for a in sys.argv[1:]] or [600, 640, 1500]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    lib = build()
    lib0 = bind(csrc.load("layout"))
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    csrc.check(lib, lib.raven_n_body_card(ctypes.byref(sms), ctypes.byref(per_sm)),
               "marked K12 card query")

    def events_ms(fn, runs=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = []
    for n in sizes:
        rng = np.random.default_rng(3)
        pts = torch.as_tensor(rng.random((n, 2)), dtype=torch.float32, device="cuda")
        ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, 200)])
        eb = np.concatenate([np.arange(1, n), rng.integers(0, n, 200)])
        ctas = L.launch_plan(n, sms.value, per_sm.value)["ctas"]
        k, kk = L.scales(n)
        slots = torch.as_tensor(np.ascontiguousarray(L.attraction_slots(n, ea, eb).T,
                                                     dtype=np.int32), device="cuda")
        temps = torch.as_tensor(np.array(L.temperatures(ITERS), dtype=np.float32),
                                device="cuda")
        buf0 = torch.empty((n + n % 2, 2), dtype=torch.float32, device="cuda")
        buf1 = torch.empty_like(buf0)

        def launch(which):
            err = which.raven_n_body_launch(
                buf0.data_ptr(), buf1.data_ptr(), slots.data_ptr(), temps.data_ptr(), n,
                slots.shape[0], ITERS, float(k), float(kk), ctas,
                torch.cuda.current_stream().cuda_stream)
            csrc.check(which, err, "K12 launch")

        def result(which):
            buf0[:n] = pts
            launch(which)
            return (buf1 if ITERS % 2 else buf0)[:n].clone()

        def marked():
            launch(lib)

        differ = int((result(lib) != result(lib0)).sum())
        if differ:
            print(f"the marked kernel differs from K12 at {n} points in {differ} coordinates",
                  file=sys.stderr)
            return 1
        buf0[:n] = pts
        csrc.check(lib, lib.raven_k12_cycles_reset(), "marks reset")
        marked()
        torch.cuda.synchronize()
        cyc = np.zeros(MAX_ITERS * len(PHASES), np.int64)
        csrc.check(lib, lib.raven_k12_cycles(cyc.ctypes.data), "marks read")
        per_it = cyc[: ITERS * len(PHASES)].reshape(ITERS, len(PHASES))[5:95]
        phases = {p: float(np.median(per_it[:, j])) for j, p in enumerate(PHASES)}
        row = {"n": n, "blocks": ctas, "slots": int(slots.shape[0]),
               "cycles_an_iteration": float(np.median(per_it.sum(1))), "phases": phases,
               "floor_estimate_cycles": floor_cycles(n, int(slots.shape[0])),
               "marked_ms": events_ms(marked), "unmarked_ms": events_ms(lambda: launch(lib0))}
        out.append(row)
        print(f"K12 at {n} points x {ITERS} iterations, {ctas} blocks, on {smi}: "
              f"{row['cycles_an_iteration']:.0f} cycles an iteration (block 0, median of "
              f"iterations 5-94): " + ", ".join(f"{p} {c:.0f}" for p, c in phases.items())
              + f"; serial floor estimate {row['floor_estimate_cycles']} cycles; a call "
              f"{row['marked_ms']:.4f} ms marked, {row['unmarked_ms']:.4f} ms unmarked",
              flush=True)
    print(json.dumps({"device": smi, "sizes": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
