#!/usr/bin/env python3
"""Time a loop of small torch ops on the host and on the card before and
after torch.profiler sessions, and after a large allocation is freed.

    python3 misc/profiler_launch_cost.py
    TEARDOWN_CUPTI=1 python3 misc/profiler_launch_cost.py

Each line gives the seconds of 20,000 iterations of three int32 ops on a
[256, 256] tensor, on the CPU and on cuda:0 (launch-bound there, as the
plain versions' row loops in chip_smoke.py are).  chip_smoke.py's phases
time kernels in torch.profiler traces; the ops launched after such a
trace pay what this shows.
"""

import time

import torch
from torch.profiler import ProfilerActivity, profile


def cpu_loop(n=20000):
    x = torch.zeros(256, 256, dtype=torch.int32)
    t = time.perf_counter()
    for _ in range(n):
        y = x + 1
        z = torch.maximum(y, x)
        x = z - 1
    return time.perf_counter() - t


def gpu_loop(n=20000):
    x = torch.zeros(256, 256, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        y = x + 1
        z = torch.maximum(y, x)
        x = z - 1
    torch.cuda.synchronize()
    return time.perf_counter() - t


def report(tag):
    print(f"{tag}: cpu {cpu_loop():.3f} s, gpu {gpu_loop():.3f} s, "
          f"threads {torch.get_num_threads()}", flush=True)


def session():
    x = torch.zeros(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(20):
            x = x + 1
        torch.cuda.synchronize()


def main():
    report("clean")
    report("clean again")
    session()
    report("after one profiler session")
    for _ in range(10):
        session()
    report("after eleven sessions")
    bufs = [torch.empty(1 << 28, dtype=torch.uint8, device="cuda") for _ in range(150)]
    del bufs
    report("after 40 GB allocated and freed (cached)")
    torch.cuda.empty_cache()
    report("after empty_cache")


if __name__ == "__main__":
    main()
