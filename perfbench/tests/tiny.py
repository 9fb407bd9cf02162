"""Tiny cells for the CPU tests: a temporary copy of the benchmark's stages,
metrics and traffic, with small configurations and mixes beside them."""

from __future__ import annotations

import json
import os
import shutil

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

READS = {"depth": 20, "mean_len": 4000, "sd_frac": 0.25, "min_len": 500,
         "sub": 0.025, "ins": 0.0125, "del": 0.0125}
CONFIGS = {
    "tiny-genome": {"sequences": [60000, 25000], "reads": READS,
                    "repeat": {"length": 2000, "copies": 3, "divergence": 0.01,
                               "placement": "dispersed"},
                    "tandem": {"sequence": 0, "at": 20000, "length": 1500, "copies": 12,
                               "divergence": 0.01}},
    "tiny-bank": {"sequences": [3000], "reads": READS,
                  "repeat": {"length": 500, "copies": 2, "divergence": 0.005, "placement": "even"}},
    # low depth and twice the errors: windows that one more iteration still
    # changes, so the polish control shows at a size a test holds
    "tiny-noisy-bank": {"sequences": [6000],
                        "reads": dict(READS, depth=10, mean_len=3000, sub=0.05, ins=0.025,
                                      **{"del": 0.025})},
}
TRAFFIC = {
    "tiny-overlap": {"stage": "overlap", "sample_reads": 40},
    "tiny-polish": {"stage": "band_consensus", "window_len": 500,
                    "draft": {"sub": 0.005, "ins": 0.0025, "del": 0.0025}},
}
CELLS = {"tiny.overlap": ("tiny-genome", "tiny-overlap"),
         "tiny.polish": ("tiny-bank", "tiny-polish"),
         "tiny.polish-noisy": ("tiny-noisy-bank", "tiny-polish")}


def make(tmp: str) -> tuple[dict, str]:
    """(spec, bench_dir): a BENCHMARK.json-like spec of the tiny cells and a
    bench folder holding the benchmark's stages, metrics and traffic with
    the tiny files beside them."""
    bench = os.path.join(tmp, "bench")
    for sub in ("stages", "metrics", "traffic"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "configs"))
    for name, conf in CONFIGS.items():
        with open(os.path.join(bench, "configs", name + ".json"), "w") as fh:
            json.dump(conf, fh)
    for name, tr in TRAFFIC.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as fh:
            json.dump(tr, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        real = json.load(fh)
    rename = {"scer-ont.overlap": "tiny.overlap", "ecoli-ont.polish-shiftband": "tiny.polish"}

    def retarget(m):
        return dict(m, workloads=[rename[w] for w in m["workloads"]]) if "workloads" in m else m

    spec = {
        "configs": [{"name": n, "file": os.path.join(bench, "configs", n + ".json")}
                    for n in CONFIGS],
        "workloads": [{"name": c, "config": cf, "traffic": t, "chips": 1}
                      for c, (cf, t) in CELLS.items()],
        "end_to_end": [retarget(m) for m in real["end_to_end"]],
        "per_layer": [retarget(m) for m in real["per_layer"]],
    }
    return spec, bench


class one_torch_thread:
    """Torch on one thread inside the block (several test workers share the
    cores), the old count restored after it."""

    def __enter__(self):
        self.old = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.old)
