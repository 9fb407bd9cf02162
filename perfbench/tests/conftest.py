"""tiny.make's spec renames the metrics' cell lists to the tiny cells, and
knows only the benchmark's first two cells.  The cells added after them
have no tiny twin: `make` here reads BENCHMARK.json with their names left
out of the metrics' lists, and builds the spec as it did before."""

import json
import os
import tempfile

from perfbench.tests import tiny

TWINNED = ("scer-ont.overlap", "ecoli-ont.polish-shiftband")
_make = tiny.make


def make(tmp: str):
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in TWINNED]
    root = tempfile.mkdtemp(dir=tmp)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    real = tiny.ROOT
    tiny.ROOT = root
    try:
        return _make(tmp)
    finally:
        tiny.ROOT = real


tiny.make = make
