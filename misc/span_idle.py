"""Where the card's idle time goes, by the program's own spans.

    python3 misc/span_idle.py --workload <cell> --seed <n> [--seconds 51]

runs one cell of BENCHMARK.json once, traced, through perfbench's harness
(as `perfbench/run.py --trace 1` does), and splits the traced window's idle
device seconds by the innermost program span (raven_tpu_torch.utils.trace)
the host was in: a span's own time is its interval less its children's,
and its idle seconds are the part of its own time in which no kernel, copy
or fill ran on the card.  It also holds each span against its profiler range
("raven:<name>") on the trace's clock, and sums each span's counts.  Prints
the cell's result line, then one JSON line of the split.  Needs a card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spans a pass or a call hangs from: time in them outside any step is
# the driver's or the engine's unnamed time
ROOTS = ("construct.find_overlaps", "band.call")


class Busy:
    """The card's merged busy intervals, for the busy seconds in any
    interval."""

    def __init__(self, merged):
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, lo: float, hi: float) -> float:
        if hi <= lo:
            return 0.0
        i = bisect.bisect_right(self.ends, lo)  # first interval ending after lo
        j = bisect.bisect_left(self.starts, hi)  # intervals [i, j) start before hi
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, lo - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - hi)
        return total


def idle_split(trace_obj, records) -> dict:
    """Idle seconds of the window by innermost program span, and the total."""
    lo, hi = trace_obj.window
    busy = Busy([(max(s, lo), min(e, hi)) for s, e in trace_obj.busy if e > lo and s < hi])
    spans = {r.id: r for r in records}
    children: dict = {}
    for r in records:
        children.setdefault(r.parent if r.parent in spans else None, []).append(r)

    def own_idle(lo_s, hi_s, kids):
        idle, t = 0.0, lo_s
        for k in sorted(kids, key=lambda k: k.start):
            ks, ke = k.start / 1e9, k.end / 1e9
            idle += (ks - t) - busy.within(t, ks)
            t = ke
        return idle + (hi_s - t) - busy.within(t, hi_s)

    by_name: dict = {}
    leaf_names = set()
    for r in records:
        kids = children.get(r.id, [])
        if not kids:
            leaf_names.add(r.name)
        by_name[r.name] = by_name.get(r.name, 0.0) + own_idle(r.start / 1e9, r.end / 1e9, kids)
    window_idle = (hi - lo) - busy.within(lo, hi)
    by_name["(no program span)"] = own_idle(lo, hi, children.get(None, []))
    named = sum(v for n, v in by_name.items() if n not in ROOTS and not n.startswith("("))
    leaves = sum(v for n, v in by_name.items() if n in leaf_names and n not in ROOTS)
    return {"window_s": hi - lo, "idle_s": window_idle,
            "idle_by_innermost_span_s": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "idle_share_in_steps": named / window_idle if window_idle > 0 else None,
            "idle_share_in_leaf_spans": leaves / window_idle if window_idle > 0 else None}


def clock_offsets(prof, records) -> dict:
    """The largest distance, ns, between a span's logged start and end and its
    profiler range's, each name's records and ranges paired in order."""
    from torch.autograd import DeviceType

    from raven_tpu_torch.utils import trace

    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(trace.PREFIX):
            ranges.setdefault(e.name()[len(trace.PREFIX):], []).append((e.start_ns(), e.end_ns()))
    worst = {"start": 0, "end": 0, "unpaired": 0}
    mine: dict = {}
    for r in records:
        mine.setdefault(r.name, []).append((r.start, r.end))
    for name, spans in mine.items():
        theirs = sorted(ranges.get(name, []))
        if len(theirs) != len(spans):
            worst["unpaired"] += abs(len(theirs) - len(spans))
            continue
        for (s, e), (ps, pe) in zip(sorted(spans), theirs):
            worst["start"] = max(worst["start"], abs(s - ps))
            worst["end"] = max(worst["end"], abs(e - pe))
    return worst


def count_sums(records) -> dict:
    sums: dict = {}
    for r in records:
        entry = sums.setdefault(r.name, {"spans": 0})
        entry["spans"] += 1
        for k, v in r.counts.items():
            if isinstance(v, int):
                entry[k] = entry.get(k, 0) + v
    return sums


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import harness
    from raven_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        sys.exit("[span_idle] needs a card")
    captured = {}

    class Captured(harness.Trace):
        def __init__(self, prof):
            super().__init__(prof)
            captured["trace"], captured["prof"] = self, prof

    harness.Trace = Captured
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    trace.clear()
    result = harness.run_cell(spec, ROOT, args.workload, args.seed, args.seconds, True,
                              "cuda:0", T0)
    print(json.dumps(result), flush=True)
    tr = captured["trace"]
    lo, hi = tr.window
    records = [r for r in trace.spans() if lo * 1e9 <= r.start and r.end <= hi * 1e9]
    calls = tr.spans_named("call") or tr.spans_named("pass")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    out = {"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
           "correct": result["correct"], "units": result["attempted"],
           "bench_unit_span_ms": 1e3 * sum(e - s for s, e in calls) / max(len(calls), 1),
           **idle_split(tr, records), "clock_offsets_ns": clock_offsets(captured["prof"], records),
           "counts": count_sums(records)}
    if "piles_ms.overlap" in m:
        out["deal_layers_cap_ms"] = sum(m.get(k, 0.0) for k in
                                        ("deal_ms.overlap", "layers_ms.overlap", "cap_ms.overlap"))
    if "band_prep_ms.polish" in m:
        out["band_steps_ms"] = sum(m.get(k, 0.0) for k in (
            "band_prep_ms.polish", "band_upload_ms.polish", "band_queue_ms.polish",
            "band_collect_ms.polish"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
