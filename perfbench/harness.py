"""The benchmark's general harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:

- `configs/<config>.json` (the path the configuration's `file` gives): the
  deployment, read by the generators in gen.py;
- `traffic/<traffic>.json`: the traffic mix's parameters, whose `stage`
  names the driver in `stages/<stage>.py` that makes the inputs, warms up,
  runs one unit of work and checks the answers against the plain
  reference;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(run)`, which
  returns a number or None when it finds nothing to read.

A stage module has `setup(ctx) -> state` (inputs from the seed, one warm
unit), `unit(state, ctx) -> {metric: work}` (one unit of the timed path,
which keeps the sampled answers), `release(state)` (frees the program's
state) and `check(state, ctx) -> ({name: (value, limit)}, failed units)`
(the comparison with the reference, after the window).  An
end-to-end rate `<x>_per_s` is the sum of the units' work under its name
over the window's seconds.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "raven_tpu")
SPAN_PREFIX = "bench:"
# the device's work in a trace: kernels, copies and fills.  A profiler
# range, the benchmark's or the program's, shows on the device's timeline
# too, as an annotation over the whole range, and is none of it.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: raven_tpu_torch is not raven_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a stage sees: the cell's files, the seed, the device, and the
    spans it records around the program's layers when the run traces."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, tracing: bool):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tracing = tracing
        self.data: dict = {}  # what the metric readers need of the inputs
        self.spans: list = []  # (name, start, end) on the host clock, traced runs

    def inputs_ready(self) -> None:
        """The inputs are made: the peak of device memory counts from here."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A layer's span: in a traced run a profiler range, ended once the
        device is idle; nothing otherwise."""
        if not self.tracing:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield
            self.sync()
        self.spans.append((name, t0, time.perf_counter()))


def device_work(event) -> bool:
    """Whether a kineto event is work on the device (DEVICE_WORK), by its
    activity kind; where torch gives no kind, any device event that is no
    annotation."""
    from torch.autograd import DeviceType

    if event.device_type() != DeviceType.CUDA:
        return False
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not event.is_user_annotation()


class Trace:
    """The traced window's device operations and the benchmark's host
    spans, in seconds on the profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        # kineto's raw events, without torch's FunctionEvent objects for
        # every launch of the window
        events = prof.profiler.kineto_results.events()
        self.device_ops = [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
                           for e in events if device_work(e)]
        self.host_spans = [(e.name()[len(SPAN_PREFIX):], e.start_ns() / 1e9, e.end_ns() / 1e9)
                           for e in events
                           if e.device_type() == DeviceType.CPU and e.name().startswith(SPAN_PREFIX)]
        win = [(s, e) for n, s, e in self.host_spans if n == "window"]
        self.window = win[0] if win else (0.0, 0.0)
        self.busy = self._merge([(s, e) for _, s, e in self.device_ops])

    @staticmethod
    def _merge(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_within(self, lo: float, hi: float) -> float:
        return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in self.busy)

    @property
    def busy_s(self) -> float:
        return self.busy_within(*self.window)

    def kernel_seconds(self, *names) -> float:
        """Device seconds of the operations whose name holds any of names."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in names))

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.host_spans if n == name]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time by the innermost benchmark span the host was in."""
        by_op: dict = {}
        for n, s, e in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        lo, hi = self.window
        gaps = []
        prev = lo
        for s, e in self.busy:
            if s > prev:
                gaps.append((prev, min(s, hi)))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        spans = [(n, s, e) for n, s, e in self.host_spans if n != "window"]
        by_span: dict = {}
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) / 2
            inner = [(se - ss, n) for n, ss, se in spans if ss <= mid <= se]
            name = min(inner)[1] if inner else "between units"
            by_span[name] = by_span.get(name, 0.0) + (e - s)
        top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        top_gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in top_ops],
                "idle_gaps": [[n, v] for n, v in top_gaps]}


class HostLoad:
    """What the host did during each unit, for reading a spread: this
    process's CPU seconds (all its threads) and the collector's seconds."""

    FIELDS = ("cpu_s", "gc_s")

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t0 = None

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def read(self) -> tuple:
        t = os.times()
        return t.user + t.system, self.gc_s

    @staticmethod
    def delta(a: tuple, b: tuple) -> dict:
        return {"cpu_s": b[0] - a[0], "gc_s": b[1] - a[1]}


class Run:
    """One run of a cell, as the metric readers see it."""

    def __init__(self, cell: dict, ctx: Context, units: list, trace: Trace | None):
        self.cell = cell
        self.ctx = ctx
        self.data = ctx.data
        self.units = units  # [{"start", "end", "work"}]
        self.trace = trace

    def span_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.ctx.spans if n == name)


def cell_metrics(spec: dict, cell_name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layer = []
    for m in spec["per_layer"]:
        if cell_name in m["workloads"] if "workloads" in m else m["moves"] in names:
            layer.append(m)
    return e2e, layer


def load_cell(spec: dict, root: str, cell_name: str, bench_dir: str = HERE):
    """The cell's entry, its configuration and traffic mix, and the stage
    module the mix names, each found by name."""
    cell = next(c for c in spec["workloads"] if c["name"] == cell_name)
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json"))
    stage = load_module(os.path.join(bench_dir, "stages", traffic["stage"] + ".py"),
                        "perfbench_stage_" + traffic["stage"])
    return cell, config, traffic, stage


def run_cell(spec: dict, root: str, cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench_dir: str = HERE) -> dict:
    """Run the cell: inputs and warm-up, the measured window, the check
    against the reference; returns the result line's object (checks
    last)."""
    cell, config, traffic, stage = load_cell(spec, root, cell_name, bench_dir)
    e2e, layer = cell_metrics(spec, cell_name)
    readers = {m["name"]: load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                                      "perfbench_metric_" + m["name"].replace(".", "_"))
               for m in (layer if trace else [])}
    dev = torch.device(device)
    ctx = Context(config, traffic, seed, dev, trace)

    state = stage.setup(ctx)
    ctx.sync()
    # the inputs live through the window: the collector need not walk them
    gc.collect()
    gc.freeze()
    ctx.spans.clear()
    units = []
    prof = None
    with contextlib.ExitStack() as stack:
        load = stack.enter_context(HostLoad())
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(torch.profiler.record_function(SPAN_PREFIX + "window"))
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        while True:
            h0 = load.read()
            u0 = time.perf_counter()
            with ctx.span("unit"):
                work = stage.unit(state, ctx)
            ctx.sync()
            u1 = time.perf_counter()
            units.append({"start": u0, "end": u1, "work": work,
                          "host": HostLoad.delta(h0, load.read())})
            if u1 - w0 >= seconds:
                break
    window_s = units[-1]["end"] - w0
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    stage.release(state)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks, failed = stage.check(state, ctx)
    correct = all(v <= lim for v, lim in checks.values())
    print(f"[perfbench] setup {setup_s:.3f} s, {len(units)} units in {window_s:.3f} s: "
          + " ".join(f"{u['end'] - u['start']:.3f}" for u in units)
          + f"; the check {time.perf_counter() - c0:.3f} s", file=sys.stderr)
    print(f"[perfbench] host, torch threads {torch.get_num_threads()}, cpus "
          f"{len(os.sched_getaffinity(0)) if hasattr(os, 'sched_getaffinity') else os.cpu_count()}, "
          "each unit's " + "/".join(HostLoad.FIELDS) + ": "
          + " ".join("/".join(f"{u['host'][k]:.3g}" for k in HostLoad.FIELDS) for u in units),
          file=sys.stderr)

    metrics = {}
    if not trace:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = sum(u["work"][m["name"]] for u in units) / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    tr = Trace(prof) if prof is not None else None
    run = Run(cell, ctx, units, tr)
    for m in layer if trace else []:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                       "count": int(cell["chips"]), "memory_peak_bytes": peak}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(units), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result

