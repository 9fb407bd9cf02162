"""The harness finds each piece by name, and its result line keeps the
contract's schema."""

import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.tests import tiny

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def _run(spec, bench_dir, cell, trace):
    with tiny.one_torch_thread():
        return harness.run_cell(spec, "/", cell, SEED, 0.0, trace, "cpu", time.perf_counter(),
                                bench_dir)


def _check_schema(r, metrics):
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1 and r["failed"] >= 0
    assert set(r["metrics"]) == set(metrics)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_new_config_traffic_and_metric_files_are_found_by_name(bench):
    """The tiny configuration and mix are files the harness has never
    named; a metric reader dropped in beside the others is read by name."""
    spec, bench_dir = bench
    with open(os.path.join(bench_dir, "metrics", "units.tiny.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.units))\n")
    spec = dict(spec, per_layer=spec["per_layer"] + [
        {"name": "units.tiny", "unit": "units", "better": "higher", "source": "host_clock",
         "layer": "device", "moves": "overlap_bases_per_s", "workloads": ["tiny.overlap"]}])
    r = _run(spec, bench_dir, "tiny.overlap", True)
    assert r["metrics"]["units.tiny"]["value"] == r["attempted"]
    assert r["correct"] and "busy_s" in r["device"] and "window_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the engine's spans: minimize, map and the driver's own time
    _check_schema(r, ["minimize_ms.overlap", "map_ms.overlap", "piles_ms.overlap", "units.tiny"])


def test_untraced_line_holds_the_end_to_end_metrics(bench):
    spec, bench_dir = bench
    r = _run(spec, bench_dir, "tiny.overlap", False)
    assert r["correct"] and r["checks"]["overlap_reads_wrong"]["value"] == 0
    _check_schema(r, ["overlap_bases_per_s", "setup_s"])
    assert "breakdown" not in r and "busy_s" not in r["device"]


def test_polish_line(bench):
    spec, bench_dir = bench
    r = _run(spec, bench_dir, "tiny.polish", False)
    assert r["correct"] and r["checks"]["windows_wrong"] == {"value": 0, "limit": 0}
    _check_schema(r, ["polish_bases_per_s", "setup_s"])


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """No card here: a non-zero exit and no result.  In a folder that holds
    only BENCHMARK.json and perfbench/, the program is missing: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["--workload", "scer-ont.overlap", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), *args],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, str(tmp_path / "perfbench" / "run.py"), *args],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "not in this checkout" in out.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raven_tpu_torch_like", sys)
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m in harness.FORBIDDEN]
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()


class _Event:
    """A kineto event as the trace reads it."""

    def __init__(self, name, cuda, kind, start, end, with_kind=True):
        from torch.autograd import DeviceType

        self._name, self._kind = name, kind
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU
        self._t = (int(start * 1e9), int(end * 1e9))
        if with_kind:
            self.activity_type = lambda: self._kind

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._t[0]

    def end_ns(self):
        return self._t[1]


def _trace(events):
    from types import SimpleNamespace

    results = SimpleNamespace(events=lambda: events)
    return harness.Trace(SimpleNamespace(profiler=SimpleNamespace(kineto_results=results)))


@pytest.mark.parametrize("with_kind", [True, False], ids=["activity-kind", "annotation-flag"])
def test_program_ranges_are_not_device_time(with_kind):
    """A profiler range that the program opens itself shows on the device's
    timeline as an annotation over the whole range: the device's busy time,
    its operations and the idle gaps stay those of the kernels, copies and
    fills."""
    work = [_Event("bench:window", False, "user_annotation", 0.0, 10.0, with_kind),
            _Event("bench:unit", False, "user_annotation", 0.0, 10.0, with_kind),
            _Event("sketch_rows_kernel", True, "kernel", 1.0, 2.0, with_kind),
            _Event("Memcpy HtoD (Pageable -> Device)", True, "gpu_memcpy", 4.0, 5.0, with_kind),
            _Event("Memset (Device)", True, "gpu_memset", 6.0, 6.5, with_kind)]
    ranges = [_Event("construct::overlaps", False, "user_annotation", 0.5, 9.0, with_kind),
              _Event("construct::overlaps", True, "gpu_user_annotation", 0.5, 9.0, with_kind)]
    plain, ranged = _trace(work), _trace(work + ranges)
    assert plain.busy_s == ranged.busy_s == pytest.approx(2.5)
    assert ranged.window_s == 10.0 and ranged.device_ops == plain.device_ops
    assert ranged.breakdown() == plain.breakdown()
    assert ranged.kernel_seconds("construct") == 0.0
