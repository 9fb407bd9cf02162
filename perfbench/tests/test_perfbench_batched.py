"""The batched overlap cell on a tiny configuration whose reads fill three
index batches (the budget cut small in the program and in the reference
alike, for these tests only): a whole run is correct on the CPU, the maps
that leave the device fail it, the controls fail it, a program that cannot
count its host maps is stopped before any input is made, and the foreign
join's reader reads its spans."""

import json
import os
import time
from types import SimpleNamespace

import pytest

from perfbench import gen, harness
from perfbench.reference import overlaps_batched as ref_batched
from perfbench.tests import tiny
from raven_tpu_torch.utils import trace

SEEDS = (2**31 + 5, 2**32 + 123)
BUDGET = 700_000  # ~1.7 Mb of reads: three batches
CELL = "tiny.overlap-batched"
OVERLAP_METRICS = ("minimize_ms.overlap", "map_ms.overlap", "piles_ms.overlap",
                   "foreign_join_ms.overlap")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    spec, bench_dir = tiny.make(str(tmp_path_factory.mktemp("bench")))
    # tiny-genome without its tandem array, whose skew in a 0.8 Mb batch
    # lifts the filter's threshold past the device join's (a decline)
    conf = {k: v for k, v in tiny.CONFIGS["tiny-genome"].items() if k != "tandem"}
    files = {("configs", "tiny-batched"): conf,
             ("traffic", "tiny-overlap-batched"): {"stage": "overlap_batched",
                                                   "sample_reads": 40}}
    for (sub, name), data in files.items():
        with open(os.path.join(bench_dir, sub, name + ".json"), "w") as fh:
            json.dump(data, fh)
    spec = dict(spec)
    spec["configs"] = spec["configs"] + [
        {"name": "tiny-batched", "file": os.path.join(bench_dir, "configs", "tiny-batched.json")}]
    spec["workloads"] = spec["workloads"] + [
        {"name": CELL, "config": "tiny-batched", "traffic": "tiny-overlap-batched", "chips": 1}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + [CELL])
                          if m["name"] == "overlap_bases_per_s" else m for m in spec["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=m["workloads"] + [CELL])
                         if m["name"] in OVERLAP_METRICS else m for m in spec["per_layer"]]
    spec["per_layer"] += [{"name": "foreign_join_ms.overlap", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "device index and chain",
                           "moves": "overlap_bases_per_s", "workloads": [CELL]}]
    return spec, bench_dir


@pytest.fixture
def small_budget(monkeypatch):
    """The program's and the reference's index batch cut to BUDGET, and the
    program's device index taken at any size."""
    from raven_tpu_torch.graph import construct
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    monkeypatch.setattr(construct, "INDEX_BATCH_BYTES", BUDGET)
    monkeypatch.setattr(ref_batched, "INDEX_BATCH_BASES", BUDGET)
    monkeypatch.setattr(MinimizerIndex, "DEVICE_MIN_BASES", 0)


def _run(bench, seed, trace_=False):
    spec, bench_dir = bench
    with tiny.one_torch_thread():
        return harness.run_cell(spec, "/", CELL, seed, 0.0, trace_, "cpu", time.perf_counter(),
                                bench_dir)


def test_reads_fill_three_batches(bench):
    spec, bench_dir = bench
    _, config, tr, _ = harness.load_cell(spec, "/", CELL, bench_dir)
    g = gen.generator(SEEDS[0], "cpu")
    genome, _ = gen.make_genome(g, config["sequences"], config.get("repeat"), "cpu",
                                config.get("tandem"))
    _, lens = gen.simulate_reads(g, genome, gen.sequence_sizes(config), config["reads"])
    ends = ref_batched.batch_ends(lens, BUDGET)
    assert ends.size == 3 and ends[-1] == lens.size
    # the read that reaches the budget closes its batch
    assert lens[:ends[0]].sum() >= BUDGET > lens[:ends[0] - 1].sum()


@pytest.mark.parametrize("seed", SEEDS)
def test_whole_run_is_correct(bench, small_budget, seed):
    r = _run(bench, seed)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"overlap_reads_wrong", "pile_reads_wrong", "host_route_maps"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"overlap_bases_per_s", "setup_s"}


def test_traced_run_reads_the_engine(bench, small_budget):
    r = _run(bench, SEEDS[0], trace_=True)
    assert r["correct"]
    # a CPU trace holds no device work: the program's span readers read
    # nothing there, the stage's own spans are read
    assert {"minimize_ms.overlap", "map_ms.overlap", "piles_ms.overlap"} <= set(r["metrics"])
    assert "foreign_join_ms.overlap" not in r["metrics"]


def test_maps_on_the_host_are_not_correct(bench, small_budget, monkeypatch):
    """The foreign queries sent to the host route: the same overlaps, but
    the maps that left the device fail the check."""
    from raven_tpu_torch.overlap import device_index

    for cls in (device_index.DeviceIndex, device_index.PartitionedIndex):
        monkeypatch.setattr(cls, "joins_foreign", False)
    r = _run(bench, SEEDS[0])
    c = r["checks"]
    assert not r["correct"] and c["host_route_maps"]["value"] > 0
    assert c["overlap_reads_wrong"]["value"] == c["pile_reads_wrong"]["value"] == 0


def _control(bench, seed, kind):
    spec, bench_dir = bench
    _, config, tr, stage = harness.load_cell(spec, "/", CELL, bench_dir)
    ctx = harness.Context(config, tr, seed, "cpu", False)
    with tiny.one_torch_thread():
        state = stage.inputs(ctx)
        stage.control(state, ctx, kind)
        return stage.check(state, ctx)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["foreign-dropped", "minhash-half"])
def test_controls_are_not_correct(bench, small_budget, seed, kind):
    checks, failed = _control(bench, seed, kind)
    assert failed == 1
    assert checks["overlap_reads_wrong"][0] > checks["overlap_reads_wrong"][1]
    assert checks["host_route_maps"] == (0, 0)


def test_a_program_without_host_maps_stops_before_any_input(bench, monkeypatch):
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    def refuse(*a, **k):
        raise AssertionError("an input was made")

    monkeypatch.delattr(MinimizerIndex, "host_maps")
    monkeypatch.setattr(gen, "generator", refuse)
    with pytest.raises(SystemExit, match="host_maps"):
        _run(bench, SEEDS[0])


def test_foreign_join_reader(monkeypatch):
    lo = 1_700_000_000.0
    ms = 1_000_000

    def span(name, start_ms, dur_ms):
        start = int(lo * 1e9) + start_ms * ms
        return trace.Record(name, 0, None, 0, start, start + dur_ms * ms, {})

    reader = harness.load_module(os.path.join(tiny.BENCH, "metrics", "foreign_join_ms.overlap.py"),
                                 "perfbench_metric_foreign_join_ms_overlap")
    tr = SimpleNamespace(window=(lo, lo + 10), window_s=10.0, device_ops=[("k", lo + 1, lo + 2)])
    run = SimpleNamespace(trace=tr)
    trace.clear()
    try:
        trace.spans().extend([
            span("construct.find_overlaps", 0, 4000), span("index.join_foreign", 100, 30),
            span("index.join_foreign", 900, 20),
            span("construct.find_overlaps", 5000, 4000), span("index.join_foreign", 5100, 70),
            # past the window: not read
            span("construct.find_overlaps", 9500, 4000), span("index.join_foreign", 9600, 500)])
        assert reader.read(run) == pytest.approx(60.0)
        assert reader.read(SimpleNamespace(trace=None)) is None
        trace.clear()
        trace.spans().append(span("construct.find_overlaps", 0, 4000))
        assert reader.read(run) is None  # the parent's program: no such span
    finally:
        trace.clear()
