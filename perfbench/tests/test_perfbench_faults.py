"""The check catches what it is there to catch: runs of the tiny cells with
the timed path broken underneath come out not correct, once for each fault
a cell can have (a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced; one card, so no
exchange), and so does each cell's control, the reference in the
program's place with one guarantee broken."""

import time

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import tiny

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def _correct(bench, cell):
    spec, bench_dir = bench
    with tiny.one_torch_thread():
        r = harness.run_cell(spec, "/", cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                             bench_dir)
    return r["correct"], r["checks"]


def _map_many_fault(kind):
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.overlap.types import OVERLAP_DTYPE

    orig = MinimizerIndex.map_many

    def map_many(self, readset, ids, *args, **kwargs):
        ids = np.asarray(ids)
        if kind == "half":
            out = orig(self, readset, ids[: ids.size // 2], *args, **kwargs)
            out.update({int(i): np.zeros(0, OVERLAP_DTYPE) for i in ids[ids.size // 2:]})
            return out
        out = orig(self, readset, ids, *args, **kwargs)
        for rid, arr in out.items():
            if arr.size:
                arr = arr.copy()
                arr["lhs_end"][0] += 1
                out[rid] = arr
        return out
    return map_many


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_overlap_faults_are_not_correct(bench, monkeypatch, fault):
    from raven_tpu_torch.graph import construct
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    if fault == "unchanged":
        monkeypatch.setattr(construct, "find_overlaps_and_create_piles", lambda *a, **k: None)
    else:
        monkeypatch.setattr(MinimizerIndex, "map_many", _map_many_fault(fault))
    correct, checks = _correct(bench, "tiny.overlap")
    assert not correct and checks["overlap_reads_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_polish_faults_are_not_correct(bench, monkeypatch, fault):
    from raven_tpu_torch.ops import consensus_band

    orig = consensus_band.band_window_consensus

    def broken(windows, *args, **kwargs):
        if fault == "unchanged":
            return [np.asarray(w[0], np.uint8) for w in windows]
        if fault == "half":
            half = len(windows) // 2
            return orig(windows[:half], *args, **kwargs) + [np.asarray(w[0], np.uint8)
                                                            for w in windows[half:]]
        out = orig(windows, *args, **kwargs)
        out[0] = out[0].copy()
        out[0][0] ^= 1
        return out

    monkeypatch.setattr(consensus_band, "band_window_consensus", broken)
    correct, checks = _correct(bench, "tiny.polish")
    assert not correct and checks["windows_wrong"]["value"] > 0


def _control(bench, cell, seed, kind):
    spec, bench_dir = bench
    _, config, tr, stage = harness.load_cell(spec, "/", cell, bench_dir)
    ctx = harness.Context(config, tr, seed, "cpu", False)
    with tiny.one_torch_thread():
        state = stage.inputs(ctx)
        stage.control(state, ctx, kind)
        checks, failed = stage.check(state, ctx)
    return checks, failed


def test_overlap_control_is_not_correct(bench):
    checks, failed = _control(bench, "tiny.overlap", SEED, "minhash-half")
    assert failed == 1 and checks["overlap_reads_wrong"][0] > checks["overlap_reads_wrong"][1]


@pytest.mark.parametrize("kind", ["iterations-1", "insertion-ties", "spans-dropped"])
def test_polish_control_is_not_correct(bench, kind):
    checks, failed = _control(bench, "tiny.polish-noisy", SEED, kind)
    assert failed == 1 and checks["windows_wrong"][0] > checks["windows_wrong"][1]
