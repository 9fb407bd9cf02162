"""The layout's float32 n-body against raven_tpu's: positions within
POS_ATOL after 1 and 5 iterations on a 600-node component, and the repeat
genome's checkpoint (tests/torch_layout_repeats.py) through both packages'
assemble with the components of 512 nodes or more on the n-body (the
n-body held to raven_tpu's positions, the port reproducible, the unitigs'
gap kept visible: ROADMAP Queue 3 item 3).  A file of its own, beside
tests/test_torch_layout.py, so that the suite's workers run the two apart
(pytest-xdist's --dist loadfile hands out a file whole); the module
docstring of tests/test_torch_layout.py says why positions are compared
after a few iterations only."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu_torch.graph import layout as tlayout  # noqa: E402
from tests.torch_layout_repeats import (  # noqa: E402, F401
    POS_ATOL, _assemble_both, _one_torch_thread, repeat_checkpoint,
)

N = 600


def _component(seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((N, 2))
    ea = np.concatenate([np.arange(N - 1), rng.integers(0, N, 200)])
    eb = np.concatenate([np.arange(1, N), rng.integers(0, N, 200)])
    return pts, ea.astype(np.int64), eb.astype(np.int64)


@pytest.mark.parametrize("iters", [1, 5])
def test_positions_match_jax(iters):
    pts, ea, eb = _component(iters)
    assert N >= tlayout._DEVICE_MIN_NODES
    runs = tlayout.DEVICE_RUNS
    got = tlayout._layout_component(pts.copy(), ea, eb, iters, "cpu")
    assert tlayout.DEVICE_RUNS == runs + 1  # the n-body path, not the host loop
    want = jlayout._layout_component(pts.copy(), ea, eb, iters)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_ATOL)


@pytest.fixture(scope="module")
def repeat_n_body(repeat_checkpoint):
    """The repeat checkpoint through both packages' assemble with the
    components of 512 nodes or more on their float32 n-body, the port's
    twice: _assemble_both's results and the port's n-body runs, once for
    the tests that read them."""
    mp = pytest.MonkeyPatch()
    try:
        runs = tlayout.DEVICE_RUNS
        out = _assemble_both(repeat_checkpoint, mp, port_runs=2)
        return out, tlayout.DEVICE_RUNS - runs
    finally:
        mp.undo()


def test_repeat_genome_n_body_runs_reproducibly(repeat_n_body, record_property):
    """The same checkpoint with the components of 512 nodes or more on
    both packages' float32 n-body: both lay out the same components from
    the same start points in the first round, the port's n-body holds
    raven_tpu's positions within POS_ATOL after 1 and 5 iterations on each
    of them, and the port gives the same unitigs on a second run.  The two
    packages' long-edge calls part from the first round on: over the 100
    iterations the n-body is chaotic (the module docstring), and
    raven_tpu's own unitigs differ between its n-body and its float64 host
    loop on this genome.  The rounds and edges that differ, and both
    unitig lengths, are recorded as properties of this test."""
    j_n_body, t_n_body = jlayout._layout_component, tlayout._layout_component
    (want, got, want_calls, got_calls, want_inputs, got_inputs), n_body_runs = repeat_n_body
    assert n_body_runs >= 2
    assert got[0] == got[1]
    assert len(got_calls) == 2 * len(want_calls)
    first = [[x[1:] for x in inputs if x[0] == 0] for inputs in (want_inputs, got_inputs)]
    assert len(first[0]) == len(first[1]) > 0
    for (pj, aj, bj), (pt, at, bt) in zip(*first):
        assert np.array_equal(pj, pt) and np.array_equal(aj, at) and np.array_equal(bj, bt)
        for iters in (1, 5):
            np.testing.assert_allclose(t_n_body(pt.copy(), at, bt, iters, "cpu"),
                                       j_n_body(pj.copy(), aj, bj, iters), rtol=0, atol=POS_ATOL)
    record_property("first_round_n_body_sizes", [len(p) for p, _, _ in first[0]])
    differ = [(i, sorted(set(g) ^ set(w)))
              for i, (g, w) in enumerate(zip(got_calls, want_calls)) if g != w]
    record_property("long_edge_calls_differ", differ)
    record_property("unitig_lengths", {"raven_tpu": [len(s) for _, s in want],
                                       "port": [len(s) for _, s in got[0]]})


@pytest.mark.xfail(strict=True, reason=(
    "the float32 n-body is chaotic over 100 iterations, and the two packages "
    "sum in another order: their long-edge calls, and so their unitigs, part "
    "on this genome (ROADMAP Queue 3 item 3)"))
def test_repeat_genome_n_body_unitigs_match_jax(repeat_n_body):
    """The gap that test_repeat_genome_n_body_runs_reproducibly records,
    kept visible: through the n-body, the port's unitigs on the repeat
    checkpoint are raven_tpu's.  Expected to fail until the n-body's
    summation order is raven_tpu's (or the repeat cell is held to other
    contigs); a pass fails the run, so the day they agree is seen."""
    (want, got, *_), _ = repeat_n_body
    assert got[0] == want
