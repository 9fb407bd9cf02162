"""The roofline counts on shapes worked by hand; padding does not move them."""

import numpy as np
import pytest

from perfbench import rooflines as rf


def _cells_by_loop(t, q, r0, bw):
    n = 0
    for r in range(t):
        for u in range(bw):
            j = r + u - bw // 2 - r0
            n += 0 <= j <= q
    return n


def test_band_cells_by_hand():
    # t = 4, q = 2, r0 = 0, bw = 4: rows see columns {0,1}, {0,1,2}, {0,1,2}, {1,2}
    assert rf.band_cells([4], [2], [0], 4) == 10
    assert _cells_by_loop(4, 2, 0, 4) == 10


@pytest.mark.parametrize("t,q,r0,bw", [(500, 480, 0, 256), (500, 120, 380, 256), (37, 600, 5, 16),
                                       (640, 768, 639, 256), (1, 0, 0, 16), (300, 10, 200, 32)])
def test_band_cells_match_a_loop(t, q, r0, bw):
    assert rf.band_cells([t], [q], [r0], bw) == _cells_by_loop(t, q, r0, bw)


def test_counts_come_from_the_data_not_the_padding():
    rng = np.random.default_rng(1)
    t = rng.integers(400, 520, 300)
    q = rng.integers(10, 560, 300)
    r0 = rng.integers(0, 200, 300)
    base = rf.band_forward_bound(t, q, r0, 256)
    # the engine pads consensus rows to t_pad and fragment rows to a power
    # of two: the bound takes the lengths, so neither enters it
    assert base == rf.band_forward_bound(t.copy(), q.copy(), r0.copy(), 256)
    assert base["int_ops"] == rf.band_cells(t, q, r0, 256) * 4
    assert rf.band_cells(np.append(t, 0), np.append(q, 0), np.append(r0, 0), 256) == \
        rf.band_cells(t, q, r0, 256)
    walk = rf.band_walk_bound(t, q, np.minimum(t, 500) - r0)
    assert walk["int_ops"] == 6 * int((np.minimum(t, 500) - r0).sum())


def test_sketch_bound_by_hand():
    b = rf.sketch_bound(bases=1000, reads=2, entries=333, w=5)
    assert b["int_ops"] == 1000 * 34
    assert b["bytes"] == 1000 / 4 + 16 + 9 * 333
    assert b["seconds"] == max(b["bytes"] / rf.HBM_BYTES_PER_S, b["int_ops"] / rf.INT_INSTR_PER_S)


def test_k3_counts_pair_instructions():
    assert rf.K3_INSTR_PER_CELL == 4
    b = rf.band_forward_bound([500], [500], [0], 256)
    assert b["by"] == "operations"
