"""K12's launch plan (raven_tpu_torch/ops/layout_cuda.py::launch_plan) and
the row-sum order it follows at every size, on the CPU.

The kernel (csrc/layout.cu) runs every iteration of a call in one
cooperative launch of as many blocks as the card holds at once, at most
one a row.  These tests hold the plan's block counts to what a few cards
can hold, its row ranges to an exact cover of the rows, and the row-sum
tree past 2^20 points (four levels of windows) to a written-out nested
loop; the kernel itself is held to its plain version on the card by
chip_smoke.py's phase 5."""

import numpy as np
import pytest
import torch

from raven_tpu_torch.ops import layout_cuda as L

H100 = {"sms": 132, "per_sm": 1}
# a small card that holds two blocks an SM, and one that holds one block
SMALL = {"sms": 16, "per_sm": 2}
ONE = {"sms": 1, "per_sm": 1}
CARDS = [H100, SMALL, ONE]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("card", CARDS)
def test_blocks_fill_the_card_up_to_one_a_row(card):
    held = card["sms"] * card["per_sm"]
    for n in {1, 2, held - 1, held} & set(range(1, held + 1)):
        assert L.launch_plan(n, **card) == {"ctas": n}
    for n in (held + 1, held + 2, 1 << 20, (1 << 20) + 32):
        assert L.launch_plan(n, **card) == {"ctas": held}


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 31, 32, 33, 131, 132, 133, 600, 640, 1024,
                               1025, 1500, 2048, 2049, 32768, 32769, 40000, (1 << 20) + 32])
def test_blocks_never_beyond_coresident_and_rows_covered(card, n):
    ctas = L.launch_plan(n, **card)["ctas"]
    assert 1 <= ctas <= min(n, card["per_sm"] * card["sms"])
    ranges = L.row_ranges(n, ctas)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [r1 - r0 for r0, r1 in ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("n", [1, 2, 7, 1 << 20, (1 << 20) + 1, L.INDEX_MAX])
def test_any_size_is_planned(n):
    assert L.launch_plan(n, **H100)["ctas"] == min(n, 132)


@pytest.mark.parametrize("n", [0, -1, L.INDEX_MAX + 1])
def test_sizes_past_the_index_range_are_refused(n):
    with pytest.raises(ValueError, match="K12 takes"):
        L.launch_plan(n, **H100)


def test_a_card_without_room_for_a_block_is_refused():
    with pytest.raises(ValueError, match="no block"):
        L.launch_plan(600, **dict(H100, per_sm=0))


def _window_sums(x):
    """Each window of 32 values summed in order from +0 (a short last
    window as if padded with +0, which changes no sum)."""
    W = -(-x.size // 32)
    cols = np.zeros(W * 32, np.float32)
    cols[: x.size] = x
    cols = cols.reshape(W, 32)
    s = np.zeros(W, np.float32)
    for c in range(32):
        s = s + cols[:, c]
    return s


def _group(ws, lo, hi, step):
    """The window sums ws[lo:hi] in groups of `step` windows from lo, each
    group's sum (_group again, one level down, or the windows themselves)
    added in order from +0."""
    f = np.float32
    s = f(0)
    for b in range(lo, hi, step):
        s = f(s + (ws[b] if step == 1 else _group(ws, b, min(b + step, hi), step // 32)))
    return s


def _nested(ws, levels):
    """ws's row sum with `levels` levels of groups written out: the top
    sums, in order from +0, the groups of 32^(levels - 1) windows, each of
    which sums its groups of 32^(levels - 2) in order, down to the
    windows.  Returns the sum and the count of top sums."""
    W = ws.size
    step = 32 ** (levels - 1)
    tops = range(0, W, step)
    return _group(ws, 0, W, step), len(tops)


@pytest.mark.parametrize("n,seed", [(32 ** 4 + 32, 7), (32 ** 4 + 32 ** 3 + 64, 5)])
def test_window_sums_four_levels_past_2_20(n, seed):
    """n values summed by window_sums, the plain version's order, and by
    the nested loop with four levels of groups, bit for bit.  At 32^4 + 32
    (2^20 + 32 columns: 32,769 windows, 1,025 groups, 33 groups of groups,
    2 at the top) the fourth level's second group holds one sum, so three
    levels give the same bits; at 32^4 + 32^3 + 64 it holds two, and a
    tree cut to three levels (its 34 sums in order) differs (on these
    values: the two orders part in about half of the seeds)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    got = L.window_sums(torch.as_tensor(x)).numpy()
    ws = _window_sums(x)
    want, tops = _nested(ws, 4)
    assert tops == 2 and got.dtype == np.float32
    assert got.tobytes() == np.float32(want).tobytes()
    three, tops = _nested(ws, 3)
    assert tops == (33 if n == 32 ** 4 + 32 else 34)
    assert (three == want) == (n == 32 ** 4 + 32)


@pytest.mark.parametrize("n", [33, 1100])
def test_sampled_rows_follow_the_plain_version(n):
    """n_body_rows_plain, the plain rules over some rows alone (chip_smoke
    holds K12's rows past 2^20 points to it), against n_body_plain's first
    iteration; at 1,100 points the rows sum two levels of windows."""
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.random((n, 2)), dtype=torch.float32)
    ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, 60)])
    eb = np.concatenate([np.arange(1, n), rng.integers(0, n, 60)])
    rows = np.unique(np.r_[0, n - 1, n // 2, rng.integers(0, n, 8)])
    want = L.n_body_plain(pts, ea, eb, 1)[rows]
    assert torch.equal(L.n_body_rows_plain(pts, ea, eb, rows), want)
