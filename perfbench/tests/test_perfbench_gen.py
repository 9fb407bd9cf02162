"""The generators repeat exactly by seed, and make what their docstrings say."""

import numpy as np
import torch

from perfbench import gen
from perfbench.tests.tiny import READS

SIZES = [40000, 15000]
REPEAT = {"length": 1500, "copies": 4, "divergence": 0.01, "placement": "dispersed"}
DRAFT = {"sub": 0.005, "ins": 0.0025, "del": 0.0025}


def _reads(seed):
    g = gen.generator(seed, "cpu")
    genome, starts = gen.make_genome(g, SIZES, REPEAT, "cpu")
    codes, lens = gen.simulate_reads(g, genome, SIZES, READS)
    return genome.numpy(), starts, codes, lens


def _bank(seed):
    g = gen.generator(seed, "cpu")
    genome, _ = gen.make_genome(g, [6000], None, "cpu")
    return gen.window_bank(g, genome, [6000], READS, DRAFT)


def test_reads_repeat_by_seed():
    a, b, c = _reads(2**31 + 11), _reads(2**31 + 11), _reads(2**31 + 12)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[2][:1000], c[2][:1000])
    genome, starts, codes, lens = a
    assert genome.size == sum(SIZES) and list(starts) == [0, SIZES[0]]
    assert lens.sum() == codes.size and codes.max() <= 3
    assert lens.size == int(sum(SIZES) * READS["depth"] / READS["mean_len"])
    # the error profile: lengths within a few percent of the sources'
    assert abs(lens.mean() / READS["mean_len"] - 1) < 0.1


def test_placements_stay_inside_one_sequence():
    g = gen.generator(7, "cpu")
    start, lens = gen.read_placements(g, [3000, 500, 9000], 40, 1200, 0.25, 400, "cpu")
    ends = np.array([3000, 3500, 12500])
    first = np.searchsorted(ends, start.numpy(), side="right")
    assert (start.numpy() + lens.numpy() <= ends[first]).all()
    assert (lens.numpy() >= 400).all()
    assert (lens.numpy() <= np.array([3000, 500, 9000])[first]).all()


def test_repeat_copies_planted():
    g = gen.generator(3, "cpu")
    genome, _ = gen.make_genome(g, [20000], {"length": 1000, "copies": 3, "divergence": 0.0,
                                             "placement": "even"}, "cpu")
    at = np.linspace(1000, 19000, 3).astype(np.int64)
    copies = [genome[a: a + 1000].numpy() for a in at]
    for c in copies[1:]:
        assert np.array_equal(c, copies[0]) or np.array_equal(c, copies[0][::-1] ^ 3)


def test_window_bank_repeats_by_seed_and_keeps_the_polisher_shape():
    a, b = _bank(123456789012), _bank(123456789012)
    assert len(a) == len(b) == 12
    for (bb1, f1, w1, s1), (bb2, f2, w2, s2) in zip(a, b):
        assert np.array_equal(bb1, bb2) and s1 == s2 and w1 is None and w2 is None
        assert all(np.array_equal(x, y) for x, y in zip(f1, f2))
    for bb, frags, _, spans in a:
        assert len(frags) >= 2 and len(frags) == len(spans)
        assert all(len(f) >= gen.MIN_FRAGMENT for f in frags)
        assert [s[0] for s in spans] == sorted(s[0] for s in spans)
        assert all(0 <= s0 < s1 <= gen.WINDOW_LEN for s0, s1 in spans)
    # partial fragments at read ends
    assert any(s != (0, gen.WINDOW_LEN) for w in a for s in w[3])


def test_mutate_keeps_segments_in_order():
    g = gen.generator(5, "cpu")
    codes = torch.randint(0, 4, (3000,), generator=g, dtype=torch.uint8)
    seg = torch.repeat_interleave(torch.arange(3), torch.tensor([1000, 1500, 500]))
    out, oseg = gen.mutate(g, codes, seg, 0.1, 0.1, 0.1)
    assert (torch.diff(oseg) >= 0).all() and out.max() <= 3
    n = torch.bincount(oseg, minlength=3).numpy()
    assert (np.abs(n / np.array([1000, 1500, 500]) - 1) < 0.1).all()


def test_tandem_array_inserted_head_to_tail():
    tandem = {"sequence": 1, "at": 700, "length": 300, "copies": 5, "divergence": 0.0}
    conf = {"sequences": [2000, 1500, 1000], "tandem": tandem}
    assert gen.sequence_sizes(conf) == [2000, 3000, 1000]
    plain, _ = gen.make_genome(gen.generator(5, "cpu"), conf["sequences"], None, "cpu")
    genome, starts = gen.make_genome(gen.generator(5, "cpu"), conf["sequences"], None, "cpu",
                                     tandem)
    assert genome.numel() == 6000 and list(starts) == [0, 2000, 5000]
    g, p = genome.numpy(), plain.numpy()
    # the sequences' own bases as without the array, the array at 700 of the second
    assert np.array_equal(g[:2700], p[:2700]) and np.array_equal(g[4200:], p[2700:])
    units = g[2700:4200].reshape(5, 300)
    assert (units == units[0]).all() and not np.array_equal(units[0], p[2700:3000])
    tandem["divergence"] = 0.05
    div, _ = gen.make_genome(gen.generator(5, "cpu"), conf["sequences"], None, "cpu", tandem)
    units = div.numpy()[2700:4200].reshape(5, 300)
    assert 0 < (units != units[0]).mean() < 0.2
