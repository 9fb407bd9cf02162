"""raven_tpu_torch.ops.overlap_step against raven_tpu.ops.overlap_step on
the CPU: the same seeded numpy inputs through each of the five metric
functions of both packages, integers bit-equal (K1's plain version in the
port, raven_tpu's jitted sketch_kernel in the reference).

The cases: a capacity below, equal to and above the cells B * L, a read
that repeats a hash inside a bucket (candidate_count's approximation),
rows shorter than k, max_hits below a bucket's size, a surviving run
longer than max_occurrence, the empty blacklist (raises in both), and
estimate_occurrence on empty counts and on freq <= 0."""

import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from raven_tpu.ops import overlap_step as jos  # noqa: E402
from raven_tpu_torch.ops import overlap_step as tos  # noqa: E402
from raven_tpu_torch.ops.sketch import sketch_compact  # noqa: E402

INF = 0xFFFFFFFF
K, W = 15, 5


def _reads(case: str):
    """(codes [B, L] uint8, lengths, read_ids [B] int32) for a named case.
    Reads are cut from a short genome, so most buckets hold several reads."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    B, L = 6, 256
    genome = rng.integers(0, 4, 500).astype(np.uint8)
    codes = np.zeros((B, L), dtype=np.uint8)
    for b in range(B):
        s = int(rng.integers(0, genome.size - L))
        codes[b] = genome[s : s + L]
    lengths = np.full(B, L, dtype=np.int32)
    if case == "repeat_in_read":
        unit = rng.integers(0, 4, 40).astype(np.uint8)
        codes[1] = np.tile(unit, -(-L // unit.size))[:L]  # a hash repeats in read 1
        codes[3, :120] = codes[1, :120]
    if case == "short_rows":
        lengths[[0, 2, 5]] = [K - 1, 0, K + W - 2]
    if case == "ragged":
        lengths[:] = rng.integers(K, L + 1, B)
    read_ids = np.arange(11, 11 + B, dtype=np.int32)
    return codes, lengths, read_ids


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _eq(got, want):
    g = got.numpy().astype(np.int64)
    w = np.asarray(want).astype(np.int64)
    assert g.shape == w.shape
    assert np.array_equal(g, w), f"{int((g != w).sum())} of {g.size} entries differ"


def _bucket_sizes(codes, lengths, read_ids, capacity):
    key = sketch_compact(_t(codes), _t(lengths), _t(read_ids), K, W, capacity)[0]
    key = key[: min(capacity, codes.size)].numpy()
    return np.unique(key[key != INF], return_counts=True)[1]


# (case, capacity as a multiple of B * L, max_hits, occurrence)
OVERLAP_CASES = [
    ("cap_below", 0.25, 4, 64),
    ("cap_equal", 1.0, 4, 64),
    ("cap_above", 1.5, 4, 64),
    ("short_rows", 1.0, 4, 64),
    ("max_hits_below_bucket", 1.0, 2, 64),
    ("repeat_in_read", 1.0, 8, 64),
    ("ragged", 0.5, 3, 3),
]


@pytest.mark.parametrize("case,cap,max_hits,occ", OVERLAP_CASES,
                         ids=[c[0] for c in OVERLAP_CASES])
def test_overlap_candidates_matches_jax(case, cap, max_hits, occ):
    codes, lengths, read_ids = _reads(case)
    capacity = int(cap * codes.size)
    want = jos.overlap_candidates_kernel(_j(codes), _j(lengths), _j(read_ids), K, W,
                                         capacity, max_hits, occ)
    got = tos.overlap_candidates(_t(codes), _t(lengths), _t(read_ids), K, W, capacity,
                                 max_hits, occ)
    n = min(capacity, codes.size) * max_hits
    assert len(got) == 7
    for g, w in zip(got[:6], want[:6]):
        assert g.numel() == n
        _eq(g, w)
    assert got[5].dtype == torch.bool
    assert int(got[6]) == int(want[6]) > 0
    if case == "max_hits_below_bucket":
        assert _bucket_sizes(codes, lengths, read_ids, capacity).max() > max_hits


CANDIDATE_CASES = [
    ("cap_below", 0.25, 64),
    ("cap_equal", 1.0, 64),
    ("cap_above", 1.5, 64),
    ("short_rows", 1.0, 64),
    ("repeat_in_read", 1.0, 64),
    ("ragged", 1.0, 2),
]


@pytest.mark.parametrize("case,cap,occ", CANDIDATE_CASES, ids=[c[0] for c in CANDIDATE_CASES])
def test_candidate_count_matches_jax(case, cap, occ):
    codes, lengths, read_ids = _reads(case)
    capacity = int(cap * codes.size)
    want = int(jos.candidate_count_kernel(_j(codes), _j(lengths), _j(read_ids), K, W,
                                          capacity, occ))
    got = tos.candidate_count(_t(codes), _t(lengths), _t(read_ids), K, W, capacity, occ)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want > 0
    if case == "repeat_in_read":
        # the documented approximation: per bucket c (c - 1) / 2, above the
        # count of pairs of distinct reads when a read repeats a hash
        key, ids = (c.numpy() for c in sketch_compact(
            _t(codes), _t(lengths), _t(read_ids), K, W, capacity)[:2])
        exact = 0
        for h in np.unique(key[key != INF]):
            sel = key == h
            if sel.sum() <= occ:
                u, c = np.unique(ids[sel], return_counts=True)
                exact += (c.sum() ** 2 - (c ** 2).sum()) // 2
        assert int(got) > exact


def _keys(rng, n, distinct, n_inf):
    """n keys over `distinct` values below 2^30 (skewed run lengths) and
    n_inf UINT32_INF sentinels, shuffled, as uint32."""
    vals = rng.integers(0, 1 << 30, distinct, dtype=np.int64)
    p = rng.random(distinct) ** 3
    keys = rng.choice(vals, n - n_inf, p=p / p.sum())
    keys = np.concatenate([keys, np.full(n_inf, INF, np.int64)])
    return rng.permutation(keys).astype(np.uint32)


def _runs(keys):
    u, c = np.unique(keys[keys != INF], return_counts=True)
    return u, c


FILTERED_CASES = ["keys_5_7_9", "blacklist_at_threshold", "long_runs_survive",
                  "blacklist_misses_all", "empty_blacklist"]


@pytest.mark.parametrize("case", FILTERED_CASES)
def test_join_count_filtered_matches_jax(case):
    rng = np.random.default_rng(len(case))
    if case == "keys_5_7_9":
        keys = np.array([5, 5, 5, 7, 7, 9, INF], np.uint32)
        blacklist, maxocc = np.array([9], np.uint32), 1
    else:
        keys = _keys(rng, 3000, 400, 50)
        u, c = _runs(keys)
        maxocc = 6
        if case == "blacklist_at_threshold":  # every surviving run <= maxocc
            blacklist = u[c > maxocc]
        elif case == "long_runs_survive":  # only some long runs blacklisted
            blacklist = u[c > maxocc][::3]
            assert (c[~np.isin(u, blacklist)] > maxocc).any()
        elif case == "blacklist_misses_all":
            blacklist = np.array([(1 << 30) + 5, (1 << 30) + 9], np.int64)
        else:
            blacklist = np.zeros(0, np.int64)
        blacklist = np.sort(blacklist).astype(np.uint32)
    tk, tb = _t(keys.astype(np.int64)), _t(blacklist.astype(np.int64))
    if case == "empty_blacklist":
        with pytest.raises(TypeError):
            jos.join_count_filtered_kernel(_j(keys), _j(blacklist), maxocc)
        with pytest.raises(TypeError):
            tos.join_count_filtered(tk, tb, maxocc)
        return
    want = int(jos.join_count_filtered_kernel(_j(keys), _j(blacklist), maxocc))
    got = tos.join_count_filtered(tk, tb, maxocc)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    if case == "keys_5_7_9":
        assert want == 3  # c (c - 1) / 2 a run would give 4
    if case == "blacklist_at_threshold":
        u, c = _runs(keys)
        c = c[~np.isin(u, blacklist)]
        assert want == int((c * (c - 1) // 2).sum()) > 0


JOIN_CASES = [("keys_5_7_9", 2), ("skewed", 6), ("skewed", 1), ("skewed", 10**6),
              ("all_sentinel", 4)]


@pytest.mark.parametrize("case,occ", JOIN_CASES,
                         ids=[f"{c}-{o}" for c, o in JOIN_CASES])
def test_join_count_matches_jax(case, occ):
    rng = np.random.default_rng(occ)
    if case == "keys_5_7_9":
        keys = np.array([5, 5, 5, 7, 7, 9, INF], np.uint32)
    elif case == "skewed":
        keys = _keys(rng, 5000, 600, 80)
    else:
        keys = np.full(64, INF, np.uint32)
    ids = rng.integers(0, 50, keys.size).astype(np.int32)
    want = int(jos.join_count_kernel(_j(keys), _j(ids), occ))
    got = tos.join_count(_t(keys.astype(np.int64)), _t(ids), occ)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    u, c = _runs(keys)
    c = c[c <= occ]
    assert want == int((c * (c - 1) // 2).sum())


OCC_CASES = [("empty", 0.001), ("freq_zero", 0.0), ("freq_negative", -0.5),
             ("tail", 0.001), ("half", 0.5), ("freq_one", 1.0), ("one_count", 0.2)]


@pytest.mark.parametrize("case,freq", OCC_CASES, ids=[c[0] for c in OCC_CASES])
def test_estimate_occurrence_matches_jax(case, freq):
    rng = np.random.default_rng(3)
    counts = {"empty": np.zeros(0, np.int64), "one_count": np.array([7])}.get(
        case, rng.integers(1, 200, 5000))
    want = jos.estimate_occurrence(counts, freq)
    got = tos.estimate_occurrence(counts, freq)
    assert type(got) is int and got == want
    if case in ("empty", "freq_zero", "freq_negative"):
        assert got == np.iinfo(np.int64).max
