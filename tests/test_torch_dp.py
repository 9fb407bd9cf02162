"""Port window-placement DP (raven_tpu_torch.ops.dp_device) vs the JAX
package: boundary_crossings_device on the CPU against raven_tpu's
jax_dp.boundary_crossings_device and align_dp.batched_boundary_crossings,
exactly, on random inter-anchor segments from each of the polisher's four
segment-size buckets; infix_align_device against raven_tpu's and
align_dp.batched_infix_align; plus the copied host modules (align_dp, the
native crossings and POA) against raven_tpu's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu.ops import align_dp as jad  # noqa: E402
from raven_tpu.ops import jax_dp  # noqa: E402
from raven_tpu.ops import poa as jpoa  # noqa: E402
from raven_tpu_torch.ops import align_dp as tad  # noqa: E402
from raven_tpu_torch.ops import dp_device  # noqa: E402
from raven_tpu_torch.ops import poa as tpoa  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several xdist workers on the same cores; torch's
    default of one intra-op thread per core makes their OpenMP threads spin
    against each other through this file's thousands of small row ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Polisher._solve_segments buckets segments by size: 64, 256, 1024 and
# MAX_SEG + 1; the last is sampled just above 1024 to keep the CPU DP small
BUCKETS = [(8, 64), (65, 256), (257, 1024), (1025, 1300)]


def _mutate(rng, seq, rate=0.08):
    keep = rng.random(seq.size) >= rate / 2
    s = seq[keep]
    subs = rng.random(s.size) < rate / 2
    s = np.where(subs, (s + rng.integers(1, 4, s.size)) % 4, s).astype(np.uint8)
    ins = rng.random(s.size) < rate / 2
    return np.repeat(s, 1 + ins.astype(np.int64))


def _segments(rng, lo, hi, n):
    tgts = [rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8) for _ in range(n)]
    qrys = [_mutate(rng, t) for t in tgts]
    qrys[0] = qrys[0][: max(1, qrys[0].size // 3)]  # a short query
    B, T, Q = n, max(t.size for t in tgts), max(q.size for q in qrys)
    tg = np.full((B, T), 250, np.uint8)
    qr = np.full((B, Q), 251, np.uint8)
    for b in range(B):
        tg[b, : tgts[b].size] = tgts[b]
        qr[b, : qrys[b].size] = qrys[b]
    tl = np.array([t.size for t in tgts], np.int64)
    ql = np.array([q.size for q in qrys], np.int64)
    cr = np.array([int(rng.integers(0, s + 1)) for s in tl], np.int64)
    cr[1] = 0  # crossing at the first row
    cr[2] = tl[2]  # ... and at the last
    return tg, tl, qr, ql, cr


@pytest.mark.parametrize("bucket", BUCKETS, ids=[str(b[1]) for b in BUCKETS])
def test_boundary_crossings_match_jax(bucket):
    rng = np.random.default_rng(bucket[1])
    args = _segments(rng, *bucket, 12)
    runs = dp_device.DEVICE_RUNS
    got = dp_device.boundary_crossings_device(*args, "cpu")
    assert dp_device.DEVICE_RUNS == runs  # counts runs on the card only
    assert got.dtype == np.int64 and got.shape == (12,)
    assert np.array_equal(got, jax_dp.boundary_crossings_device(*args))
    assert np.array_equal(got, jad.batched_boundary_crossings(*args))
    assert np.array_equal(got, tad.batched_boundary_crossings(*args))


def test_rows_scan_matches_forward_rows():
    rng = np.random.default_rng(4)
    tg, tl, qr, ql, cr = _segments(rng, 20, 90, 9)
    want = jad.batched_forward_rows(tg, qr, cr)
    got = dp_device.rows_scan(
        torch.from_numpy(tg), torch.from_numpy(qr), torch.from_numpy(cr)
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_host_copies_match():
    rng = np.random.default_rng(6)
    args = _segments(rng, 30, 200, 10)
    want = jad.native_boundary_crossings(*args)
    got = tad.native_boundary_crossings(*args)
    assert want is not None and got is not None
    assert np.array_equal(got, want)
    backbone = rng.integers(0, 4, 300).astype(np.uint8)
    frags = [_mutate(rng, backbone) for _ in range(8)]
    wts = [rng.integers(1, 40, f.size).astype(np.uint8) for f in frags]
    for w in (None, wts):
        assert np.array_equal(
            tpoa.poa_consensus(backbone, frags, w), jpoa.poa_consensus(backbone, frags, w)
        )
    assert tpoa._native_poa() is not None


def _infix_case(rng, B=8):
    """tests/test_align_dp.py:53's inputs: targets of 20-120 bases planted,
    with a substitution, in queries of 50-250."""
    t_lens = rng.integers(20, 120, B)
    q_lens = rng.integers(50, 250, B)
    T, Q = int(t_lens.max()), int(q_lens.max())
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    q = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    for b in range(B):
        tl, ql = int(t_lens[b]), int(q_lens[b])
        s = int(rng.integers(0, max(1, ql - tl)))
        seg = t[b, :tl].copy()
        if seg.size > 10:
            seg[5] = (seg[5] + 1) % 4
        q[b, s : s + min(seg.size, ql - s)] = seg[: min(seg.size, ql - s)]
    return t, t_lens, q, q_lens


@pytest.mark.parametrize("edge", ["planted", "empty-targets"])
def test_infix_align_device_matches_jax(edge):
    """infix_align_device against jax_dp.infix_align_device and
    align_dp.batched_infix_align, bit for bit; with some t_lens of 0 (the
    whole query free: distance 0 at column 0)."""
    rng = np.random.default_rng(53)
    t, t_lens, q, q_lens = _infix_case(rng)
    if edge == "empty-targets":
        t_lens[[0, 5]] = 0
    got = dp_device.infix_align_device(t, t_lens, q, q_lens, device="cpu")
    want = jax_dp.infix_align_device(t, t_lens, q, q_lens)
    host = jad.batched_infix_align(t, t_lens, q, q_lens)
    for g, w, h in zip(got, want, host):
        assert g.dtype == np.int64
        assert np.array_equal(g, w)
        assert np.array_equal(g, h)
    if edge == "empty-targets":
        assert got[0][0] == got[2][0] == 0
