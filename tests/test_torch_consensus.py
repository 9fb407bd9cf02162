"""Port window consensus (raven_tpu_torch.ops.consensus_cuda /
consensus_device) vs the JAX package on the same numpy inputs:
votes_primitives_plain against the interpret-mode Pallas kernel, the vote
tables against fused_votes_kernel(band=0), the copied host helpers, and
device_window_consensus against raven_tpu's full-NW path — all exactly
equal.  The CUDA kernel K2 itself is held against votes_primitives_plain
on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu.ops import consensus_device as jcd  # noqa: E402
from raven_tpu.ops import pallas_consensus as jpc  # noqa: E402
from raven_tpu_torch.ops import consensus_cuda as tcc  # noqa: E402
from raven_tpu_torch.ops import consensus_device as tcd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several xdist workers on the same cores; torch's
    default of one intra-op thread per core makes their OpenMP threads spin
    against each other through this file's thousands of small row ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_case(rng, NWIN, T, Q, B, partial=True):
    """tests/test_pallas_consensus.py's case generator: windows of random
    consensus, fragments drawn from them with deletions, substitutions and
    insertions (30% of them partial), weights 1-59, and one padding row
    with q_len 0."""
    cons_lens = rng.integers(T // 2, T - 4, NWIN).astype(np.int32)
    cons_arr = np.where(
        np.arange(T)[None, :] < cons_lens[:, None],
        rng.integers(0, 4, (NWIN, T)),
        -1,
    ).astype(np.int32)
    win_idx = (np.arange(B) % NWIN).astype(np.int32)
    frags = np.full((B, Q), -1, np.int32)
    q_lens = np.zeros(B, np.int32)
    wts = np.zeros((B, Q), np.int32)
    for b in range(B):
        cl = int(cons_lens[win_idx[b]])
        src = cons_arr[win_idx[b], :cl].astype(np.uint8)
        if partial and rng.random() < 0.3:
            r0 = int(rng.integers(0, cl // 2))
            r1 = int(rng.integers(r0 + cl // 4, cl + 1))
            src = src[r0:r1]
        keep = rng.random(src.size) >= 0.05
        s = src[keep]
        subs = rng.random(s.size) < 0.05
        s = np.where(subs, (s + 1) % 4, s)
        ins = rng.random(s.size) < 0.05
        s = np.repeat(s, 1 + ins.astype(np.int64))[: Q - 1]
        q_lens[b] = s.size
        frags[b, : s.size] = s
        wts[b, : s.size] = rng.integers(1, 60, s.size)
    q_lens[-1] = 0
    frags[-1] = -1
    wts[-1] = 0
    cons_runs = jcd.homopolymer_run_map(cons_arr, cons_lens)
    return cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_votes_primitives_plain_matches_pallas():
    NWIN, T, Q, B = 4, 128, 160, 32
    rng = np.random.default_rng(17)
    cons_arr, cons_lens, _, frags, q_lens, wts, win_idx = _mk_case(rng, NWIN, T, Q, B)
    # weights up to 255 reach the top of the packed fields
    wts = np.where(frags >= 0, rng.integers(0, 256, wts.shape), 0).astype(np.int32)
    cw = cons_arr[win_idx]
    cwl = cons_lens[win_idx]
    want = jpc.pallas_votes_primitives(
        jnp.asarray(cw), jnp.asarray(cwl), jnp.asarray(frags),
        jnp.asarray(q_lens), jnp.asarray(wts), T, Q, True,
    )
    got = tcc.votes_primitives(_t(cw), _t(cwl), _t(frags), _t(q_lens), _t(wts))
    assert got[0].dtype == torch.int32
    for name, g, w, width in zip(
        ("col_sym", "col_w", "ins_b", "ins_w"), got, want, (T, T, T + 1, T + 1)
    ):
        w = np.asarray(w)
        assert g.shape == (B, width), name
        assert np.array_equal(g.numpy(), w[:, :width]), name
        assert np.array_equal(g.numpy()[:, :T], w[:, :T]), name
    # the insertion columns past T + 1 are never written on the TPU
    assert (np.asarray(want[2])[:, T + 1 :] == -1).all()
    # the padding row (q_len 0) carries no vote
    assert (got[0][-1] == 5).all() and (got[2][-1] == -1).all()


def _edge_case(name):
    """Inputs that K2's fragment pairs (rows 2p, 2p+1) and column tiles
    could break, each [B, T] / [B, Q] int32 with B a multiple of 8 (the
    Pallas kernel's block); the same cases chip_smoke.py holds the card to."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("adjacent windows", "qlen 0 in odd rows"):
        cons_arr, cons_lens, _, frags, q_lens, wts, win_idx = _mk_case(rng, 3, 96, 128, 16)
        if name == "qlen 0 in odd rows":
            q_lens[[3, 9]] = 0
            frags[[3, 9]] = -1
            wts[[3, 9]] = 0
        return cons_arr[win_idx], cons_lens[win_idx], frags, q_lens, wts
    B, T, Q = 8, 48, 1024
    tl = rng.integers(20, T + 1, B).astype(np.int32)
    cw = np.where(np.arange(T)[None, :] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.zeros(B, np.int32)
    if name == "Q = 1024":  # lengths across the tile edges, one half empty
        ql[:] = [1024, 512, 700, 0, 1, 257, 1000, 33]
        for b in range(B):
            fr[b, : ql[b]] = rng.integers(0, 4, ql[b])
    elif name == "twice the consensus":  # long left runs
        for b in range(B):
            f = np.concatenate([cw[b, : tl[b]], cw[b, : tl[b]]])
            f = np.where(rng.random(f.size) < 0.05, (f + 1) % 4, f)
            ql[b] = f.size
            fr[b, : f.size] = f
    elif name == "all mismatches":  # every cell a mismatch: the DP's floor
        cw = np.where(cw >= 0, 0, -1)
        ql[:] = Q
        fr[:] = 1
    elif name == "walks from row 0":  # q * GAP is the best end value
        tl = (np.arange(B) % 2).astype(np.int32)
        cw = np.where(np.arange(T)[None, :] < tl[:, None], 0, -1)
        ql[:] = 10
        fr[:, :10] = 1
    wts = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0)
    return (cw.astype(np.int32), tl, fr, ql, wts.astype(np.int32))


@pytest.mark.parametrize("name", [
    "adjacent windows", "qlen 0 in odd rows", "Q = 1024", "twice the consensus",
    "all mismatches", "walks from row 0",
])
def test_votes_primitives_plain_matches_pallas_edges(name):
    cw, cwl, frags, q_lens, wts = _edge_case(name)
    T, Q = cw.shape[1], frags.shape[1]
    want = jpc.pallas_votes_primitives(
        *(jnp.asarray(a) for a in (cw, cwl, frags, q_lens, wts)), T, Q, True
    )
    got = tcc.votes_primitives(*(_t(a) for a in (cw, cwl, frags, q_lens, wts)))
    for g, w, width in zip(got, want, (T, T, T + 1, T + 1)):
        assert np.array_equal(g.numpy(), np.asarray(w)[:, :width]), name
    if name == "walks from row 0":  # the walk stays on row 0: one insertion
        assert (got[0].numpy() == 5).all()
        assert (got[2].numpy()[:, 0] == 1).all() and (got[2].numpy()[:, 1:] == -1).all()


@pytest.mark.parametrize("shape", [(4, 128, 160, 32), (8, 256, 384, 64)])
def test_fused_votes_match_fused_votes_kernel(shape):
    NWIN, T, Q, B = shape
    rng = np.random.default_rng(17)
    case = _mk_case(rng, NWIN, T, Q, B)
    want = jcd.fused_votes_kernel(
        *(jnp.asarray(a) for a in case), T=T, Q=Q, STEPS=T + Q, NWIN=NWIN, band=0
    )
    got = tcc.fused_votes(*(_t(a) for a in case), T, Q, NWIN)
    for name, g, w in zip(("base_votes", "ins_votes", "cover"), got, want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("share", [0.01, 0.0], ids=["few-votes", "no-votes"])
def test_votes_from_primitives_sparse_matches_jax(share):
    """The vote epilogue on primitives where nearly every entry, or every
    one, carries no vote (each adds 0 at its own cell, where raven_tpu
    masks it): the tables equal raven_tpu's votes_from_primitives, and
    with no vote at all they are zero.  The entries without a vote carry
    weights that must not be counted."""
    NWIN, T, B = 6, 96, 40
    rng = np.random.default_rng(29)
    cons_lens = rng.integers(T // 2, T, NWIN).astype(np.int32)
    cons_arr = np.where(
        np.arange(T)[None, :] < cons_lens[:, None], rng.integers(0, 4, (NWIN, T)), -1
    ).astype(np.int32)
    cons_runs = jcd.homopolymer_run_map(cons_arr, cons_lens)
    win_idx = rng.integers(0, NWIN, B).astype(np.int32)
    vote = rng.random((B, T)) < share
    col_sym = np.where(vote, rng.integers(0, 5, (B, T)), 5).astype(np.int32)
    col_w = rng.integers(0, 256, (B, T)).astype(np.int32)
    ins = rng.random((B, T + 1)) < share
    ins_b = np.where(ins, rng.integers(0, 4, (B, T + 1)), -1).astype(np.int32)
    ins_w = rng.integers(0, 256, (B, T + 1)).astype(np.int32)
    case = (col_sym, col_w, ins_b, ins_w, win_idx, cons_runs)
    want = jpc.votes_from_primitives(*(jnp.asarray(a) for a in case), T=T, NWIN=NWIN)
    got = tcc.votes_from_primitives(*(_t(a) for a in case), T, NWIN)
    for name, g, w in zip(("base_votes", "ins_votes", "cover"), got, want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), np.asarray(w)), name
        if share == 0.0:
            assert not g.numpy().any(), name
    if share > 0.0:
        assert got[0].numpy().any() and got[1].numpy().any()


def test_host_helpers_are_copies():
    rng = np.random.default_rng(3)
    cons = rng.integers(0, 4, (6, 40)).astype(np.int32)
    cons[:, 25:] = -1
    cons[2, :10] = 1  # a homopolymer run
    lens = np.full(6, 25, np.int32)
    runs = tcd.homopolymer_run_map(cons, lens)
    assert np.array_equal(runs, jcd.homopolymer_run_map(cons, lens))
    for wi in range(6):
        L = 25
        bv = rng.integers(0, 5, (40, 5)).astype(np.int64)
        bv[3] = 0  # an unvoted column keeps its base
        iv = rng.integers(0, 3, (41, 4)).astype(np.int64)
        cv = bv.sum(axis=1)
        args = (cons[wi], L, bv, iv, cv, 7)
        assert np.array_equal(
            tcd.rebuild_consensus(*args), jcd.rebuild_consensus(*args)
        )


def _windows(rng, n, window, coverage):
    """bench_polish.make_windows at a small size, plus one window without
    fragments."""
    windows = []
    for _ in range(n):
        truth = rng.integers(0, 4, window).astype(np.uint8)

        def mutate():
            keep = rng.random(window) >= 0.06
            seg = truth[keep]
            subs = rng.random(seg.size) < 0.04
            seg = np.where(
                subs, (seg + rng.integers(1, 4, seg.size)) % 4, seg
            ).astype(np.uint8)
            ins = rng.random(seg.size) < 0.05
            return np.repeat(seg, 1 + ins.astype(np.int64))

        backbone = mutate()
        frags = [mutate() for _ in range(coverage)]
        wts = [rng.integers(1, 40, f.size).astype(np.uint8) for f in frags]
        windows.append((backbone, frags, wts))
    windows[3] = (windows[3][0], [], [])
    return windows


def test_device_window_consensus_matches_jax():
    rng = np.random.default_rng(29)
    windows = _windows(rng, 8, 200, 10)
    kw = dict(iterations=2, t_pad=256, q_pad=256, chunk=64)
    want = jcd.device_window_consensus(windows, banded=False, **kw)
    got = tcd.device_window_consensus(windows, device="cpu", **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)
    assert np.array_equal(got[3], windows[3][0])  # no fragments: unchanged


def test_unported_engines_raise():
    """No engine is left unported: the mesh-sharded votes run (on a
    virtual 2-device CPU mesh, the one device's consensus), and what is
    not a mesh is refused."""
    from raven_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(29)
    windows = _windows(rng, 4, 120, 6)
    kw = dict(iterations=2, t_pad=128, q_pad=160, chunk=16)
    one = tcd.device_window_consensus(windows, device="cpu", **kw)
    two = tcd.device_window_consensus(windows, mesh=Mesh(["cpu"] * 2), **kw)
    for a, b in zip(one, two):
        assert np.array_equal(a, b)
    with pytest.raises(AttributeError):
        tcd.device_window_consensus(windows, mesh=object(), device="cpu")


def test_wrapper_takes_plain_only_on_cpu():
    rng = np.random.default_rng(8)
    cons_arr, cons_lens, _, frags, q_lens, wts, win_idx = _mk_case(rng, 2, 64, 48, 8)
    args = tuple(
        _t(a) for a in (cons_arr[win_idx], cons_lens[win_idx], frags, q_lens, wts)
    )
    launches = tcc.LAUNCHES
    got = tcc.votes_primitives(*args)
    want = tcc.votes_primitives_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tcc.LAUNCHES == launches  # the CPU path launches nothing
    with pytest.raises(TypeError):
        tcc._check(args[0].to(torch.int64), *args[1:])
