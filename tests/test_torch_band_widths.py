"""The band kernels' plain versions at the band widths raven_tpu takes
beside the main path's 256, against raven_tpu on the CPU, on the same numpy
inputs: the shift-banded forward and walk (K3/K4's plain versions) and
band_window_consensus at bw = 128 and 384, and the anchored banded forward
and walk (K9/K10's plain versions), the vote tables and
device_window_consensus(banded=True) at q_pad = 100, 128 and 200 (bands of
128, 128 and 256, two of them wider than the fragment), all integer
outputs bit for bit; and the card kernels' shape checks, which take these
widths, bw = 528 and q_pad = 8200, and still refuse bw = 520 and every
other width that is not raven_tpu's.  The CUDA kernels
themselves are held against their plain versions at these widths on the
card by chip_smoke.py's phase 13."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu.ops import consensus_band as jb  # noqa: E402
from raven_tpu.ops import consensus_device as jcd  # noqa: E402
from raven_tpu_torch.ops import band_cuda  # noqa: E402
from raven_tpu_torch.ops import banded_cuda as tbc  # noqa: E402
from raven_tpu_torch.ops import consensus_band as tb  # noqa: E402
from raven_tpu_torch.ops import consensus_device as tcd  # noqa: E402
from tests.test_torch_band import _windows  # noqa: E402
from tests.test_torch_banded_consensus import (  # noqa: E402
    _banded_case,
    _walk_both,
    _windows_like_anchored_partial,
)

BAND_WIDTHS = (128, 384)
Q_PADS = (100, 128, 200)
BANDED_CASES = ("default spans", "partial spans", "steep spans", "qlen 0",
                "all mismatches", "walks from row 0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.delenv("RAVEN_TPU_CONSENSUS_GROUP", raising=False)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True, order="C")) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _band_batch(bw, kind, T=96):
    """A group of 5 windows laid out as band_window_consensus lays it out
    at a band of bw (its host_layout): (cons_arr, cons_lens, cw, tl,
    fw_sh, q_lens, r0, win, NWIN).  `kind` "spans" places 40% of the
    fragments on a part of their window; "insertion-runs" puts 1-2 runs of
    20-60 bases the consensus lacks into each fragment, whose left moves
    cross the kernel's 16-lane strips."""
    rng = np.random.default_rng(bw + len(kind))
    windows = _windows(rng, 5, 80, 8, spans=kind == "spans")
    if kind == "insertion-runs":
        runs = []
        for bb, frags, wts in windows:
            fr, wt = [], []
            for f, w in zip(frags, wts):
                for _ in range(int(rng.integers(1, 3))):
                    at = int(rng.integers(1, f.size))
                    n = int(rng.integers(20, 61))
                    f = np.concatenate([f[:at], rng.integers(0, 4, n).astype(np.uint8), f[at:]])
                    w = np.concatenate([w[:at], np.full(n, 30, np.uint8), w[at:]])
                fr.append(f)
                wt.append(w)
            runs.append((bb, fr, wt))
        windows = runs
    grp = [(w[0], w[1], w[2], w[3] if len(w) > 3 else None) for w in windows]
    (cons0, lens0, fw_sh, q_lens, r0, win), NWIN = tb.host_layout(grp, T, 4 * T, bw)
    return cons0, lens0, cons0[win], lens0[win], fw_sh, q_lens, r0, win, NWIN


@pytest.mark.parametrize("kind", ["spans", "insertion-runs"])
@pytest.mark.parametrize("bw", BAND_WIDTHS)
def test_band_forward_and_walk_match_jax_at_width(bw, kind):
    """K3's and K4's plain versions at bw against raven_tpu's band_forward
    and mask_walk_votes (each fragment its own window, so raven_tpu's
    tables are its vote rows), through the public wrappers on CPU tensors,
    which launch nothing."""
    T = 96
    cons0, lens0, cw, tl, fw_sh, q_lens, r0, win, _ = _band_batch(bw, kind)
    launches = dict(band_cuda.LAUNCHES)
    got = band_cuda.band_forward(*_t(cw, tl, fw_sh, q_lens, r0), T, bw)
    want = jb.band_forward(*_j(cw, tl, fw_sh, q_lens, r0), T, bw)
    assert got[0].shape == (T, cw.shape[0], bw // 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    B = cw.shape[0]
    want_tables = jb.mask_walk_votes(
        *want, *_j(fw_sh, q_lens, r0, np.arange(B, dtype=np.int32)), T, bw, B
    )
    votes, ins = band_cuda.mask_walk_votes(*got, *_t(fw_sh, q_lens, r0), T, bw)
    tables = band_cuda.vote_tables(votes, ins, torch.arange(B, dtype=torch.int32), B)
    for g, w in zip(tables, want_tables):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert votes.any() and ins.any()
    assert band_cuda.LAUNCHES == launches
    if kind == "insertion-runs":
        # in-fragment runs of 17 left moves: each crosses a strip boundary
        mv = got[0].numpy().astype(np.int64) & 0xFFFFFFFF
        codes = ((mv[..., None] >> (2 * np.arange(16))) & 3).reshape(T, -1, bw)
        j = (np.arange(1, T + 1)[:, None, None] + np.arange(bw)[None, None, :]
             - bw // 2 - r0[None, :, None])
        left = (codes == 2) & (j >= 1) & (j <= q_lens[None, :, None])
        runs = np.lib.stride_tricks.sliding_window_view(left, 17, axis=2).all(axis=3)
        assert runs.sum() > 10


@pytest.mark.parametrize("bw", BAND_WIDTHS)
def test_band_window_consensus_matches_jax_at_width(bw):
    rng = np.random.default_rng(41 + bw)
    windows = _windows(rng, 5, 150, 10, spans=True)
    kw = dict(iterations=2, t_pad=256, q_pad=320, bw=bw)
    got = tb.band_window_consensus(windows, device="cpu", **kw)
    want = jb.band_window_consensus(windows, group=128, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", BANDED_CASES)
@pytest.mark.parametrize("q_pad", Q_PADS)
def test_banded_plain_matches_jax_at_q_pad(q_pad, name):
    """K9's and K10's plain versions at raven_tpu's band for q_pad,
    min(256, pow2(q_pad)), against nw_moves_banded_kernel on every output
    and traceback_banded_kernel's paths as primitives; at q_pad 100 and 200
    the band is wider than the fragment and its columns past Q read the
    fragment's last code."""
    T, Q = 96, q_pad
    BW = min(256, tcd._pow2_of(Q))
    assert BW == jcd._pow2_of(Q) if Q <= 128 else BW == 256
    cw, tl, fr, ql, r0, r1, wt = _banded_case(name, T, Q)
    launches = dict(tbc.LAUNCHES)
    want = jcd.nw_moves_banded_kernel(*_j(cw, tl, fr, ql, r0, r1), T=T, Q=Q, BW=BW)
    got = tbc.nw_moves_banded(*_t(cw, tl, fr, ql, r0, r1), T, Q, BW)
    for what, g, w in zip(("moves", "offs", "end_scores", "row0_score"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, what
        assert g.shape == w.shape, what
        assert np.array_equal(g.numpy(), w), what
    gp, wp, _ = _walk_both(*got, ql, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert np.array_equal(g.numpy(), w), what
    assert tbc.LAUNCHES == launches
    if Q + 1 < BW:
        assert (got[1].numpy() == 0).all()  # the band never leaves column 0


@pytest.mark.parametrize("q_pad", Q_PADS)
def test_fused_votes_banded_matches_jax_at_q_pad(q_pad):
    T, Q, NWIN = 96, q_pad, 8
    BW = min(256, tcd._pow2_of(Q))
    cw, tl, fr, ql, r0, r1, wt = _banded_case("partial spans", T, Q, B=32)
    win_idx = (np.arange(32) % NWIN).astype(np.int32)
    cons_arr = np.full((NWIN, T), -1, np.int32)
    cons_lens = np.zeros(NWIN, np.int32)
    for b in range(NWIN):  # each window's consensus from its first fragment row
        cons_arr[b], cons_lens[b] = cw[b], tl[b]
    cons_runs = jcd.homopolymer_run_map(cons_arr, cons_lens)
    case = (cons_arr, cons_lens, cons_runs, fr, ql, wt, win_idx, r0, r1)
    want = jcd.fused_votes_banded_kernel(*_j(*case), T=T, Q=Q, BW=BW, STEPS=T + Q, NWIN=NWIN)
    got = tbc.fused_votes_banded(*_t(*case), T, Q, BW, NWIN)
    for what, g, w in zip(("base_votes", "ins_votes", "cover"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), what
    assert got[2].numpy().any()


@pytest.mark.parametrize("q_pad", Q_PADS)
def test_banded_window_consensus_matches_jax_at_q_pad(q_pad):
    """device_window_consensus(banded=True) with fragments cut to q_pad:
    raven_tpu's consensus, token for token."""
    windows = _windows_like_anchored_partial(np.random.default_rng(23 + q_pad))[:2]
    kw = dict(iterations=2, t_pad=640, q_pad=q_pad, chunk=32)
    want = jcd.device_window_consensus(windows, banded=True, **kw)
    got = tcd.device_window_consensus(windows, banded=True, device="cpu", **kw)
    assert len(got) == len(want) == len(windows)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)


def test_kernel_shape_checks_take_raven_tpus_widths():
    """The checks the wrappers run before a launch: K3/K4 take every
    multiple of 16 from 16 to 512 and past it (528: the wide and direct
    routes) and refuse other widths and bw = 520; K9/K10 take raven_tpu's
    bands for q_pad 100, 128 and 200 and q_pad = 8200 (the cap of 8192 is
    gone) and refuse other widths."""
    for bw in (*range(16, 513, 16), 528):
        band_cuda.check_kernel_shape(640, bw)
    for t, bw in ((640, 520), (640, 8), (640, 0), (640, 264), (0, 256)):
        with pytest.raises(ValueError, match="multiple of 16"):
            band_cuda.check_kernel_shape(t, bw)
    for q_pad in (*Q_PADS, 768, 8192, 8200):
        tbc.check_kernel_shape(640, q_pad, min(256, tcd._pow2_of(q_pad)))
    for t, q, bw in ((640, 768, 512), (640, 100, 64), (640, 0, 128)):
        with pytest.raises(ValueError, match="BW in"):
            tbc.check_kernel_shape(t, q, bw)
    # a launch is refused before it reaches the card: the CPU tensors never
    # get there, so the check is the kernel path's own
    cw, tl, fr, ql, r0, r1, _ = _t(*_banded_case("default spans", 8, 8200, B=2))
    with pytest.raises(ValueError, match="BW in"):
        tbc._forward_kernel(cw, tl, fr, ql, r0, r1, 8, 8200, 512)
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        band_cuda._forward_kernel(x, x[:, 0].contiguous(), torch.zeros((2, 8 + 520 + 1), dtype=torch.uint8),
                                  x[:, 0].contiguous(), x[:, 0].contiguous(), 8, 520)
