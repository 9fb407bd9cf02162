"""The consensus kernels at every shape raven_tpu's three engines take.

Each wrapper picks its kernel's route from the shape (`launch_plan`): K2's
16-bit pair route or its int32 route, K3's strip kernels or its wide one,
K4's staged walk or its direct one, K9's packed fragments in shared or in
device memory.  Here, on the CPU: every boundary of those plans one below
and one above (the old route on the old side, the new one past it); the
plain versions, which the wrappers run on a CPU tensor and chip_smoke.py's
phase 13(d) holds the new routes to on the card, against raven_tpu's JAX
functions past each old limit, bit for bit; and the three engines through
device="cpu" at shapes the card refused before (full NW at q_pad 1040,
anchored banded at q_pad 8208, shift-banded at bw 528), byte for byte
against raven_tpu's consensus."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu.ops import consensus_band as jb  # noqa: E402
from raven_tpu.ops import consensus_device as jcd  # noqa: E402
from raven_tpu.ops import pallas_consensus as jpc  # noqa: E402
from raven_tpu_torch.ops import band_cuda as tbd  # noqa: E402
from raven_tpu_torch.ops import banded_cuda as tbc  # noqa: E402
from raven_tpu_torch.ops import consensus_band as tb  # noqa: E402
from raven_tpu_torch.ops import consensus_cuda as tcc  # noqa: E402
from raven_tpu_torch.ops import consensus_device as tcd  # noqa: E402
from tests.test_torch_band import _windows  # noqa: E402
from tests.test_torch_banded_consensus import _banded_case, _walk_both  # noqa: E402

PAIR, I32 = "votes_primitives", "votes_primitives_i32"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True, order="C")) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ the plans
@pytest.mark.parametrize("T, Q, route", [
    (640, 1024, PAIR), (640, 1025, I32),            # the pair route's four tiles
    (9412, 768, PAIR), (9413, 768, I32),            # a warp's shared memory at Q 768
    (9327, 1024, PAIR), (9328, 1024, I32),          # and at Q 1024
    (1, 1, PAIR), (16, 1040, I32), (16384, 1024, I32),
    (64, 262143, I32), (64, 262144, None),          # an end value reaches NEG: refused
], ids=lambda v: str(v))
def test_k2_launch_plan(T, Q, route):
    if route is None:
        with pytest.raises(ValueError, match="sentinel NEG"):
            tcc.launch_plan(T, Q)
        return
    assert tcc.launch_plan(T, Q) == (route, 2 if route == PAIR else 1)


def test_k2_launch_plan_16_bit_range(monkeypatch):
    """4Q + 3T + 8 <= 0xC000: 49,152 keeps the pair route and 49,153 takes
    the int32 one once shared memory is out of the way; with the card's
    227 KB a block, shared memory binds first (Q <= 1024 puts T past
    15,000 there), so both take the int32 route."""
    assert 4 * 1024 + 3 * 15016 + 8 == 49152 and 4 * 1022 + 3 * 15019 + 8 == 49153
    assert tcc.launch_plan(15016, 1024)[0] == tcc.launch_plan(15019, 1022)[0] == I32
    monkeypatch.setattr(tcc, "SMEM_BYTES", 1 << 30)
    assert tcc.launch_plan(15016, 1024)[0] == PAIR
    assert tcc.launch_plan(15019, 1022)[0] == I32
    with pytest.raises(ValueError, match="T >= 1"):
        tcc.launch_plan(0, 768)


@pytest.mark.parametrize("T, BW, fwd, walk", [
    (640, 512, ("band_forward", 4), ("mask_walk_votes", 16)),
    (640, 528, ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)),
    (640, 4096, ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)),
    (640, 256, ("band_forward", 8), ("mask_walk_votes", 16)),
    # K3's T ceilings: 8 fragments at 256, 4 at 512
    (14399, 256, ("band_forward", 8), ("mask_walk_votes_direct", 4)),
    (14400, 256, ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)),
    (28799, 512, ("band_forward", 4), ("mask_walk_votes_direct", 4)),
    (28800, 512, ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)),
    # K4's: 16 fragments beside the best-row tables
    (10143, 256, ("band_forward", 8), ("mask_walk_votes", 16)),
    (10144, 256, ("band_forward", 8), ("mask_walk_votes_direct", 4)),
    (5791, 512, ("band_forward", 4), ("mask_walk_votes", 16)),
    (5792, 512, ("band_forward", 4), ("mask_walk_votes_direct", 4)),
], ids=lambda v: str(v))
def test_band_launch_plan(T, BW, fwd, walk):
    assert tbd.launch_plan(T, BW) == (fwd, walk)


def test_band_launch_plan_refuses():
    """What no route takes: widths that are not a multiple of 16, and past
    a block's 1024 threads of 16 band lanes."""
    tbd.launch_plan(64, tbd.KERNEL_MAX_BW)
    for T, BW in ((64, 520), (64, tbd.KERNEL_MAX_BW + 16), (0, 256)):
        with pytest.raises(ValueError, match="multiple of 16"):
            tbd.launch_plan(T, BW)


SMEM, GLOBAL = "nw_moves_banded", "nw_moves_banded_global"


@pytest.mark.parametrize("T, Q, BW, route", [
    (640, 8192, 256, SMEM), (640, 8208, 256, SMEM),        # the old cap of 8192, gone
    (640, 55887, 256, SMEM), (640, 55888, 256, GLOBAL),    # 8 fragments' codes
    (640, 65536, 256, GLOBAL), (16384, 768, 256, SMEM),
    (640, 27919, 128, SMEM), (640, 27920, 128, GLOBAL),    # 16 fragments at 128
], ids=lambda v: str(v))
def test_banded_launch_plan(T, Q, BW, route):
    assert tbc.launch_plan(T, Q, BW) == (route, tbc.FWD_FRAGS[BW])


# ------------------------------------------- plain versions past the limits
def _k2_case(T, Q, B, seed):
    """[B, T] / [B, Q] int32 K2 inputs: consensus rows of T/2 .. T bases,
    fragments of Q/2 .. Q bases cycling through their consensus with 5%
    substitutions (long left and up runs), weights 1-255."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    cw = np.where(np.arange(T)[None] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(Q // 2, Q + 1))
        src = np.resize(cw[b, : tl[b]], n)
        fr[b, :n] = np.where(rng.random(n) < 0.05, (src + 1) % 4, src)
        ql[b] = n
    wt = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0)
    return cw.astype(np.int32), tl, fr, ql, wt.astype(np.int32)


@pytest.mark.parametrize("T, Q", [(64, 1040), (400, 12000)], ids=["Q1040", "past-16-bit"])
def test_votes_primitives_plain_matches_pallas_past_the_pair_route(T, Q):
    """K2's plain version, which the int32 route is held to on the card,
    against the interpret-mode Pallas kernel: past the pair route's Q of
    1024, and past its 16-bit range (4Q + 3T + 8 = 49,208)."""
    assert tcc.launch_plan(T, Q)[0] == I32
    case = _k2_case(T, Q, 8, T + Q)
    want = jpc.pallas_votes_primitives(*_j(*case), T, Q, True)
    got = tcc.votes_primitives(*_t(*case))
    for name, g, w, width in zip(("col_sym", "col_w", "ins_b", "ins_w"), got, want,
                                 (T, T, T + 1, T + 1)):
        assert np.array_equal(g.numpy(), np.asarray(w)[:, :width]), name
    assert (got[0].numpy() < 5).sum() > 4 * T and (got[2].numpy() >= 0).any()


def _band_group(bw, T=64):
    """Two windows of 60 bases, 3 fragments each, with 1-2 runs of 20-60
    bases the consensus lacks in each fragment, laid out as
    band_window_consensus lays a group out at a band of bw: (cw, tl, fw_sh,
    q_lens, r0) of the 256 rows."""
    rng = np.random.default_rng(bw)
    grp = []
    for bb, frags, wts in _windows(rng, 2, 60, 3):
        fr, wt = [], []
        for f, w in zip(frags, wts):
            for _ in range(int(rng.integers(1, 3))):
                at, n = int(rng.integers(1, f.size)), int(rng.integers(20, 61))
                f = np.concatenate([f[:at], rng.integers(0, 4, n).astype(np.uint8), f[at:]])
                w = np.concatenate([w[:at], np.full(n, 30, np.uint8), w[at:]])
            fr.append(f)
            wt.append(w)
        grp.append((bb, fr, wt, None))
    (cons0, lens0, fw_sh, q_lens, r0, win), _ = tb._prepare_group(grp, T, 4 * T, bw)
    return cons0[win], lens0[win], fw_sh, q_lens, r0


@pytest.mark.parametrize("bw", [528, 1024])
def test_band_plain_matches_jax_past_512(bw):
    """K3's and K4's plain versions, which the wide and direct routes are
    held to on the card, against raven_tpu's band_forward and
    mask_walk_votes (each fragment its own window, so the tables are its
    vote rows) at bands wider than the strip kernels take."""
    T = 64
    assert tbd.launch_plan(T, bw) == (("band_forward_wide", 1), ("mask_walk_votes_direct", 4))
    cw, tl, fw_sh, q_lens, r0 = _band_group(bw, T)
    got = tbd.band_forward(*_t(cw, tl, fw_sh, q_lens, r0), T, bw)
    want = jb.band_forward(*_j(cw, tl, fw_sh, q_lens, r0), T, bw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    B = cw.shape[0]
    votes, ins = tbd.mask_walk_votes(*got, *_t(fw_sh, q_lens, r0), T, bw)
    tables = tbd.vote_tables(votes, ins, torch.arange(B, dtype=torch.int32), B)
    want_tables = jb.mask_walk_votes(
        *want, *_j(fw_sh, q_lens, r0, np.arange(B, dtype=np.int32)), T, bw, B
    )
    for g, w in zip(tables, want_tables):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (votes != 0).sum() > 100 and (ins != 0).any()


@pytest.mark.parametrize("name", ["partial spans", "steep spans"])
def test_banded_plain_matches_jax_past_8192(name):
    """K9's and K10's plain versions, which both of K9's routes are held to
    on the card, against nw_moves_banded_kernel and
    traceback_banded_kernel's paths at q_pad 8208 (the old cap of 8192):
    fragments of a few dozen bases on their consensus, and steep spans
    with fragments thousands of bases long."""
    T, Q, BW = 64, 8208, 256
    cw, tl, fr, ql, r0, r1, wt = _banded_case(name, T, Q, B=4)
    want = jcd.nw_moves_banded_kernel(*_j(cw, tl, fr, ql, r0, r1), T=T, Q=Q, BW=BW)
    got = tbc.nw_moves_banded(*_t(cw, tl, fr, ql, r0, r1), T, Q, BW)
    for what, g, w in zip(("moves", "offs", "end_scores", "row0_score"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), what
    gp, wp, _ = _walk_both(*got, ql, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert np.array_equal(g.numpy(), w), what
    if name == "steep spans":
        assert ql.max() > 1000
        assert (np.diff(got[1].numpy().astype(np.int64), axis=0) > 2).any()


def test_banded_plain_matches_jax_where_band_starts_wrap():
    """raven_tpu computes a band start as (row - r0) * q_len // span in
    int32, which wraps once the product reaches 2^31 (here at row 8,192 of
    fragments 262,144 bases long): the band then falls back to column 0.
    K9's plain version takes the same steps back as raven_tpu's
    nw_moves_banded_kernel, bit for bit (its regather reads NEG where
    raven_tpu's clipped one does)."""
    T, Q, BW = 8200, 262144, 256
    rng = np.random.default_rng(11)
    cw = rng.integers(0, 4, (2, T)).astype(np.int32)
    fr = rng.integers(0, 4, (2, Q)).astype(np.int32)
    tl, ql = np.full(2, T, np.int32), np.full(2, Q, np.int32)
    r0, r1 = np.zeros(2, np.int32), tl.copy()
    assert tbc.launch_plan(T, Q, BW)[0] == GLOBAL
    want = jcd.nw_moves_banded_kernel(*_j(cw, tl, fr, ql, r0, r1), T=T, Q=Q, BW=BW)
    got = tbc.nw_moves_banded(*_t(cw, tl, fr, ql, r0, r1), T, Q, BW)
    for what, g, w in zip(("moves", "offs", "end_scores", "row0_score"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), what
    assert (np.diff(got[1].numpy().astype(np.int64), axis=0) < 0).any()


# ---------------------------------------------------------------- engines
def _probe_windows(seed, spans=False):
    return _windows(np.random.default_rng(seed), 2, 60, 3, spans=spans)


@pytest.mark.parametrize("engine", ["full NW q_pad 1040", "banded q_pad 8208",
                                    "shift-banded bw 528"])
def test_engines_match_jax_past_the_old_limits(engine):
    """The three engines through device="cpu" (the plain versions) at
    shapes the card refused before, raven_tpu's consensus byte for byte."""
    if engine.startswith("shift-banded"):
        windows = _probe_windows(5, spans=True)
        kw = dict(iterations=2, t_pad=128, q_pad=160, bw=528)
        got = tb.band_window_consensus(windows, device="cpu", **kw)
        want = jb.band_window_consensus(windows, group=128, **kw)
    else:
        banded = engine.startswith("banded")
        windows = _probe_windows(7, spans=banded)
        kw = dict(iterations=2, t_pad=128, q_pad=8208 if banded else 1040, chunk=8,
                  banded=banded)
        got = tcd.device_window_consensus(windows, device="cpu", **kw)
        want = jcd.device_window_consensus(windows, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)
