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
from tests.test_torch_banded_consensus import (  # noqa: E402
    _banded_case, _prims_from_paths, _walk_both,
)

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
    (64, 262143, I32), (64, 262144, I32),           # end values can reach NEG: taken
    (1, tcc.I32_MAX_TQ - 1, I32), (2, tcc.I32_MAX_TQ - 1, None),  # int32's edge
], ids=lambda v: str(v))
def test_k2_launch_plan(T, Q, route):
    if route is None:
        with pytest.raises(ValueError, match="leave int32"):
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
    # K3's wide route up to a block's 1024 threads of 16 lanes, then its
    # global one
    (64, 16384, ("band_forward_wide", 1), ("mask_walk_votes_direct", 4)),
    (64, 16400, ("band_forward_global", 1), ("mask_walk_votes_direct", 4)),
    (64, 32768, ("band_forward_global", 1), ("mask_walk_votes_direct", 4)),
], ids=lambda v: str(v))
def test_band_launch_plan(T, BW, fwd, walk):
    assert tbd.launch_plan(T, BW) == (fwd, walk)


def test_band_launch_plan_refuses():
    """What no route takes: widths that are not a multiple of 16, T < 1,
    and bands past 2^27 lanes, where K3's closure scan would leave int32;
    past a block's 1024 threads of 16 band lanes the global route takes
    over."""
    assert tbd.launch_plan(64, tbd.WIDE_MAX_BW + 16)[0] == ("band_forward_global", 1)
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


NEG = tcc.NEG


def _neg_chunk(lens=(16, 12)):
    """One chunk past q_len 262,143 at T 16: two windows, with consensus
    rows of `lens` bases, and four fragments cycling through them with 5%
    substitutions, of 262,208 bases in each window (4 q_len - 7 tlen >
    2^20: every end value below NEG), 262,144 and 200,000 (end values above
    NEG), weights 1-255."""
    T, Q, NWIN = 16, 262208, 8
    rng = np.random.default_rng(3)
    cons_lens = np.zeros(NWIN, np.int32)
    cons_lens[:2] = lens
    cons_arr = np.full((NWIN, T), -1, np.int32)
    for w in range(2):
        cons_arr[w, : cons_lens[w]] = rng.integers(0, 4, cons_lens[w])
    win = np.array([0, 1, 0, 1], np.int32)
    ql = np.array([262208, 262208, 262144, 200000], np.int32)
    fr = np.full((4, Q), -1, np.int32)
    for b, n in enumerate(ql):
        src = np.resize(cons_arr[win[b], : cons_lens[win[b]]], n)
        fr[b, :n] = np.where(rng.random(n) < 0.05, (src + 1) % 4, src)
    wt = np.where(fr >= 0, rng.integers(1, 256, fr.shape), 0).astype(np.int32)
    runs = jcd.homopolymer_run_map(cons_arr, cons_lens)
    return (cons_arr, cons_lens, runs, fr, ql, wt, win), T, Q, NWIN


@pytest.mark.parametrize("lens, rows", [((16, 12), [15, 12]), ((14, 10), [14, 10])],
                         ids=["longest-T", "all-shorter-than-T"])
def test_fused_votes_matches_fused_votes_kernel_past_neg(lens, rows):
    """fused_votes, the engine's K2 call, against raven_tpu's
    fused_votes_kernel(band=0) where every end value of a fragment falls
    below NEG: raven_tpu's jnp.argmax then starts the walk one below the
    best row (window 0 with a consensus of T bases), or on the inactive
    row tlen, whose move 3 casts nothing (window 1; and window 0 when
    every consensus is shorter than T, row 14 then lying one past every
    row the port's plain forward computes, while the other fragments still
    walk); the Pallas kernel's rule would start both on row 1
    (fused_votes_pallas gives other tables here)."""
    case, T, Q, NWIN = _neg_chunk(lens)
    want = jcd.fused_votes_kernel(*_j(*case), T=T, Q=Q, STEPS=T + Q, NWIN=NWIN, band=0)
    got = tcc.fused_votes(*_t(*case), T, Q, NWIN)
    for what, g, w in zip(("base_votes", "ins_votes", "cover"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), what
    pallas = tcc.fused_votes_pallas(*_t(*case), T, Q, NWIN)
    assert not all(torch.equal(a, b) for a, b in zip(pallas, got))
    # the walk's start rows in raven_tpu
    cw, cwl = case[0][case[6]], case[1][case[6]]
    _, ends, _ = jcd.nw_moves_kernel(*_j(cw, cwl, case[3], case[4]), T=T, Q=Q)
    ends = np.asarray(ends)
    assert (ends[:, :2] < NEG).sum(axis=0).tolist() == list(lens)
    assert ends.argmax(axis=0)[:2].tolist() == rows


def test_votes_primitives_matches_the_pallas_rule_past_neg():
    """votes_primitives, the counterpart of pallas_votes_primitives, with
    its start row past q_len 262,143: first active row whose end value
    exceeds NEG, row 0 when none does.  The interpret-mode Pallas kernel
    needs a [Q, Q / 8] float32 pack matrix (34 GB at Q 262,208), so here
    raven_tpu's XLA kernels take that rule instead: nw_moves_kernel's end
    values raised to NEG, which jnp.argmax then reads as the Pallas kernel
    reads its own (test_votes_primitives_plain_matches_pallas* hold the
    two rules' shared code to the Pallas kernel itself)."""
    (cons_arr, cons_lens, _, fr, ql, wt, win), T, Q, _ = _neg_chunk()
    cw, cwl = cons_arr[win], cons_lens[win]
    moves, ends, row0 = jcd.nw_moves_kernel(*_j(cw, cwl, fr, ql), T=T, Q=Q)
    pt, pq, pmv = jcd.traceback_kernel(moves, jnp.maximum(ends, NEG), row0, jnp.asarray(ql),
                                       T=T, Q=Q, STEPS=T + Q)
    want = _prims_from_paths(pt, pq, pmv, fr, wt, T, Q)
    got = tcc.votes_primitives(*_t(cw, cwl, fr, ql, wt))
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), got, want):
        assert np.array_equal(g.numpy(), w), what
    # both fragments past the edge walk from row 1: one column vote each
    assert (got[0].numpy() < 5).sum(axis=1)[:2].tolist() == [1, 1]


def test_pallas_consensus_switch_matches_jax(monkeypatch):
    """consensus_device.PALLAS_CONSENSUS, the counterpart of raven_tpu's
    RAVEN_TPU_PALLAS_CONSENSUS=1: without a mesh the engine then takes
    fused_votes_pallas, banded or not, and gives raven_tpu's consensus,
    whose engine runs its Pallas kernel in interpret mode on the CPU
    (outside it, pallas_call refuses the CPU).  fused_votes_pallas itself
    equals raven_tpu's on the same chunk."""
    windows = _probe_windows(7)
    kw = dict(iterations=2, t_pad=128, q_pad=160, chunk=8)
    monkeypatch.setenv("RAVEN_TPU_PALLAS_CONSENSUS", "1")
    monkeypatch.setattr(tcd, "PALLAS_CONSENSUS", True)
    want = jcd.device_window_consensus(windows, **kw)
    for banded in (False, True):
        got = tcd.device_window_consensus(windows, device="cpu", banded=banded, **kw)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    frags, wts, ql, win, *_ = tcd.flatten_fragments(windows, 160, 8)
    cons_arr, cons_lens = tcd.pad_consensus([w[0] for w in windows], 128, 8)
    case = (cons_arr, cons_lens, tcd.homopolymer_run_map(cons_arr, cons_lens), frags, ql, wts,
            win)
    jw = jpc.fused_votes_pallas(*_j(*case), 128, 160, 8, interpret=True)
    tw = tcc.fused_votes_pallas(*_t(*case), 128, 160, 8)
    for g, w in zip(tw, jw):
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="interpret mode"):
        jpc.fused_votes_pallas(*_j(*case), 128, 160, 8, interpret=False)


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
    (cons0, lens0, fw_sh, q_lens, r0, win), _ = tb.host_layout(grp, T, 4 * T, bw)
    return cons0[win], lens0[win], fw_sh, q_lens, r0


@pytest.mark.parametrize("bw", [528, 1024, 16400, 32768])
def test_band_plain_matches_jax_past_512(bw):
    """K3's and K4's plain versions, which the wide, global and direct
    routes are held to on the card, against raven_tpu's band_forward and
    mask_walk_votes (each fragment its own window, so the tables are its
    vote rows) at bands wider than the strip kernels take, and wider than
    a block's 1024 threads of 16 lanes."""
    T = 64
    fwd = "band_forward_wide" if bw <= tbd.WIDE_MAX_BW else "band_forward_global"
    assert tbd.launch_plan(T, bw) == ((fwd, 1), ("mask_walk_votes_direct", 4))
    cw, tl, fw_sh, q_lens, r0 = _band_group(bw, T)
    if bw > tbd.WIDE_MAX_BW:  # the group's 6 fragments and 2 of its empty rows
        cw, tl, fw_sh, q_lens, r0 = (a[:8] for a in (cw, tl, fw_sh, q_lens, r0))
        assert (q_lens[:6] > 0).all() and (q_lens[6:] == 0).all()
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
    offs = got[1].numpy().astype(np.int64)
    assert (np.diff(offs, axis=0) < 0).any()
    # K10's plain walk on these outputs against traceback_banded_kernel's:
    # as K9 left them (every end value is NEG = q_len * GAP, so both walks
    # start on the top row and stall there), and started four rows into
    # the wrapped stretch (its band at column 0) at column 200, reading K9's
    # moves on wrapped rows up to the last row before the wrap, whose band
    # lies 262,000 columns away
    wt = np.random.default_rng(12).integers(1, 256, fr.shape).astype(np.int32)
    gp, wp, kinds = _walk_both(*got, ql, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert np.array_equal(g.numpy(), w), what
    assert (kinds.numpy() == 1).all()
    first = int(np.argmax(np.diff(offs[:, 0]) < 0)) + 1  # the first wrapped row
    assert (offs[first:, :] == 0).all() and first + 4 < T
    ends = np.full((T, 2), NEG, np.int32)
    ends[first + 3] = 0
    ql2 = np.full(2, 200, np.int32)
    gp, wp, kinds = _walk_both(got[0], got[1], ends, ql2 * tbc.GAP, ql2, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert np.array_equal(g.numpy(), w), what
    assert (gp[0].numpy()[:, first : first + 4] < 5).sum() > 0


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
