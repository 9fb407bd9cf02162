"""The port's anchored banded window consensus (raven_tpu_torch.ops.banded_cuda,
device_window_consensus(banded=True), --device-banded-alignment) vs
raven_tpu's on the same numpy inputs: nw_moves_banded_plain against
nw_moves_banded_kernel on every output, traceback_banded_plain against the
primitives of traceback_banded_kernel's paths, the vote tables against
fused_votes_banded_kernel, the window consensus, the Polisher and the CLI,
all exactly equal.  The CUDA kernels K9 and K10 themselves are held against
their plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu import config as jconfig  # noqa: E402
from raven_tpu.io import ReadSet as JReadSet  # noqa: E402
from raven_tpu.ops import consensus_device as jcd  # noqa: E402
from raven_tpu.polish.polisher import Polisher as JPolisher  # noqa: E402
from raven_tpu_torch import config as tconfig  # noqa: E402
from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.ops import banded_cuda as tbc  # noqa: E402
from raven_tpu_torch.ops import consensus_device as tcd  # noqa: E402
from raven_tpu_torch.polish.polisher import Polisher as TPolisher  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402
from tests.test_torch_polish import _engines, _run_both_clis, setup  # noqa: E402, F401

# raven_tpu's polisher reads these; unset, it takes the path the port copies
_JAX_ENV = (
    "RAVEN_TPU_CONSENSUS_ENGINE", "RAVEN_TPU_CONSENSUS_ITERS",
    "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_BANDED", "RAVEN_TPU_PALLAS_CONSENSUS",
    "RAVEN_TPU_CONSENSUS_GROUP",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several xdist workers on the same cores; torch's
    default of one intra-op thread per core makes their OpenMP threads spin
    against each other through this file's thousands of small row ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for name in _JAX_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def banded_reads_path(tmp_path_factory):
    """Half of tests/test_torch_pipeline.py's 30 kb setup, as a FASTA file:
    90 reads of 3 kb at 3% error from a 15 kb genome, which both CLIs
    assemble to one contig.  Each polish round runs both packages' banded
    engine on the CPU, chunk by chunk, so the reads are kept few."""
    rng = np.random.default_rng(1530)
    genome = random_genome(rng, 15000)
    reads, _ = sample_reads(rng, genome, 90, 3000, error=0.03)
    path = tmp_path_factory.mktemp("banded") / "reads.fasta"
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    return path


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = (
    "default spans", "partial spans", "one-row spans", "steep spans",
    "longer than the span", "qlen 0", "tlen < T", "all mismatches", "walks from row 0",
)


def _banded_case(name, T, Q, B=24):
    """[B, T] / [B, Q] int32 inputs of the anchored banded NW: consensus
    rows of T/2 .. T bases, fragments drawn from them with 5% deletions,
    substitutions and insertions, weights 0-255, placed on their whole
    consensus unless the case says otherwise."""
    rng = np.random.default_rng(sum(map(ord, name)) + T + Q)
    tl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    cw = np.where(np.arange(T)[None] < tl[:, None], rng.integers(0, 4, (B, T)), -1)
    cw = cw.astype(np.int32)
    fr = np.full((B, Q), -1, np.int32)
    ql = np.zeros(B, np.int32)
    r0 = np.zeros(B, np.int32)
    r1 = tl.copy()
    for b in range(B):
        src = cw[b, : tl[b]]
        if name == "partial spans" and b % 5 < 2:  # 40% at r0 > 0
            r0[b] = rng.integers(1, tl[b] // 2)
            r1[b] = rng.integers(r0[b] + tl[b] // 4, tl[b] + 1)
            src = src[r0[b] : r1[b]]
        elif name == "one-row spans":
            # a fragment as long as the band anchored on one row: the band
            # start leaps past BW columns there
            r0[b] = rng.integers(0, tl[b])
            r1[b] = r0[b] + 1
            src = np.resize(src, Q)[: int(rng.integers(Q // 2, Q + 1))]
        elif name == "steep spans" and b % 2:
            # a fragment as long as the band or longer anchored on a span of
            # 2 to ~T/3 rows: its band start steps by several columns a row,
            # beside a fragment on its whole consensus
            r0[b] = rng.integers(0, tl[b] // 2)
            r1[b] = r0[b] + rng.integers(2, max(3, T // 3))
            src = np.resize(src, Q)[: int(rng.integers(Q // 2, Q + 1))]
        elif name == "longer than the span":  # slope 2
            src = np.concatenate([src, src])
        s = src[rng.random(src.size) >= 0.05]
        s = np.where(rng.random(s.size) < 0.05, (s + 1) % 4, s)
        s = np.repeat(s, 1 + (rng.random(s.size) < 0.05))[:Q]
        ql[b] = s.size
        fr[b, : s.size] = s
    if name == "qlen 0":
        ql[::3] = 0
        fr[::3] = -1
    elif name == "tlen < T":
        tl = np.minimum(tl, rng.integers(0, T // 3, B)).astype(np.int32)
        cw = np.where(np.arange(T)[None] < tl[:, None], cw, -1).astype(np.int32)
    elif name == "all mismatches":  # the DP on NEG-derived values
        cw = np.where(cw >= 0, 0, -1).astype(np.int32)
        ql[:] = rng.integers(1, Q + 1, B)
        fr = np.where(np.arange(Q)[None] < ql[:, None], 1, -1).astype(np.int32)
    elif name == "walks from row 0":
        # consensus of 0 or 1 bases against mismatching fragments, some
        # longer than row 1's band: the walk starts at row 0 and, past the
        # band, stalls there
        tl = (np.arange(B) % 2).astype(np.int32)
        cw = np.where(np.arange(T)[None] < tl[:, None], 0, -1).astype(np.int32)
        r1 = np.maximum(tl, 1)
        ql[:] = rng.integers(5, Q + 1, B)
        fr = np.where(np.arange(Q)[None] < ql[:, None], 1, -1).astype(np.int32)
    wt = np.where(fr >= 0, rng.integers(0, 256, fr.shape), 0).astype(np.int32)
    return cw, tl, fr, ql, r0.astype(np.int32), r1.astype(np.int32), wt


def _prims_from_paths(pt, pq, pmv, frags, wts, T, Q):
    """raven_tpu's walk (path_t, path_q, path_mv [STEPS, B]) as K2's
    primitives, following _votes_from_paths: a diag or up move votes at row
    t - 1, the first left move of a run an insertion at junction t, both
    from fragment column clip(q - 1, 0, Q - 1)."""
    pt, pq, pmv = (np.asarray(a).astype(np.int64) for a in (pt, pq, pmv))
    B = pmv.shape[1]
    col_sym = np.full((B, T), 5, np.int64)
    col_w = np.zeros((B, T), np.int64)
    ins_b = np.full((B, T + 1), -1, np.int64)
    ins_w = np.zeros((B, T + 1), np.int64)
    pk = (np.clip(frags, 0, 3) | (wts << 2)).astype(np.int64)
    prev = np.concatenate([np.full((1, B), 3), pmv[:-1]])
    bidx = np.broadcast_to(np.arange(B), pmv.shape)
    p = pk[bidx, np.clip(pq - 1, 0, Q - 1)]
    m = pmv <= 1
    assert not (np.bincount((bidx * T + pt - 1)[m], minlength=B * T) > 1).any()
    col_sym[bidx[m], pt[m] - 1] = np.where(pmv[m] == 0, p[m] & 3, 4)
    col_w[bidx[m], pt[m] - 1] = p[m] >> 2
    m = (pmv == 2) & (prev != 2)
    assert not (np.bincount((bidx * (T + 1) + pt)[m], minlength=B * (T + 1)) > 1).any()
    ins_b[bidx[m], pt[m]] = p[m] & 3
    ins_w[bidx[m], pt[m]] = p[m] >> 2
    return col_sym, col_w, ins_b, ins_w


def _walk_both(moves, offs, ends, row0, ql, fr, wt, T, Q, BW):
    """raven_tpu's banded walk as primitives, and the port's with how its
    walks ended."""
    pt, pq, pmv = jcd.traceback_banded_kernel(
        *(jnp.asarray(np.asarray(a)) for a in (moves, offs, ends, row0, ql)),
        T=T, Q=Q, BW=BW, STEPS=T + Q,
    )
    want = _prims_from_paths(pt, pq, pmv, fr, wt, T, Q)
    got, kinds, _ = tbc.traceback_banded_plain(
        *(_t(np.asarray(a)) for a in (moves, offs, ends, row0, ql, fr, wt)), T, Q, BW,
        return_walks=True,
    )
    return got, want, kinds


# Q >= 2 BW - 1, so that a band start can leap by BW or more
@pytest.mark.parametrize("shape", [(96, 288, 128), (96, 520, 256)], ids=["BW128", "BW256"])
@pytest.mark.parametrize("name", CASES)
def test_nw_moves_and_walk_banded_plain_match_jax(name, shape):
    T, Q, BW = shape
    cw, tl, fr, ql, r0, r1, wt = _banded_case(name, T, Q)
    want = jcd.nw_moves_banded_kernel(
        *(jnp.asarray(a) for a in (cw, tl, fr, ql, r0, r1)), T=T, Q=Q, BW=BW
    )
    got = tbc.nw_moves_banded(*(_t(a) for a in (cw, tl, fr, ql, r0, r1)), T, Q, BW)
    for what, g, w in zip(("moves", "offs", "end_scores", "row0_score"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, what
        assert g.shape == w.shape, what
        assert np.array_equal(g.numpy(), w), what
    gp, wp, kinds = _walk_both(*got, ql, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert g.dtype == torch.int32, what
        assert np.array_equal(g.numpy(), w), what
    if name == "walks from row 0":
        assert (kinds == 1).any()  # some walks stall on the top row
        assert (gp[0].numpy() == 5).all()  # and none votes on a column
    if name == "one-row spans":
        # the band leaps by at least BW on a row of some fragment
        off = got[1].numpy().astype(np.int64)
        assert (np.diff(off, axis=0) >= BW).any()
    if name == "steep spans":
        # band starts step by 3 to BW - 1 columns on rows of some fragments
        step = np.diff(got[1].numpy().astype(np.int64), axis=0)
        assert ((step >= 3) & (step < BW)).any()


@pytest.mark.parametrize("shape", [(96, 160, 128), (96, 320, 256)], ids=["BW128", "BW256"])
def test_walk_off_the_band_matches_jax(shape):
    """Band starts raised at random under the moves: the walks that would
    leave the band stop (raven_tpu's defensive stop, which K9's own outputs
    never reach)."""
    T, Q, BW = shape
    cw, tl, fr, ql, r0, r1, wt = _banded_case("partial spans", T, Q)
    moves, offs, ends, row0 = tbc.nw_moves_banded_plain(
        *(_t(a) for a in (cw, tl, fr, ql, r0, r1)), T, Q, BW
    )
    rng = np.random.default_rng(11)
    offs = offs.numpy() + rng.integers(0, 40, offs.shape).astype(np.int32) * (
        rng.random(offs.shape) < 0.2
    )
    gp, wp, kinds = _walk_both(moves, offs.astype(np.int32), ends, row0, ql, fr, wt, T, Q, BW)
    for what, g, w in zip(("col_sym", "col_w", "ins_b", "ins_w"), gp, wp):
        assert np.array_equal(g.numpy(), w), what
    assert (kinds == 2).any()


@pytest.mark.parametrize("shape", [(4, 128, 256, 32), (8, 256, 384, 64)])
def test_fused_votes_banded_match_fused_votes_banded_kernel(shape):
    NWIN, T, Q, B = shape
    BW = min(256, tcd._pow2_of(Q))
    rng = np.random.default_rng(17)
    cons_lens = rng.integers(T // 2, T - 4, NWIN).astype(np.int32)
    cons_arr = np.where(
        np.arange(T)[None, :] < cons_lens[:, None], rng.integers(0, 4, (NWIN, T)), -1
    ).astype(np.int32)
    win_idx = (np.arange(B) % NWIN).astype(np.int32)
    frags = np.full((B, Q), -1, np.int32)
    q_lens = np.zeros(B, np.int32)
    r0 = np.zeros(B, np.int32)
    r1 = cons_lens[win_idx].copy()
    for b in range(B - 1):  # the last row pads (q_len 0)
        cl = int(cons_lens[win_idx[b]])
        if rng.random() < 0.4:
            r0[b] = rng.integers(0, cl // 2)
            r1[b] = rng.integers(r0[b] + cl // 4, cl + 1)
        s = cons_arr[win_idx[b], r0[b] : r1[b]]
        s = s[rng.random(s.size) >= 0.05]
        s = np.where(rng.random(s.size) < 0.05, (s + 1) % 4, s)
        s = np.repeat(s, 1 + (rng.random(s.size) < 0.05))[:Q]
        q_lens[b] = s.size
        frags[b, : s.size] = s
    wts = np.where(frags >= 0, rng.integers(0, 256, frags.shape), 0).astype(np.int32)
    cons_runs = jcd.homopolymer_run_map(cons_arr, cons_lens)
    case = (cons_arr, cons_lens, cons_runs, frags, q_lens, wts, win_idx, r0, r1)
    want = jcd.fused_votes_banded_kernel(
        *(jnp.asarray(a) for a in case), T=T, Q=Q, BW=BW, STEPS=T + Q, NWIN=NWIN
    )
    got = tbc.fused_votes_banded(*(_t(a) for a in case), T, Q, BW, NWIN)
    for what, g, w in zip(("base_votes", "ins_votes", "cover"), got, want):
        assert g.dtype == torch.int32, what
        assert np.array_equal(g.numpy(), np.asarray(w)), what


def _mutate(rng, codes, sub, dele, ins):
    """tests/test_consensus_device.py's mutate."""
    out = []
    for c in codes:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(int(rng.integers(0, 4)))
            out.append(int(c))
            continue
        if r < dele + ins + sub:
            out.append((int(c) + int(rng.integers(1, 4))) % 4)
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def _windows_like_matches_full(rng):
    """tests/test_consensus_device.py::test_banded_consensus_matches_full's
    windows: 3 of 300 bp, 10 fragments each, no weights or spans."""
    windows = []
    for _ in range(3):
        truth = rng.integers(0, 4, 300).astype(np.uint8)
        bb = _mutate(rng, truth, 0.03, 0.03, 0.03)
        frags = [_mutate(rng, truth, 0.03, 0.03, 0.03) for _ in range(10)]
        windows.append((bb, frags, None))
    return windows


def _windows_like_anchored_partial(rng):
    """tests/test_consensus_device.py::test_banded_anchored_partial_fragments's
    windows: 4 of 500 bp, 20 fragments each, 40% of them placed on a part
    [r0, r1) of the window."""
    windows = []
    for _ in range(4):
        truth = rng.integers(0, 4, 500).astype(np.uint8)

        def mut(seg):
            keep = rng.random(seg.size) >= 0.05
            s = seg[keep]
            subs = rng.random(s.size) < 0.04
            s = np.where(subs, (s + 1) % 4, s).astype(np.uint8)
            ins = rng.random(s.size) < 0.05
            return np.repeat(s, 1 + ins.astype(np.int64))

        frags, spans = [], []
        for _ in range(20):
            if rng.random() < 0.4:
                r0 = int(rng.integers(0, 300))
                r1 = int(rng.integers(r0 + 150, 501))
            else:
                r0, r1 = 0, 500
            frags.append(mut(truth[r0:r1]))
            spans.append((r0, r1))
        wts = [np.full(f.size, 9, np.uint8) for f in frags]
        windows.append((mut(truth), frags, wts, spans))
    return windows


@pytest.mark.parametrize("which", ["matches_full", "anchored_partial"])
def test_banded_window_consensus_matches_jax(which):
    if which == "matches_full":
        windows = _windows_like_matches_full(np.random.default_rng(153))
        kw = dict(iterations=2, t_pad=384, q_pad=512, chunk=32)
    else:
        windows = _windows_like_anchored_partial(np.random.default_rng(9))
        kw = dict(iterations=2, t_pad=640, q_pad=768, chunk=128)
    want = jcd.device_window_consensus(windows, banded=True, **kw)
    got = tcd.device_window_consensus(windows, banded=True, device="cpu", **kw)
    assert len(got) == len(want) == len(windows)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)


def test_wrappers_take_plain_only_on_cpu():
    T, Q, BW = 64, 255, 256
    cw, tl, fr, ql, r0, r1, wt = _banded_case("partial spans", T, Q, B=8)
    args = tuple(_t(a) for a in (cw, tl, fr, ql, r0, r1))
    launches = dict(tbc.LAUNCHES)
    fwd = tbc.nw_moves_banded(*args, T, Q, BW)
    assert all(torch.equal(a, b) for a, b in zip(fwd, tbc.nw_moves_banded_plain(*args, T, Q, BW)))
    walk_args = (*fwd, args[3], _t(fr), _t(wt))
    got = tbc.traceback_banded(*walk_args, T, Q, BW)
    want = tbc.traceback_banded_plain(*walk_args, T, Q, BW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tbc.LAUNCHES == launches  # the CPU path launches nothing
    # the card kernels' checks: a dtype, a shape, contiguity, the band
    with pytest.raises(TypeError):
        tbc._forward_kernel(args[0].to(torch.int64), *args[1:], T, Q, BW)
    with pytest.raises(TypeError):
        tbc._forward_kernel(*args[:2], args[2][:, :-1].contiguous(), *args[3:], T, Q, BW)
    with pytest.raises(ValueError, match="contiguous"):
        tbc._walk_kernel(*walk_args[:6], _t(wt.T).T, T, Q, BW)
    for t_, q_, bw_ in ((T, Q, 192), (T, 0, 128), (0, Q, 256)):
        with pytest.raises(ValueError, match="BW in"):
            tbc.check_kernel_shape(t_, q_, bw_)
    # raven_tpu's widths, the band past the fragment and fragments past
    # 8192 included
    for t_, q_, bw_ in ((640, 768, 256), (T, Q, 128), (T, 200, 256), (T, 100, 128),
                        (T, 8200, 256)):
        tbc.check_kernel_shape(t_, q_, bw_)
    with pytest.raises(ValueError, match="device"):
        tbc.nw_moves_banded(*(a.to("meta") for a in args), T, Q, BW)


@pytest.mark.parametrize(
    "poa_batches", [1, 0], ids=["poa-batches-1", "no-poa-batches"]
)
def test_polisher_banded_consensus_matches_jax(setup, poa_batches):  # noqa: F811
    """DeviceCfg.banded_alignment selects the anchored banded engine, in
    chunks of 256 fragment rows with poa_batches = 1 and of 2048 without;
    the device is asked for (use_device) in the second.  The inputs are
    tests/test_torch_polish.py's setup."""
    reads, draft = setup
    tp = TPolisher(
        device="cpu", use_device=True,
        device_cfg=tconfig.DeviceCfg(poa_batches=poa_batches, banded_alignment=True),
    )
    jp = JPolisher(
        use_device=True,
        device_cfg=jconfig.DeviceCfg(poa_batches=poa_batches, banded_alignment=True),
    )
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = jp.polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    assert tp.last_engine == "device"
    assert len(got) == len(want) == 1
    assert got[0][0] == want[0][0]
    assert np.array_equal(got[0][1], want[0][1])


@pytest.mark.parametrize(
    "extra, engines",
    [
        (["--device-poa-batches", "1", "--device-banded-alignment"], ["device", "device"]),
        (["--device-banded-alignment"], ["host", "host"]),
    ],
    ids=["banded-alignment", "banded-alignment-default"],
)
def test_cli_banded_polish_contigs_byte_identical(banded_reads_path, extra, engines,
                                                  monkeypatch, capsys):
    """`-p 2 --device-banded-alignment` runs (no longer refused): with
    --device-poa-batches the anchored banded consensus in both rounds;
    without, raven_tpu's hybrid schedule, which on --device cpu (and on
    raven_tpu's CPU backend) takes the host POA in both rounds."""
    flags = ["-p", "2", *extra, "--disable-checkpoints"]
    got, want, spans = _run_both_clis(banded_reads_path, flags, monkeypatch, capsys)
    assert got.count(">") == 1
    assert got == want
    assert _engines(spans) == engines
