"""The port's shift-banded consensus (raven_tpu_torch.ops.consensus_band and
ops/band_cuda.py's plain K3/K4 versions) vs raven_tpu.ops.consensus_band on
the CPU, on the same numpy inputs: the forward's moves and end scores, the
walk's per-fragment votes, the vote tables, the per-window steps (run map,
insertion canonicalisation, rebuild), the resident loop's tokens and
band_window_consensus's output, all integer outputs bit for bit."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from raven_tpu.ops import consensus_band as jb  # noqa: E402
from raven_tpu_torch.ops import band_cuda  # noqa: E402
from raven_tpu_torch.ops import consensus_band as tb  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mutate(rng, codes, sub, dele, ins):
    keep = rng.random(codes.size) >= dele
    seg = codes[keep]
    subs = rng.random(seg.size) < sub
    seg = np.where(subs, (seg + rng.integers(1, 4, seg.size)) % 4, seg).astype(np.uint8)
    insm = rng.random(seg.size) < ins
    return np.repeat(seg, 1 + insm.astype(np.int64))


def _case(name):
    """(T, BW, NWIN, cons_arr, cons_lens, frag_rows, weight_rows, win_of, r0)
    for one named case; the fragments' weights are >= 1, so each vote shows
    in the tables."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    if name == "end-ties":
        # a periodic consensus: a fragment of whole periods scores its best
        # end at every period (ties broken by the first row); all-mismatch
        # fragments tie row 0 (their walks start there)
        T, BW, NWIN = 96, 256, 8
        cons = [np.tile(np.array([0, 1, 2], np.uint8), 30), np.zeros(70, np.uint8)]
        frags = [np.tile(np.array([0, 1, 2], np.uint8), k) for k in (1, 2, 3, 5)]
        frags += [np.full(n, 1, np.uint8) for n in (1, 5, 9)]
        win_of = [0, 0, 0, 0, 1, 1, 1]
        r0 = np.zeros(len(frags), np.int32)
        weights = [rng.integers(1, 60, f.size).astype(np.uint8) for f in frags]
    else:
        full = name == "full-rect"
        T, BW, NWIN = (96, 384, 8) if full else (256, 256, 8)
        L = 80 if full else 200
        cons, frags, weights, win_of, r0 = [], [], [], [], []
        for wi in range(5):
            truth = rng.integers(0, 4, L).astype(np.uint8)
            cons.append(mutate(rng, truth, 0.05, 0.05, 0.04)[:T])
            for _ in range(6):
                s, e = 0, L
                if name == "spans" and rng.random() < 0.5:
                    s = int(rng.integers(0, L // 2))
                    e = int(rng.integers(s + 40, L + 1))
                f = mutate(rng, truth[s:e], 0.06, 0.05, 0.05)
                if name == "insertion-runs":
                    # runs of 20-60 bases the consensus lacks: their left
                    # moves cross the band kernel's 16-lane strips
                    for _ in range(int(rng.integers(1, 3))):
                        at = int(rng.integers(1, f.size))
                        run = rng.integers(0, 4, int(rng.integers(20, 61))).astype(np.uint8)
                        f = np.concatenate([f[:at], run, f[at:]])
                if name == "long-fragments" and rng.random() < 0.5:
                    # past what the band reaches: q_len > T + BW/2 - r0
                    f = np.concatenate([f, f, mutate(rng, truth, 0.1, 0.05, 0.05)])
                    s = int(rng.integers(0, 120))
                frags.append(f)
                hi = 256 if name == "weights-over-cap" else 60
                weights.append(rng.integers(1, hi, f.size).astype(np.uint8))
                win_of.append(wi)
                r0.append(s)
        r0 = np.asarray(r0, np.int32)
    cons_arr = np.full((NWIN, T), -1, np.int32)
    cons_lens = np.zeros(NWIN, np.int32)
    for wi, c in enumerate(cons):
        cons_arr[wi, : c.size] = c
        cons_lens[wi] = c.size
    return T, BW, NWIN, cons_arr, cons_lens, frags, weights, np.asarray(win_of, np.int32), r0


CASES = ["full-rect", "spans", "weights-over-cap", "long-fragments", "end-ties",
         "insertion-runs"]


def _packed(name, pad_rows=8):
    """The case's fragment batch as band_window_consensus packs it, with
    `pad_rows` rows of padding (q_len 0) at the end."""
    T, BW, NWIN, cons_arr, cons_lens, frags, weights, win_of, r0 = _case(name)
    B = len(frags) + pad_rows
    r0p = np.zeros(B, np.int32)
    r0p[: len(frags)] = np.clip(r0, 0, T - 1)
    fw_sh = np.zeros((B, T + BW + 1), np.uint8)
    q_lens = np.zeros(B, np.int32)
    fw_sh[: len(frags)], q_lens[: len(frags)] = tb.pack_shifted_fragments(
        frags, weights, r0p, 4 * T, T, BW
    )
    win = np.zeros(B, np.int32)
    win[: len(frags)] = win_of
    cw = cons_arr[win]
    tl = cons_lens[win]
    return T, BW, NWIN, cons_arr, cons_lens, cw, tl, fw_sh, q_lens, r0p, win


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True, order="C")) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name", CASES)
def test_band_forward_matches_jax(name):
    T, BW, _, _, _, cw, tl, fw_sh, q_lens, r0, _ = _packed(name)
    got = band_cuda.band_forward(*_t(cw, tl, fw_sh, q_lens, r0), T, BW)
    want = jb.band_forward(*_j(cw, tl, fw_sh, q_lens, r0), T, BW)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    if name == "long-fragments":
        assert (q_lens > T + BW // 2 - r0).any()
    if name == "insertion-runs":
        # in-fragment runs of 17 left moves: each crosses a strip boundary
        mv = np.asarray(want[0]).astype(np.int64) & 0xFFFFFFFF
        codes = ((mv[..., None] >> (2 * np.arange(16))) & 3).reshape(T, -1, BW)
        j = (np.arange(1, T + 1)[:, None, None] + np.arange(BW)[None, None, :]
             - BW // 2 - r0[None, :, None])
        left = (codes == 2) & (j >= 1) & (j <= q_lens[None, :, None])
        runs = np.lib.stride_tricks.sliding_window_view(left, 17, axis=2).all(axis=3)
        assert runs.sum() > 100
    if name == "end-ties":
        ends = np.asarray(want[1])
        best = ends.max(axis=0)
        assert ((ends == best).sum(axis=0) > 1).any()  # tied best rows
        assert (np.asarray(want[2]) >= best)[: 7].any()  # walks from row 0


@pytest.mark.parametrize("name", CASES)
def test_mask_walk_votes_matches_jax(name):
    """Each fragment as its own window, so raven_tpu's tables are its
    per-fragment vote rows."""
    T, BW, _, _, _, cw, tl, fw_sh, q_lens, r0, _ = _packed(name)
    B = cw.shape[0]
    mv, es, r0s = jb.band_forward(*_j(cw, tl, fw_sh, q_lens, r0), T, BW)
    want = jb.mask_walk_votes(
        mv, es, r0s, *_j(fw_sh, q_lens, r0, np.arange(B, dtype=np.int32)), T, BW, B
    )
    votes, ins = band_cuda.mask_walk_votes(
        *_t(np.asarray(mv), np.asarray(es), np.asarray(r0s), fw_sh, q_lens, r0), T, BW
    )
    assert votes.shape == (B, T) and ins.shape == (B, T + 1)
    got = band_cuda.vote_tables(votes, ins, torch.arange(B, dtype=torch.int32), B)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the padded rows (q_len 0) vote nothing
    assert not votes[q_lens == 0].any() and not ins[q_lens == 0].any()
    assert votes.any() and ins.any()


@pytest.mark.parametrize("name", CASES)
def test_band_votes_kernel_and_window_steps_match_jax(name):
    T, BW, NWIN, cons_arr, cons_lens, _, _, fw_sh, q_lens, r0, win = _packed(name)
    args = (cons_arr, cons_lens, fw_sh, q_lens, r0, win)
    got = tb.band_votes_kernel(*_t(*args), T, BW, NWIN)
    want = jb.band_votes_kernel(*_j(*args), T, BW, NWIN)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    bv, ir, cv = got

    runs = tb._run_map_device(torch.from_numpy(cons_arr), T)
    runs_j = jb._run_map_device(jnp.asarray(cons_arr), T)
    assert np.array_equal(runs.numpy(), np.asarray(runs_j))
    iv = tb.canonicalize_ins(ir, runs, T)
    iv_j = jb.canonicalize_ins(jnp.asarray(ir.numpy()), runs_j, T)
    assert np.array_equal(iv.numpy(), np.asarray(iv_j))
    toks, lens = tb._rebuild_device(*_t(cons_arr, cons_lens), bv, iv, cv, T)
    toks_j, lens_j = jb._rebuild_device(
        *_j(cons_arr, cons_lens, bv.numpy(), iv.numpy(), cv.numpy()), T
    )
    assert np.array_equal(toks.numpy(), np.asarray(toks_j))
    assert np.array_equal(lens.numpy(), np.asarray(lens_j))


@pytest.mark.parametrize("name", ["full-rect", "spans", "weights-over-cap"])
def test_resident_consensus_matches_jax(name):
    T, BW, NWIN, cons_arr, cons_lens, _, _, fw_sh, q_lens, r0, win = _packed(name)
    args = (cons_arr, cons_lens, fw_sh, q_lens, r0, win)
    toks, lens = tb.resident_consensus(*_t(*args), T, BW, NWIN, 3)
    toks_j, lens_j = jb.resident_consensus(*_j(*args), T, BW, NWIN, 3)
    assert toks.dtype == torch.int8
    assert np.array_equal(toks.numpy(), np.asarray(toks_j))
    assert np.array_equal(lens.numpy(), np.asarray(lens_j))


def _windows(rng, n, L, n_frags, spans=False, weights=True):
    out = []
    for _ in range(n):
        truth = rng.integers(0, 4, L).astype(np.uint8)
        frags, sp = [], []
        for _ in range(n_frags):
            s, e = 0, L
            if spans and rng.random() < 0.4:
                s = int(rng.integers(0, L // 2))
                e = int(rng.integers(s + L // 4, L + 1))
            frags.append(mutate(rng, truth[s:e], 0.05, 0.05, 0.05))
            sp.append((s, e))
        wts = [rng.integers(1, 80, f.size).astype(np.uint8) for f in frags] if weights else None
        w = (mutate(rng, truth, 0.05, 0.05, 0.04), frags, wts)
        out.append(w + (sp,) if spans else w)
    return out


@pytest.mark.parametrize(
    "kw",
    [dict(t_pad=128, q_pad=128, bw=384), dict(t_pad=256, q_pad=320, bw=256, spans=True)],
    ids=["full-rect", "bw256-spans"],
)
def test_band_window_consensus_matches_jax(kw):
    kw = dict(kw)
    spans = kw.pop("spans", False)
    rng = np.random.default_rng(31)
    windows = _windows(rng, 5, 100 if kw["bw"] == 384 else 200, 10, spans=spans)
    got = tb.band_window_consensus(windows, iterations=2, device="cpu", **kw)
    want = jb.band_window_consensus(windows, iterations=2, group=128, **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.array_equal(g, w)


def test_band_window_consensus_edges_match_jax():
    """A window without fragments passes through; groups of 2 windows
    give what one group gives, and what raven_tpu gives."""
    rng = np.random.default_rng(7)
    bb = rng.integers(0, 4, 100).astype(np.uint8)
    out = tb.band_window_consensus([(bb, [], None)], iterations=1, t_pad=128, bw=384,
                                   device="cpu")
    assert np.array_equal(out[0], bb)
    windows = _windows(rng, 5, 80, 8, weights=False)
    windows.insert(2, (bb[:60], [], None))
    one = tb.band_window_consensus(windows, iterations=2, t_pad=128, bw=384, device="cpu")
    grouped = tb.band_window_consensus(windows, iterations=2, t_pad=128, bw=384, group=2,
                                       device="cpu")
    want = jb.band_window_consensus(windows, iterations=2, t_pad=128, bw=384, group=2)
    for a, b, w in zip(one, grouped, want):
        assert np.array_equal(a, b)
        assert np.array_equal(b, w)
    assert np.array_equal(one[2], bb[:60])
    # the mesh-sharded loop runs: 2 virtual CPU devices give the one's
    from raven_tpu_torch.parallel.mesh import Mesh

    two = tb.band_window_consensus(windows, iterations=2, t_pad=128, bw=384, group=2,
                                   mesh=Mesh(["cpu"] * 2))
    for a, b in zip(one, two):
        assert np.array_equal(a, b)


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors the wrappers take the plain versions and the launch
    counters stay put; a device without a kernel raises."""
    T, BW, NWIN, cons_arr, cons_lens, _, _, fw_sh, q_lens, r0, win = _packed("spans")
    before = dict(band_cuda.LAUNCHES)
    tb.band_votes_kernel(*_t(cons_arr, cons_lens, fw_sh, q_lens, r0, win), T, BW, NWIN)
    assert band_cuda.LAUNCHES == before
    meta = torch.zeros((2, T), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no banded forward kernel"):
        band_cuda.band_forward(meta, None, None, None, None, T, BW)
    with pytest.raises(ValueError, match="no band pack kernel"):
        band_cuda.band_pack(None, None, None, meta[0], None, T, BW)
    # a whole call on the CPU packs its rows with the plain version
    windows = _windows(np.random.default_rng(3), 3, 60, 4, spans=True)
    tb.band_window_consensus(windows, iterations=1, t_pad=64, q_pad=96, bw=256, device="cpu")
    assert band_cuda.LAUNCHES == before and band_cuda.LAUNCHES["band_pack"] == 0


def _previous_layout(grp, t_pad, q_pad, bw, n_dev=1):
    """The group layout band_window_consensus made on the host before the
    rows were packed on the device: fragment by fragment, through
    pack_shifted_fragments.  ((cons0, lens0, fw_sh, q_lens, r0, win_of),
    NWIN), numpy."""
    frag_rows, weight_rows, win_of, r0_list = [], [], [], []
    for gi, (bb, frags, wts, spans) in enumerate(grp):
        for fi, f in enumerate(frags):
            frag_rows.append(np.asarray(f, np.uint8))
            weight_rows.append(np.asarray(wts[fi], np.uint8) if wts is not None
                               else np.ones(len(f), np.uint8))
            win_of.append(gi)
            r0_list.append(int(spans[fi][0]) if spans is not None else 0)
    B_total = len(frag_rows)
    NWIN = tb._pow2(len(grp), 8)
    B_pad = -(-tb._pow2(max(B_total, 1), 256) // n_dev) * n_dev
    r0 = np.zeros(B_pad, np.int32)
    r0[:B_total] = np.clip(r0_list, 0, t_pad - 1)
    fw_sh = np.zeros((B_pad, t_pad + bw + 1), np.uint8)
    q_lens = np.zeros(B_pad, np.int32)
    if B_total:
        fw_sh[:B_total], q_lens[:B_total] = tb.pack_shifted_fragments(
            frag_rows, weight_rows, r0, q_pad, t_pad, bw)
    win = np.zeros(B_pad, np.int32)
    win[:B_total] = win_of
    cons0 = np.full((NWIN, t_pad), -1, np.int32)
    lens0 = np.zeros(NWIN, np.int32)
    for gi, (bb, _f, _w, _s) in enumerate(grp):
        cl = min(len(bb), t_pad)
        cons0[gi, :cl] = np.asarray(bb, np.uint8)[:cl]
        lens0[gi] = cl
    return (cons0, lens0, fw_sh, q_lens, r0, win), NWIN


PACK_CASES = ["weights-none", "weights-over-63", "weights-mixed", "weights-longer", "past-q_pad",
              "r0-at-end", "zero-length", "n_dev-3", "one-window"]


def _pack_group(name, bw, t_pad=128):
    """(group, q_pad, n_dev) for one named band_pack case: windows of
    fragments of 0-260 bases on backbones of 60-200, a third of the windows
    with spans (starts past t_pad and below 0 among them, clipped)."""
    rng = np.random.default_rng(PACK_CASES.index(name) + 101 + bw)
    n_win = {"one-window": 1, "n_dev-3": 7}.get(name, 5)
    q_pad, n_dev = (96 if name == "past-q_pad" else 2 * t_pad), (3 if name == "n_dev-3" else 1)
    grp = []
    for wi in range(n_win):
        n_frag = int(rng.integers(3, 12)) if name != "n_dev-3" else 37
        lo = 0 if name == "zero-length" else 20
        frags = [rng.integers(0, 4, int(rng.integers(lo, 260))).astype(np.uint8)
                 for _ in range(n_frag)]
        if name == "zero-length":
            frags[::3] = [np.zeros(0, np.uint8)] * len(frags[::3])
        wts = None
        if name == "weights-over-63" or (name == "weights-mixed" and wi % 2):
            wts = [rng.integers(0, 256, f.size).astype(np.uint8) for f in frags]
        if name == "weights-longer":  # weights past their fragment's end go unread
            wts = [rng.integers(0, 64, f.size + 7 * (i % 2)).astype(np.uint8)
                   for i, f in enumerate(frags)]
        spans = None
        if name == "r0-at-end":
            spans = [(t_pad - 1 + int(rng.integers(0, 3)), t_pad) for _ in frags]
        elif wi % 3 == 1:
            spans = [(int(rng.integers(-5, t_pad + 20)), t_pad) for _ in frags]
        grp.append((rng.integers(0, 4, int(rng.integers(60, 200))).astype(np.uint8), frags,
                    wts, spans))
    return grp, q_pad, n_dev


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bw", [256, 768])
@pytest.mark.parametrize("name", PACK_CASES)
def test_band_pack_matches_pack_shifted_fragments(name, bw, device):
    """band_pack on the flat arrays of _prepare_group gives the rows and
    q_lens that pack_shifted_fragments gives, byte for byte: on CPU tensors
    its plain version, on a card the kernel (one launch)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: band_pack's kernel runs only on one")
    t_pad = 128
    grp, q_pad, n_dev = _pack_group(name, bw, t_pad)
    (_, _, fw_want, q_want, _, _), _ = _previous_layout(grp, t_pad, q_pad, bw, n_dev)
    _, v, _ = tb._prepare_group(grp, t_pad, q_pad, bw, n_dev)
    assert (v["wts"] is None) == (name in ("weights-none", "past-q_pad", "r0-at-end",
                                          "zero-length", "n_dev-3", "one-window"))
    d = {k: None if x is None else torch.from_numpy(x).to(device) for k, x in v.items()}
    before = band_cuda.LAUNCHES["band_pack"]
    fw_sh = band_cuda.band_pack(d["bases"], d["wts"], d["src"], d["q_lens"], d["r0"], t_pad, bw)
    assert band_cuda.LAUNCHES["band_pack"] == before + (device == "cuda")
    assert fw_sh.dtype == torch.uint8 and fw_sh.shape == fw_want.shape
    assert np.array_equal(fw_sh.cpu().numpy(), fw_want)
    assert np.array_equal(v["q_lens"], q_want)
    B_total = sum(len(w[1]) for w in grp)
    assert fw_want.shape[0] % n_dev == 0 and not fw_want[B_total:].any()
    if name == "weights-over-63":
        assert (fw_want >> 2).max() == tb.WCAP
    if name == "past-q_pad":
        assert (q_want == q_pad).any()
    if name == "r0-at-end":  # n cut by the row's end: SW - off = bw // 2 + 1 bytes
        assert (np.count_nonzero(fw_want[:B_total], axis=1) <= bw // 2 + 1).all()


@pytest.mark.parametrize("name", ["weights-mixed", "n_dev-3", "zero-length"])
def test_prepare_group_matches_previous_layout(name):
    """_prepare_group's arrays, packed by band_pack's plain version, are the
    previous host layout, window for window: the backbone and its length,
    and each of the window's rows (bytes, q_len, r0), in order; the padding
    rows are empty."""
    t_pad, bw = 128, 256
    grp, q_pad, n_dev = _pack_group(name, bw, t_pad)
    want, NWIN = _previous_layout(grp, t_pad, q_pad, bw, n_dev)
    got, NWIN_got = tb.host_layout(grp, t_pad, q_pad, bw, n_dev)
    assert NWIN_got == NWIN
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    cons0, lens0, fw_sh, q_lens, r0, win = got
    B_total = sum(len(w[1]) for w in grp)
    for gi in range(NWIN):
        assert np.array_equal(cons0[gi], want[0][gi]) and lens0[gi] == want[1][gi]
        rows = np.flatnonzero(want[5][:B_total] == gi)
        assert np.array_equal(np.flatnonzero(win[:B_total] == gi), rows)
        for a, b in zip((fw_sh, q_lens, r0), (want[2], want[3], want[4])):
            assert np.array_equal(a[rows], b[rows])
    for a in (fw_sh, q_lens, r0, win):
        assert not a[B_total:].any()
