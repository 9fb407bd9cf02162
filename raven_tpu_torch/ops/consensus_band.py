"""Shift-banded window consensus: the polisher's default device engine.

The port of raven_tpu/ops/consensus_band.py.  Every fragment aligns to its
window's working consensus in a slope-1 band of BW lanes (fragments stored
pre-shifted by their placement row, so the band advances one column a row),
scores 3/-5/-4 with a free consensus prefix and suffix; a reverse row walk
turns each alignment into per-row votes; the votes sum into per-window
tables; each window's consensus is rebuilt from them on the device, and the
next iteration aligns against it.  Only the last iteration's tokens leave
the device.

Where the work goes: the forward (K3) and the walk (K4) are hand-written
CUDA kernels (ops/band_cuda.py, csrc/band.cu); the per-window steps (K5:
the homopolymer run map, the insertion canonicalisation, the rebuild) are a
few whole-tensor torch ops an iteration.  raven_tpu's one-hot float32
matmuls (the per-fragment consensus rows, the vote sums) become an index
gather and integer index_add_, which give the same integers.

Shapes and grouping are raven_tpu's: windows in groups of at most `group`
windows and `max_rows` fragment rows, windows padded to a power of two of at
least 8, fragment rows to one of at least 256, placement rows clipped to
[0, t_pad - 1].  With a mesh, the fragment rows are padded to a multiple
of its size and dealt to its devices in contiguous blocks; each device
runs K3 and K4 on its block, and each iteration's vote tables meet on the
first device, summed there, for one rebuild whose consensus goes back to
every device (raven_tpu's _resident_consensus_sharded).  Across
processes each rank runs its own devices' blocks and the tables are
all-reduced, so every rank rebuilds the same consensus.

Weights are packed with the base into one uint8 (base | min(w, 63) << 2):
quality weights cap at 63 on this engine.  The packed rows are laid out on
the device (band_cuda.band_pack) from one flat upload a group: the host
only concatenates the group's fragments (pack_shifted_fragments is the
same layout made on the host, row by row: the specification).
"""

from __future__ import annotations

from itertools import chain, repeat

import numpy as np
import torch

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.ops import band_cuda
from raven_tpu_torch.parallel.mesh import local_blocks, sum_on_first
from raven_tpu_torch.utils import trace

NEG = -(1 << 20)
MATCH, MISMATCH, GAP = 3, -5, -4
WCAP = band_cuda.WCAP  # quality weight cap (2 bits base + 6 bits weight per byte)


def pack_shifted_fragments(
    frag_rows, weight_rows, r0, q_pad: int, t_pad: int, bw: int
):
    """Host prep: [B, SW] uint8 of (base | weight<<2), fragment i stored
    at column offset r0[i] + bw//2 + 1.  Chars the band never reads
    (beyond SW) are dropped; the j<=qlen mask in the kernel uses the
    full length.  Returns (packed, q_lens)."""
    B = len(frag_rows)
    SW = t_pad + bw + 1
    packed = np.zeros((B, SW), dtype=np.uint8)
    q_lens = np.zeros(B, dtype=np.int32)
    half = bw // 2 + 1
    for i, f in enumerate(frag_rows):
        f = np.asarray(f, np.uint8)[:q_pad]
        q_lens[i] = f.size
        off = int(r0[i]) + half
        n = min(f.size, max(SW - off, 0))
        if n <= 0:
            continue
        w = (
            np.minimum(weight_rows[i][:n], WCAP).astype(np.uint8)
            if weight_rows is not None
            else np.ones(n, np.uint8)
        )
        packed[i, off : off + n] = f[:n] | (w << 2)
    return packed, q_lens


def band_votes_kernel(cons_arr, cons_lens, fw_sh, q_lens, r0, win_idx, T: int, BW: int,
                      NWIN: int):
    """Forward and walk votes for one fragment batch: the vote tables
    (base_votes [NWIN, T, 5], ins_raw [NWIN, T+1, 4], cover [NWIN, T])
    int32.  Each fragment's consensus row is an index gather of its
    window's."""
    wi = win_idx.to(torch.int64)
    cw = cons_arr[wi].contiguous()
    t_lens = cons_lens[wi].contiguous()
    moves, end_scores, row0_score = band_cuda.band_forward(cw, t_lens, fw_sh, q_lens, r0, T, BW)
    return band_cuda.band_votes(
        moves, end_scores, row0_score, fw_sh, q_lens, r0, win_idx, T, BW, NWIN
    )


def _run_map_device(cons_arr, T: int):
    """cons_runs [NWIN, T+1, 4] int32: the junction where inserting base b
    before position t lands, the start of the run of b ending at t-1 (a
    cummax over break positions, as homopolymer_run_map computes it)."""
    NWIN = cons_arr.shape[0]
    dev = cons_arr.device
    is_b = cons_arr[:, :, None] == torch.arange(4, dtype=cons_arr.dtype, device=dev)
    pos = torch.arange(1, T + 1, dtype=torch.int32, device=dev)[None, :, None]
    breaks = torch.cummax(torch.where(is_b, 0, pos), dim=1).values
    return torch.cat([torch.zeros((NWIN, 1, 4), dtype=torch.int32, device=dev), breaks], dim=1)


def canonicalize_ins(ins_raw, cons_runs, T: int):
    """Move raw-junction insertion votes to their homopolymer run starts
    with one integer scatter-add."""
    NWIN = ins_raw.shape[0]
    dev = ins_raw.device
    w = torch.arange(NWIN, device=dev)[:, None, None]
    b = torch.arange(4, device=dev)[None, None, :]
    idx = (w * (T + 1) + cons_runs.to(torch.int64)) * 4 + b
    out = torch.zeros(NWIN * (T + 1) * 4, dtype=torch.int32, device=dev)
    out.index_add_(0, idx.reshape(-1), ins_raw.reshape(-1))
    return out.view(NWIN, T + 1, 4)


def _rebuild_device(cons_arr, cons_lens, bv, iv, cv, T: int):
    """Every window's consensus update from its vote tables.

    Per junction: the insertion with the most weight, adopted once its
    weight clears a quarter of the adjacent column's; per column: the base
    with the most weight (the old base when unvoted, nothing when the
    deletion wins).  Returns (toks [NWIN, 2T+1] int32, compacted and padded
    with -1, lens [NWIN] int64): the interleaved [ins_0, base_0, ins_1, ...]
    stream with its off tokens dropped, by one scatter with a dump slot."""
    NWIN = cons_arr.shape[0]
    dev = cons_arr.device
    t_idx = torch.arange(T, device=dev)[None, :]
    tj_idx = torch.arange(T + 1, device=dev)[None, :]
    L = cons_lens.to(torch.int64)[:, None]
    ib = iv.argmax(dim=2)  # ties: the first maximum, as jnp.argmax
    bv_sums = bv.sum(dim=2)
    col_w = torch.cat([bv_sums[:, :1], bv_sums], dim=1)
    ins_on = (iv.sum(dim=2) > 0) & (iv.max(dim=2).values * 4 > col_w) & (tj_idx <= L)
    bb = bv.argmax(dim=2)
    unvoted = bv_sums == 0
    base_sym = torch.where(unvoted, cons_arr.to(torch.int64), bb)
    base_on = (unvoted | (bb < 4)) & (t_idx < L)
    pair_t = torch.stack([ib[:, :T], base_sym], dim=2).view(NWIN, 2 * T)
    pair_on = torch.stack([ins_on[:, :T], base_on], dim=2).view(NWIN, 2 * T)
    toks = torch.cat([pair_t, ib[:, T:]], dim=1)
    on = torch.cat([pair_on, ins_on[:, T:]], dim=1)
    CAP = 2 * T + 1
    pos = torch.cumsum(on.to(torch.int64), dim=1) - 1
    lens = (pos[:, -1] + 1).clamp(max=CAP)
    w_off = torch.arange(NWIN, device=dev)[:, None] * CAP
    flat = torch.where(on, w_off + pos, NWIN * CAP)
    out = torch.full((NWIN * CAP + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, flat.reshape(-1), toks.to(torch.int32).reshape(-1))
    return out[:-1].view(NWIN, CAP), lens


def resident_consensus(cons0, lens0, fw_sh, q_lens, r0, win_idx, T: int, BW: int, NWIN: int,
                       ITERS: int, mesh=None):
    """The refinement loop on device tensors: per iteration the forward and
    the walk votes over the whole fragment batch, the insertion
    canonicalisation and every window's rebuild, fed to the next iteration.
    With a mesh, the fragment rows (whose count must be a multiple of its
    size) are dealt over its devices, the votes summed on its first device
    (this process's first, all-reduced across processes), where cons0 and
    lens0 must lie.  Returns the last iteration's (toks
    [NWIN, 2T+1] int8, lens [NWIN])."""
    if ITERS < 1:
        raise ValueError(f"ITERS must be at least 1, got {ITERS}")
    rows = (fw_sh, q_lens, r0, win_idx)
    if mesh is None:
        shards = [rows]
    else:
        shards = [
            tuple(a[sl].to(dev) for a in rows)
            for dev, sl in local_blocks(mesh, q_lens.shape[0])
        ]
    cons, lens = cons0, lens0
    for _ in range(ITERS):
        runs = _run_map_device(cons, T)
        bv, ir, cv = sum_on_first(
            (band_votes_kernel(cons.to(f.device), lens.to(f.device), f, q, r, wi, T, BW, NWIN)
             for f, q, r, wi in shards),
            cons.device, mesh.group if mesh is not None else None,
        )
        iv = canonicalize_ins(ir, runs, T)
        toks, toks_len = _rebuild_device(cons, lens, bv, iv, cv, T)
        cons = toks[:, :T].contiguous()
        lens = toks_len.clamp(max=T).to(torch.int32)
    return toks.to(torch.int8), toks_len


def _pow2(v: int, lo: int) -> int:
    c = lo
    while c < v:
        c <<= 1
    return c


_TORCH_DTYPE = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                np.dtype(np.uint8): torch.uint8}


def _upload(stage, arrays: dict, device: torch.device) -> dict:
    """A group's arrays (numpy views of the uint8 CPU tensor `stage`, or
    None) as tensors on `device`: to a card one copy of `stage`, pinned,
    without blocking (so the next group's host prep overlaps this group's
    work), and the same views of the copy."""
    if device.type != "cuda":
        return {k: None if a is None else torch.from_numpy(a).to(device)
                for k, a in arrays.items()}
    flat = stage.to(device, non_blocking=True)
    base = stage.data_ptr()
    out = {}
    for k, a in arrays.items():
        if a is not None:
            at = a.ctypes.data - base
            a = flat[at: at + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
        out[k] = a
    return out


def _prepare_group(grp, t_pad: int, q_pad: int, bw: int, n_dev: int = 1,
                   pinned: bool = False):
    """Host prep of one group of windows, laid out for one upload: (stage,
    arrays, NWIN).  `stage` is one uint8 CPU tensor (in pinned memory when
    `pinned`) and `arrays` numpy views of it by name: the backbones cons0
    [NWIN, t_pad] (-1 past each) and lens0 [NWIN] int32; per fragment row
    (B_pad of them, a multiple of `n_dev`; the rows past the group's
    fragments are padding, q_len 0) src int64, the row's first byte in
    `bases`, and int32 q_lens (its length cut at q_pad), r0 (its span start
    clipped to [0, t_pad - 1]) and win_of; `bases`, the fragments' bytes
    back to back, and `wts`, their weights (ones for a window that carries
    none), None when no window of the group carries weights.
    band_cuda.band_pack turns them into the rows fw_sh [B_pad, t_pad + bw +
    1] that pack_shifted_fragments makes.  The work is whole-group: the
    lengths and span starts by np.fromiter, one concatenate of the bytes
    (and one of the weights) straight into the buffer."""
    counts = np.fromiter((len(w[1]) for w in grp), np.int64, len(grp))
    B_total = int(counts.sum())
    NWIN = _pow2(len(grp), 8)
    B_pad = -(-_pow2(max(B_total, 1), 256) // n_dev) * n_dev
    frags = [f for w in grp for f in w[1]]
    lens = np.fromiter(map(len, frags), np.int64, B_total)
    N = int(lens.sum())
    weighted = any(w[2] is not None for w in grp)
    shapes = {"src": (np.int64, (B_pad,)), "q_lens": (np.int32, (B_pad,)),
              "r0": (np.int32, (B_pad,)), "win_of": (np.int32, (B_pad,)),
              "cons0": (np.int32, (NWIN, t_pad)), "lens0": (np.int32, (NWIN,)),
              "bases": (np.uint8, (N,)), "wts": (np.uint8, (N if weighted else 0,))}
    at, size = {}, 0
    for k, (dt, shape) in shapes.items():  # each array at a multiple of 16 bytes
        at[k] = size
        size += -(-int(np.prod(shape)) * np.dtype(dt).itemsize // 16) * 16
    stage = torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
    buf = stage.numpy()
    a = {k: buf[at[k]: at[k] + int(np.prod(shape)) * np.dtype(dt).itemsize]
         .view(dt).reshape(shape) for k, (dt, shape) in shapes.items()}
    for k in ("src", "q_lens", "r0", "win_of"):
        a[k][B_total:] = 0
    a["src"][:B_total] = np.cumsum(lens) - lens
    a["q_lens"][:B_total] = np.minimum(lens, q_pad)
    starts = np.fromiter(chain.from_iterable(
        (s[0] for s in sp[: len(fr)]) if sp is not None else repeat(0, len(fr))
        for _b, fr, _w, sp in grp), np.int64, B_total)
    a["r0"][:B_total] = np.clip(starts, 0, t_pad - 1)
    a["win_of"][:B_total] = np.repeat(np.arange(len(grp), dtype=np.int32), counts)
    if B_total:
        np.concatenate(frags, out=a["bases"], casting="unsafe")
    if weighted:
        parts, lo = [], 0
        for (_b, fr, wts, _s), n in zip(grp, counts):
            if wts is None:
                parts.append(np.ones(int(lens[lo: lo + n].sum()), np.uint8))
            elif any(len(w) != len(f) for w, f in zip(wts, fr)):
                parts.extend(np.asarray(w)[: len(f)] for w, f in zip(wts, fr))
            else:
                parts.extend(wts[: len(fr)])
            lo += n
        np.concatenate(parts, out=a["wts"], casting="unsafe")
    else:
        a["wts"] = None
    a["cons0"].fill(-1)
    a["lens0"].fill(0)
    for gi, (bb, _f, _w, _s) in enumerate(grp):
        cl = min(len(bb), t_pad)
        a["cons0"][gi, :cl] = bb[:cl]
        a["lens0"][gi] = cl
    return stage, a, NWIN


def host_layout(grp, t_pad: int, q_pad: int, bw: int, n_dev: int = 1):
    """A group's arrays as band_window_consensus hands them to
    resident_consensus, made on the CPU (band_pack's plain version):
    ((cons0, lens0, fw_sh, q_lens, r0, win_of) as numpy, NWIN)."""
    stage, a, NWIN = _prepare_group(grp, t_pad, q_pad, bw, n_dev)
    d = _upload(stage, a, torch.device("cpu"))
    fw_sh = band_cuda.band_pack(d["bases"], d["wts"], d["src"], d["q_lens"], d["r0"],
                                t_pad, bw)
    return (a["cons0"], a["lens0"], fw_sh.numpy(), a["q_lens"], a["r0"], a["win_of"]), NWIN


def band_window_consensus(
    windows,
    iterations: int = 2,
    t_pad: int = 640,
    q_pad: int = 768,
    bw: int = 256,
    group: int = 128,
    max_rows: int = 32768,
    mesh=None,
    device=None,
):
    """Batched window consensus on the shift-banded resident engine, on
    `device` (CUDA by default), or over the devices of `mesh`
    (raven_tpu_torch.parallel.mesh.Mesh, the first device holding each
    group's consensus).

    windows: [(backbone, fragments, weights-or-None[, spans])]; returns one
    consensus array per window, token for token what raven_tpu's
    band_window_consensus returns.  Windows are split into groups of at most
    `group` windows and `max_rows` fragment rows; each group's refinement
    loop is queued on the device in turn and the tokens are collected once
    every group is queued.

    The call is the span "band.call" {windows, groups}; each group's host
    prep "band.prepare" {windows, fragments, rows: the padded B}, its upload
    and the pack of its fragment rows on the device "band.upload" {bytes:
    the one staged buffer that crosses} and its refinement loop's launches
    "band.queue" {iterations}; the tokens' return, which waits for the
    card, "band.collect".
    """
    with trace.span("band.call", windows=len(windows)) as call:
        device = mesh.first if mesh is not None else resolve_device(device)
        n_dev = mesh.size if mesh is not None else 1
        n_win = len(windows)
        windows = [
            (w[0], w[1], w[2], w[3] if len(w) > 3 else None) for w in windows
        ]
        out: list = [None] * n_win
        pending = []  # (win_lo, n_local, toks, lens) on the device

        wi = 0
        while wi < n_win:
            # group boundary: window count AND fragment-row budget
            lo = wi
            rows = 0
            while wi < n_win and (wi - lo) < group:
                r = len(windows[wi][1])
                if rows + r > max_rows and wi > lo:
                    break
                rows += r
                wi += 1
            grp = windows[lo:wi]
            with trace.span("band.prepare", windows=len(grp), fragments=rows) as s:
                stage, arrays, NWIN = _prepare_group(grp, t_pad, q_pad, bw, n_dev,
                                                     pinned=device.type == "cuda")
                s["rows"] = arrays["q_lens"].shape[0]
            with trace.span("band.upload", bytes=stage.nbytes):
                d = _upload(stage, arrays, device)
                fw_sh = band_cuda.band_pack(d["bases"], d["wts"], d["src"], d["q_lens"],
                                            d["r0"], t_pad, bw)
            with trace.span("band.queue", iterations=int(iterations)):
                toks, lens = resident_consensus(
                    d["cons0"], d["lens0"], fw_sh, d["q_lens"], d["r0"], d["win_of"], t_pad,
                    bw, NWIN, int(iterations), mesh,
                )
            pending.append((lo, len(grp), toks, lens))

        with trace.span("band.collect"):
            for lo, n_local, toks, lens in pending:
                toks_np = toks.cpu().numpy()
                lens_np = lens.cpu().numpy()
                for gi in range(n_local):
                    out[lo + gi] = toks_np[gi, : int(lens_np[gi])].astype(np.uint8)
        call["groups"] = len(pending)
    return out
