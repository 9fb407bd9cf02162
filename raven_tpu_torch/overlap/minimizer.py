"""(k,w)-minimizer sampling — host (numpy) reference implementation.

Replacement for the `ram` dependency's MinimizerEngine::Minimize
(use sites: reference construct.cc:42,363; assemble.cc:754,777).  The device
implementations in raven_tpu_torch.ops.sketch (torch) and
raven_tpu_torch.ops.sketch_cuda (CUDA) compute the same sketch (bit-parity
tested); this numpy version is the correctness oracle and the small-input
path.

Definitions
-----------
For every k-mer window position p in a read we compute the forward 2k-bit
value fk and its reverse-complement value rk.  Positions with fk == rk are
skipped (strand-ambiguous).  The canonical value min(fk, rk) is avalanched
with an invertible masked integer hash (the classic 64-bit mix used by
minimap-family tools, bijective modulo 2^(2k)), and the sketch keeps every
position whose hash is minimal in at least one w-window (robust winnowing,
ties kept).  `strand` records whether the forward value was canonical.

minhash mode ("micromizers", reference CLI -M, construct.h:19): keep only the
floor(len / k) smallest hashes of the read's sketch.
"""

from __future__ import annotations

import numpy as np


def hash_mix(key: np.ndarray, mask: int) -> np.ndarray:
    """Invertible avalanche hash on the masked domain (uint64 in/out)."""
    key = np.asarray(key, dtype=np.uint64)
    m = np.uint64(mask)
    with np.errstate(over="ignore"):  # modular arithmetic is intended
        key = (~key + (key << np.uint64(21))) & m
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & m
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & m
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & m
    return key


def kmer_values(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement 2k-bit values for every k-mer window.

    Returns (fk, rk), each uint64[len(codes) - k + 1].
    """
    n = codes.size
    if n < k:
        e = np.empty(0, dtype=np.uint64)
        return e, e
    c = codes.astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(c, k)  # [n-k+1, k]
    fw_pow = (np.uint64(1) << (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)))
    rc_pow = (np.uint64(1) << (np.uint64(2) * np.arange(k, dtype=np.uint64)))
    fk = (win * fw_pow).sum(axis=1, dtype=np.uint64)
    rk = ((np.uint64(3) ^ win) * rc_pow).sum(axis=1, dtype=np.uint64)
    return fk, rk


def minimize_read(
    codes: np.ndarray, k: int, w: int, minhash: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sketch one read.

    Returns (hash u64, pos u32, strand u8) sorted by position; pos is the
    k-mer start on the forward strand; strand=1 means forward was canonical.
    """
    n = codes.size
    if n < k + max(w, 1) - 1 or n < k:
        e = np.empty(0, np.uint64)
        return e, np.empty(0, np.uint32), np.empty(0, np.uint8)
    mask = (1 << (2 * k)) - 1
    fk, rk = kmer_values(codes, k)
    ambiguous = fk == rk
    canonical = np.minimum(fk, rk)
    strand = (fk <= rk).astype(np.uint8)  # 1 = forward canonical
    h = hash_mix(canonical, mask)
    # exclude ambiguous positions from winnowing
    INF = np.uint64(0xFFFFFFFFFFFFFFFF)
    h_win = np.where(ambiguous, INF, h)

    nw = h_win.size - w + 1
    if nw <= 0:
        e = np.empty(0, np.uint64)
        return e, np.empty(0, np.uint32), np.empty(0, np.uint8)
    sw = np.lib.stride_tricks.sliding_window_view(h_win, w)  # [nw, w]
    wmin = sw.min(axis=1)  # sliding window minimum
    # position p is kept iff h[p] equals the min of some window covering p:
    # windows j in [p-w+1, p] ∩ [0, nw); since wmin[j] <= h[p] whenever p is
    # inside window j, the condition is max_j wmin[j] == h[p].
    pad = np.full(w - 1, np.uint64(0), dtype=np.uint64)
    wmin_padded = np.concatenate([pad, wmin, pad])
    cover = np.lib.stride_tricks.sliding_window_view(wmin_padded, w)  # [len(h), w]
    cover_max = cover.max(axis=1)
    keep = (cover_max == h_win) & ~ambiguous & (h_win != INF)

    pos = np.nonzero(keep)[0].astype(np.uint32)
    hashes = h[pos]
    strands = strand[pos]

    if minhash and pos.size:
        budget = n // k
        if pos.size > budget:
            order = np.argsort(hashes, kind="stable")[:budget]
            order.sort()  # back to position order
            pos = pos[order]
            hashes = hashes[order]
            strands = strands[order]
    return hashes, pos, strands


def _minimize_chunk(readset, ids, k, w, minhash):
    hs, is_, ps, ss = [], [], [], []
    for i in ids:
        h, p, s = minimize_read(readset.sequence(int(i)), k, w, minhash)
        if h.size:
            hs.append(h)
            is_.append(np.full(h.size, i, dtype=np.uint32))
            ps.append(p)
            ss.append(s)
    if not hs:
        return (
            np.empty(0, np.uint64),
            np.empty(0, np.uint32),
            np.empty(0, np.uint32),
            np.empty(0, np.uint8),
        )
    return (
        np.concatenate(hs),
        np.concatenate(is_),
        np.concatenate(ps),
        np.concatenate(ss),
    )


_POOL_STATE: dict = {}


def _pool_worker(args):
    lo, hi = args
    rs = _POOL_STATE["readset"]
    return _minimize_chunk(
        rs,
        _POOL_STATE["ids"][lo:hi],
        _POOL_STATE["k"],
        _POOL_STATE["w"],
        _POOL_STATE["minhash"],
    )


def minimize_reads(
    readset, ids: np.ndarray, k: int, w: int, minhash: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sketch several reads; returns (hash, id, pos, strand) concatenated.

    Large batches fan out over processes (fork shares the read arrays
    copy-on-write) — the host equivalent of the reference's thread pool
    (construct.cc:57-113); single-process for small inputs and platforms
    without fork.
    """
    import os
    import sys

    from raven_tpu_torch.config import worker_count

    total = int(readset.lengths[np.asarray(ids, dtype=np.int64)].sum()) if len(ids) else 0
    workers = worker_count()
    import torch

    if (
        total >= 16_000_000
        and workers > 1
        and sys.platform.startswith("linux")
        and os.environ.get("RAVEN_TPU_NO_MP") != "1"
        and not torch.cuda.is_initialized()  # a child forked after CUDA init must not touch it
    ):
        import multiprocessing as mp

        _POOL_STATE.update(
            {"readset": readset, "ids": ids, "k": k, "w": w, "minhash": minhash}
        )
        try:
            n = len(ids)
            chunk = (n + workers * 4 - 1) // (workers * 4)
            ranges = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
            ctx = mp.get_context("fork")
            with ctx.Pool(workers) as pool:
                parts = pool.map(_pool_worker, ranges)
            return tuple(
                np.concatenate([p[j] for p in parts]) for j in range(4)
            )  # type: ignore[return-value]
        finally:
            _POOL_STATE.clear()
    return _minimize_chunk(readset, ids, k, w, minhash)
