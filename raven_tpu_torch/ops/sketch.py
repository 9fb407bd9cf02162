"""Device (k,w)-minimizer sketching over fixed-width read segments.

The torch port of raven_tpu/ops/sketch.py: the host packers that tile reads
into halo'd fixed-width segment rows (numpy plus the native segment_pack.cc
pass), and `sketch_segments`, which sketches a batch of rows on the device
and globalizes the result into flat (key, read id, position, strand)
columns.  The per-row sketch itself is kernel K1
(raven_tpu_torch.ops.sketch_cuda: the CUDA kernel on a CUDA tensor,
`sketch_plain` on a CPU tensor).  Canonical hashing is the masked avalanche
mix, bit-identical to the uint64 host path (raven_tpu_torch.overlap.minimizer)
for 2k <= 30.

This replaces the `ram` dependency's Minimize loop (reference
construct.cc:42,363) as the overlap phase's hot kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from raven_tpu_torch.ops.sketch_cuda import sketch, sketch_plain  # noqa: F401

UINT32_INF = np.uint32(0xFFFFFFFF)

# Segment rows of one read never cross a multiple-of-CHUNK_ALIGN row
# boundary (pad rows fill the gap).  The device index sketches in chunks
# of at most CHUNK_ALIGN rows (device_index._chunk_sketch_compact), and
# read-aligned chunks let it compute per-read minhash ranks INSIDE the
# chunk pass — the separate full-index (read, hash, pos) flags sort was
# the build's single largest cost.  Waste: <= a few rows per boundary
# (reads are ~5 rows), < 0.1%.
CHUNK_ALIGN = 8192


def align_row_starts(segs: np.ndarray, align: int = CHUNK_ALIGN):
    """Row start per read such that no read's rows cross a
    multiple-of-`align` row boundary.  Returns (starts [n] int64,
    total_rows).  Reads longer than align rows (~16.6 Gb at width 2048)
    are unsupported."""
    segs = np.asarray(segs, dtype=np.int64)
    n = segs.size
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    assert int(segs.max(initial=0)) <= align, "read exceeds one chunk"
    c = np.cumsum(segs)
    starts_un = c - segs
    pad_at = np.zeros(n, dtype=np.int64)
    off = 0
    b_end = align
    total = int(c[-1])
    while b_end < total + off:
        j = int(np.searchsorted(c, b_end - off, side="left"))
        if j >= n:
            break
        if int(starts_un[j]) + off < b_end < int(c[j]) + off:
            pad = b_end - (int(starts_un[j]) + off)
            pad_at[j] += pad
            off += pad
        b_end += align
    return starts_un + np.cumsum(pad_at), total + off


def segments_per_read(lengths: np.ndarray, k: int, w: int, width: int = 2048) -> np.ndarray:
    """The halo'd segment rows each read of `lengths` tiles into (0 for a
    read too short to hold one (k, w) window)."""
    stride = width - ((k - 1) + 2 * (w - 1))
    n = np.asarray(lengths, dtype=np.int64)
    return np.where(n < k + w - 1, 0, 1 + np.maximum(0, -(-(n - width) // stride)))


def segment_reads(
    readset, ids: np.ndarray, k: int, w: int, width: int = 2048
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tile reads into fixed-width halo'd segments for sketch_segments_kernel.

    Returns (codes [S, width] u32, eff_lens, read_ids, base_offsets,
    claim_lo, claim_hi) — all int32 except codes.
    """
    halo = (k - 1) + 2 * (w - 1)
    stride = width - halo
    assert stride > 0
    rows = []
    meta = []
    pad_meta = (0, 0, 0, 0, 0)  # eff 0 -> every entry masked out
    for i in ids:
        i = int(i)
        n = int(readset.lengths[i])
        if n < k + w - 1:
            continue
        segs = 1 + max(0, -(-(n - width) // stride))
        used = len(rows) % CHUNK_ALIGN
        if used + segs > CHUNK_ALIGN:  # read would straddle a chunk edge
            for _ in range(CHUNK_ALIGN - used):
                rows.append(np.zeros(0, dtype=np.uint8))
                meta.append(pad_meta)
        s = 0
        seg_idx = 0
        while True:
            codes = readset.sequence(i, s, min(width, n - s))
            rows.append(codes)
            last = s + width >= n
            c_lo = 0 if seg_idx == 0 else w - 1
            # the final segment reaches the read end: claim its whole tail
            c_hi = width if last else (w - 1) + stride
            meta.append((codes.size, i, s, c_lo, c_hi))
            if last:
                break
            s += stride
            seg_idx += 1
    S = len(rows)
    out = np.zeros((S, width), dtype=np.uint8)
    for r, codes in enumerate(rows):
        out[r, : codes.size] = codes
    m = np.array(meta, dtype=np.int32).reshape(S, 5)
    return out, m[:, 0], m[:, 1], m[:, 2], m[:, 3], m[:, 4]


def segment_reads_packed(
    readset, ids: np.ndarray, k: int, w: int, width: int = 2048
):
    """segment_reads followed by 2-bit packing (4 bases/byte), as one
    native C++ pass when the readset stores flat SoA codes.

    Returns (packed [S, width//4] uint8, eff, rids, base, clo, chi).
    The packed rows feed the device index h2d upload directly
    (overlap/device_index.py) — the python segment + pack pair was the
    serial host head of the device overlap stage (~5 s of a ~9 s steady
    stage at 115 Mbp)."""
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
    halo = (k - 1) + 2 * (w - 1)
    stride = width - halo
    assert stride > 0 and width % 4 == 0

    codes_flat = getattr(readset, "codes", None)
    starts = getattr(readset, "starts", None)
    native = None
    if (
        isinstance(codes_flat, np.ndarray)
        and isinstance(starts, np.ndarray)
        and codes_flat.dtype == np.uint8
        and codes_flat.flags.c_contiguous
    ):
        from raven_tpu_torch import native as native_mod

        native = native_mod.get_lib()
    if native is not None and hasattr(native, "raven_segment_pack"):
        import ctypes
        import os as _os

        lengths = np.ascontiguousarray(readset.lengths, dtype=np.int64)
        starts64 = np.ascontiguousarray(starts, dtype=np.int64)
        segs = segments_per_read(lengths[ids], k, w, width)
        row_starts, S = align_row_starts(segs)
        row_off = np.empty(ids.size + 1, dtype=np.int64)
        row_off[: ids.size] = row_starts
        row_off[ids.size] = S
        # gap (alignment pad) rows are never touched by the native pass:
        # zero-init everything — eff 0 masks every entry of a pad row
        packed = np.zeros((S, width // 4), dtype=np.uint8)
        eff = np.zeros(S, dtype=np.int32)
        rid = np.zeros(S, dtype=np.int32)
        base = np.zeros(S, dtype=np.int32)
        clo = np.zeros(S, dtype=np.int32)
        chi = np.zeros(S, dtype=np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        native.raven_segment_pack(
            codes_flat.ctypes.data_as(u8p),
            starts64.ctypes.data_as(i64p),
            lengths.ctypes.data_as(i64p),
            ids.ctypes.data_as(i64p),
            ctypes.c_longlong(ids.size),
            row_off.ctypes.data_as(i64p),
            ctypes.c_int(k),
            ctypes.c_int(w),
            ctypes.c_int(width),
            packed.ctypes.data_as(u8p),
            eff.ctypes.data_as(i32p),
            rid.ctypes.data_as(i32p),
            base.ctypes.data_as(i32p),
            clo.ctypes.data_as(i32p),
            chi.ctypes.data_as(i32p),
            ctypes.c_int(min(16, _os.cpu_count() or 1)),
        )
        return packed, eff, rid, base, clo, chi

    codes, eff, rids, base, clo, chi = segment_reads(
        readset, ids, k, w, width=width
    )
    S = codes.shape[0]
    c4 = codes.reshape(S, width // 4, 4)
    packed = (
        c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4) | (c4[..., 3] << 6)
    ).astype(np.uint8)
    return packed, eff, rids, base, clo, chi


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """[S, W/4] uint8 rows of 2-bit codes (4 bases per byte, first base in
    the low bits) -> [S, W] uint8 codes 0..3, on packed's device."""
    u = packed.to(torch.int32)
    S, B = u.shape
    return (
        torch.stack([(u >> (2 * b)) & 3 for b in range(4)], dim=2)
        .reshape(S, B * 4)
        .to(torch.uint8)
    )


def sketch_segments(codes, eff_lens, read_ids, base_offsets, claim_lo,
                    claim_hi, k: int, w: int):
    """Fixed-width segment sketching (sketch_segments_kernel's contract).

    Long reads are tiled into constant-width segments with a
    (k - 1 + 2(w - 1))-base halo so every winnowing decision has its full
    window context in-segment; each segment claims the disjoint position
    range [claim_lo, claim_hi) and the union over segments reproduces the
    per-read sketch exactly.

    codes: [S, C] uint8 on the device; eff_lens, read_ids, base_offsets,
    claim_lo, claim_hi: [S] int32 on the same device.  Returns flat
    (key int64, id int32, pos int32, strand int32) with UINT32_INF keys
    outside claims or not kept.
    """
    h, strand, keep = sketch(codes, eff_lens, k, w)
    S, C = h.shape
    pos = torch.arange(C, dtype=torch.int32, device=h.device)[None, :]
    claim = (pos >= claim_lo[:, None]) & (pos < claim_hi[:, None])
    key = torch.where(
        keep & claim, h.to(torch.int64), int(UINT32_INF)
    ).reshape(-1)
    ids = read_ids[:, None].expand(S, C).reshape(-1)
    gpos = (pos + base_offsets[:, None]).reshape(-1)
    sb = strand.reshape(-1).to(torch.int32)
    return key, ids, gpos, sb


def sketch_compact(codes, lengths, read_ids, k: int, w: int, capacity: int):
    """raven_tpu's sketch_compact_kernel (raven_tpu/ops/sketch.py:317): K1
    on `[B, L]` read rows, then every cell as (key int64, id int32, pos
    int32, strand int32) in flattened read-major order, stably sorted by
    key (kept minimizers' hashes; UINT32_INF, the largest key, where none
    is kept), cut to `capacity` entries (the smallest keys) or padded to
    it with UINT32_INF keys (id -1, pos 0, strand 0) when the rows hold
    fewer cells.  Returns those four columns and, fifth, the count of kept
    minimizers before the cut (a 0-d tensor on the rows' device).  codes:
    [B, L] uint8; lengths, read_ids: [B] int32, on one device; K1 on a
    CUDA tensor, its plain version on a CPU tensor."""
    h, strand, keep = sketch(codes, lengths, k, w)
    B, L = h.shape
    key = torch.where(keep, h.to(torch.int64), int(UINT32_INF)).reshape(-1)
    ids = read_ids.to(torch.int32)[:, None].expand(B, L).reshape(-1)
    pos = torch.arange(L, dtype=torch.int32, device=h.device).repeat(B)
    sb = strand.reshape(-1).to(torch.int32)
    key, order = torch.sort(key, stable=True)
    cols = (key, ids[order], pos[order], sb[order])
    kept = keep.sum()
    pad = capacity - key.numel()
    if pad <= 0:
        return (*(c[:capacity] for c in cols), kept)
    fill = (int(UINT32_INF), -1, 0, 0)
    return (*(torch.cat([c, c.new_full((pad,), v)]) for c, v in zip(cols, fill)), kept)
