"""Global (NW) edit distance — the edlib-equivalent.

Reference use sites: overlap identity filtering (construct.cc:190-199),
bubble path similarity (assemble.cc:271-281), CSV edge similarity
(graph_repr.cc:250-258), golden test oracle (raven_test.cpp:38-44).

Paths:
  * native C++ Myers bit-parallel (raven_tpu_torch/native/myers.cc) — default;
  * numpy fallback using the prefix-min trick (each row's horizontal
    dependency collapsed into np.minimum.accumulate);
  * a banded device kernel for batched similarity (the polisher's, which
    this package does not carry yet).
"""

from __future__ import annotations

import ctypes

import numpy as np

_ED_FN = None
_ED_TRIED = False


def _native_ed():
    global _ED_FN, _ED_TRIED
    if _ED_FN is not None or _ED_TRIED:
        return _ED_FN
    _ED_TRIED = True
    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    fn = lib.raven_myers_ed
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong,
    ]
    _ED_FN = fn
    return fn


def _numpy_ed(a: np.ndarray, b: np.ndarray) -> int:
    """O(nm) DP; horizontal dependency resolved via prefix minimum."""
    n, m = a.size, b.size
    if n == 0:
        return m
    if m == 0:
        return n
    idx = np.arange(m + 1, dtype=np.int32)
    prev = idx.copy()  # D[0][:]
    for i in range(n):
        e = np.empty(m + 1, dtype=np.int32)
        e[0] = i + 1
        sub = prev[:-1] + (b != a[i])
        e[1:] = np.minimum(sub, prev[1:] + 1)
        # D[i][j] = min_k<=j (E[k] + j - k)
        prev = np.minimum.accumulate(e - idx) + idx
    return int(prev[-1])


def edit_distance(a: np.ndarray | str, b: np.ndarray | str) -> int:
    """Global edit distance between two code arrays (or strings)."""
    if isinstance(a, str):
        from raven_tpu_torch.io.readset import encode

        a = encode(a)
    if isinstance(b, str):
        from raven_tpu_torch.io.readset import encode

        b = encode(b)
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    fn = _native_ed()
    if fn is not None:
        return int(
            fn(
                a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                a.size,
                b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                b.size,
            )
        )
    return _numpy_ed(a, b)


_ED_BANDED_FN = None
_ED_BANDED_TRIED = False


def _native_ed_banded():
    global _ED_BANDED_FN, _ED_BANDED_TRIED
    if _ED_BANDED_FN is not None or _ED_BANDED_TRIED:
        return _ED_BANDED_FN
    _ED_BANDED_TRIED = True
    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    fn = lib.raven_myers_ed_banded
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong,
        ctypes.c_longlong,
    ]
    _ED_BANDED_FN = fn
    return fn


def edit_distance_banded(
    a: np.ndarray | str, b: np.ndarray | str, k0: int = 4096
) -> int:
    """Exact global edit distance via block-banded Myers with Ukkonen
    doubling: O(m * ED / 64) instead of O(m * n / 64) — megabase-scale
    contig-vs-truth comparisons in seconds (the edlib banded path the
    full-matrix kernel lacks).  Falls back to the full kernel when the
    native library is unavailable."""
    if isinstance(a, str):
        from raven_tpu_torch.io.readset import encode

        a = encode(a)
    if isinstance(b, str):
        from raven_tpu_torch.io.readset import encode

        b = encode(b)
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    fn = _native_ed_banded()
    if fn is None:
        return edit_distance(a, b)
    k = max(64, int(k0))
    ap = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    bp = b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    while True:
        r = int(fn(ap, a.size, bp, b.size, k))
        if r >= 0:
            return r
        if k >= max(a.size, b.size):
            return edit_distance(a, b)
        k *= 2


def edit_distance_bounded(
    a: np.ndarray | str, b: np.ndarray | str, limit: int
) -> int:
    """Exact edit distance if it is <= limit, else any value > limit.

    Threshold checks (bubble path similarity >= 0.8, assemble.cc:267-279)
    never need the exact distance of dissimilar pairs — one banded Myers
    pass with band = limit answers them in O(m * limit / 64) instead of
    the full O(m * n / 64) matrix (a 500 kb bubble pair drops ~25x)."""
    if isinstance(a, str):
        from raven_tpu_torch.io.readset import encode

        a = encode(a)
    if isinstance(b, str):
        from raven_tpu_torch.io.readset import encode

        b = encode(b)
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    limit = int(limit)
    if abs(a.size - b.size) > limit:
        return limit + 1  # ED >= |n - m|
    fn = _native_ed_banded()
    if fn is None:
        return edit_distance(a, b)
    r = int(
        fn(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            a.size,
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            b.size,
            max(64, limit),
        )
    )
    return r if r >= 0 else limit + 1


def overlap_identity(overlaps: np.ndarray, readset) -> np.ndarray:
    """1 - ED/max(len) per overlap (reference construct.cc:177-199)."""
    from raven_tpu_torch.io.readset import reverse_complement

    scores = np.zeros(overlaps.size, dtype=np.float64)
    for j, o in enumerate(overlaps):
        lhs = readset.sequence(
            int(o["lhs_id"]),
            int(o["lhs_begin"]),
            int(o["lhs_end"]) - int(o["lhs_begin"]),
        )
        rhs = readset.sequence(
            int(o["rhs_id"]),
            int(o["rhs_begin"]),
            int(o["rhs_end"]) - int(o["rhs_begin"]),
        )
        if not o["strand"]:
            rhs = reverse_complement(rhs)
        ed = edit_distance(lhs, rhs)
        scores[j] = 1.0 - ed / max(lhs.size, rhs.size)
    return scores
