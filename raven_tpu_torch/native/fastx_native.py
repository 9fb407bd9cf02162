"""ctypes bridge for the native FASTX parser (fastx.cc)."""

from __future__ import annotations

import ctypes

import numpy as np

_FNS = None


def _load():
    global _FNS
    if _FNS is not None:
        return _FNS
    from raven_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        _FNS = False
        return False
    lib.raven_fastx_parse.restype = ctypes.c_void_p
    lib.raven_fastx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for name in (
        "raven_fastx_num_reads",
        "raven_fastx_total_bases",
        "raven_fastx_names_size",
        "raven_fastx_has_quals",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p]
    lib.raven_fastx_error.restype = ctypes.c_char_p
    lib.raven_fastx_error.argtypes = [ctypes.c_void_p]
    lib.raven_fastx_copy.restype = None
    lib.raven_fastx_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_char_p,
    ]
    lib.raven_fastx_free.restype = None
    lib.raven_fastx_free.argtypes = [ctypes.c_void_p]
    _FNS = lib
    return lib


def parse(path: str, is_fastq: bool):
    """Returns a ReadSet, or None when the native library is unavailable.
    Raises ParserError on malformed input (mirroring the python parser)."""
    lib = _load()
    if not lib:
        return None
    from raven_tpu_torch.io.fastx import ParserError
    from raven_tpu_torch.io.readset import ReadSet

    h = lib.raven_fastx_parse(path.encode(), 1 if is_fastq else 0)
    if not h:
        return None
    try:
        err = lib.raven_fastx_error(h)
        if err:
            raise ParserError(err.decode())
        n = lib.raven_fastx_num_reads(h)
        total = lib.raven_fastx_total_bases(h)
        names_size = lib.raven_fastx_names_size(h)
        has_quals = lib.raven_fastx_has_quals(h)

        codes = np.zeros(total, dtype=np.uint8)
        quals = np.zeros(total if has_quals else 0, dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int64)
        names_buf = ctypes.create_string_buffer(int(names_size) + 1)
        lib.raven_fastx_copy(
            h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if has_quals
            else None,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            names_buf,
        )
        names = (
            names_buf.raw[: int(names_size)].decode().split("\n")[:-1]
            if names_size
            else []
        )
        starts = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(lengths[:-1], out=starts[1:])
        if has_quals and not quals.any():
            quals = np.empty(0, dtype=np.uint8)  # all '!' -> no quality
        return ReadSet(names, starts, lengths, codes, quals)
    finally:
        lib.raven_fastx_free(h)
