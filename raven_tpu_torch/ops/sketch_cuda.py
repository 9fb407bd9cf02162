"""Segment sketch: the CUDA kernel K1 and its plain PyTorch version.

`sketch(codes, lengths, k, w)` is the port of the TPU kernel
raven_tpu/ops/pallas_sketch.py::pallas_sketch.  On a CUDA tensor it
launches the hand-written kernel in raven_tpu_torch/csrc/sketch.cu (see the
note there for what bounds it and how the design answers that) or raises;
on a CPU tensor it runs `sketch_plain`, the same function in torch ops
(the counterpart of raven_tpu.ops.sketch.sketch_kernel).  Both return
(hash int32, strand bool, keep bool), each [S, L], bit-identical.

`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

UINT32_INF = 0xFFFFFFFF  # window sentinel (hashes are < 2^30)
LAUNCHES = 0


def _hash_mix(key: torch.Tensor, mask: int) -> torch.Tensor:
    # int64 lanes: every masked step is congruent mod 2^(2k) to the uint32
    # mix (torch on the CPU has no uint32 shifts), and values stay < 2^61
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def sketch_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    """codes [S, L] integer base codes 0..3; lengths [S].  Returns (hash
    int32, strand bool, keep bool), each [S, L], indexed by k-mer start;
    positions beyond L - k carry zeros."""
    S, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    mask = (1 << (2 * k)) - 1
    n = L - k + 1
    fk = torch.zeros((S, n), dtype=torch.int64, device=dev)
    rk = torch.zeros((S, n), dtype=torch.int64, device=dev)
    for j in range(k):
        cj = c[:, j : j + n]
        fk |= cj << (2 * (k - 1 - j))
        rk |= (cj ^ 3) << (2 * j)
    ambiguous = fk == rk
    strand = fk <= rk
    h = _hash_mix(torch.minimum(fk, rk), mask)

    pos = torch.arange(n, device=dev)[None, :]
    last = lengths.to(torch.int64)[:, None] - k
    hwin = torch.where(ambiguous | (pos > last), UINT32_INF, h)

    hp = torch.cat(
        [hwin, torch.full((S, w - 1), UINT32_INF, dtype=torch.int64, device=dev)],
        dim=1,
    )
    wmin = hp[:, :n]
    for t in range(1, w):
        wmin = torch.minimum(wmin, hp[:, t : t + n])
    wmin = torch.where(pos + (w - 1) <= last, wmin, 0)

    wp = torch.cat(
        [torch.zeros((S, w - 1), dtype=torch.int64, device=dev), wmin], dim=1
    )
    covmax = wp[:, :n]
    for t in range(1, w):
        covmax = torch.maximum(covmax, wp[:, t : t + n])
    keep = (covmax == hwin) & ~ambiguous & (hwin != UINT32_INF)

    pad = (0, L - n)
    return (
        torch.nn.functional.pad(h, pad).to(torch.int32),
        torch.nn.functional.pad(strand, pad),
        torch.nn.functional.pad(keep, pad),
    )


def _kernel(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    global LAUNCHES
    from raven_tpu_torch import csrc

    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be [S, L] uint8, got {codes.dtype} {tuple(codes.shape)}")
    S, L = codes.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (S,):
        raise TypeError(f"lengths must be [{S}] int32, got {lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must lie on one device")
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    if not (1 <= k <= 15 and 1 <= w and L >= k):
        raise ValueError(f"unsupported k={k}, w={w}, L={L} (2k <= 30, L >= k)")
    if S >= 2**31:
        raise ValueError(f"too many rows ({S})")
    h = torch.empty((S, L), dtype=torch.int32, device=codes.device)
    strand = torch.empty((S, L), dtype=torch.bool, device=codes.device)
    keep = torch.empty((S, L), dtype=torch.bool, device=codes.device)
    if S == 0:
        return h, strand, keep
    lib = csrc.load("sketch")
    fn = lib.raven_sketch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(
        codes.data_ptr(), lengths.data_ptr(), h.data_ptr(),
        strand.data_ptr(), keep.data_ptr(), S, L, k, w, stream,
    )
    csrc.check(lib, err, "segment sketch kernel launch")
    LAUNCHES += 1
    return h, strand, keep


def sketch(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if codes.device.type == "cuda":
        return _kernel(codes, lengths, k, w)
    if codes.device.type == "cpu":
        return sketch_plain(codes, lengths, k, w)
    raise ValueError(f"no segment sketch for device {codes.device}")
